"""Tensor-parallel scenarios for the port, and a rank that runs them (no
JAX).

A world of 2 or 4 ranks of this module over gloo lays itself out as a
(world/2 × 2) mesh: a 1 × 2 or a 2 × 2 world, the word table, the
full_deprel weights (but under halo) and the MLP and classifier kernels
sharded over the ``model`` axis (``parallel.mesh.param_shardings``).
Each rank saves what it got to ``OUT_DIR/rank{R}.pt``:

    GCN_TPU_COORDINATOR=localhost:PORT GCN_TPU_NUM_PROCS=4 \\
    GCN_TPU_PROC_ID=R python tests/tp_worker.py OUT_DIR INPUTS

* ``mode_<m>`` for ``MODES``: the ``INPUTS`` file's configuration in
  ``graph_partition`` m, its weights and batches (halo plans attached
  here): the placement and the rank's part shapes, the forward's logits
  and the whole gradients of Σ logits² on the first batch, then 3
  ``DistributedTrainer`` steps and an evaluation;
* ``traj_<name>`` for ``SCENARIOS``: 3 steps and an evaluation, to hold
  against ``Trainer`` (a bound clip, ``topn`` inside rank 1's shard, the
  row-sparse update, a vocabulary the axis does not divide, ...);
* ``CKPT`` (a world of 4): 3 steps, then a checkpoint in
  ``OUT_DIR/ckpt``.

With ``--load CKPT_DIR`` the ranks instead load that checkpoint into the
``CKPT`` scenario's trainer and save the whole state they hold (the
parameters and optimizer state gathered) and a checkpoint of it in
``OUT_DIR/resaved``, then take one step on ``load_batch()`` and save the
loss and the parameters.
"""

from __future__ import annotations

import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from gcn_tpu_torch.config import Config  # noqa: E402
from tests.dp_worker import (  # noqa: E402
    NO_DROPOUT,
    Batches,
    run,
    synthetic_batch,
    tiny_cfg,
)

MODES = ("none", "edges", "halo")
AXIS = {"mesh.graph_axis": 2}
DROPOUT = {"model.emb_dropout": 0.2, "model.edge_keep_prob": 0.9,
           "model.deprel_keep_prop": 0.9, "model.rnn_layers": 2}
ADAGRAD = {"train.optim": "adagrad"}
# name → (graph_partition, overrides of ``tiny_cfg``)
SCENARIOS = {
    "dropout": ("none", DROPOUT),
    "clip": ("none", {**ADAGRAD, "train.max_grad_norm": 0.05}),
    "topn": ("edges", {"model.topn": 100}),
    "sparse": ("none", {**ADAGRAD, "train.sparse_emb_grad": "true",
                        "model.emb_dropout": 0.2, "model.topn": 100}),
    "sparse_dense": ("none", {**ADAGRAD, "train.sparse_emb_grad": "false",
                              "model.emb_dropout": 0.2,
                              "model.topn": 100}),
    "vocab_129": ("none", {"model.vocab_size": 129}),
    "conv_l2": ("edges", {"train.conv_l2": 0.01}),
    "einsum": ("none", {"model.deprel_factored": False}),
    "einsum_edges": ("edges", {"model.deprel_factored": False}),
    "shared_w": ("none", {"model.deprel_shared_w": True,
                          "model.rnn_hidden": 8}),
    "adam": ("halo", {"train.optim": "adam"}),
}
CKPT = "ckpt"


def mode_cfg(mode: str):
    """The configuration the ``MODES`` hold against gcn_tpu: no dropout,
    no BiLSTM, adagrad."""
    return tiny_cfg(**NO_DROPOUT, **AXIS, **ADAGRAD,
                    **{"model.rnn": False,
                       "model.graph_partition": mode})


def scenario(name: str):
    """(config, train batches, evaluation batches) of a scenario."""
    if name == CKPT:
        mode, over = "none", ADAGRAD
    else:
        mode, over = SCENARIOS[name]
    cfg = tiny_cfg(**AXIS, **{"model.graph_partition": mode}, **over)
    batches = [synthetic_batch(cfg, 110 + i, padded=i) for i in range(3)]
    evals = [synthetic_batch(cfg, 120), synthetic_batch(cfg, 121, padded=3)]
    return cfg, Batches(batches), Batches(evals)


def load_batch():
    return synthetic_batch(scenario(CKPT)[0], 130)


def planned(batches: list, mode: str, k: int) -> list:
    from gcn_tpu_torch.parallel.halo import attach_halo_plans

    if mode != "halo":
        return batches
    return [attach_halo_plans(b, b["words"].shape[1], k) for b in batches]


def layout(tr) -> dict:
    """The placement and this rank's part shapes."""
    return {"placement": dict(tr.placement),
            "slot_placement": {n: dict(st)
                               for n, st in tr.slot_placement.items()},
            "shapes": {n: tuple(p.shape) for n, p in tr.params.items()},
            "slot_shapes": {n: {s: tuple(t.shape) for s, t in st.items()}
                            for n, st in tr.opt.state.items()}}


def forward_grads(tr, batch: dict) -> dict:
    """The sharded forward's logits (every data index's rows) and the
    whole gradients of Σ logits² (each part gathered over the model
    group, summed over the data group)."""
    from gcn_tpu_torch.data.sharding import ShardedBatcher
    from gcn_tpu_torch.parallel.mesh import unshard
    from gcn_tpu_torch.parallel.train_step import all_reduce_flat, gather_rows
    from gcn_tpu_torch.train.evaluator import batch_to_device

    d, size = tr.groups.data_index, tr.mesh.data
    mine = batch_to_device(ShardedBatcher(Batches([batch]), d, size).slice(
        batch), tr.device)
    with tr.partition():
        logits, _ = tr.model(mine)
    params = tr.params
    grads = torch.autograd.grad(logits.square().sum(), list(params.values()),
                                allow_unused=True)
    grads = [unshard(torch.zeros_like(p) if g is None else g,
                     tr.placement[n], tr.groups.model, tr.mesh.model)
             for (n, p), g in zip(params.items(), grads)]
    summed = all_reduce_flat(grads, group=tr.groups.data)
    return {"logits": gather_rows(logits.detach(), d, size, tr.groups.data),
            "grads": dict(zip(params, summed))}


def main(out_dir: str, inputs_file: str) -> None:
    from gcn_tpu_torch.data.sharding import ShardedBatcher
    from gcn_tpu_torch.parallel import distributed
    from gcn_tpu_torch.train.distributed_trainer import DistributedTrainer

    torch.set_num_threads(1)
    distributed.initialize(backend="gloo")
    rank, world = distributed.rank(), distributed.world_size()
    if inputs_file == "--load":
        return load_main(out_dir, sys.argv[3])
    inputs = torch.load(inputs_file, weights_only=False)
    res: dict = {"world": world}

    def steps(tr, batches, evals):
        d, size = tr.groups.data_index, tr.mesh.data
        return run(tr, ShardedBatcher(batches, d, size),
                   ShardedBatcher(evals, d, size))

    for mode in MODES:
        cfg = Config.from_dict(inputs["cfgs"][mode])
        tr = DistributedTrainer(cfg, inputs["state"], rng_seed=0,
                                device="cpu")
        assert tr.mesh.model == 2 and not tr._graphs_on()
        batches = planned(inputs["batches"], mode, 2)
        evals = planned(inputs["evals"], mode, 2)
        res[f"mode_{mode}"] = {
            **layout(tr), **forward_grads(tr, batches[0]),
            **steps(tr, Batches(batches), Batches(evals))}
    for name in SCENARIOS:
        cfg, batches, evals = scenario(name)
        tr = DistributedTrainer(cfg, rng_seed=0, device="cpu")
        k = tr.mesh.model
        res[f"traj_{name}"] = {
            **layout(tr),
            **steps(tr, Batches(planned(batches.batches,
                                        cfg.model.graph_partition, k)),
                    Batches(planned(evals.batches,
                                    cfg.model.graph_partition, k)))}
    if world == 4:
        cfg, batches, evals = scenario(CKPT)
        tr = DistributedTrainer(cfg, rng_seed=0, device="cpu")
        steps(tr, batches, evals)
        tr.save(os.path.join(out_dir, "ckpt"), epoch=1)
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    distributed.shutdown()


def load_main(out_dir: str, ckpt_dir: str) -> None:
    from gcn_tpu_torch.data.sharding import ShardedBatcher
    from gcn_tpu_torch.parallel import distributed
    from gcn_tpu_torch.train.distributed_trainer import DistributedTrainer

    rank = distributed.rank()
    cfg, _, _ = scenario(CKPT)
    tr = DistributedTrainer(cfg, rng_seed=7, device="cpu")
    meta = tr.load(ckpt_dir)
    res = {"meta": meta, "global_step": tr.global_step, **layout(tr),
           "params": {k: v.clone() for k, v in tr.full_state_dict().items()},
           "opt_state": {n: {s: t.clone() for s, t in st.items()}
                         for n, st in tr.full_opt_state().items()}}
    tr.save(os.path.join(out_dir, "resaved"), epoch=meta.get("epoch"))
    d, size = tr.groups.data_index, tr.mesh.data
    batch = ShardedBatcher(Batches([load_batch()]), d, size).slice(
        load_batch())
    res["loss"] = float(tr.update(batch))
    res["stepped"] = {k: v.clone() for k, v in tr.full_state_dict().items()}
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    distributed.shutdown()


if __name__ == "__main__":
    main(*sys.argv[1:3])
