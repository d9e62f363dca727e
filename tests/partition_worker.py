"""Graph-partition scenarios for the port, and a rank that runs them (no
JAX).

A world of 2 or 4 ranks of this module over gloo lays itself out as a
(world/2 × 2) mesh: a 1 × 2 or a 2 × 2 world, the edge lists split over
the ``model`` axis (``graph_partition="edges"``).  Each rank runs every
scenario and saves what it got to ``OUT_DIR/rank{R}.pt``:

    GCN_TPU_COORDINATOR=localhost:PORT GCN_TPU_NUM_PROCS=4 \\
    GCN_TPU_PROC_ID=R python tests/partition_worker.py OUT_DIR INPUTS

* ``fwd_<name>``: a model's partitioned forward on its data rows and the
  gradients of Σ logits² (summed over the ``data`` group), for the
  ``INPUTS`` file's ``variants`` (configuration, weights and batch made
  by gcn_tpu) and for ``FORWARD_SCENARIOS`` (made here from seeds);
* ``traj_<name>``: 3 ``DistributedTrainer`` steps and an evaluation on
  the ``INPUTS`` file's ``trajectories``, and on ``TRAIN_SCENARIOS``;
* ``model_axis_1`` (a world of 2 only): the same ranks as a 2 × 1 mesh
  with ``graph_partition="edges"``, which runs the dense path.
"""

from __future__ import annotations

import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from gcn_tpu_torch.config import Config  # noqa: E402
from gcn_tpu_torch.models.gcn import (  # noqa: E402
    GCNClassifier,
    init_params,
)
from tests.dp_worker import (  # noqa: E402
    B,
    N,
    NO_DROPOUT,
    Batches,
    run,
    synthetic_batch,
    tiny_cfg,
)

EDGES = {"model.graph_partition": "edges", "mesh.graph_axis": 2}
# every stochastic point of a full_deprel step: the preset's dropouts,
# word type, edge and deprel dropout, the BiLSTM's inter-layer dropout
DROPOUT = {"model.emb_dropout": 0.2, "model.edge_keep_prob": 0.9,
           "model.deprel_keep_prop": 0.9, "model.rnn_layers": 2}
TRAIN_SCENARIOS = ("dropout", "dropout_no_edge", "attention_dropout")
FORWARD_SCENARIOS = ("padding", "out_of_range_regular",
                     "out_of_range_attention")


def train_scenario(name: str):
    """(config, train batches, evaluation batches): ``dropout`` with edge
    dropout, which only another partitioned world reproduces;
    ``dropout_no_edge`` and ``attention_dropout``, whose masks are the
    dense path's, so ``Trainer`` reproduces them."""
    over = {"dropout": DROPOUT,
            "dropout_no_edge": {**DROPOUT, "model.edge_keep_prob": 1.0},
            "attention_dropout": {"model.adj_type": "attention",
                                  "model.emb_dropout": 0.2}}[name]
    cfg = tiny_cfg(**EDGES, **over)
    batches = [synthetic_batch(cfg, 30 + i, padded=i) for i in range(3)]
    evals = [synthetic_batch(cfg, 40), synthetic_batch(cfg, 41, padded=3)]
    return cfg, Batches(batches), Batches(evals)


def forward_scenario(name: str):
    """(config, weights, batch) of a forward-only scenario: ``padding``,
    15 edge slots (not a multiple of the model axis); the
    ``out_of_range_*`` ones, an edge whose child lies past N and one whose
    parent lies below 0, both unmasked."""
    adj = {"out_of_range_attention": "attention"}.get(name, "regular")
    if name == "padding":
        adj = "full_deprel"
    cfg = tiny_cfg(**EDGES, **NO_DROPOUT, **{"model.adj_type": adj})
    model = GCNClassifier(cfg.model)
    init_params(model, torch.Generator().manual_seed(5))
    batch = synthetic_batch(cfg, 50)
    if name == "padding":
        # a tree over at most N tokens has at most N - 1 edges
        assert not batch["edge_mask"][:, N - 1:].any()
        for k in ("edge_parent", "edge_child", "edge_deprel", "edge_mask"):
            batch[k] = batch[k][:, :N - 1]
    else:
        batch["edge_parent"][0, N - 1] = 2
        batch["edge_child"][0, N - 1] = N + 3
        batch["edge_parent"][3, N - 1] = -1
        batch["edge_child"][3, N - 1] = 1
        batch["edge_mask"][[0, 3], N - 1] = True
    return cfg, model.state_dict(), batch


def rows_of(batch: dict, index: int, size: int) -> dict:
    lo, hi = index * B // size, (index + 1) * B // size
    return {k: v[lo:hi] for k, v in batch.items()}


def forward_grads(cfg, state, batch, mesh, groups) -> dict:
    """The partitioned forward's logits (every data index's rows) and the
    gradients of Σ logits² summed over the ``data`` group."""
    from gcn_tpu_torch.parallel.train_step import all_reduce_flat, gather_rows
    from gcn_tpu_torch.train.evaluator import batch_to_device
    from gcn_tpu_torch.utils.shard_ctx import graph_partition

    model = GCNClassifier(cfg.model)
    model.load_state_dict(state)
    params = dict(model.named_parameters())
    mine = batch_to_device(rows_of(batch, groups.data_index, mesh.data),
                           torch.device("cpu"))
    with graph_partition(cfg.model.graph_partition, mesh, groups):
        logits, _ = model(mine)
    grads = torch.autograd.grad(logits.square().sum(), list(params.values()),
                                allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params.values(), grads)]
    summed = all_reduce_flat(grads, group=groups.data)
    return {"logits": gather_rows(logits.detach(), groups.data_index,
                                  mesh.data, groups.data),
            "grads": dict(zip(params, summed))}


def main(out_dir: str, inputs_file: str) -> None:
    import torch.distributed as dist

    from gcn_tpu_torch.data.sharding import ShardedBatcher
    from gcn_tpu_torch.parallel import distributed
    from gcn_tpu_torch.parallel.mesh import make_groups, make_mesh
    from gcn_tpu_torch.train.distributed_trainer import DistributedTrainer

    torch.set_num_threads(1)
    distributed.initialize(backend="gloo")
    rank, world = distributed.rank(), distributed.world_size()
    mesh = make_mesh(world, model=2)
    groups = make_groups(mesh, rank)
    inputs = torch.load(inputs_file, weights_only=False)
    res = {"world": world, "mesh": mesh.shape,
           "coords": (groups.data_index, groups.model_index),
           "model_group": dist.get_process_group_ranks(groups.model),
           "data_group": dist.get_process_group_ranks(groups.data)}

    def steps(cfg, state, batches, evals):
        tr = DistributedTrainer(cfg, state, rng_seed=0, device="cpu")
        assert tr.mesh == mesh and not tr._graphs_on()
        d, size = tr.groups.data_index, tr.mesh.data
        return run(tr, ShardedBatcher(batches, d, size),
                   ShardedBatcher(evals, d, size))

    for name, (cfg, state, batch) in inputs["variants"].items():
        res[f"fwd_{name}"] = forward_grads(Config.from_dict(cfg), state,
                                           batch, mesh, groups)
    for name in FORWARD_SCENARIOS:
        res[f"fwd_{name}"] = forward_grads(*forward_scenario(name), mesh,
                                           groups)
    for name, (cfg, state, batches, evals) in inputs["trajectories"].items():
        res[f"traj_{name}"] = steps(Config.from_dict(cfg), state,
                                    Batches(batches), Batches(evals))
    for name in TRAIN_SCENARIOS:
        cfg, batches, evals = train_scenario(name)
        res[f"traj_{name}"] = steps(cfg, None, batches, evals)
    if world == 2:
        cfg, batches, evals = train_scenario("dropout")
        cfg.mesh.graph_axis = 1
        tr = DistributedTrainer(cfg, rng_seed=0, device="cpu")
        res["model_axis_1"] = {"mesh": tr.mesh.shape, **run(
            tr, ShardedBatcher(batches, rank, 2),
            ShardedBatcher(evals, rank, 2))}
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    distributed.shutdown()


if __name__ == "__main__":
    main(*sys.argv[1:])
