"""Halo-partition scenarios for the port, and a rank that runs them (no
JAX).

A world of 2, 3 or 4 ranks of this module over gloo lays itself out as a
1 × 2, 1 × 3 or 2 × 2 mesh, the nodes cut into slabs over the ``model``
axis (``graph_partition="halo"``).  Each rank runs its world's scenarios
and saves what it got to ``OUT_DIR/rank{R}.pt``:

    GCN_TPU_COORDINATOR=localhost:PORT GCN_TPU_NUM_PROCS=4 \\
    GCN_TPU_PROC_ID=R python tests/halo_worker.py OUT_DIR INPUTS

* ``agg`` (worlds of 2 and 3): ``halo_aggregate``, ``halo_aggregate_pair``
  and ``halo_attention_pair`` on ``agg_inputs``, whole outputs and input
  gradients, the exchanges each made, the same through the ``edges``
  operators, and whether the debug checksum passes a clean exchange and
  raises on a corrupted one;
* ``fwd_<name>``: a model's halo forward on its data rows and the
  gradients of Σ logits² (summed over the ``data`` group), for the
  ``INPUTS`` file's ``variants`` (configuration, weights and batch made by
  gcn_tpu; worlds of 2 and 4) and for ``FORWARD_SCENARIOS`` (every
  world), with the shapes the GCN stack's aggregates and its exit saw;
* ``traj_<name>`` (worlds of 2 and 4): 3 ``DistributedTrainer`` steps and
  an evaluation on the ``INPUTS`` file's ``trajectories`` and on
  ``TRAIN_SCENARIOS`` (``dropout`` under halo and under edges).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from gcn_tpu_torch.config import Config  # noqa: E402
from gcn_tpu_torch.data.sharding import ShardedBatcher  # noqa: E402
from gcn_tpu_torch.models.gcn import (  # noqa: E402
    GCNClassifier,
    init_params,
)
from gcn_tpu_torch.parallel.halo import attach_halo_plans  # noqa: E402
from tests.dp_worker import (  # noqa: E402
    B,
    N,
    NO_DROPOUT,
    Batches,
    run,
    synthetic_batch,
    tiny_cfg,
)
from tests.partition_worker import DROPOUT  # noqa: E402

HALO = {"model.graph_partition": "halo", "mesh.graph_axis": 2}
TRAIN_SCENARIOS = ("dropout", "dropout_edges", "dropout_no_edge",
                   "attention_dropout")
FORWARD_SCENARIOS = ("nodes_15", "out_of_range_regular",
                     "out_of_range_attention")
AGG_B, AGG_N, AGG_E, AGG_H, AGG_DK = 3, 13, 17, 5, 4


def model_axis(world: int) -> int:
    return 3 if world == 3 else 2


def with_plans(batch: dict, k: int) -> dict:
    """``batch`` with its halo plans for ``k`` slabs."""
    return attach_halo_plans(batch, batch["words"].shape[1], k)


def train_scenario(name: str, k: int = 2):
    """(config, train batches, evaluation batches), the batches with
    plans for ``k`` slabs: ``dropout`` (every dropout, edge dropout
    included) under halo and ``dropout_edges`` the same under edges, whose
    [B, E] edge masks only a partitioned world reproduces;
    ``dropout_no_edge`` and ``attention_dropout``, whose masks are the
    dense path's, so ``Trainer`` reproduces them."""
    over = {"dropout": DROPOUT,
            "dropout_edges": {**DROPOUT, "model.graph_partition": "edges"},
            "dropout_no_edge": {**DROPOUT, "model.edge_keep_prob": 1.0},
            "attention_dropout": {"model.adj_type": "attention",
                                  "model.emb_dropout": 0.2}}[name]
    cfg = tiny_cfg(**{**HALO, "mesh.graph_axis": k, **over})
    batches = [with_plans(synthetic_batch(cfg, 30 + i, padded=i), k)
               for i in range(3)]
    evals = [with_plans(synthetic_batch(cfg, 40), k),
             with_plans(synthetic_batch(cfg, 41, padded=3), k)]
    return cfg, Batches(batches), Batches(evals)


def forward_scenario(name: str):
    """(config, weights, batch without plans): ``nodes_15``, a
    full_deprel batch of 15 nodes (slabs padded on a model axis of 2);
    the ``out_of_range_*`` ones, an edge whose child lies past N and one
    whose parent lies below 0, both unmasked."""
    adj = {"out_of_range_attention": "attention",
           "out_of_range_regular": "regular"}.get(name, "full_deprel")
    cfg = tiny_cfg(**HALO, **NO_DROPOUT, **{"model.adj_type": adj})
    model = GCNClassifier(cfg.model)
    init_params(model, torch.Generator().manual_seed(5))
    batch = synthetic_batch(cfg, 50)
    if name == "nodes_15":
        n = N - 1
        for k in ("words", "pos", "ner", "deprel", "subj_mask", "obj_mask",
                  "pad_mask"):
            batch[k] = batch[k][:, :n]
        batch["lengths"] = np.minimum(batch["lengths"], n)
        inside = (batch["edge_parent"] < n) & (batch["edge_child"] < n)
        batch["edge_mask"] &= inside
        for i in range(B):  # entities inside the cut sentence
            for k in ("subj_mask", "obj_mask"):
                if not batch[k][i].any() and batch["lengths"][i]:
                    batch[k][i, 0] = True
    else:
        batch["edge_parent"][0, N - 1] = 2
        batch["edge_child"][0, N - 1] = N + 3
        batch["edge_parent"][3, N - 1] = -1
        batch["edge_child"][3, N - 1] = 1
        batch["edge_mask"][[0, 3], N - 1] = True
    return cfg, model.state_dict(), batch


def agg_inputs(k: int) -> dict:
    """A random multigraph batch (``AGG_B`` rows of ``AGG_N`` nodes, every
    edge inside), its plans for ``k`` slabs, and seeded features: the
    bands' x_f, x_r [B, N, H], attention's q [B, N, Dk], k [B, N, Dk] and
    messages hw [B, N, H], and a weight w [B, N, H] of the outputs'
    loss."""
    rng = np.random.RandomState(70 + k)
    shape = (AGG_B, AGG_E)
    batch = {"words": np.zeros((AGG_B, AGG_N), np.int32),
             "edge_parent": rng.randint(0, AGG_N, shape).astype(np.int32),
             "edge_child": rng.randint(0, AGG_N, shape).astype(np.int32),
             "edge_mask": rng.rand(*shape) < 0.8}
    batch = with_plans(batch, k)
    feats = {"x_f": AGG_H, "x_r": AGG_H, "q": AGG_DK, "k": AGG_DK,
             "hw": AGG_H, "w": AGG_H}
    for name, width in feats.items():
        batch[name] = rng.randn(AGG_B, AGG_N, width).astype(np.float32)
    return batch


def _tensors(batch: dict) -> dict:
    from gcn_tpu_torch.train.evaluator import batch_to_device

    return batch_to_device(batch, torch.device("cpu"))


def aggregates(mesh, groups) -> dict:
    """The ``agg`` results of this rank (see the module docstring)."""
    from gcn_tpu_torch.parallel import halo
    from gcn_tpu_torch.parallel.edge_partition import (
        local_edges,
        partitioned_aggregate,
        partitioned_aggregate_pair,
        partitioned_attention_layer,
    )
    from gcn_tpu_torch.utils.shard_ctx import Partition

    t = _tensors(agg_inputs(mesh.model))
    part = Partition("halo", mesh, groups)
    lay = halo.layout_of(part, AGG_N)
    arrs_f = halo.plans_from_batch(t, "f")
    arrs_r = halo.plans_from_batch(t, "r")
    edges = (t["edge_parent"], t["edge_child"], t["edge_mask"])
    local = tuple(local_edges(part, e) for e in edges)
    out = {}

    def measured(name, inputs, fn):
        xs = {k: t[k].clone().requires_grad_(True) for k in inputs}
        halo.EXCHANGES.reset()
        y = fn(xs)
        calls = halo.EXCHANGES.calls
        grads = torch.autograd.grad((y * t["w"]).sum(), list(xs.values()))
        out[name] = {"out": y.detach(), "grads": dict(zip(inputs, grads)),
                     "exchanges_forward": calls,
                     "exchanges": halo.EXCHANGES.calls,
                     "bytes": halo.EXCHANGES.bytes}

    def slabs(xs, *names):
        return [halo.scatter_to_slab(xs[n], lay) for n in names]

    measured("single", ("x_f",), lambda xs: halo.gather_from_slabs(
        halo.halo_aggregate(lay, *slabs(xs, "x_f"), arrs_f), lay))
    measured("pair", ("x_f", "x_r"), lambda xs: halo.gather_from_slabs(
        halo.halo_aggregate_pair(lay, *slabs(xs, "x_f", "x_r"), arrs_f,
                                 arrs_r), lay))
    measured("attention", ("q", "k", "hw"), lambda xs: halo.gather_from_slabs(
        halo.halo_attention_pair(
            lay, *slabs(xs, "q"),
            halo.scatter_to_slab(torch.cat([xs["k"], xs["hw"]], -1), lay),
            AGG_DK, arrs_f, arrs_r), lay))
    epart = Partition("edges", mesh, groups)
    measured("edges_single", ("x_f",), lambda xs: partitioned_aggregate(
        epart, xs["x_f"], *local))
    measured("edges_pair", ("x_f", "x_r"),
             lambda xs: partitioned_aggregate_pair(
                 epart, xs["x_f"], xs["x_r"], *local, local[2]))
    measured("edges_attention", ("q", "k", "hw"),
             lambda xs: partitioned_attention_layer(
                 epart, xs["q"], xs["k"], xs["hw"], *local))

    x_f, x_r = (lay.cut(t[n]).contiguous() for n in ("x_f", "x_r"))
    halo.halo_aggregate_pair(lay, x_f, x_r, arrs_f, arrs_r,
                             debug_checksum=True)
    out["checksum_clean"] = True
    clean = halo._all_to_all

    def corrupted(sends, group):
        return clean(sends, group) + 1.0

    halo._all_to_all = corrupted
    try:
        halo.halo_aggregate_pair(lay, x_f, x_r, arrs_f, arrs_r,
                                 debug_checksum=True)
        out["checksum_raised"] = False
    except FloatingPointError as e:
        out["checksum_raised"] = "checksum mismatch" in str(e)
    finally:
        halo._all_to_all = clean
    return out


def forward_grads(cfg, state, batch, mesh, groups) -> dict:
    """The halo forward's logits (every data index's rows), the gradients
    of Σ logits² summed over the ``data`` group, and the shapes the GCN
    stack's aggregates took in and its exit gave out."""
    from gcn_tpu_torch.models import gcn as gcn_mod
    from gcn_tpu_torch.parallel.train_step import all_reduce_flat, gather_rows
    from gcn_tpu_torch.utils.shard_ctx import graph_partition

    model = GCNClassifier(cfg.model)
    model.load_state_dict(state)
    params = dict(model.named_parameters())
    global_batch = with_plans(batch, mesh.model)
    mine = _tensors(ShardedBatcher(Batches([], B), groups.data_index,
                                   mesh.data).slice(global_batch))
    shapes = {"aggregate_in": set(), "gather_in": set()}
    saved = {n: getattr(gcn_mod, n) for n in (
        "halo_aggregate", "halo_aggregate_pair", "halo_attention_pair",
        "gather_from_slabs")}

    def on_aggregate(fn):
        def wrapper(lay, x, *args, **kw):
            shapes["aggregate_in"].add(tuple(x.shape))
            return fn(lay, x, *args, **kw)
        return wrapper

    def on_exit(fn):
        def wrapper(x, lay):
            shapes["gather_in"].add(tuple(x.shape))
            return fn(x, lay)
        return wrapper

    for name, fn in saved.items():
        setattr(gcn_mod, name, on_exit(fn) if name == "gather_from_slabs"
                else on_aggregate(fn))
    try:
        with graph_partition(cfg.model.graph_partition, mesh, groups):
            logits, _ = model(mine)
    finally:
        for name, fn in saved.items():
            setattr(gcn_mod, name, fn)
    grads = torch.autograd.grad(logits.square().sum(), list(params.values()),
                                allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params.values(), grads)]
    summed = all_reduce_flat(grads, group=groups.data)
    return {"logits": gather_rows(logits.detach(), groups.data_index,
                                  mesh.data, groups.data),
            "grads": dict(zip(params, summed)),
            "shapes": {k: sorted(v) for k, v in shapes.items()}}


def main(out_dir: str, inputs_file: str) -> None:
    import torch.distributed as dist

    from gcn_tpu_torch.parallel import distributed
    from gcn_tpu_torch.parallel.mesh import make_groups, make_mesh
    from gcn_tpu_torch.train.distributed_trainer import DistributedTrainer

    torch.set_num_threads(1)
    distributed.initialize(backend="gloo")
    rank, world = distributed.rank(), distributed.world_size()
    k = model_axis(world)
    mesh = make_mesh(world, model=k)
    groups = make_groups(mesh, rank)
    inputs = torch.load(inputs_file, weights_only=False)
    res = {"world": world, "mesh": mesh.shape,
           "coords": (groups.data_index, groups.model_index),
           "model_group": dist.get_process_group_ranks(groups.model)}

    def steps(cfg, state, batches, evals):
        tr = DistributedTrainer(cfg, state, rng_seed=0, device="cpu")
        assert tr.mesh == mesh and not tr._graphs_on()
        d, size = tr.groups.data_index, tr.mesh.data
        return run(tr, ShardedBatcher(batches, d, size),
                   ShardedBatcher(evals, d, size))

    for name in FORWARD_SCENARIOS:
        cfg, state, batch = forward_scenario(name)
        cfg.mesh.graph_axis = k
        res[f"fwd_{name}"] = forward_grads(cfg, state, batch, mesh, groups)
    if mesh.data == 1:
        res["agg"] = aggregates(mesh, groups)
    if k == 2:
        for name, (cfg, state, batch) in inputs["variants"].items():
            res[f"fwd_{name}"] = forward_grads(Config.from_dict(cfg), state,
                                               batch, mesh, groups)
        for name, (cfg, state, batches, evals) in \
                inputs["trajectories"].items():
            res[f"traj_{name}"] = steps(
                Config.from_dict(cfg), state,
                Batches([with_plans(b, k) for b in batches]),
                Batches([with_plans(b, k) for b in evals]))
        for name in TRAIN_SCENARIOS:
            cfg, batches, evals = train_scenario(name)
            res[f"traj_{name}"] = steps(cfg, None, batches, evals)
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    distributed.shutdown()


if __name__ == "__main__":
    main(*sys.argv[1:])
