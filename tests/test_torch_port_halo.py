"""The port's halo graph partition (``graph_partition="halo"``) on the CPU:
gloo worlds of ``tests/halo_worker.py`` laid out as 1 × 2, 1 × 3 and
2 × 2 meshes, each spawned once (all three at the same time), every
subprocess with a time limit of its own.

* The plan: ``build_halo_plan`` equals gcn_tpu's ``build_halo_plan`` and
  ``build_halo_plan_loop`` in bits, in every field, at K = 1-4, both
  bands, with and without static budgets, on random forests (N not always
  a multiple of K); ``attach_halo_plans`` gives gcn_tpu's keys and arrays;
  an edge with an end outside [0, N) is left out of the plan.
* The aggregates: on the 1 × 2 and 1 × 3 worlds ``halo_aggregate``,
  ``halo_aggregate_pair`` and ``halo_attention_pair`` within 1e-5 of
  ``ops.spmm``'s unpartitioned aggregates and of the port's ``edges``
  operators, with their gradients; one exchange a call forward (the pair
  included), one backward; the debug checksum raises on a corrupted
  exchange.
* Against gcn_tpu on ``make_mesh(data=2, model=2)`` under its
  ``graph_partition("halo", mesh)``, with plans from its
  ``attach_halo_plans``, dropout off and from its weights: the logits
  within 1e-4 and every gradient of Σ logits² within 1e-4 of its largest
  |grad|, in six variants, on the 1 × 2 and the 2 × 2 world; 3
  ``DistributedTrainer`` steps in ``full_deprel`` and ``attention`` within
  1e-4 of gcn_tpu's ``DistributedTrainer`` under halo.
* With every dropout on, edge dropout included, the halo world follows the
  edges world within 1e-4 and every rank holds the same parameters in
  bits; without edge dropout and in attention both follow ``Trainer``.
* The layout: the GCN stack's aggregates and exit see [B, S, ·] slabs;
  15 nodes over 2 and 16 over 3 slabs (padding) and edges outside [0, N)
  give the port's unpartitioned result.
* ``ShardedBatcher`` cuts the plans on their batch axis (also where K
  equals the local rows); a batch with plans does not pack; the batchers
  attach and cache plans; the train CLI as two processes with
  ``--graph_partition halo --graph_axis 2`` against one process
  unpartitioned.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_tpu.config import Config as JaxConfig
from gcn_tpu.models.gcn import GCNClassifier as JaxGCN
from gcn_tpu.parallel import halo as jax_halo
from gcn_tpu.parallel.mesh import make_mesh as jax_make_mesh
from gcn_tpu.train.distributed_trainer import (
    DistributedTrainer as JaxDistributedTrainer,
)
from gcn_tpu.utils.shard_ctx import graph_partition as jax_graph_partition
from gcn_tpu_torch.config import cgcn_preset
from gcn_tpu_torch.convert import params_from_jax
from gcn_tpu_torch.data.dataset import Batcher, RelationDataset
from gcn_tpu_torch.data.packing import packable, sentence_packable
from gcn_tpu_torch.data.sharding import ShardedBatcher
from gcn_tpu_torch.data.vocab import Vocab
from gcn_tpu_torch.models.gcn import GCNClassifier
from gcn_tpu_torch.ops.sddmm import edge_softmax, sddmm
from gcn_tpu_torch.ops.spmm import spmm_forward, spmm_reverse, valid_edges
from gcn_tpu_torch.parallel import halo
from gcn_tpu_torch.parallel.distributed import free_port
from gcn_tpu_torch.train.evaluator import batch_to_device
from gcn_tpu_torch.train.trainer import Trainer
from gcn_tpu_torch.train.transfer import Staging
from tests import dp_worker
from tests import halo_worker as hw
from tests.test_torch_port_cuda import one_torch_thread  # noqa: F401
from tests.test_torch_port_model import REPO
from tests.test_torch_port_parallel import _env, _logs

TOL = 1e-4
TOL_AGG = 1e-5
CPU = torch.device("cpu")
WORLD_TIMEOUT = 420   # seconds a world's ranks may take
CLI_TIMEOUT = 300     # seconds the CLI runs may take
VARIANTS = {
    "regular": {"model.adj_type": "regular"},
    "diagonal_deprel": {"model.adj_type": "diagonal_deprel"},
    "full_deprel": {},
    "full_deprel_einsum": {"model.deprel_factored": False},
    "deprel_directed": {"model.deprel_directed": True},
    "attention": {"model.adj_type": "attention"},
}
TRAJECTORIES = ("full_deprel", "attention")
PLAN_FIELDS = ("n_devices", "slab", "halo_width", "requests",
               "request_mask", "local_dst", "local_src", "local_mask",
               "halo_dst", "halo_src", "halo_mask", "local_edge",
               "halo_edge")


def _forest(rng, b: int, n: int, e: int):
    """[B, E] edge lists of random forests over N nodes (each row a few
    trees over a random prefix, its edges in a shuffled order) and their
    mask."""
    parent = np.zeros((b, e), np.int32)
    child = np.zeros((b, e), np.int32)
    mask = np.zeros((b, e), bool)
    for i in range(b):
        length = rng.randint(1, n + 1)
        nodes = rng.permutation(length)
        edges = [(nodes[rng.randint(t)], nodes[t]) for t in range(1, length)
                 if rng.rand() < 0.85]
        edges = [edges[j] for j in rng.permutation(len(edges))][:e]
        for j, (p, c) in enumerate(edges):
            parent[i, j], child[i, j], mask[i, j] = p, c, True
    return parent, child, mask


def _plans_equal(got, want):
    for f in PLAN_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert a == b, f


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_plan_matches_gcn_tpu_in_bits(k, reverse):
    rng = np.random.RandomState(11 * k + int(reverse))
    for _ in range(5):
        b, n = rng.randint(1, 7), rng.randint(2, 26)
        e = rng.randint(n - 1, n + 4)
        parent, child, mask = _forest(rng, b, n, e)
        slab = -(-n // k)
        for pad_to in (None, (slab, e, e), (slab + 2, e + 3, e + 5)):
            got = halo.build_halo_plan(parent, child, mask, n, k,
                                       reverse=reverse, pad_to=pad_to)
            for build in (jax_halo.build_halo_plan,
                          jax_halo.build_halo_plan_loop):
                _plans_equal(got, build(parent, child, mask, n, k,
                                        reverse=reverse, pad_to=pad_to))


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_attach_halo_plans_matches_gcn_tpu(k):
    cfg = dp_worker.tiny_cfg()
    batch = dp_worker.synthetic_batch(cfg, 90 + k, padded=2)
    parent, child, mask = _forest(np.random.RandomState(k), dp_worker.B,
                                  dp_worker.N, dp_worker.N)
    for b in (batch, {**batch, "edge_parent": parent, "edge_child": child,
                      "edge_mask": mask}):
        got = halo.attach_halo_plans(b, dp_worker.N, k)
        want = jax_halo.attach_halo_plans(b, dp_worker.N, k)
        assert set(got) == set(want)
        assert sum(halo.is_plan_key(key) for key in got) == 20
        for key, v in want.items():
            assert got[key].dtype == v.dtype, key
            np.testing.assert_array_equal(got[key], v, err_msg=key)


@pytest.mark.parametrize("reverse", [False, True])
def test_plan_leaves_out_edges_outside_the_nodes(reverse):
    """The port drops an edge with an end outside [0, N) whole: its plan
    is gcn_tpu's plan of the batch with that edge masked."""
    rng = np.random.RandomState(5)
    parent, child, mask = _forest(rng, 4, 12, 14)
    parent[0, 13], child[0, 13], mask[0, 13] = 2, 15, True
    parent[2, 12], child[2, 12], mask[2, 12] = -1, 3, True
    parent[3, 13], child[3, 13], mask[3, 13] = 12, 0, True
    kept = mask.copy()
    kept[[0, 2, 3], [13, 12, 13]] = False
    for k in (2, 3):
        _plans_equal(
            halo.build_halo_plan(parent, child, mask, 12, k, reverse,
                                 pad_to=(6, 14, 14)),
            jax_halo.build_halo_plan(parent, child, kept, 12, k, reverse,
                                     pad_to=(6, 14, 14)))


# ------------------------------------------------------------- the worlds
def _cfg(name: str):
    return dp_worker.tiny_cfg(**hw.HALO, **dp_worker.NO_DROPOUT,
                              **{"model.rnn": False}, **VARIANTS[name])


def _jax_variant(name: str):
    """gcn_tpu's halo forward and gradients of Σ logits² on a 2 × 2 mesh,
    with its own plans: (config, its weights for the port, the batch
    without plans, logits, gradients)."""
    cfg = _cfg(name)
    batch = dp_worker.synthetic_batch(cfg, 60)
    planned = jax_halo.attach_halo_plans(batch, dp_worker.N, 2)
    model = JaxGCN(JaxConfig.from_dict(cfg.to_dict()).model)
    params = model.init({"params": jax.random.key(0),
                         "dropout": jax.random.key(1)}, batch, True)
    mesh = jax_make_mesh(data=2, model=2)

    def loss(p):
        with jax_graph_partition("halo", mesh):
            logits, _ = model.apply(p, planned, True)
        return jnp.sum(logits ** 2), logits

    (_, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    return (cfg, params_from_jax(jax.device_get(params)), batch,
            np.asarray(logits), params_from_jax(jax.device_get(grads)))


def _jax_trajectory(name: str):
    """gcn_tpu's DistributedTrainer under halo on a 2 × 2 mesh, 3 steps on
    batches with its plans: (config, initial weights, batches and
    evaluation batches without plans, losses, final weights)."""
    cfg = _cfg(name)
    batches = [dp_worker.synthetic_batch(cfg, 70 + i) for i in range(3)]
    evals = [dp_worker.synthetic_batch(cfg, 80)]
    planned = [jax_halo.attach_halo_plans(b, dp_worker.N, 2)
               for b in batches]
    jt = JaxDistributedTrainer(JaxConfig.from_dict(cfg.to_dict()),
                               mesh=jax_make_mesh(data=2, model=2),
                               rng_seed=0, init_batch=planned[0])
    assert jt._partition_mesh is jt.mesh
    state = params_from_jax(jax.device_get(jt.params))
    losses = [float(jt.update(b)) for b in planned]
    return (cfg, state, batches, evals, losses,
            params_from_jax(jax.device_get(jt.params)))


@pytest.fixture(scope="module")
def jax_runs():
    return ({n: _jax_variant(n) for n in VARIANTS},
            {n: _jax_trajectory(n) for n in TRAJECTORIES})


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, jax_runs):
    """{world size: every rank's results} of the 1 × 2, 1 × 3 and 2 × 2
    worlds, run at once."""
    variants, trajectories = jax_runs
    out = tmp_path_factory.mktemp("halo")
    inputs = str(out / "inputs.pt")
    torch.save({"variants": {n: (v[0].to_dict(), v[1], v[2])
                             for n, v in variants.items()},
                "trajectories": {n: (t[0].to_dict(), t[1], t[2], t[3])
                                 for n, t in trajectories.items()}}, inputs)
    worker = os.path.join(REPO, "tests", "halo_worker.py")
    procs = []
    for size in (2, 3, 4):
        (out / str(size)).mkdir()
        port = free_port()
        procs += [subprocess.Popen(
            [sys.executable, worker, str(out / str(size)), inputs],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_env(r, port, size)) for r in range(size)]
    try:
        for p in procs:
            o, e = p.communicate(timeout=WORLD_TIMEOUT)
            assert p.returncode == 0, (e[-3000:], o[-1000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return {size: [torch.load(out / str(size) / f"rank{r}.pt",
                              weights_only=False) for r in range(size)]
            for size in (2, 3, 4)}


def _params_err(got: dict, want: dict) -> float:
    assert set(got) == set(want)
    return max(float((got[k] - want[k]).abs().max())
               / max(1.0, float(want[k].abs().max())) for k in want)


def _grads_ok(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k, v in want.items():
        scale = max(float(v.abs().max()), 1e-30)
        assert float((got[k] - v).abs().max()) <= TOL * scale, k


def test_worlds_lay_out_the_mesh(worlds):
    for size, ranks in worlds.items():
        k = hw.model_axis(size)
        for rank, res in enumerate(ranks):
            d, m = divmod(rank, k)
            assert res["mesh"] == {"data": size // k, "model": k}
            assert res["coords"] == (d, m)
            assert res["model_group"] == [k * d + j for j in range(k)]


def _agg_reference(k: int, kind: str):
    """``ops.spmm``'s unpartitioned aggregate of ``halo_worker.
    agg_inputs`` and the gradients of Σ w·out."""
    t = batch_to_device(hw.agg_inputs(k), CPU)
    ep, ec, em = t["edge_parent"], t["edge_child"], t["edge_mask"]
    names = {"single": ("x_f",), "pair": ("x_f", "x_r"),
             "attention": ("q", "k", "hw")}[kind]
    xs = {n: t[n].clone().requires_grad_(True) for n in names}
    if kind == "single":
        y = spmm_forward(xs["x_f"], ep, ec, em)
    elif kind == "pair":
        y = (spmm_forward(xs["x_f"], ep, ec, em)
             + spmm_reverse(xs["x_r"], ep, ec, em))
    else:
        ok = valid_edges(ep, ec, em, hw.AGG_N)
        q, kk = xs["q"], xs["k"]
        a_f = edge_softmax(ep, sddmm(ep, ec, ok, q, kk), ok, hw.AGG_N)
        a_r = edge_softmax(ec, sddmm(ec, ep, ok, q, kk), ok, hw.AGG_N)
        y = (spmm_forward(xs["hw"], ep, ec, ok, edge_weights=a_f)
             + spmm_reverse(xs["hw"], ep, ec, ok, edge_weights=a_r))
    grads = torch.autograd.grad((y * t["w"]).sum(), list(xs.values()))
    return y.detach(), dict(zip(names, grads))


@pytest.mark.parametrize("kind", ["single", "pair", "attention"])
def test_aggregates_match_unpartitioned_and_edges(kind, worlds):
    for size in (2, 3):
        want, want_grads = _agg_reference(size, kind)
        assert float(want.abs().max()) > 0.1
        for res in worlds[size]:
            for got in (res["agg"][kind], res["agg"][f"edges_{kind}"]):
                np.testing.assert_allclose(got["out"].numpy(), want.numpy(),
                                           atol=TOL_AGG, rtol=0)
                for name, g in want_grads.items():
                    np.testing.assert_allclose(got["grads"][name].numpy(),
                                               g.numpy(), atol=TOL_AGG,
                                               rtol=0, err_msg=name)


def test_each_call_makes_one_exchange(worlds):
    """The pair and attention exchange both bands in one buffer: one
    exchange forward and one backward a call, of [K, B, Hp_f + Hp_r, ·]
    (Hp = S), (K-1)/K of it crossing."""
    for size in (2, 3):
        s = -(-hw.AGG_N // size)
        for res in worlds[size]:
            for kind, (bands, width) in {
                    "single": (1, hw.AGG_H), "pair": (2, hw.AGG_H),
                    "attention": (2, hw.AGG_DK + hw.AGG_H)}.items():
                got = res["agg"][kind]
                assert got["exchanges_forward"] == 1, kind
                assert got["exchanges"] == 2, kind
                buffer = size * hw.AGG_B * bands * s * width * 4
                assert got["bytes"] == 2 * buffer * (size - 1) // size, kind


def test_checksum_raises_on_a_corrupted_exchange(worlds):
    for size in (2, 3):
        for res in worlds[size]:
            assert res["agg"]["checksum_clean"]
            assert res["agg"]["checksum_raised"]


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_halo_forward_matches_gcn_tpu(name, jax_runs, worlds):
    want = jax_runs[0][name][3]
    for size in (2, 4):
        for res in worlds[size]:
            np.testing.assert_allclose(res[f"fwd_{name}"]["logits"].numpy(),
                                       want, atol=TOL, rtol=0)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_halo_gradients_match_gcn_tpu(name, jax_runs, worlds):
    """Every rank ends the backward with the whole gradients: the slabs'
    shares are neither missing nor counted twice."""
    want = jax_runs[0][name][4]
    for size in (2, 4):
        for res in worlds[size]:
            _grads_ok(res[f"fwd_{name}"]["grads"], want)


@pytest.mark.parametrize("name", TRAJECTORIES)
def test_trajectory_matches_gcn_tpus_distributed_trainer(name, jax_runs,
                                                         worlds):
    cfg, state, batches, evals, losses, params = jax_runs[1][name]
    one = dp_worker.run(Trainer(cfg, state, rng_seed=0, device="cpu"),
                        dp_worker.Batches(batches), dp_worker.Batches(evals))
    for size in (2, 4):
        for res in worlds[size]:
            got = res[f"traj_{name}"]
            np.testing.assert_allclose(got["losses"], losses, rtol=TOL)
            assert _params_err(got["params"], params) <= TOL
            assert got["preds"] == one["preds"]
            np.testing.assert_allclose(got["probs"], one["probs"], atol=1e-5)


def test_halo_follows_edges_with_every_dropout(worlds):
    """Edge dropout's [B, E] masks are drawn on the whole edge list under
    both partitions, and halo folds them into its plan's slots; every
    other mask is drawn whole and cut to the slab."""
    for size in (2, 4):
        ranks = worlds[size]
        a, b = ranks[0]["traj_dropout"], ranks[0]["traj_dropout_edges"]
        np.testing.assert_allclose(a["losses"], b["losses"], rtol=TOL)
        assert _params_err(a["params"], b["params"]) <= TOL
        assert a["preds"] == b["preds"]
        for name in hw.TRAIN_SCENARIOS:
            first = ranks[0][f"traj_{name}"]["params"]
            for res in ranks[1:]:
                for k, v in res[f"traj_{name}"]["params"].items():
                    assert torch.equal(v, first[k]), (size, name, k)
    a, b = (worlds[s][0]["traj_dropout"] for s in (2, 4))
    np.testing.assert_allclose(a["losses"], b["losses"], rtol=TOL)
    assert _params_err(a["params"], b["params"]) <= TOL


@pytest.mark.parametrize("name", ["dropout_no_edge", "attention_dropout"])
def test_halo_steps_follow_trainer(name, worlds):
    cfg, batches, evals = hw.train_scenario(name)
    want = dp_worker.run(Trainer(cfg, rng_seed=0, device="cpu"), batches,
                         evals)
    for size in (2, 4):
        for res in worlds[size]:
            got = res[f"traj_{name}"]
            np.testing.assert_allclose(got["losses"], want["losses"],
                                       rtol=TOL)
            assert _params_err(got["params"], want["params"]) <= TOL
            assert got["preds"] == want["preds"]
            np.testing.assert_allclose(got["probs"], want["probs"],
                                       atol=1e-5)
            assert got["eval_loss"] == pytest.approx(want["eval_loss"],
                                                     rel=TOL)


def test_gcn_activations_are_node_slabs(worlds):
    """A rank's GCN layers see [B, S, ·] slabs, never [B, N, ·]: the
    aggregates' inputs and the stack's exit."""
    for size, ranks in worlds.items():
        k = hw.model_axis(size)
        rows = dp_worker.B // (size // k)
        for res in ranks:
            for name in ("nodes_15", "out_of_range_regular",
                         "out_of_range_attention"):
                n = dp_worker.N - (name == "nodes_15")
                s = -(-n // k)
                shapes = res[f"fwd_{name}"]["shapes"]
                assert shapes["gather_in"] == [(rows, s, 16)], name
                assert {sh[:2] for sh in shapes["aggregate_in"]} == {
                    (rows, s)}, name
                assert s < n


def _unpartitioned(name: str, attention_impl=None):
    cfg, state, batch = hw.forward_scenario(name)
    if attention_impl:
        cfg.model.attention_impl = attention_impl
    model = GCNClassifier(cfg.model)
    model.load_state_dict(state)
    logits, _ = model(batch_to_device(batch, CPU))
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(logits.square().sum(), list(params.values()),
                                allow_unused=True)
    return logits.detach(), {k: torch.zeros_like(params[k]) if g is None
                             else g for k, g in zip(params, grads)}


@pytest.mark.parametrize("name,impl", [
    ("nodes_15", None),
    ("out_of_range_regular", None),
    ("out_of_range_attention", "edge"),
    ("out_of_range_attention", "dense"),
])
def test_halo_holds_to_the_unpartitioned_path(name, impl, worlds):
    """Slabs padded past N (15 nodes over 2, 16 over 3); an edge with an
    end outside [0, N) dropped whole, as the port's unpartitioned paths
    drop it."""
    logits, grads = _unpartitioned(name, impl)
    assert torch.isfinite(logits).all()
    for ranks in worlds.values():
        for res in ranks:
            got = res[f"fwd_{name}"]
            np.testing.assert_allclose(got["logits"].numpy(), logits.numpy(),
                                       atol=TOL, rtol=0)
            _grads_ok(got["grads"], grads)


# ------------------------------------------------------------- the batches
@pytest.mark.parametrize("data_size", [2, 4])
def test_sharded_batcher_cuts_plans_on_the_batch_axis(data_size):
    """With K = 2 slabs and 2 local rows a batch, the device axis and the
    batch axis have one length: the plans are cut on the batch axis (dim 2
    of [K, K, B, Hp], dim 1 of [K, B, E]) all the same, like gcn_tpu's
    ``ShardedBatcher``."""
    from gcn_tpu.data.sharding import ShardedBatcher as JaxShardedBatcher

    cfg = dp_worker.tiny_cfg()
    batch = halo.attach_halo_plans(dp_worker.synthetic_batch(cfg, 3),
                                   dp_worker.N, 2)
    rows = dp_worker.B // data_size
    for d in range(data_size):
        got = ShardedBatcher(dp_worker.Batches([batch]), d,
                             data_size).slice(batch)
        want = JaxShardedBatcher(dp_worker.Batches([batch]), d,
                                 data_size)._slice(batch)
        assert set(got) == set(want)
        for key, v in want.items():
            np.testing.assert_array_equal(got[key], v, err_msg=key)
        assert got["hplan_f_req"].shape == (2, 2, rows, 8)
        assert got["hplan_r_ldst"].shape == (2, rows, dp_worker.N)
        np.testing.assert_array_equal(
            got["hplan_f_hsrc"], batch["hplan_f_hsrc"][:, d * rows:
                                                       (d + 1) * rows])
    inner = dp_worker.Batches([batch])
    inner.halo_devices = 0
    wrapped = ShardedBatcher(inner, 0, 2)
    wrapped.halo_devices = 3
    assert wrapped.halo_devices == 3 == inner.halo_devices


def test_a_batch_with_plans_does_not_pack():
    """gcn_tpu's exact-key rule: the packers would drop the plans, so a
    batch that carries them crosses field by field."""
    cfg = dp_worker.tiny_cfg()
    batch = dp_worker.synthetic_batch(cfg, 4)
    assert packable(batch)
    planned = halo.attach_halo_plans(batch, dp_worker.N, 2)
    assert not packable(planned) and not sentence_packable(planned)
    staging = Staging(CPU, True, "compact", 2)
    sig = staging.signature([planned])
    assert sig[0] == "fields"
    assert {k for k, *_ in sig[1:]} == set(planned)


def test_batchers_attach_and_cache_plans(capsys):
    vocab = Vocab.load(os.path.join(REPO, "dataset", "vocab", "vocab.pkl"))
    cfg = cgcn_preset(**{"model.vocab_size": vocab.size})
    ds = RelationDataset(os.path.join(REPO, "dataset", "tacred", "dev.json"),
                         cfg, vocab, evaluation=True)
    plain = Batcher(ds, 8, evaluation=True)
    assert plain.halo_devices == 0
    planned = Batcher(ds, 8, evaluation=True)
    planned.halo_devices = 2
    first = [planned.materialize(c) for c in planned.chunks[:3]]
    for got, want in zip(first, (plain.materialize(c)
                                 for c in plain.chunks[:3])):
        full = halo.attach_halo_plans(want, want["words"].shape[1], 2)
        assert set(got) == set(full)
        for key, v in full.items():
            np.testing.assert_array_equal(got[key], v, err_msg=key)
    again = planned.materialize(planned.chunks[0])
    assert again["hplan_f_req"] is first[0]["hplan_f_req"]  # cached
    tight = Batcher(ds, 8, evaluation=True)
    tight.halo_devices = 2
    tight._HALO_CACHE_BUDGET = 0
    for c in tight.chunks[:3]:
        tight.materialize(c)
    err = capsys.readouterr().err
    assert err.count("halo-plan cache budget (0 MB) exhausted") == 1


def test_two_process_halo_cli_matches_one_process(tmp_path):
    """``--graph_partition halo --graph_axis 2`` as a 1 × 2 world on the
    CPU against the same run unpartitioned in one process: ``logs.txt``'s
    train loss within 1e-3 relative, the same dev F1; only rank 0
    writes."""
    train = [sys.executable, "-m", "gcn_tpu_torch.scripts.train",
             "--cpu", "--no-rnn", "--hidden_dim", "16", "--emb_dim", "300",
             "--batch_size", "10", "--effective_batch_size", "10",
             "--num_epoch", "2", "--seed", "7", "--log_step", "100",
             "--adj_type", "full_deprel", "--id", "gh"]
    part = ["--graph_partition", "halo", "--graph_axis", "2"]
    port = free_port()
    procs = [subprocess.Popen(
        train + part + ["--model_save_dir", str(tmp_path / f"mp{r}")],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(r, port)) for r in range(2)]
    procs.append(subprocess.Popen(
        train + ["--model_save_dir", str(tmp_path / "sp")], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1")))
    try:
        outs = [p.communicate(timeout=CLI_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, (err[-3000:], out[-1000:])
    assert "Mesh: {'data': 1, 'model': 2}, graph_partition halo" in outs[0][0]
    sp, mp = _logs(tmp_path / "sp" / "gh"), _logs(tmp_path / "mp0" / "gh")
    assert len(sp) == len(mp) == 2
    for row_s, row_m in zip(sp, mp):
        assert row_s[0] == row_m[0]
        assert abs(float(row_s[1]) - float(row_m[1])) <= 1e-3 * max(
            1.0, abs(float(row_s[1]))), (row_s, row_m)
        assert float(row_s[3]) == float(row_m[3]), (row_s, row_m)
    assert not os.path.exists(tmp_path / "mp1")
