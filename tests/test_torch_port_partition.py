"""The port's graph partition (``graph_partition="edges"``) on the CPU:
gloo worlds of ``tests/partition_worker.py`` laid out as 1 × 2 and 2 × 2
meshes, each spawned once.

* Against gcn_tpu on ``make_mesh(data=2, model=2)`` under its
  ``graph_partition("edges", mesh)``, dropout off, from its weights: the
  forward's logits within 1e-4 and every gradient of Σ logits² within
  1e-4 of its max |grad|, in ``regular``, ``diagonal_deprel``,
  ``full_deprel`` factored and not, ``deprel_directed`` and ``attention``;
  3 ``DistributedTrainer`` steps in ``full_deprel`` and ``attention``
  within 1e-4 of gcn_tpu's ``DistributedTrainer`` with the partition.
* With every dropout on, edge dropout included, the 1 × 2 and 2 × 2 worlds
  follow each other within 1e-4 over 3 steps, and every rank of a world
  holds the same parameters in bits; without edge dropout (its [B, E]
  masks are not the dense bands' [B, N, N] ones) and in the attention
  mode both follow ``Trainer`` within 1e-4.
* 15 edge slots over a model axis of 2 (padding), and edges with an end
  outside [0, N): held to the port's unpartitioned paths (the port drops
  such an edge whole; gcn_tpu clamps its gather).
* A plain ``Trainer`` with ``graph_partition="edges"`` gives the dense
  path's bits, and a 2 × 1 mesh follows ``Trainer``.
* The partition context (both modes) and the edge shares; the train CLI
  as two processes with ``--graph_partition edges --graph_axis 2`` against
  one process unpartitioned.
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
from gcn_tpu.parallel.mesh import make_mesh as jax_make_mesh
from gcn_tpu.train.distributed_trainer import (
    DistributedTrainer as JaxDistributedTrainer,
)
from gcn_tpu.utils.shard_ctx import graph_partition as jax_graph_partition
from gcn_tpu_torch.convert import params_from_jax
from gcn_tpu_torch.models.gcn import GCNClassifier
from gcn_tpu_torch.parallel.distributed import free_port
from gcn_tpu_torch.parallel.edge_partition import (
    local_edges,
    pad_edges_for_axis,
)
from gcn_tpu_torch.parallel.mesh import MeshGroups, make_mesh
from gcn_tpu_torch.train.evaluator import batch_to_device
from gcn_tpu_torch.train.trainer import Trainer
from gcn_tpu_torch.utils.shard_ctx import (
    Partition,
    active_partition,
    graph_partition,
)
from tests import dp_worker
from tests import partition_worker as pw
from tests.test_torch_port_cuda import one_torch_thread  # noqa: F401
from tests.test_torch_port_model import REPO
from tests.test_torch_port_parallel import CLI, _env, _logs, _wait

TOL = 1e-4
CPU = torch.device("cpu")
VARIANTS = {
    "regular": {"model.adj_type": "regular"},
    "diagonal_deprel": {"model.adj_type": "diagonal_deprel"},
    "full_deprel": {},
    "full_deprel_einsum": {"model.deprel_factored": False},
    "deprel_directed": {"model.deprel_directed": True},
    "attention": {"model.adj_type": "attention"},
}
TRAJECTORIES = ("full_deprel", "attention")


def _cfg(name: str):
    return dp_worker.tiny_cfg(**pw.EDGES, **dp_worker.NO_DROPOUT,
                              **{"model.rnn": False}, **VARIANTS[name])


def _jax_variant(name: str):
    """gcn_tpu's partitioned forward and gradients of Σ logits² on a 2 × 2
    mesh: (config, its weights for the port, batch, logits, gradients)."""
    cfg = _cfg(name)
    batch = dp_worker.synthetic_batch(cfg, 60)
    model = JaxGCN(JaxConfig.from_dict(cfg.to_dict()).model)
    params = model.init({"params": jax.random.key(0),
                         "dropout": jax.random.key(1)}, batch, True)
    mesh = jax_make_mesh(data=2, model=2)

    def loss(p):
        with jax_graph_partition("edges", mesh):
            logits, _ = model.apply(p, batch, True)
        return jnp.sum(logits ** 2), logits

    (_, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    return (cfg, params_from_jax(jax.device_get(params)), batch,
            np.asarray(logits), params_from_jax(jax.device_get(grads)))


def _jax_trajectory(name: str):
    """gcn_tpu's DistributedTrainer with the partition on a 2 × 2 mesh, 3
    steps: (config, initial weights, batches, evaluation batches, losses,
    final weights)."""
    cfg = _cfg(name)
    batches = [dp_worker.synthetic_batch(cfg, 70 + i) for i in range(3)]
    evals = [dp_worker.synthetic_batch(cfg, 80)]
    jt = JaxDistributedTrainer(JaxConfig.from_dict(cfg.to_dict()),
                               mesh=jax_make_mesh(data=2, model=2),
                               rng_seed=0, init_batch=batches[0])
    assert jt._partition_mesh is jt.mesh
    state = params_from_jax(jax.device_get(jt.params))
    losses = [float(jt.update(b)) for b in batches]
    return (cfg, state, batches, evals, losses,
            params_from_jax(jax.device_get(jt.params)))


@pytest.fixture(scope="module")
def jax_runs():
    return ({n: _jax_variant(n) for n in VARIANTS},
            {n: _jax_trajectory(n) for n in TRAJECTORIES})


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, jax_runs):
    """{K_data: every rank's results} of the 1 × 2 and 2 × 2 worlds, run
    at once."""
    variants, trajectories = jax_runs
    out = tmp_path_factory.mktemp("partition")
    inputs = str(out / "inputs.pt")
    torch.save({"variants": {n: (v[0].to_dict(), v[1], v[2])
                             for n, v in variants.items()},
                "trajectories": {n: (t[0].to_dict(), t[1], t[2], t[3])
                                 for n, t in trajectories.items()}}, inputs)
    worker = os.path.join(REPO, "tests", "partition_worker.py")
    procs = []
    for size in (2, 4):
        (out / str(size)).mkdir()
        port = free_port()
        procs += [subprocess.Popen(
            [sys.executable, worker, str(out / str(size)), inputs],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_env(r, port, size)) for r in range(size)]
    _wait(procs)
    return {size // 2: [torch.load(out / str(size) / f"rank{r}.pt",
                                   weights_only=False) for r in range(size)]
            for size in (2, 4)}


def _params_err(got: dict, want: dict) -> float:
    assert set(got) == set(want)
    return max(float((got[k] - want[k]).abs().max())
               / max(1.0, float(want[k].abs().max())) for k in want)


def _grads_ok(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k, v in want.items():
        scale = max(float(v.abs().max()), 1e-30)
        assert float((got[k] - v).abs().max()) <= TOL * scale, k


def test_worlds_lay_out_the_mesh_and_its_groups(worlds):
    for data, ranks in worlds.items():
        for rank, res in enumerate(ranks):
            d, m = divmod(rank, 2)
            assert res["mesh"] == {"data": data, "model": 2}
            assert res["coords"] == (d, m)
            assert res["model_group"] == [2 * d, 2 * d + 1]
            assert res["data_group"] == [2 * i + m for i in range(data)]


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_partitioned_forward_matches_gcn_tpu(name, jax_runs, worlds):
    want = jax_runs[0][name][3]
    for ranks in worlds.values():
        for res in ranks:
            np.testing.assert_allclose(res[f"fwd_{name}"]["logits"].numpy(),
                                       want, atol=TOL, rtol=0)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_partitioned_gradients_match_gcn_tpu(name, jax_runs, worlds):
    """Every rank ends the backward with the whole gradients: the model
    group's sums are neither missing nor counted twice."""
    want = jax_runs[0][name][4]
    for ranks in worlds.values():
        for res in ranks:
            _grads_ok(res[f"fwd_{name}"]["grads"], want)


@pytest.mark.parametrize("name", TRAJECTORIES)
def test_trajectory_matches_gcn_tpus_distributed_trainer(name, jax_runs,
                                                         worlds):
    cfg, state, batches, evals, losses, params = jax_runs[1][name]
    one = dp_worker.run(Trainer(cfg, state, rng_seed=0, device="cpu"),
                        dp_worker.Batches(batches), dp_worker.Batches(evals))
    for ranks in worlds.values():
        for res in ranks:
            got = res[f"traj_{name}"]
            np.testing.assert_allclose(got["losses"], losses, rtol=TOL)
            assert _params_err(got["params"], params) <= TOL
            assert got["preds"] == one["preds"]
            np.testing.assert_allclose(got["probs"], one["probs"], atol=1e-5)


def test_worlds_follow_each_other_with_every_dropout(worlds):
    """Edge dropout's [B, E] masks are drawn on the whole edge list at the
    global batch's shape, so they depend on neither axis."""
    a, b = (worlds[d][0]["traj_dropout"] for d in (1, 2))
    np.testing.assert_allclose(a["losses"], b["losses"], rtol=TOL)
    assert _params_err(a["params"], b["params"]) <= TOL
    assert a["preds"] == b["preds"]
    for ranks in worlds.values():
        for name in pw.TRAIN_SCENARIOS:
            first = ranks[0][f"traj_{name}"]["params"]
            for res in ranks[1:]:
                for k, v in res[f"traj_{name}"]["params"].items():
                    assert torch.equal(v, first[k]), (name, k)


@pytest.mark.parametrize("name", ["dropout_no_edge", "attention_dropout"])
def test_partitioned_steps_follow_trainer(name, worlds):
    cfg, batches, evals = pw.train_scenario(name)
    want = dp_worker.run(Trainer(cfg, rng_seed=0, device="cpu"), batches,
                         evals)
    for ranks in worlds.values():
        for res in ranks:
            got = res[f"traj_{name}"]
            np.testing.assert_allclose(got["losses"], want["losses"],
                                       rtol=TOL)
            assert _params_err(got["params"], want["params"]) <= TOL
            assert got["preds"] == want["preds"]
            np.testing.assert_allclose(got["probs"], want["probs"],
                                       atol=1e-5)
            assert got["eval_loss"] == pytest.approx(want["eval_loss"],
                                                     rel=TOL)


def _unpartitioned(name: str, attention_impl=None):
    cfg, state, batch = pw.forward_scenario(name)
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
    ("padding", None),
    ("out_of_range_regular", None),
    ("out_of_range_attention", "edge"),
    ("out_of_range_attention", "dense"),
])
def test_partition_holds_to_the_unpartitioned_path(name, impl, worlds):
    """15 edge slots padded to 16; an edge with an end outside [0, N)
    dropped whole, as the port's unpartitioned paths drop it."""
    logits, grads = _unpartitioned(name, impl)
    assert torch.isfinite(logits).all()
    for ranks in worlds.values():
        for res in ranks:
            got = res[f"fwd_{name}"]
            np.testing.assert_allclose(got["logits"].numpy(), logits.numpy(),
                                       atol=TOL, rtol=0)
            _grads_ok(got["grads"], grads)


def test_model_axis_one_runs_the_dense_path(worlds):
    cfg, batches, evals = pw.train_scenario("dropout")
    assert cfg.model.graph_partition == "edges"
    want = dp_worker.run(Trainer(cfg, rng_seed=0, device="cpu"), batches,
                         evals)
    cfg.model.graph_partition = "none"
    dense = dp_worker.run(Trainer(cfg, rng_seed=0, device="cpu"), batches,
                          evals)
    assert want["losses"] == dense["losses"]
    for k, v in dense["params"].items():
        assert torch.equal(want["params"][k], v), k
    for res in worlds[1]:
        got = res["model_axis_1"]
        assert got["mesh"] == {"data": 2, "model": 1}
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=TOL)
        assert _params_err(got["params"], want["params"]) <= TOL
        assert got["preds"] == want["preds"]


def test_partition_context():
    mesh = make_mesh(4, model=2)
    groups = MeshGroups(1, 0)
    for mode, m in (("none", mesh), ("", mesh), ("edges", None),
                    ("edges", make_mesh(4))):
        with graph_partition(mode, m, groups):
            assert active_partition() is None
    with graph_partition("edges", mesh, groups):
        part = active_partition()
        assert (part.mode, part.mesh, part.groups) == ("edges", mesh, groups)
        with graph_partition("none", mesh, groups):
            assert active_partition() == part
    assert active_partition() is None
    with graph_partition("halo", mesh, groups):
        part = active_partition()
        assert (part.mode, part.mesh, part.groups) == ("halo", mesh, groups)
    assert active_partition() is None
    with pytest.raises(ValueError, match="unknown graph_partition"):
        with graph_partition("nodes", mesh, groups):
            pass
    GCNClassifier(dp_worker.tiny_cfg(
        **{"model.graph_partition": "halo"}).model)


@pytest.mark.parametrize("k,e", [(2, 15), (2, 16), (3, 16), (4, 5)])
def test_local_edges_split_the_padded_list_in_order(k, e):
    """gcn_tpu's ``P(data, model)`` on the edge axis after
    ``pad_edges_for_axis``: contiguous shares in model order."""
    rng = np.random.RandomState(e)
    batch = {"edge_parent": torch.from_numpy(rng.randint(0, 9, (3, e))),
             "edge_child": torch.from_numpy(rng.randint(0, 9, (3, e))),
             "edge_deprel": torch.from_numpy(rng.randint(0, 9, (3, e))),
             "edge_mask": torch.from_numpy(rng.rand(3, e) < 0.7),
             "words": torch.zeros(3, 9)}
    padded = pad_edges_for_axis(batch, k)
    width = -(-e // k) * k
    assert padded["words"] is batch["words"]
    mesh = make_mesh(k, model=k)
    for key in ("edge_parent", "edge_child", "edge_deprel", "edge_mask"):
        t = padded[key]
        assert t.shape == (3, width) and t.dtype == batch[key].dtype
        assert torch.equal(t[:, :e], batch[key])
        assert not t[:, e:].any()
        shares = [local_edges(Partition("edges", mesh, MeshGroups(0, m)),
                              batch[key]) for m in range(k)]
        assert torch.equal(torch.cat(shares, dim=1), t)


def test_two_process_partitioned_cli_matches_one_process(tmp_path):
    """``--graph_partition edges --graph_axis 2`` as a 1 × 2 world on the
    CPU against the same run unpartitioned in one process: ``logs.txt``'s
    train loss within 1e-3 relative, the same dev F1; only rank 0
    writes."""
    train = [sys.executable, "-m", "gcn_tpu_torch.scripts.train", *CLI,
             "--adj_type", "full_deprel", "--id", "gp"]
    part = ["--graph_partition", "edges", "--graph_axis", "2"]
    port = free_port()
    procs = [subprocess.Popen(
        train + part + ["--model_save_dir", str(tmp_path / f"mp{r}")],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(r, port)) for r in range(2)]
    procs.append(subprocess.Popen(
        train + ["--model_save_dir", str(tmp_path / "sp")], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1")))
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, (err[-3000:], out[-1000:])
    assert "Mesh: {'data': 1, 'model': 2}, graph_partition edges" in outs[0][0]
    sp, mp = _logs(tmp_path / "sp" / "gp"), _logs(tmp_path / "mp0" / "gp")
    assert len(sp) == len(mp) == 2
    for row_s, row_m in zip(sp, mp):
        assert row_s[0] == row_m[0]
        assert abs(float(row_s[1]) - float(row_m[1])) <= 1e-3 * max(
            1.0, abs(float(row_s[1]))), (row_s, row_m)
        assert float(row_s[3]) == float(row_m[3]), (row_s, row_m)
    assert not os.path.exists(tmp_path / "mp1")
