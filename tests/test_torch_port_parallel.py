"""The port's data parallelism on the CPU: two ranks over gloo.

* Two ranks of ``tests/dp_worker.py`` (subprocesses, no JAX) run each
  scenario through ``DistributedTrainer`` on their rows of the global
  batches; ``Trainer`` runs it in process on the global batches: 3 steps
  with the preset's dropouts on (and word-type, edge, deprel and
  inter-layer dropout), a batch whose padded rows fall on one rank only
  (the global denominator), ``conv_l2`` (counted once), a
  cross-sentence-packed batch, and ``--sparse_emb_grad true``.  Losses
  and every parameter within 1e-4 (of max(1, max |p|)), the same
  evaluation predictions, probabilities within 1e-5, and the two ranks'
  parameters equal in bits.
* The same ranks against gcn_tpu's ``DistributedTrainer`` on
  ``make_mesh(data=2, model=1)`` from its weights, dropout off (the two
  frameworks draw different masks): losses and parameters within 1e-4.
* ``ShardedBatcher`` cuts a packed batch's per-slot leaves with their
  rows; gcn_tpu's cuts every leaf by rows (``ROADMAP.md`` §3).
* The train CLI as two processes (``GCN_TPU_*``, ``--cpu``, gcn_tpu's
  multihost test's sizes) against one: ``logs.txt``'s train loss within
  1e-3 relative, equal dev F1; only rank 0 writes; ``best_model`` loads.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from gcn_tpu.config import Config as JaxConfig
from gcn_tpu.data.sharding import ShardedBatcher as JaxShardedBatcher
from gcn_tpu.parallel.mesh import make_mesh as jax_make_mesh
from gcn_tpu.train.distributed_trainer import (
    DistributedTrainer as JaxDistributedTrainer,
)
from gcn_tpu_torch.convert import params_from_jax
from gcn_tpu_torch.data.sharding import ShardedBatcher
from gcn_tpu_torch.ops.dropout import RowShard, dropout
from gcn_tpu_torch.parallel.distributed import free_port
from gcn_tpu_torch.parallel.mesh import (
    MeshGroups,
    group_ranks,
    make_groups,
    make_mesh,
)
from gcn_tpu_torch.train.checkpoint import load_checkpoint
from gcn_tpu_torch.train.trainer import SPARSE_EMB_AUTO_VOCAB, Trainer
from gcn_tpu_torch.utils.shard_ctx import active_partition, graph_partition
from tests import dp_worker
from tests.test_torch_port_cuda import one_torch_thread  # noqa: F401
from tests.test_torch_port_model import REPO

TOL = 1e-4


def _env(rank: int, port: int, procs: int = 2) -> dict:
    env = dict(os.environ, GCN_TPU_COORDINATOR=f"localhost:{port}",
               GCN_TPU_NUM_PROCS=str(procs), GCN_TPU_PROC_ID=str(rank),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


def _wait(procs, timeout=240):
    for p in procs:
        out, err = p.communicate(timeout=timeout)
        assert p.returncode == 0, (err[-3000:], out[-1000:])


@pytest.fixture(scope="module")
def jax_run():
    """gcn_tpu's DistributedTrainer over a 2 x 1 mesh on the ``jax``
    scenario: (its initial weights for the port, its losses, its
    trainer)."""
    cfg, batches, _ = dp_worker.scenario("jax")
    jt = JaxDistributedTrainer(JaxConfig.from_dict(cfg.to_dict()),
                               mesh=jax_make_mesh(data=2, model=1),
                               rng_seed=0, init_batch=batches.batches[0])
    state = params_from_jax(jax.device_get(jt.params))
    losses = [float(jt.update(b)) for b in batches]
    return state, losses, jt


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_run):
    """Both ranks' results of every scenario."""
    out = tmp_path_factory.mktemp("dp")
    state_file = str(out / "state.pt")
    torch.save(jax_run[0], state_file)
    port = free_port()
    worker = os.path.join(REPO, "tests", "dp_worker.py")
    _wait([subprocess.Popen(
        [sys.executable, worker, str(out), state_file],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(r, port)) for r in range(2)])
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(2)]


def _params_err(got: dict, want: dict) -> float:
    assert set(got) == set(want)
    return max(float((got[k] - want[k]).abs().max())
               / max(1.0, float(want[k].abs().max())) for k in want)


@pytest.mark.parametrize("name", ["dropout", "padded", "conv_l2", "packed",
                                  "sparse"])
def test_two_ranks_match_one_process(name, ranks):
    cfg, batches, evals = dp_worker.scenario(name)
    want = dp_worker.run(Trainer(cfg, rng_seed=0, device="cpu"), batches,
                         evals)
    assert ranks[0]["world"] == 2
    for got in (r[name] for r in ranks):
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=TOL)
        assert _params_err(got["params"], want["params"]) <= TOL
        assert got["preds"] == want["preds"]
        np.testing.assert_allclose(got["probs"], want["probs"], atol=1e-5)
        assert got["eval_loss"] == pytest.approx(want["eval_loss"], rel=TOL)
        assert got["sparse_emb"] == want["sparse_emb"] == (name == "sparse")
    for k, v in ranks[0][name]["params"].items():
        assert torch.equal(v, ranks[1][name]["params"][k]), k


def test_forced_sparse_under_data_parallelism_matches_dense(ranks):
    """As gcn_tpu's test_mesh_forced_sparse_matches_single_device: the
    ranks' row-sparse steps against one process's dense steps."""
    cfg, batches, evals = dp_worker.scenario("sparse")
    cfg.train.sparse_emb_grad = "false"
    dense = dp_worker.run(Trainer(cfg, rng_seed=0, device="cpu"), batches,
                          evals)
    got = ranks[0]["sparse"]
    np.testing.assert_allclose(got["losses"], dense["losses"], atol=1e-5)
    assert _params_err(got["params"], dense["params"]) < 1e-5
    # "auto" stays dense under data parallelism at any table size
    big = dp_worker.tiny_cfg(**{"model.vocab_size": SPARSE_EMB_AUTO_VOCAB,
                                "model.emb_dim": 4})
    assert Trainer(big, device="cpu").sparse_emb
    assert ranks[0]["auto_sparse"] is False


def test_two_ranks_match_gcn_tpus_distributed_trainer(jax_run, ranks):
    state, jax_losses, jt = jax_run
    got = ranks[0]["jax"]
    np.testing.assert_allclose(got["losses"], jax_losses, rtol=TOL)
    assert _params_err(got["params"],
                       params_from_jax(jax.device_get(jt.params))) <= TOL
    cfg, batches, evals = dp_worker.scenario("jax")
    one = dp_worker.run(Trainer(cfg, state, rng_seed=0, device="cpu"),
                        batches, evals)
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=TOL)
    assert _params_err(got["params"], one["params"]) <= TOL
    assert got["preds"] == one["preds"]


def test_row_shard_draws_the_global_masks_rows():
    x = torch.randn(8, 5, 3)
    full = dropout(x, 0.5, False, torch.Generator().manual_seed(4))
    for lo, hi in ((0, 4), (4, 8)):
        part = dropout(x[lo:hi], 0.5, False,
                       RowShard(torch.Generator().manual_seed(4), lo, hi, 8))
        assert torch.equal(part, full[lo:hi])
    with pytest.raises(ValueError):
        dropout(x[:3], 0.5, False, RowShard(torch.Generator(), 0, 4, 8))


def test_sharded_batcher_keeps_slot_leaves_with_their_rows():
    cfg, batches, _ = dp_worker.scenario("packed")
    batch = batches.batches[0]
    rows, slots = batch["slot_mask"].shape[:2]
    assert batch["labels"].shape == (rows * slots,)
    for rank in range(2):
        mine = ShardedBatcher(batches, rank, 2).slice(batch)
        lo, hi = rank * rows // 2, (rank + 1) * rows // 2
        np.testing.assert_array_equal(mine["words"], batch["words"][lo:hi])
        for k in ("labels", "example_mask"):
            np.testing.assert_array_equal(
                mine[k], batch[k][lo * slots:hi * slots])
        # gcn_tpu's ShardedBatcher cuts the per-slot leaves by rows, so
        # rank 1's labels are the wrong sentences' (ROADMAP.md §3)
        theirs = JaxShardedBatcher(batches, rank, 2)._slice(batch)
        np.testing.assert_array_equal(theirs["words"], mine["words"])
        np.testing.assert_array_equal(theirs["labels"],
                                      batch["labels"][lo:hi])
        assert theirs["labels"].shape[0] < theirs["slot_mask"][
            :, :, 0].size == mine["labels"].shape[0]
    with pytest.raises(ValueError, match="not divisible"):
        ShardedBatcher(batches, 0, 3)


def test_mesh_model_axis_names_item_8():
    """The model axis lays out (item 8a); the halo partition (item 8b)
    activates.  The groups' ranks as the worlds of
    ``tests/test_torch_port_partition.py`` build them."""
    assert make_mesh(4).shape == {"data": 4, "model": 1}
    assert make_mesh(4).coords(3) == (3, 0)
    mesh = make_mesh(4, model=2)
    assert mesh.shape == {"data": 2, "model": 2}
    assert [mesh.coords(r) for r in range(4)] == [(0, 0), (0, 1), (1, 0),
                                                  (1, 1)]
    assert group_ranks(mesh) == ([[0, 1], [2, 3]], [[0, 2], [1, 3]])
    assert group_ranks(make_mesh(3, data=1, model=3)) == ([[0, 1, 2]],
                                                          [[0], [1], [2]])
    assert make_groups(make_mesh(4), 2) == MeshGroups(2, 0)  # no group made
    groups = make_groups(make_mesh(4), 0)
    with graph_partition("halo", mesh, groups):
        assert active_partition() == ("halo", mesh, groups)
    assert active_partition() is None
    with pytest.raises(ValueError):
        make_mesh(4, data=3)
    with pytest.raises(ValueError):
        make_mesh(4, model=3)


CLI = ["--cpu", "--no-rnn", "--hidden_dim", "16", "--emb_dim", "300",
       "--batch_size", "10", "--effective_batch_size", "10",
       "--num_epoch", "2", "--seed", "7", "--log_step", "100"]


def _logs(run_dir):
    with open(os.path.join(run_dir, "logs.txt")) as f:
        return [ln.split("\t") for ln in f.read().splitlines()
                if ln and not ln.startswith(("#", "new best"))]


def test_two_process_cli_matches_one_process(tmp_path):
    """Rank 1 is given a run directory of its own, which must stay
    unwritten: only rank 0 writes."""
    train = [sys.executable, "-m", "gcn_tpu_torch.scripts.train", *CLI,
             "--id", "dp"]
    port = free_port()
    env1 = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        train + ["--model_save_dir", str(tmp_path / f"mp{r}")], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(r, port)) for r in range(2)]
    procs.append(subprocess.Popen(
        train + ["--model_save_dir", str(tmp_path / "sp")], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env1))
    _wait(procs)
    sp, mp = _logs(tmp_path / "sp" / "dp"), _logs(tmp_path / "mp0" / "dp")
    assert len(sp) == len(mp) == 2
    for row_s, row_m in zip(sp, mp):
        assert row_s[0] == row_m[0]
        assert abs(float(row_s[1]) - float(row_m[1])) <= 1e-3 * max(
            1.0, abs(float(row_s[1]))), (row_s, row_m)
        assert float(row_s[3]) == float(row_m[3]), (row_s, row_m)
    assert not os.path.exists(tmp_path / "mp1")
    params, _, _ = load_checkpoint(str(tmp_path / "mp0" / "dp" / "best_model"))
    assert "word_emb" in params["params"]
