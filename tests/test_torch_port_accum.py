"""The accumulating train step (``update_gap > 1``) against gcn_tpu's, on
the CPU.

Each micro-batch adds its gradients into the trainer's gradient sums
(gcn_tpu's ``_loss_and_grads`` / ``_loss_and_grads_packed`` /
``_loss_and_grads_spacked`` with ``_accum_add``), and every
``update_gap``-th one, or ``flush_gradients``, steps the optimizer on the
sums (``_apply_grads``).  Each test runs eagerly ("eager") and through the
card's dispatch path with each graph replayed eagerly ("graphs":
``card_path_on_the_cpu``, a micro-batch graph per batch signature and the
apply graph), so the functions the card captures are the ones held here.

* ``update_gap`` 5 over 12 micro-batches of two length buckets (two
  applies and a flush of 2), and with ``update_lr`` between the
  micro-batches of a group: losses within 1e-4 relative of gcn_tpu's,
  every parameter within 1e-4 of max(1, max |p|) (dropout off: the two
  frameworks draw different masks);
* cross-sentence-packed batches at ``update_gap`` 2 (gcn_tpu's
  ``_loss_and_grads_spacked``), within the same tolerances;
* a checkpoint saved with 2 micro-batches pending resumes bit for bit,
  dropout on; ``load`` zeroes the sums, so the next apply holds only the
  micro-batches after it;
* ``warmup`` captures nothing on the CPU and, on the card's path, each
  train signature's micro-batch graph and the apply graph, the trainer's
  state (sums and count too) as it was, and a warmed run gives the
  unwarmed run's bits;
* two gloo ranks of ``tests/dp_worker.py`` at ``update_gap`` 2 follow
  ``Trainer`` within 1e-4.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from gcn_tpu.train.trainer import Trainer as JaxTrainer
from gcn_tpu_torch.convert import params_from_jax
from gcn_tpu_torch.parallel.distributed import free_port
from gcn_tpu_torch.train.dispatch import eager_dispatch
from gcn_tpu_torch.train.trainer import Trainer
from tests import dp_worker
from tests.test_torch_port_cuda import one_torch_thread  # noqa: F401
from tests.test_torch_port_dispatch import card_path_on_the_cpu  # noqa: F401
from tests.test_torch_port_model import REPO, _configs
from tests.test_torch_port_parallel import _env, _params_err, _wait
from tests.test_torch_port_regular import _configs as _preset_configs
from tests.test_torch_port_sentence_packing import packers
from tests.test_torch_port_train import (
    NO_DROPOUT,
    _params_close,
    _train_batchers,
)

TOL = 1e-4
PATHS = ["eager", "graphs"]


def _on_path(request, path: str) -> None:
    """Put the card's dispatch path on the CPU for ``path`` "graphs"."""
    if path == "graphs":
        request.getfixturevalue("card_path_on_the_cpu")


def _pairs(jb, tb, count: int) -> list:
    """``count`` (gcn_tpu, port) batch pairs, epoch after epoch (word
    dropout drawn anew each epoch)."""
    pairs = []
    while len(pairs) < count:
        pairs.extend(zip(jb, tb))
    return pairs[:count]


def _micro_batches(jcfg, tcfg, count: int, seed: int = 3):
    """``count`` batch pairs of B=8 from the in-repo train split."""
    return _pairs(*_train_batchers(jcfg, tcfg, seed=seed), count)


def _gap_configs(gap: int, **extra):
    return _configs(**{"model.rnn_impl": "auto",
                       "model.deprel_factored": "auto",
                       "train.effective_batch_size": 8 * gap, **extra})


def _graph_kinds(tr) -> list:
    return sorted(k[0] for k in tr.graphs)


@pytest.mark.parametrize("mode", ["two_buckets", "update_lr"])
@pytest.mark.parametrize("path", PATHS)
def test_accumulating_trajectory_matches_jax(request, path, mode):
    """update_gap 5, 12 micro-batches: applies after 5 and 10, then a
    flush of 2; in ``update_lr`` the rate changes after micro-batch 3
    (inside the first group) and after 7 (inside the second)."""
    _on_path(request, path)
    jcfg, tcfg = _gap_configs(5, **NO_DROPOUT)
    assert jcfg.train.update_gap == tcfg.train.update_gap == 5
    jt = JaxTrainer(jcfg)
    tt = Trainer(tcfg, params_from_jax(jax.device_get(jt.params)),
                 device="cpu")
    pairs = _micro_batches(jcfg, tcfg, 12)
    assert len({b["words"].shape for _, b in pairs}) >= 2
    for i, (a, b) in enumerate(pairs):
        if mode == "update_lr" and i in (3, 7):
            jt.update_lr(0.1 * i)
            tt.update_lr(0.1 * i)
        want, got = float(jt.update(a)), float(tt.update(b))
        assert got == pytest.approx(want, rel=TOL), i
        assert tt.pending_batches == jt._accum_count == (i + 1) % 5
        if (i + 1) % 5 == 0:
            _params_close(tt, jt.params)
    jt.flush_gradients()
    tt.flush_gradients()
    assert tt.pending_batches == 0 and tt.global_step == 12
    assert int(tt.opt.count) == 3
    _params_close(tt, jt.params)
    if path == "graphs":
        shapes = {b["words"].shape for _, b in pairs}
        assert _graph_kinds(tt) == ["apply"] + ["micro"] * len(shapes)
    else:
        assert not tt.graphs


@pytest.mark.parametrize("path", PATHS)
def test_packed_sentences_accumulate_as_jax(request, path):
    """Cross-sentence-packed batches at update_gap 2 (gcn_tpu:
    ``_loss_and_grads_spacked``; the card's path: the sentence wire format
    in the micro-batch graph's static input), 5 micro-batches and a flush
    of one."""
    _on_path(request, path)
    jcfg, tcfg = _preset_configs("cgcn", **NO_DROPOUT, **{
        "train.batch_size": 4, "train.effective_batch_size": 8,
        "train.word_dropout": 0.1})
    assert jcfg.train.update_gap == tcfg.train.update_gap == 2
    jt = JaxTrainer(jcfg)
    tt = Trainer(tcfg, params_from_jax(jax.device_get(jt.params)),
                 device="cpu")
    pairs = _pairs(*packers(jcfg, tcfg), 5)
    assert all("slot_mask" in b for _, b in pairs)
    for i, (a, b) in enumerate(pairs):
        want, got = float(jt.update(a)), float(tt.update(b))
        assert got == pytest.approx(want, rel=TOL), i
    jt.flush_gradients()
    tt.flush_gradients()
    _params_close(tt, jt.params)
    if path == "graphs":
        assert all(k[:2] == ("micro", "sentences") for k in tt.graphs
                   if k[0] == "micro")
        assert ("apply",) in tt.graphs


def _dropout_run(gap: int = 5):
    """A config with the preset's dropouts on and its 12 batches."""
    jcfg, tcfg = _gap_configs(gap)
    return tcfg, [b for _, b in _micro_batches(jcfg, tcfg, 12)]


def _same_state(a, b):
    for k, v in a.model.state_dict().items():
        assert torch.equal(b.model.state_dict()[k], v), k
    for k, st in a.opt.state.items():
        for slot, v in st.items():
            assert torch.equal(b.opt.state[k][slot], v), (k, slot)
    assert torch.equal(a.opt.count, b.opt.count)


@pytest.mark.parametrize("path", PATHS)
def test_resume_with_pending_micro_batches_is_bitwise(request, path,
                                                      tmp_path):
    """Dropout on: a save after 7 micro-batches (one apply, 2 pending)
    records global_step 5; a fresh trainer that loads it and replays
    micro-batches 5-11 and the flush ends with the uninterrupted run's
    parameters and optimizer state in bits."""
    _on_path(request, path)
    tcfg, batches = _dropout_run()
    whole = Trainer(tcfg, device="cpu")
    for b in batches[:7]:
        whole.update(b)
    assert whole.pending_batches == 2
    whole.save(str(tmp_path / "c"), epoch=1)
    for b in batches[7:]:
        whole.update(b)
    whole.flush_gradients()
    resumed = Trainer(tcfg, device="cpu")
    meta = resumed.load(str(tmp_path / "c"))
    assert meta["global_step"] == resumed.global_step == 5
    for b in batches[5:]:
        resumed.update(b)
    resumed.flush_gradients()
    _same_state(whole, resumed)
    assert resumed.global_step == whole.global_step == 12


@pytest.mark.parametrize("path", PATHS)
def test_load_zeroes_the_accumulator(request, path, tmp_path):
    """A trainer with 2 micro-batches pending loads a checkpoint: nothing
    is pending and the sums are zero (the same tensors, which its graphs
    hold), so its next apply equals a fresh trainer's from the same
    checkpoint over the same 5 micro-batches, in bits."""
    _on_path(request, path)
    tcfg, batches = _dropout_run()
    first = Trainer(tcfg, device="cpu")
    for b in batches[:5]:
        first.update(b)
    first.save(str(tmp_path / "c"))
    busy = Trainer(tcfg, device="cpu")
    for b in batches[:7]:
        busy.update(b)
    sums = dict(busy._accum)
    assert busy.pending_batches == 2
    assert any(float(t.abs().max()) > 0 for t in sums.values())
    busy.load(str(tmp_path / "c"))
    assert busy.pending_batches == 0 and busy.global_step == 5
    for k, t in busy._accum.items():
        assert t is sums[k] and not bool(t.any()), k
    busy.flush_gradients()  # nothing pending: no step
    assert int(busy.opt.count) == 1
    fresh = Trainer(tcfg, device="cpu")
    fresh.load(str(tmp_path / "c"))
    for tr in (busy, fresh):
        for b in batches[5:10]:
            tr.update(b)
    assert int(busy.opt.count) == 2
    _same_state(busy, fresh)


def _snapshot(tr) -> list:
    return [t.detach().clone() for t in tr._state()] + [
        tr.pending_batches, tr.global_step]


def _unchanged(tr, before: list) -> bool:
    now = _snapshot(tr)
    return len(now) == len(before) and all(
        torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
        for a, b in zip(now, before))


@pytest.mark.parametrize("path", PATHS)
def test_warmup_captures_the_accumulating_graphs(request, path):
    """With 2 micro-batches pending (run eagerly, so nothing is captured
    yet), ``warmup`` over the run's train shapes captures nothing on the
    CPU; on the card's path, one micro-batch graph a train signature and
    the apply graph (gcn_tpu's ``_loss_and_grads`` per shape,
    ``_accum_add`` and ``_apply_grads``).  Either way parameters,
    optimizer state, the sums, their count and the step stay as they
    were, and the run goes on to the unwarmed run's bits."""
    _on_path(request, path)
    tcfg, batches = _dropout_run()
    warm, cold = Trainer(tcfg, device="cpu"), Trainer(tcfg, device="cpu")
    with eager_dispatch():
        for tr in (warm, cold):
            for b in batches[:7]:
                tr.update(b)
    before = _snapshot(warm)
    shapes = {b["words"].shape: b for b in batches}
    stats = warm.warmup(list(shapes.values()), eval_batches=[])
    assert _unchanged(warm, before)
    if path == "graphs":
        assert stats["programs"] == len(shapes) + 1
        assert _graph_kinds(warm) == ["apply"] + ["micro"] * len(shapes)
    else:
        assert stats["programs"] == 0 and not warm.graphs
    losses = []
    for tr in (warm, cold):
        losses.append([float(tr.update(b)) for b in batches[7:]])
        tr.flush_gradients()
    assert losses[0] == losses[1]
    _same_state(warm, cold)


def test_gloo_world_of_two_accumulates_as_trainer(tmp_path):
    """Two ranks of ``tests/dp_worker.py`` (``DistributedTrainer`` over
    gloo, each on its rows) on its ``accum`` scenario, update_gap 2 over 5
    batches with the preset's dropouts (one with its padded rows on one
    rank): losses and every parameter within 1e-4 of ``Trainer`` on the
    global batches, the same evaluation predictions, and the two ranks'
    parameters equal in bits."""
    cfg, batches, evals = dp_worker.scenario("accum")
    assert cfg.train.update_gap == 2
    port = free_port()
    worker = os.path.join(REPO, "tests", "dp_worker.py")
    _wait([subprocess.Popen(
        [sys.executable, worker, str(tmp_path), "", "accum"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(r, port)) for r in range(2)])
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    want = dp_worker.run(Trainer(cfg, rng_seed=0, device="cpu"), batches,
                         evals)
    for got in (r["accum"] for r in ranks):
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=TOL)
        assert _params_err(got["params"], want["params"]) <= TOL
        assert got["preds"] == want["preds"]
    for k, v in ranks[0]["accum"]["params"].items():
        assert torch.equal(v, ranks[1]["accum"]["params"][k]), k
