"""The port's dispatch layer against gcn_tpu's, on the CPU.

On the CPU the port runs its steps eagerly (CUDA graphs exist only on the
card, where ``tests/test_torch_port_cuda.py`` and ``chip_smoke.py`` hold
them against eager steps); what runs here is the dispatch logic:

* ``allowed_chunk_sizes`` and ``chunk_plan`` equal gcn_tpu's for caps
  1-16 and runs of 0-40 batches;
* ``Batcher.warmup_batches`` gives gcn_tpu's shapes and leaves the
  word-dropout stream as it was;
* ``update_chunk`` of 7 batches equals 7 ``update`` calls bit for bit; with
  dropout off it follows gcn_tpu's ``update_chunk`` (steps_per_dispatch 4,
  JAX on the CPU) within 1e-4 — losses relative, every parameter over
  max(1, max |p|) — the tolerance of the trajectory tests;
* ``evaluate`` at steps_per_dispatch 4 over mixed buckets and a short last
  batch gives gcn_tpu's predictions, probabilities within 1e-4 and the
  average loss within 1e-5 relative;
* the optimizer with its device count and rate follows optax within 1e-6
  on all six cores, across a ``set_learning_rate``;
* the driver at ``--steps_per_dispatch 4 --save_steps 3`` writes the
  spd=1 run's ``logs.txt``, step checkpoints and final checkpoints, and
  a run killed after the step-3 checkpoint and resumed is the whole run.
"""

import json
import os

import jax
import numpy as np
import optax
import pytest
import torch

from gcn_tpu.data.dataset import Batcher as JaxBatcher
from gcn_tpu.data.dataset import RelationDataset as JaxDataset
from gcn_tpu.data.vocab import Vocab as JaxVocab
from gcn_tpu.train import trainer as jax_trainer_mod
from gcn_tpu.train.optim import build_optimizer as jax_build_optimizer
from gcn_tpu.train.optim import set_learning_rate as jax_set_lr
from gcn_tpu.train.trainer import Trainer as JaxTrainer
from gcn_tpu_torch.convert import params_from_jax
from gcn_tpu_torch.data.dataset import Batcher, RelationDataset
from gcn_tpu_torch.data.vocab import Vocab
from gcn_tpu_torch.scripts import train
from gcn_tpu_torch.train import driver as driver_mod
from gcn_tpu_torch.train import trainer as trainer_mod
from gcn_tpu_torch.train.checkpoint import load_checkpoint
from gcn_tpu_torch.train.dispatch import allowed_chunk_sizes, chunk_plan
from gcn_tpu_torch.train.optim import CORES, build_optimizer, \
    set_learning_rate
from gcn_tpu_torch.train.trainer import Trainer
from tests.test_torch_port_cli import SMALL, logs_rows
from tests.test_torch_port_cuda import one_torch_thread  # noqa: F401
from tests.test_torch_port_model import DATA, VOCAB, _configs
from tests.test_torch_port_train import NO_DROPOUT, _params_close, _tree

TRAIN = os.path.join(DATA, "train.json")


def test_chunk_sizes_and_plans_match_gcn_tpu():
    for cap in range(1, 17):
        assert allowed_chunk_sizes(cap) == \
            jax_trainer_mod.allowed_chunk_sizes(cap)
        for k in range(41):
            plan = chunk_plan(k, cap)
            assert plan == jax_trainer_mod.chunk_plan(k, cap)
            assert sum(plan) == k


@pytest.mark.parametrize("evaluation", [False, True])
def test_warmup_batches_match_gcn_tpu(evaluation):
    jcfg, tcfg = _configs()
    kw = {"evaluation": evaluation, "seed": 3, "pad_batches": False}
    jb = JaxBatcher(JaxDataset(TRAIN, jcfg, JaxVocab.load(VOCAB)), 7, **kw)
    tb = Batcher(RelationDataset(TRAIN, tcfg, Vocab.load(VOCAB)), 7, **kw)
    fresh = Batcher(RelationDataset(TRAIN, tcfg, Vocab.load(VOCAB)), 7, **kw)
    want = [b["words"].shape for b in jb.warmup_batches()]
    got = tb.warmup_batches()
    assert [b["words"].shape for b in got] == want
    assert len(set(want)) == len(want) > 1
    # the batches after a warm-up are an unwarmed batcher's, word dropout
    # included
    for a, b in zip(tb, fresh):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    if evaluation:
        assert tb._cache is not None  # filled by the pass, not the warm-up


def same_shape_batches(tcfg, count: int) -> list[dict]:
    """``count`` training batches of one shape (word dropout on)."""
    ds = RelationDataset(TRAIN, tcfg, Vocab.load(VOCAB))
    batcher = Batcher(ds, 8, seed=5, length_buckets=[48])
    out = []
    while len(out) < count:
        out.extend(batcher)
    assert len({b["words"].shape for b in out}) == 1
    return out[:count]


def test_update_chunk_is_the_updates_bit_for_bit():
    _, tcfg = _configs(**{"train.steps_per_dispatch": 4})
    batches = same_shape_batches(tcfg, 7)
    a, b = Trainer(tcfg, device="cpu"), Trainer(tcfg, device="cpu")
    got = a.update_chunk(batches)
    want = [b.update(x) for x in batches]
    assert len(got) == 7 and a.global_step == b.global_step == 7
    assert [float(x) for x in got] == [float(x) for x in want]
    for k, v in b.model.state_dict().items():
        assert torch.equal(a.model.state_dict()[k], v), k


def test_update_chunk_follows_gcn_tpu():
    ov = {**NO_DROPOUT, "model.rnn_impl": "auto",
          "model.deprel_factored": "auto", "train.effective_batch_size": 8,
          "train.steps_per_dispatch": 4}
    jcfg, tcfg = _configs(**ov)
    jt = JaxTrainer(jcfg)
    tt = Trainer(tcfg, params_from_jax(jax.device_get(jt.params)),
                 device="cpu")
    batches = same_shape_batches(tcfg, 7)
    want = [float(x) for x in jt.update_chunk(batches)]
    got = [float(x) for x in tt.update_chunk(batches)]
    assert got == pytest.approx(want, rel=1e-4)
    assert tt.global_step == jt.global_step == 7
    _params_close(tt, jt.params)


def test_evaluate_in_chunks_follows_gcn_tpu():
    jcfg, tcfg = _configs(**{"train.steps_per_dispatch": 4,
                             "train.batch_size": 3,
                             "model.rnn_impl": "auto",
                             "model.deprel_factored": "auto"})
    jt = JaxTrainer(jcfg)
    tt = Trainer(tcfg, params_from_jax(jax.device_get(jt.params)),
                 device="cpu")
    batches = []
    for split in ("dev", "test"):
        ds = RelationDataset(os.path.join(DATA, f"{split}.json"), tcfg,
                             Vocab.load(VOCAB), evaluation=True)
        batches += list(Batcher(ds, 3, evaluation=True, pad_batches=False))
    shapes = [b["words"].shape for b in batches]
    assert len(set(s[1] for s in shapes)) > 1 and shapes[-1][0] < 3
    jp, jprobs, jloss = jt.evaluate(batches)
    tp, tprobs, tloss = tt.evaluate(batches)
    assert tp == jp
    np.testing.assert_allclose(tprobs, jprobs, atol=1e-4, rtol=0)
    assert tloss == pytest.approx(jloss, rel=1e-5)


@pytest.mark.parametrize("name", CORES)
def test_device_count_and_rate_follow_optax(name):
    rng = np.random.RandomState(len(name))
    params = _tree(rng)
    tx = jax_build_optimizer(name, 0.3, max_grad_norm=1.0, topn=4,
                             lr_decay=0.1)
    state = tx.init(params)
    jparams = params
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = build_optimizer(name, 0.3, max_grad_norm=1.0, topn=4,
                          lr_decay=0.1)
    opt.init(tparams)
    assert opt.count.dtype == torch.int32 and opt.count.dim() == 0
    for i in range(6):
        if i == 3:
            state = jax_set_lr(state, 0.05)
            set_learning_rate(opt, 0.05)
        grads = _tree(rng, scale=3.0)
        updates, state = tx.update(grads, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.step(tparams, {k: torch.from_numpy(v) for k, v in
                           grads.items()})
    assert int(opt.count) == 6 and float(opt.learning_rate) == \
        pytest.approx(0.05)
    for k, v in jparams.items():
        np.testing.assert_allclose(tparams[k].numpy(), np.asarray(v),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


class _Killed(Exception):
    pass


def test_chunked_driver_writes_the_spd1_run(tmp_path, monkeypatch):
    """Dropout and word dropout on, 2 epochs of 5 steps: chunks cut at the
    bucket changes and at steps 3, 6 and 9."""
    monkeypatch.setattr(driver_mod, "rmtree", lambda path: None)  # keep
    argv = [*SMALL, "--save_steps", "3", "--num_epoch", "2", "--cpu",
            "--model_save_dir", str(tmp_path)]
    chunks = []
    update_chunk = trainer_mod.Trainer.update_chunk

    def counted(self, batches):
        chunks.append(len(batches))
        return update_chunk(self, batches)

    monkeypatch.setattr(trainer_mod.Trainer, "update_chunk", counted)
    train.main([*argv, "--id", "spd1"])
    assert chunks == []
    train.main([*argv, "--id", "spd4", "--steps_per_dispatch", "4"])
    assert sum(chunks) == 10 and max(chunks) <= 3 < 4
    assert logs_rows(tmp_path / "spd1") == logs_rows(tmp_path / "spd4")
    names = sorted(n for n in os.listdir(tmp_path / "spd1")
                   if n.startswith(("checkpoint_", "best_model")))
    assert "checkpoint_step_9" in names
    assert names == sorted(n for n in os.listdir(tmp_path / "spd4")
                           if n.startswith(("checkpoint_", "best_model")))
    for name in names:
        want = load_checkpoint(str(tmp_path / "spd1" / name))
        got = load_checkpoint(str(tmp_path / "spd4" / name))
        assert got[2]["meta"] == want[2]["meta"], name
        for a, b in zip(jax.tree.leaves(got[:2]), jax.tree.leaves(want[:2])):
            np.testing.assert_array_equal(a, b, err_msg=name)
    monkeypatch.undo()

    # killed in the chunk after the step-3 checkpoint, then resumed
    def killed_after_step_3(self, batches):
        if self.global_step >= 3:
            raise _Killed
        return update_chunk(self, batches)

    monkeypatch.setattr(trainer_mod.Trainer, "update_chunk",
                        killed_after_step_3)
    with pytest.raises(_Killed):
        train.main([*argv, "--id", "split", "--steps_per_dispatch", "4"])
    monkeypatch.undo()
    meta = json.load(open(tmp_path / "split" / "checkpoint_step_3" /
                          "meta.json"))["meta"]
    assert (meta["global_step"], meta["step_in_epoch"]) == (3, 3)
    train.main([*argv, "--id", "split", "--steps_per_dispatch", "4",
                "--resume"])
    assert logs_rows(tmp_path / "spd1") == logs_rows(tmp_path / "split")
    for name in ("checkpoint_epoch_2", "best_model"):
        want = load_checkpoint(str(tmp_path / "spd1" / name))
        got = load_checkpoint(str(tmp_path / "split" / name))
        assert got[2]["meta"] == want[2]["meta"], name
        for a, b in zip(jax.tree.leaves(got[:2]), jax.tree.leaves(want[:2])):
            np.testing.assert_array_equal(a, b, err_msg=name)


class _ReplayedEagerly:
    """Stands in for a captured CUDA graph on the CPU: each replay runs the
    captured function again on the graph's static inputs, with the step
    slots' generators as ``StepGraph.replay`` reseeded them."""

    def __init__(self, fn, static, generators):
        self.fn, self.static, self.generators = fn, static, generators
        self.step = None

    def replay(self):
        self.step.outputs = self.fn(self.static, self.generators)


@pytest.fixture
def card_path_on_the_cpu(monkeypatch):
    """The card's dispatch path (staging, packed copies, graph cache,
    reseeded step generators, chunk graphs, the evaluation window) run on
    the CPU, each graph replayed eagerly."""
    from gcn_tpu_torch.train import dispatch, evaluator, transfer

    def capture(fn, static, device, pool, slots=0, state=()):
        generators = [torch.Generator(device=device) for _ in range(slots)]
        saved = [t.detach().clone() for t in state]
        fn(static, generators)  # the warm-up call
        with torch.no_grad():
            for t, s in zip(state, saved):
                t.copy_(s)
        graph = _ReplayedEagerly(fn, static, generators)
        graph.step = dispatch.StepGraph(graph, static, None, generators, {})
        return graph.step

    class Event:
        def record(self):
            pass

        def synchronize(self):
            pass

    def take(self, nbytes):
        return 0, torch.empty(nbytes, dtype=torch.uint8)

    for mod in (trainer_mod, evaluator):
        monkeypatch.setattr(mod, "graphs_on", lambda device, model,
                            backend=None: (
            dispatch._EAGER[0] == 0 and model.capturable
            and backend in (None, "nccl")))
    monkeypatch.setattr(dispatch, "capture", capture)
    monkeypatch.setattr(transfer.PinnedRing, "take", take)
    monkeypatch.setattr(transfer.PinnedRing, "release", lambda self, s: None)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)


@pytest.mark.parametrize("fmt", ["compact", "int32", "fields"])
def test_card_dispatch_path_is_the_eager_path(card_path_on_the_cpu, fmt):
    """Dropout on: one step at a time and a 7-batch update_chunk (4 + 2 +
    1) through the card's dispatch path give the eager steps' losses and
    parameters bit for bit, one copy a packed dispatch; a warm-up first
    changes nothing; evaluation in chunks of 4 gives the eager one's
    outputs."""
    from gcn_tpu_torch.train.dispatch import eager_dispatch

    ov = {"train.steps_per_dispatch": 4, "train.effective_batch_size": 8,
          "train.pack_format": "int32" if fmt == "int32" else "compact",
          "train.pack_transfers": fmt != "fields"}
    _, tcfg = _configs(**ov)
    batches = same_shape_batches(tcfg, 9)
    warm, path, eager = (Trainer(tcfg, device="cpu") for _ in range(3))
    stats = warm.warmup(batches[:1])
    assert stats["programs"] == (2 if fmt == "fields" else 6)
    assert warm.global_step == 0 and int(warm.opt.count) == 0
    with eager_dispatch():
        want = [eager.update(b) for b in batches]
        ev_want = eager.evaluate(batches)
    for tr in (path, warm):
        got = [tr.update(b) for b in batches[:2]] + tr.update_chunk(
            batches[2:])
        assert [float(x) for x in got] == [float(x) for x in want]
        for k, v in eager.model.state_dict().items():
            assert torch.equal(tr.model.state_dict()[k], v), k
        assert tr.evaluate(batches) == ev_want
    keys = sorted(k[2] for k in path.graphs if k[0] == "packed")
    assert keys == ([] if fmt == "fields" else [1, 2, 4])
    if fmt != "fields":  # captures send once; 2 + (4 + 2 + 1 pieces)
        assert path.staging.copies == 2 + 3


@pytest.mark.parametrize("adj_type,factored,capturable", [
    ("full_deprel", "auto", True), ("full_deprel", "pallas", True),
    ("full_deprel", False, True), ("full_deprel", "ragged", False),
    ("regular", "ragged", True), ("attention", "ragged", True)])
def test_capturable_follows_the_config(adj_type, factored, capturable):
    """Only a full_deprel model on the plain grouped matmul (it reads the
    group sizes on the host) is one that a graph cannot hold."""
    from gcn_tpu_torch.models.gcn import GCNClassifier

    _, tcfg = _configs(**{"model.adj_type": adj_type,
                          "model.deprel_factored": factored})
    assert GCNClassifier(tcfg.model).capturable is capturable


def test_a_model_that_reads_the_host_takes_no_graph(card_path_on_the_cpu):
    """``deprel_factored="ragged"`` on the card's dispatch path: its steps,
    a 7-batch update_chunk, a warm-up and evaluation run eagerly, as
    inside ``eager_dispatch()``, and capture nothing."""
    from gcn_tpu_torch.train.dispatch import eager_dispatch

    _, tcfg = _configs(**{"model.deprel_factored": "ragged",
                          "train.steps_per_dispatch": 4,
                          "train.effective_batch_size": 8})
    batches = same_shape_batches(tcfg, 9)
    tr, eager = Trainer(tcfg, device="cpu"), Trainer(tcfg, device="cpu")
    assert tr.warmup(batches[:1])["programs"] == 0
    got = [tr.update(b) for b in batches[:2]] + tr.update_chunk(batches[2:])
    with eager_dispatch():
        want = [eager.update(b) for b in batches]
        ev_want = eager.evaluate(batches)
    assert [float(x) for x in got] == [float(x) for x in want]
    for k, v in eager.model.state_dict().items():
        assert torch.equal(tr.model.state_dict()[k], v), k
    assert tr.evaluate(batches) == ev_want
    assert not tr.graphs and not tr._evaluator.graphs
    assert tr.staging.copies == 0


def test_cpu_gradients_are_the_same_bits_every_run():
    """On the CPU, several threads: the word, POS and NER tables'
    gradients (repeated rows summed) are the same bits in every run, so a
    ``--cpu`` run is reproducible."""
    _, tcfg = _configs(**{"model.emb_dim": 64, **NO_DROPOUT})
    ds = RelationDataset(TRAIN, tcfg, Vocab.load(VOCAB))
    (batch,) = list(Batcher(ds, 40, seed=0, length_buckets=[128]))
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        runs = [Trainer(tcfg, device="cpu")._loss_and_grads(batch)[1]
                for _ in range(4)]
    finally:
        torch.set_num_threads(threads)
    for k, g in runs[0].items():
        assert all(torch.equal(g, r[k]) for r in runs[1:]), k
