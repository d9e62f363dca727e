"""Cross-sentence packing in the port against gcn_tpu's, on the CPU (the
Pallas kernels in interpret mode, as gcn_tpu's own tests run them).

Several sentences share one row of a ``PackedBatcher`` batch; the BiLSTM
resets its carry at each sentence boundary (``seg_start`` → the scan's
``keep``), the head pools per slot and the edges are offset into the row.

* ``PackedBatcher`` gives gcn_tpu's arrays, array for array, for training
  (word dropout on, several epochs) and evaluation, and the same order
  and gold labels;
* ``_segment_resets`` equals gcn_tpu's; ``bilstm`` with ``seg_start``
  matches gcn_tpu's ``_bidirectional_pallas`` within 1e-5; every packed
  sentence, in both directions, matches its own unpacked row within 1e-5;
* ``pool_slots`` matches gcn_tpu's;
* the whole forward on packed batches: logits and ``h_out`` within 1e-4 of
  gcn_tpu's on the dense, fused and attention edge paths, and within 1e-5
  of the port's own unpacked forward on the same sentences;
* one train step's gradients within 1e-4 of each tensor's max |grad|;
* the sentence wire format: gcn_tpu's bytes, and an exact unpack;
* the evaluator's loss on packed batches is gcn_tpu's weighted mean;
* the train CLI with ``--pack_sentences``: a resumed run gives the whole
  run's bits, and a warm-started 2-epoch run matches gcn_tpu's
  ``run_training`` (``logs.txt`` within 1e-4 relative, the same F1s);
  BERT inputs with packing raise ``ValueError``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_tpu.data import packing as jax_packing
from gcn_tpu.data.dataset import PackedBatcher as JaxPacked
from gcn_tpu.data.dataset import RelationDataset as JaxDataset
from gcn_tpu.data.vocab import Vocab as JaxVocab
from gcn_tpu.models.gcn import GCNClassifier as JaxGCN
from gcn_tpu.ops import lstm as jax_lstm
from gcn_tpu.ops import pooling as jax_pooling
from gcn_tpu.train import cli as jax_cli
from gcn_tpu.train.driver import run_training as jax_run_training
from gcn_tpu.train.trainer import Trainer as JaxTrainer
from gcn_tpu_torch.convert import params_from_jax
from gcn_tpu_torch.data import packing
from gcn_tpu_torch.data.dataset import Batcher, PackedBatcher, \
    RelationDataset
from gcn_tpu_torch.data.vocab import Vocab
from gcn_tpu_torch.models.gcn import GCNClassifier
from gcn_tpu_torch.ops import lstm as lstm_mod
from gcn_tpu_torch.ops.pooling import pool_slots
from gcn_tpu_torch.scripts import train
from gcn_tpu_torch.train import cli
from gcn_tpu_torch.train.checkpoint import load_checkpoint
from gcn_tpu_torch.train.evaluator import Evaluator, batch_to_device
from gcn_tpu_torch.train.trainer import Trainer
from tests.test_torch_port_cli import SMALL as CLI_SMALL
from tests.test_torch_port_cli import NO_DROPOUT as CLI_NO_DROPOUT
from tests.test_torch_port_cli import _init_checkpoint, logs_rows
from tests.test_torch_port_cuda import one_torch_thread  # noqa: F401
from tests.test_torch_port_model import DATA, VOCAB
from tests.test_torch_port_regular import _configs
from tests.test_torch_port_train import NO_DROPOUT

CPU = torch.device("cpu")
ROWS, PACK_LEN, SLOTS = 4, 64, 4  # 256 tokens a band: group counts exact
PATHS = {"dense": {},
         "fused": {"model.use_pallas": True},
         "attention_edge": {"model.adj_type": "attention",
                            "model.attention_impl": "edge"}}


def packers(jcfg, tcfg, split="train", evaluation=False, seed=5,
            rows=ROWS):
    path = os.path.join(DATA, f"{split}.json")
    jds = JaxDataset(path, jcfg, JaxVocab.load(VOCAB))
    tds = RelationDataset(path, tcfg, Vocab.load(VOCAB))
    kw = dict(pack_len=PACK_LEN, max_slots=SLOTS, evaluation=evaluation,
              seed=seed)
    return JaxPacked(jds, rows, **kw), PackedBatcher(tds, rows, **kw)


def assert_same_batch(jb, tb):
    assert set(jb) == set(tb)
    for k, v in jb.items():
        np.testing.assert_array_equal(tb[k], v, err_msg=k)
        assert tb[k].dtype == v.dtype and tb[k].shape == v.shape, k


@pytest.mark.parametrize("evaluation", [False, True])
def test_packed_batcher_matches_jax(evaluation):
    jcfg, tcfg = _configs("cgcn", **{"train.word_dropout": 0.3})
    jp, tp = packers(jcfg, tcfg, evaluation=evaluation)
    assert (tp.rows, tp.order, tp.gold(), tp.pack_len, len(tp)) == (
        jp.rows, jp.order, jp.gold(), jp.pack_len, len(jp))
    assert max(len(r) for r in tp.rows) > 1
    dropped = 0
    for _ in range(2):  # word dropout is drawn anew every epoch
        for jb, tb in zip(jp, tp):
            assert_same_batch(jb, tb)
            dropped += int((tb["words"] == 1).sum())
    assert (dropped > 0) is (not evaluation)
    assert_same_batch(jp.warmup_batches()[0], tp.warmup_batches()[0])


def test_packed_batcher_advance_skips_what_a_resume_skips():
    _, tcfg = _configs("cgcn", **{"train.word_dropout": 0.3})
    _, whole = packers(_configs("cgcn")[0], tcfg)
    _, skipped = packers(_configs("cgcn")[0], tcfg)
    first = [whole.materialize(c) for c in whole.chunks]
    later = [whole.materialize(c) for c in whole.chunks[:2]]
    skipped.advance(len(first))
    for a, b in zip(later, [skipped.materialize(c)
                            for c in skipped.chunks[:2]]):
        assert_same_batch(a, b)


def test_packed_batcher_refuses_float_words():
    _, tcfg = _configs("cgcn", **{"model.use_bert_embeddings": True,
                                  "model.emb_dim": 8})
    path = os.path.join(DATA, "dev.json")
    bert = {d["id"]: np.zeros((len(d["token"]), 8), np.float32)
            for d in json.load(open(path))}
    ds = RelationDataset(path, tcfg, Vocab.load(VOCAB),
                         bert_embeddings=bert)
    with pytest.raises(ValueError, match="integer word ids"):
        PackedBatcher(ds, 2)


def packed_batch(jcfg, tcfg, evaluation=True):
    jp, tp = packers(jcfg, tcfg, "test", evaluation=evaluation)
    return next(iter(jp)), next(iter(tp)), tp


def test_segment_resets_match_jax():
    jcfg, tcfg = _configs("cgcn")
    _, tb, _ = packed_batch(jcfg, tcfg)
    rng = np.random.RandomState(0)
    seg = np.concatenate([tb["seg_start"],
                          rng.rand(3, PACK_LEN) < 0.2], axis=0)
    lengths = np.concatenate([tb["lengths"], [PACK_LEN, 0, 17]]).astype(
        np.int32)
    want = jax_lstm._segment_resets(jnp.asarray(seg), jnp.asarray(lengths))
    got = lstm_mod._segment_resets(torch.from_numpy(seg),
                                   torch.from_numpy(lengths))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the reverse resets are the length-reversed sentence ENDS
    assert not np.array_equal(got[1].numpy(), got[0].numpy())


def bilstm_layer(rng, d, h):
    return {direction: {
        "w_ih": (rng.randn(d, 4 * h) / np.sqrt(h)).astype(np.float32),
        "w_hh": (rng.randn(h, 4 * h) / np.sqrt(h)).astype(np.float32),
        "b_ih": (rng.randn(4 * h) * 0.1).astype(np.float32),
        "b_hh": (rng.randn(4 * h) * 0.1).astype(np.float32)}
        for direction in ("fwd", "bwd")}


def test_bilstm_with_seg_start_matches_jax_and_each_sentence_alone():
    """One BiLSTM layer over the packed rows: gcn_tpu's
    ``_bidirectional_pallas`` (interpret mode) within 1e-5, and every
    packed sentence's outputs, forward and reverse halves, within 1e-5 of
    the same sentence run in a row of its own."""
    jcfg, tcfg = _configs("cgcn")
    _, tb, _ = packed_batch(jcfg, tcfg)
    rng = np.random.RandomState(1)
    d, h = 12, 8
    layer = bilstm_layer(rng, d, h)
    b, n = tb["words"].shape
    x = rng.randn(b, n, d).astype(np.float32)
    lengths, seg = tb["lengths"], tb["seg_start"]
    want = jax_lstm._bidirectional_pallas(
        jnp.asarray(x), jnp.asarray(lengths),
        jax.tree.map(jnp.asarray, layer), seg_start=jnp.asarray(seg))
    tlayer = jax.tree.map(torch.from_numpy, layer)
    got = lstm_mod.bilstm([tlayer], torch.from_numpy(x),
                          torch.from_numpy(lengths), impl="pallas",
                          seg_start=torch.from_numpy(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    checked = 0
    for r in range(b):
        starts = list(np.flatnonzero(seg[r]))
        ends = starts[1:] + [int(lengths[r])]
        for s0, s1 in zip(starts, ends):
            alone = lstm_mod.bilstm(
                [tlayer], torch.from_numpy(x[r:r + 1, s0:s1]),
                torch.tensor([s1 - s0]), impl="pallas")
            np.testing.assert_allclose(got[r, s0:s1].numpy(),
                                       alone[0].numpy(), atol=1e-5, rtol=0)
            checked += 1
    assert checked > b  # rows of several sentences


@pytest.mark.parametrize("kind", ["max", "avg", "sum"])
def test_pool_slots_matches_jax(kind):
    rng = np.random.RandomState(2)
    h = rng.randn(3, 10, 5).astype(np.float32)
    ex = rng.rand(3, 4, 10) < 0.6
    ex[0, 1] = True  # an empty slot
    want = jax_pooling.pool_slots(jnp.asarray(h), jnp.asarray(ex), kind)
    got = pool_slots(torch.from_numpy(h), torch.from_numpy(ex), kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


def slot_rows(tp, chunk_index=0):
    """(flattened slot index, example index) of the chunk's sentences."""
    return [(r * tp.max_slots + si, i)
            for r, row in enumerate(tp.chunks[chunk_index])
            for si, i in enumerate(row)]


@pytest.mark.parametrize("path", sorted(PATHS))
def test_packed_forward_matches_jax_and_the_unpacked_rows(path):
    jcfg, tcfg = _configs("cgcn", **PATHS[path])
    jbatch, tbatch, tp = packed_batch(jcfg, tcfg)
    model = JaxGCN(jcfg.model)
    params = model.init({"params": jax.random.key(0),
                         "dropout": jax.random.key(1)}, jbatch, True)
    jl, jh = jax.jit(lambda p, b: model.apply(p, b, True))(params, jbatch)
    port = GCNClassifier(tcfg.model)
    port.load_state_dict(params_from_jax(jax.device_get(params)))
    valid = tbatch["example_mask"]  # an empty slot pools the -1e12 fill
    assert not valid.all()
    with torch.no_grad():
        logits, h_out = port(batch_to_device(tbatch, CPU))
        assert logits.shape == (ROWS * SLOTS, tcfg.model.num_class)
        np.testing.assert_allclose(logits.numpy()[valid],
                                   np.asarray(jl)[valid], atol=1e-4, rtol=0)
        np.testing.assert_allclose(h_out.numpy()[valid],
                                   np.asarray(jh)[valid], atol=1e-4, rtol=0)
        # the same sentences one a row
        ds = tp.ds
        unpacked = Batcher(ds, len(ds), evaluation=True)
        ul, uh = port(batch_to_device(next(iter(unpacked)), CPU))
    rows = slot_rows(tp)
    assert len(rows) > ROWS
    for at, i in rows:
        np.testing.assert_allclose(logits[at].numpy(), ul[i].numpy(),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(h_out[at].numpy(), uh[i].numpy(),
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("path", ["dense", "attention_edge"])
def test_packed_train_step_gradients_match_jax(path):
    """jax.value_and_grad of gcn_tpu's Trainer._loss on a packed training
    batch (dropout off, word dropout on) against the port's: the loss
    within 1e-5 relative, every gradient within 1e-4 of its max |grad|."""
    jcfg, tcfg = _configs("cgcn", **PATHS[path], **NO_DROPOUT,
                          **{"train.word_dropout": 0.1})
    jp, tp = packers(jcfg, tcfg, evaluation=False)
    jbatch, tbatch = next(iter(jp)), next(iter(tp))
    jt = JaxTrainer(jcfg)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jt._loss(p, jbatch, jt._key, 0)))(jt.params)
    want = params_from_jax(jax.device_get(grads))
    tt = Trainer(tcfg, params_from_jax(jax.device_get(jt.params)),
                 device="cpu")
    tl, got = tt._grads(batch_to_device(tbatch, CPU), tt.step_generator(0))
    assert abs(float(tl) - float(loss)) <= 1e-5 * abs(float(loss))
    for k, v in want.items():
        scale = max(float(v.abs().max()), 1e-30)
        assert float((got[k] - v).abs().max()) <= 1e-4 * scale, k


def test_sentence_wire_format_matches_jax_and_unpacks_exactly():
    jcfg, tcfg = _configs("cgcn")
    jbatch, tbatch, _ = packed_batch(jcfg, tcfg)
    assert packing.sentence_packable(tbatch)
    assert not packing.packable(tbatch)
    want = jax_packing.pack_sentence_batch(jbatch)
    got = packing.pack_sentence_batch(tbatch)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    n, s = tbatch["words"].shape[1], tbatch["slot_mask"].shape[1]
    assert got.shape[1] == packing.sp_width(n, s, True)
    out = np.zeros_like(got)
    packing.pack_sentence_batch(tbatch, out=out)
    np.testing.assert_array_equal(out, got)
    back = packing.unpack_sentence_batch(torch.from_numpy(got), n, s, True)
    plain = batch_to_device(tbatch, CPU)
    assert set(back) == set(plain)
    for k, v in plain.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    # a batch with a key the format does not carry does not pack
    assert not packing.sentence_packable({**tbatch, "extra": tbatch["pos"]})


def test_evaluator_packed_loss_is_the_weighted_mean():
    """``evaluate`` over packed batches (rows × slots == batch_size, so a
    row count could pass for the unpacked formula): each batch's mean loss
    weighted by its valid examples, as gcn_tpu's ``evaluate``; the same
    predictions and probabilities as gcn_tpu's."""
    jcfg, tcfg = _configs("cgcn", **{"train.batch_size": ROWS * SLOTS})
    jp, tp = packers(jcfg, tcfg, "test", evaluation=True)
    jt = JaxTrainer(jcfg)
    ev = Evaluator(tcfg, params_from_jax(jax.device_get(jt.params)),
                   device="cpu")
    preds, probs, avg = ev.evaluate(tp)
    jpreds, jprobs, javg = jt.evaluate(jp)
    assert preds == jpreds
    np.testing.assert_allclose(probs, jprobs, atol=1e-5, rtol=0)
    losses, counts = [], []
    for b in tp:
        losses.append(ev.predict_batch(b)[2])
        counts.append(int(b["example_mask"].sum()))
    weighted = float(np.dot(losses, counts)) / sum(counts)
    assert abs(avg - weighted) <= 1e-6 * abs(weighted)
    assert abs(avg - javg) <= 1e-5 * abs(javg)
    assert len(counts) > 1 and len(set(counts)) > 1  # the weights matter


PACK_ARGS = ["--pack_sentences", str(SLOTS), "--pack_len", str(PACK_LEN),
             "--batch_size", str(ROWS), "--effective_batch_size", str(ROWS)]


def test_resumed_packed_run_is_the_whole_run(tmp_path):
    """Dropout and word dropout on: 2 epochs against 1, then --resume to
    2: the same logs.txt and checkpoints, bit for bit."""
    argv = [*CLI_SMALL, *PACK_ARGS, "--cpu", "--model_save_dir",
            str(tmp_path)]
    train.main([*argv, "--num_epoch", "2", "--id", "whole"])
    train.main([*argv, "--num_epoch", "1", "--id", "split"])
    train.main([*argv, "--num_epoch", "2", "--id", "split", "--resume"])
    assert logs_rows(tmp_path / "whole") == logs_rows(tmp_path / "split")
    for name in ("checkpoint_epoch_2", "best_model"):
        want = load_checkpoint(str(tmp_path / "whole" / name))
        got = load_checkpoint(str(tmp_path / "split" / name))
        assert got[2]["meta"] == want[2]["meta"], name
        for a, b in zip(jax.tree.leaves(got[:2]), jax.tree.leaves(want[:2])):
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_packed_train_cli_matches_gcn_tpu_from_a_warm_start(tmp_path):
    """Dropout off, word dropout on (one numpy stream in both packers):
    the port's train CLI and gcn_tpu's ``run_training`` with
    ``--pack_sentences`` write logs.txt rows within 1e-4 relative and the
    same F1s."""
    argv = [*CLI_SMALL, *CLI_NO_DROPOUT, *PACK_ARGS, "--num_epoch", "2",
            "--seed", "3", "--lr", "0.3", "--pooling_l2", "0.003",
            "--load", "--model_file", str(tmp_path / "init")]
    _init_checkpoint(str(tmp_path / "init"), argv)
    out = train.main([*argv, "--cpu", "--id", "port", "--model_save_dir",
                      str(tmp_path)])
    jargs = jax_cli.build_parser("tacred").parse_args(
        [*argv, "--id", "jax", "--model_save_dir", str(tmp_path)])
    devices = jax.devices
    try:  # gcn_tpu's single-device trainer, as on a one-chip host
        jax.devices = lambda *a, **k: devices(*a, **k)[:1]
        jax_run_training(jax_cli.args_to_config(jargs),
                         load_from=jargs.model_file)
    finally:
        jax.devices = devices
    (prows, pbest), (jrows, jbest) = (logs_rows(tmp_path / "port"),
                                      logs_rows(tmp_path / "jax"))
    assert len(prows) == len(jrows) == 2
    for p, j in zip(prows, jrows):
        assert p[0] == j[0] and p[3:] == j[3:]  # epoch, dev F1s
        np.testing.assert_allclose(p[1:3], j[1:3], rtol=1e-4)
    assert pbest == jbest
    assert out["run_dir"] == str(tmp_path / "port")


def test_pack_sentences_is_accepted_and_refuses_bert_inputs(tmp_path):
    assert "pack_sentences" not in cli.UNSUPPORTED
    args = cli.build_parser("tacred").parse_args(
        [*CLI_SMALL, *PACK_ARGS, "--use_bert_embeddings", "true"])
    cli.check_supported(args)  # the flag itself passes the CLI's check
    with pytest.raises(ValueError, match="does not support BERT"):
        train.main([*CLI_SMALL, *PACK_ARGS, "--cpu", "--num_epoch", "1",
                    "--use_bert_embeddings", "true",
                    "--model_save_dir", str(tmp_path)])
