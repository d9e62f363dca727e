"""The port's C-GCN evaluation slice against the JAX package end to end.

One small C-GCN (``cgcn_preset`` with narrow widths, ``rnn_impl="pallas"``,
``deprel_factored="pallas"``; the Pallas kernels run in interpret mode on
the CPU) is initialised by flax, carried across with
``convert.params_from_jax`` and fed the same ``dataset/tacred/test.json``
batch built by both loaders.  Tolerance: 1e-4 absolute on logits and
``h_out`` in f32 (BiLSTM, two or three GCN layers and the MLP, each summed
in another order than XLA's).

Also here: the loaders agree, ``Evaluator.evaluate`` agrees with
``Trainer.evaluate``, the copied modules agree with their originals, the
port imports nothing of JAX or gcn_tpu, and its entry point refuses to run
without a card unless asked for the CPU.
"""

import ast
import dataclasses
import io
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from gcn_tpu import config as jax_config
from gcn_tpu import constants as jax_constants
from gcn_tpu import constants_semeval as jax_constants_semeval
from gcn_tpu.data.dataset import Batcher as JaxBatcher
from gcn_tpu.data.dataset import RelationDataset as JaxDataset
from gcn_tpu.data.vocab import Vocab as JaxVocab
from gcn_tpu.models.gcn import GCNClassifier as JaxGCN
from gcn_tpu.train import scorer as jax_scorer
from gcn_tpu.train.trainer import Trainer
from gcn_tpu_torch import config, constants, constants_semeval
from gcn_tpu_torch.convert import params_from_jax
from gcn_tpu_torch.data.dataset import Batcher, RelationDataset
from gcn_tpu_torch.data.vocab import Vocab
from gcn_tpu_torch.models.gcn import GCNClassifier, init_params
from gcn_tpu_torch.train import scorer
from gcn_tpu_torch.train.evaluator import Evaluator, batch_to_device
from tests.test_torch_port_cuda import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "dataset", "tacred")
VOCAB = os.path.join(REPO, "dataset", "vocab", "vocab.pkl")
ATOL = 1e-4

SMALL = {"model.emb_dim": 16, "model.pos_dim": 4, "model.ner_dim": 4,
         "model.hidden_dim": 16, "model.rnn_hidden": 8,
         "model.deprel_emb_dim": 6, "model.rnn_impl": "pallas",
         "model.deprel_factored": "pallas", "train.batch_size": 8}
VARIANTS = {
    "two_layers": {},
    "past_max_depth": {"model.num_layers": 3},  # layer 2: all-ones row
    "directed_avg": {"model.deprel_directed": True, "model.pooling": "avg"},
    "no_self_loop_sum": {"model.deprel_self_loop": False,
                         "model.pooling": "sum"},
}


def _configs(**extra):
    ov = {**SMALL, **extra}
    jcfg, tcfg = jax_config.cgcn_preset(**ov), config.cgcn_preset(**ov)
    jcfg.model.vocab_size = tcfg.model.vocab_size = Vocab.load(VOCAB).size
    return jcfg, tcfg


def _batches(jcfg, tcfg, split="test", bs=8):
    jds = JaxDataset(os.path.join(DATA, f"{split}.json"), jcfg,
                     JaxVocab.load(VOCAB), evaluation=True)
    tds = RelationDataset(os.path.join(DATA, f"{split}.json"), tcfg,
                          Vocab.load(VOCAB))
    return (JaxBatcher(jds, bs, evaluation=True),
            Batcher(tds, bs, evaluation=True))


@pytest.mark.parametrize("split", ["train", "dev", "test"])
def test_loaders_give_equal_batches(split):
    jcfg, tcfg = _configs()
    jb, tb = _batches(jcfg, tcfg, split)
    assert jb.gold() == tb.gold()
    assert len(jb) == len(tb)
    for a, b in zip(jb, tb):
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_matches_jax(variant):
    jcfg, tcfg = _configs(**VARIANTS[variant])
    jb, tb = _batches(jcfg, tcfg)
    jbatch, tbatch = next(iter(jb)), next(iter(tb))
    model = JaxGCN(jcfg.model)
    params = model.init({"params": jax.random.key(0),
                         "dropout": jax.random.key(1)}, jbatch, True)
    logits, h_out = jax.jit(lambda p, b: model.apply(p, b, True))(params,
                                                                  jbatch)
    port = GCNClassifier(tcfg.model)
    port.load_state_dict(params_from_jax(jax.device_get(params)))
    with torch.no_grad():
        tl, th = port(batch_to_device(tbatch, torch.device("cpu")))
    assert tl.shape == (8, 42) and th.shape == (8, 16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(logits), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(th.numpy(), np.asarray(h_out), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("batch_size", [8, 7])
def test_evaluator_matches_trainer(batch_size):
    """Same predictions and loss; batch 7 takes the off-size weighting."""
    jcfg, tcfg = _configs(**{"train.batch_size": 8})
    jb, tb = _batches(jcfg, tcfg, "dev", bs=batch_size)
    trainer = Trainer(jcfg)
    ev = Evaluator(tcfg, params_from_jax(jax.device_get(trainer.params)),
                   device="cpu")
    jp, jprobs, jloss = trainer.evaluate(jb)
    tp, tprobs, tloss = ev.evaluate(tb)
    assert tp == jp
    np.testing.assert_allclose(np.asarray(tprobs), np.asarray(jprobs),
                               atol=1e-5)
    assert tloss == pytest.approx(jloss, rel=1e-5)
    preds, probs, loss = ev.predict_batch(next(iter(tb)))
    assert len(preds) == len(probs) == batch_size


def test_init_params_match_jax_distributions():
    _, tcfg = _configs()
    model = GCNClassifier(tcfg.model)
    init_params(model, torch.Generator().manual_seed(0))
    assert torch.all(model.word_emb[0] == 0)
    assert torch.all(model.deprel_emb[0] == 0)
    bound = 1.0 / np.sqrt(tcfg.model.rnn_hidden)
    with torch.no_grad():
        assert float(model.rnn.l0_fwd_w_hh.abs().max()) <= bound
        assert float(model.gcn_deprel_w1.abs().max()) <= 1.0 / np.sqrt(16)
    again = GCNClassifier(tcfg.model)
    init_params(again, torch.Generator().manual_seed(0))
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              again.state_dict().items()):
        assert torch.equal(a, b), k


def test_unsupported_modes_raise():
    for ov in ({"model.compute_dtype": "bfloat16"},
               {"model.graph_partition": "edges"},
               {"model.graph_partition": "halo"}):
        _, tcfg = _configs(**ov)
        with pytest.raises(NotImplementedError):
            GCNClassifier(tcfg.model)


def test_copied_modules_match_originals():
    assert dataclasses.asdict(config.cgcn_preset()) == dataclasses.asdict(
        jax_config.cgcn_preset())
    for name in ("DEPREL_TO_ID", "POS_TO_ID", "NER_TO_ID", "LABEL_TO_ID",
                 "SUBJ_NER_TO_ID", "OBJ_NER_TO_ID"):
        assert getattr(constants, name) == getattr(jax_constants, name)
    assert constants.DEPREL_FORWARD_BOUND == 42
    assert constants.SELF_LOOP_INDEX == 84
    for name in ("DEPREL_TO_ID", "POS_TO_ID", "NER_TO_ID", "LABEL_TO_ID",
                 "ID_TO_LABEL", "SUBJ_NER_TO_ID", "OBJ_NER_TO_ID",
                 "VOCAB_PREFIX", "NEGATIVE_LABEL", "NUM_DEPREL", "NUM_POS",
                 "NUM_CLASS", "PAD_ID", "UNK_ID", "PAD_TOKEN", "UNK_TOKEN",
                 "EMB_INIT_RANGE", "INFINITY_NUMBER"):
        assert getattr(constants_semeval, name) == getattr(
            jax_constants_semeval, name), name
    assert constants_semeval.POS_TO_ID["pad"] == 47
    assert len(constants_semeval.DEPREL_TO_ID) == 42
    assert constants_semeval.NEGATIVE_LABEL == "Other"
    rng = np.random.RandomState(0)
    labels = list(constants.LABEL_TO_ID)
    gold = [labels[i] for i in rng.randint(0, 5, 200)]
    pred = [labels[i] for i in rng.randint(0, 5, 200)]
    assert scorer.score(gold, pred, out=io.StringIO()) == \
        jax_scorer.score(gold, pred, out=io.StringIO())


def _port_sources():
    pkg = os.path.join(REPO, "gcn_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_nothing_of_jax_or_gcn_tpu():
    banned = ("jax", "flax", "optax", "gcn_tpu")
    bad = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in banned:
                    bad.append(f"{os.path.relpath(path, REPO)}: {name}")
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = ("import sys, chip_smoke, gcn_tpu_torch.train.evaluator, "
            "gcn_tpu_torch.convert, gcn_tpu_torch.data.dataset, "
            "gcn_tpu_torch.ops.sddmm, gcn_tpu_torch.ops.deprel_bilinear; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'gcn_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True).stdout
    assert out.strip() == "[]"


def test_port_never_loads_the_native_builder():
    for path in _port_sources():
        with open(path) as f:
            text = f.read()
        assert "libgraphbuilder" not in text and "native/" not in text, path


def test_library_name_covers_every_included_header(tmp_path, monkeypatch):
    """Each source's ``#include "..."`` names a shared ``csrc/*.cuh``, and
    editing that header renames the library, so a build never loads one
    made from an older header."""
    from gcn_tpu_torch.ops import _cuda

    for src in _cuda.CSRC.glob("*.cu"):
        for line in src.read_text().splitlines():
            if line.startswith('#include "'):
                header = line.split('"')[1]
                assert header.endswith(".cuh"), (src.name, header)
                assert (_cuda.CSRC / header).exists(), (src.name, header)
    for f in ("band_aggregate.cu", "edge_gather.cuh"):
        (tmp_path / f).write_bytes((_cuda.CSRC / f).read_bytes())
    monkeypatch.setattr(_cuda, "CSRC", tmp_path)
    kernel = _cuda.CudaKernel("band_aggregate.cu", {})
    before = kernel.lib_path()
    with open(tmp_path / "edge_gather.cuh", "a") as f:
        f.write("// edited\n")
    assert kernel.lib_path() != before


def test_entry_point_needs_a_card_unless_asked_for_the_cpu():
    _, tcfg = _configs()
    state = GCNClassifier(tcfg.model).state_dict()
    ev = Evaluator(tcfg, state, device="cpu")
    assert next(ev.model.parameters()).device.type == "cpu"
    if torch.cuda.is_available():
        assert Evaluator(tcfg, state).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Evaluator(tcfg, state)
