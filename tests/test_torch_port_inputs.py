"""The port's SemEval inputs and precomputed (BERT) word vectors against the
JAX package, on the CPU.

* The port's ``RelationDataset`` + ``Batcher`` give JAX's arrays bit for
  bit on the in-repo ``dataset/semeval/{train,test}.json`` with
  ``dataset/vocab_semeval`` (no anonymization, no ``ner``, SemEval's tag
  and label tables) and on TACRED with a seeded id → ``[L, D]`` dict
  (float ``[B, N, D]`` words, zero-padded, no word dropout), for the
  evaluation batcher and the training batcher of a seed.
* The torch-reference golden ``model_bert_rnn.npz`` at atol 2e-5 / rtol
  1e-4 on logits and pooled, both ways of ``use_pallas``.
* A narrow C-GCN on each input against ``gcn_tpu``'s on the same flax
  parameters: logits and ``h_out`` within 1e-4 absolute, and 5 steps of
  ``Trainer.update`` (model dropout rates 0, the batches' word dropout on
  for SemEval) with losses within 1e-4 relative and parameters within 1e-4
  of max(1, max |p|).
* ``anonymize`` / ``normalize_tokens`` equal the originals; a BERT tree
  (no ``word_emb``) round-trips through ``convert``; the trainer refuses a
  word matrix for a model without a word table.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from gcn_tpu import config as jax_config
from gcn_tpu.data import bert as jax_bert
from gcn_tpu.data.dataset import Batcher as JaxBatcher
from gcn_tpu.data.dataset import RelationDataset as JaxDataset
from gcn_tpu.data.vocab import Vocab as JaxVocab
from gcn_tpu.models.gcn import GCNClassifier as JaxGCN
from gcn_tpu.train.trainer import Trainer as JaxTrainer
from gcn_tpu_torch import config, constants_semeval
from gcn_tpu_torch.convert import params_from_jax, params_to_jax
from gcn_tpu_torch.data import bert
from gcn_tpu_torch.data.dataset import Batcher, RelationDataset
from gcn_tpu_torch.data.vocab import Vocab
from gcn_tpu_torch.models.gcn import GCNClassifier
from gcn_tpu_torch.train.evaluator import batch_to_device
from gcn_tpu_torch.train.trainer import Trainer
from tests.test_torch_port_cuda import one_torch_thread  # noqa: F401
from tests.test_torch_port_diagonal import _golden_model
from tests.test_torch_port_model import DATA, REPO, SMALL, VOCAB
from tests.test_torch_port_train import NO_DROPOUT, _params_close

ATOL = 1e-4
SEMEVAL_DATA = os.path.join(REPO, "dataset", "semeval")
SEMEVAL_VOCAB = os.path.join(REPO, "dataset", "vocab_semeval", "vocab.pkl")
INPUTS = {  # each input's overrides, data directory and vocabulary
    "semeval": ({"model.dataset": "semeval", "model.num_class": 10},
                SEMEVAL_DATA, SEMEVAL_VOCAB),
    "bert": ({"model.use_bert_embeddings": True}, DATA, VOCAB),
}


def bert_embeddings(path, dim, seed=0):
    """A seeded id → [L, dim] f32 dict over the records of ``path``, as
    ``gcn_tpu.data.bert.extract_embeddings`` would write one."""
    rng = np.random.RandomState(seed)
    with open(path) as f:
        return {d["id"]: rng.randn(len(d["token"]), dim).astype(np.float32)
                for d in json.load(f)}


def _configs(kind, **extra):
    overrides, _, vocab = INPUTS[kind]
    ov = {**SMALL, **overrides, **extra}
    jcfg, tcfg = jax_config.cgcn_preset(**ov), config.cgcn_preset(**ov)
    jcfg.model.vocab_size = tcfg.model.vocab_size = Vocab.load(vocab).size
    return jcfg, tcfg


def _loaders(kind, jcfg, tcfg, split, evaluation, seed=0):
    _, data_dir, vocab = INPUTS[kind]
    path = os.path.join(data_dir, f"{split}.json")
    emb = (bert_embeddings(path, tcfg.model.emb_dim) if kind == "bert"
           else None)
    jds = JaxDataset(path, jcfg, JaxVocab.load(vocab), evaluation=evaluation,
                     bert_embeddings=emb)
    tds = RelationDataset(path, tcfg, Vocab.load(vocab), bert_embeddings=emb)
    kw = {"evaluation": True} if evaluation else {"seed": seed}
    return JaxBatcher(jds, 8, **kw), Batcher(tds, 8, **kw)


@pytest.mark.parametrize("evaluation", [True, False])
@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("kind", sorted(INPUTS))
def test_loaders_give_equal_batches(kind, split, evaluation):
    jcfg, tcfg = _configs(kind)
    assert tcfg.train.word_dropout > 0
    jb, tb = _loaders(kind, jcfg, tcfg, split, evaluation, seed=7)
    assert jb.gold() == tb.gold()
    assert len(jb) == len(tb)
    for _ in range(1 if evaluation else 2):  # word dropout anew an epoch
        for a, b in zip(jb, tb):
            assert set(a) == set(b)
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    if kind == "semeval":
        assert "ner" not in b
        assert set(tb.gold()) <= set(constants_semeval.LABEL_TO_ID)
        # not anonymized: every sentence's ids are its own tokens'
        with open(os.path.join(SEMEVAL_DATA, f"{split}.json")) as f:
            records = json.load(f)
        lower = tcfg.train.lower
        for d, ex in zip(records, tb.ds.examples):
            tokens = [t.lower() if lower else t for t in d["token"]]
            assert ex.words.tolist() == tb.ds.vocab.map(tokens)
    else:
        assert b["words"].dtype == np.float32 and b["words"].ndim == 3
        assert batch_to_device(b, torch.device("cpu"))["words"].dtype == \
            torch.float32
        rows = ~b["pad_mask"]
        assert np.all(b["words"][~rows] == 0)
        # no word dropout on float words: each row is its sentence's own
        ds = tb.ds
        for i, idx in enumerate(tb.chunks[-1]):
            length = ds.examples[idx].length
            np.testing.assert_array_equal(b["words"][i, :length],
                                          ds.examples[idx].words)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_bert_golden(use_pallas):
    z, model, batch = _golden_model("model_bert_rnn", use_pallas)
    assert model.cfg.use_bert_embeddings and batch["words"].dim() == 3
    assert not hasattr(model, "word_emb")
    with torch.no_grad():
        logits, pooled = model(batch)
    np.testing.assert_allclose(pooled.numpy(), z["out.pooled"], atol=2e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(logits.numpy(), z["out.logits"], atol=2e-5,
                               rtol=1e-4)


def _jax_and_port(kind, **extra):
    jcfg, tcfg = _configs(kind, **extra)
    jb, tb = _loaders(kind, jcfg, tcfg, "test", evaluation=True)
    jbatch, tbatch = next(iter(jb)), next(iter(tb))
    model = JaxGCN(jcfg.model)
    params = model.init({"params": jax.random.key(0),
                         "dropout": jax.random.key(1)}, jbatch, True)
    port = GCNClassifier(tcfg.model)
    port.load_state_dict(params_from_jax(jax.device_get(params)))
    return model, params, jbatch, port, tbatch


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("kind", sorted(INPUTS))
def test_forward_matches_jax(kind, use_pallas):
    model, params, jbatch, port, tbatch = _jax_and_port(
        kind, **{"model.use_pallas": use_pallas})
    logits, h_out = jax.jit(lambda p, b: model.apply(p, b, True))(params,
                                                                  jbatch)
    with torch.no_grad():
        tl, th = port(batch_to_device(tbatch, torch.device("cpu")))
    assert tl.shape == (8, port.cfg.num_class)
    np.testing.assert_allclose(tl.numpy(), np.asarray(logits), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(th.numpy(), np.asarray(h_out), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("kind", sorted(INPUTS))
def test_parameters_match_the_flax_tree(kind):
    """SemEval: a 48-row POS table and no NER table; BERT: no word table,
    the BiLSTM's input as wide as the float words; the tree round-trips
    through ``convert``."""
    _, params, _, port, _ = _jax_and_port(kind)
    tree = jax.device_get(params)
    state = port.state_dict()
    assert set(state) == set(params_from_jax(tree))
    cfg = port.cfg
    if kind == "semeval":
        assert state["pos_emb"].shape == (48, cfg.pos_dim)
        assert "word_emb" in state and "ner_emb" not in state
    else:
        assert "word_emb" not in state and "ner_emb" in state
        assert state["rnn.l0_fwd_w_ih"].shape[0] == cfg.input_dim == (
            cfg.emb_dim + cfg.pos_dim + cfg.ner_dim)
    back = params_to_jax(state)
    flat = params_from_jax(back)
    assert set(back["params"]) == set(tree["params"])
    for k, v in params_from_jax(tree).items():
        assert torch.equal(flat[k], v), k


@pytest.mark.parametrize("kind", sorted(INPUTS))
def test_trainer_trajectory_matches_jax(kind):
    jcfg, tcfg = _configs(kind, **NO_DROPOUT, **{
        "model.rnn_impl": "auto", "model.deprel_factored": "auto",
        "train.effective_batch_size": 8})
    jt = JaxTrainer(jcfg)
    tt = Trainer(tcfg, params_from_jax(jax.device_get(jt.params)),
                 device="cpu")
    jb, tb = _loaders(kind, jcfg, tcfg, "train", evaluation=False, seed=3)
    for i, (a, b) in enumerate(zip(jb, tb)):
        want, got = float(jt.update(a)), float(tt.update(b))
        assert got == pytest.approx(want, rel=1e-4), i
    assert tt.global_step == jt.global_step == 5
    _params_close(tt, jt.params)


def test_trainer_refuses_a_word_matrix_without_a_word_table():
    _, tcfg = _configs("bert")
    with pytest.raises(ValueError, match="no word table"):
        Trainer(tcfg, emb_matrix=np.zeros((tcfg.model.vocab_size,
                                           tcfg.model.emb_dim)),
                device="cpu")


def test_bert_model_refuses_word_ids():
    _, tcfg = _configs("bert")
    model = GCNClassifier(tcfg.model)
    with pytest.raises(ValueError, match="float words"):
        model({"words": torch.ones(2, 5, dtype=torch.long)})


def test_token_preprocessing_matches_the_original():
    with open(os.path.join(DATA, "train.json")) as f:
        records = json.load(f)
    for d in records:
        d = dict(d, token=["-LRB-"] + d["token"][1:-1] + ["-RSB-"])
        assert bert.anonymize(d) == jax_bert.anonymize(d)
        assert bert.normalize_tokens(d["token"]) == \
            jax_bert.normalize_tokens(d["token"])
    assert bert.BRACKET_MAP == jax_bert.BRACKET_MAP

