"""The port's packed batch transfer against gcn_tpu's, on the CPU.

* ``pack_batch`` and ``pack_batch_compact`` write gcn_tpu's bytes for the
  same batch: TACRED batches (with NER), SemEval batches (without), and
  values that need the wide fields (word ids past 2**16, edge indices past
  2**8, lengths past 2**16), also when they pack into a given buffer.
* ``packable`` says what gcn_tpu's says: float (BERT) words, extra or
  missing keys, and arrays that are not numpy.
* ``unpack_batch`` gives back exactly ``batch_to_device``'s dict (keys,
  dtypes, values) for both formats, and values out of a narrow field's
  range raise in both packages.
"""

import os

import numpy as np
import pytest
import torch

from gcn_tpu.data import packing as jax_packing
from gcn_tpu_torch.config import cgcn_preset
from gcn_tpu_torch.data import packing
from gcn_tpu_torch.data.dataset import Batcher, RelationDataset
from gcn_tpu_torch.data.vocab import Vocab
from gcn_tpu_torch.train.evaluator import batch_to_device
from tests.test_torch_port_cuda import one_torch_thread  # noqa: F401
from tests.test_torch_port_model import DATA, REPO, VOCAB

SEMEVAL = os.path.join(REPO, "dataset", "semeval")
SEMEVAL_VOCAB = os.path.join(REPO, "dataset", "vocab_semeval", "vocab.pkl")
PACKERS = {"compact": (packing.pack_batch_compact,
                       jax_packing.pack_batch_compact),
           "int32": (packing.pack_batch, jax_packing.pack_batch)}


def loader_batches(kind: str) -> list[dict]:
    """Every training batch (word dropout on) of the in-repo split."""
    if kind == "tacred":
        cfg = cgcn_preset(**{"model.vocab_size": Vocab.load(VOCAB).size})
        ds = RelationDataset(os.path.join(DATA, "train.json"), cfg,
                             Vocab.load(VOCAB))
    else:
        cfg = cgcn_preset(**{"model.dataset": "semeval",
                             "model.num_class": 10})
        ds = RelationDataset(os.path.join(SEMEVAL, "train.json"), cfg,
                             Vocab.load(SEMEVAL_VOCAB))
    return list(Batcher(ds, 8, seed=1))


def wide_batch(b=3, n=300) -> dict:
    """Values at the top of every field's wire width."""
    rng = np.random.RandomState(7)
    lengths = np.array([n, 70000, 1], np.int32)[:b]
    return {
        "words": rng.randint(0, 2**31 - 1, (b, n)).astype(np.int32),
        "pos": np.full((b, n), 255, np.int32),
        "ner": rng.randint(0, 256, (b, n)).astype(np.int32),
        "deprel": rng.randint(0, 256, (b, n)).astype(np.int32),
        "edge_parent": rng.randint(0, 65536, (b, n)).astype(np.int32),
        "edge_child": np.full((b, n), 65535, np.int32),
        "edge_deprel": rng.randint(0, 256, (b, n)).astype(np.int32),
        "edge_mask": rng.rand(b, n) < 0.5,
        "subj_mask": rng.rand(b, n) < 0.1,
        "obj_mask": rng.rand(b, n) < 0.1,
        "pad_mask": rng.rand(b, n) < 0.3,
        "lengths": lengths,
        "labels": np.array([41, 0, 2**20], np.int32)[:b],
        "example_mask": np.array([True, False, True])[:b],
    }


def cases(kind: str) -> list[dict]:
    return [wide_batch()] if kind == "wide" else loader_batches(kind)


@pytest.mark.parametrize("fmt", sorted(PACKERS))
@pytest.mark.parametrize("kind", ["tacred", "semeval", "wide"])
def test_packers_write_gcn_tpus_bytes(kind, fmt):
    mine, theirs = PACKERS[fmt]
    for batch in cases(kind):
        assert packing.packable(batch) and jax_packing.packable(batch)
        want = theirs(batch)
        got = mine(batch)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
        assert got.shape[1] == packing.packed_width(
            batch["words"].shape[1], "ner" in batch, fmt)
        out = np.full_like(want, 77)
        assert mine(batch, out=out) is out
        assert out.tobytes() == want.tobytes()


def test_packable_agrees_with_gcn_tpu():
    base = loader_batches("tacred")[0]
    semeval = loader_batches("semeval")[0]
    bert = dict(base, words=np.zeros(base["words"].shape + (16,),
                                      np.float32))
    extra = dict(base, hplan_rows=np.zeros((8, 4), np.int32))
    missing = {k: v for k, v in base.items() if k != "pad_mask"}
    torch_words = dict(base, words=torch.from_numpy(base["words"]))
    odd_width = dict(base, pos=base["pos"][:, :-1])
    for batch, want in ((base, True), (semeval, True), (bert, False),
                        (extra, False), (missing, False),
                        (torch_words, False), (odd_width, False)):
        assert packing.packable(batch) == jax_packing.packable(batch) \
            == want


@pytest.mark.parametrize("fmt", sorted(PACKERS))
@pytest.mark.parametrize("kind", ["tacred", "semeval", "wide"])
def test_unpack_gives_batch_to_devices_dict(kind, fmt):
    mine, _ = PACKERS[fmt]
    for batch in cases(kind):
        got = packing.unpack_batch(torch.from_numpy(mine(batch)),
                                   "ner" in batch)
        want = batch_to_device(batch, torch.device("cpu"))
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype, k
            assert torch.equal(got[k], v), k


@pytest.mark.parametrize("field,value", [("pos", -1), ("deprel", 256),
                                         ("edge_parent", 65536),
                                         ("edge_child", -1)])
def test_narrow_fields_refuse_what_does_not_fit(field, value):
    batch = wide_batch()
    batch[field] = batch[field].copy()
    batch[field][1, 3] = value
    with pytest.raises(ValueError, match=field):
        jax_packing.pack_batch_compact(batch)
    with pytest.raises(ValueError, match=field):
        packing.pack_batch_compact(batch)


@pytest.mark.parametrize("field,value", [(None, None), ("pos", -1),
                                         ("deprel", 256),
                                         ("edge_parent", 65536)])
def test_staging_widens_what_compact_cannot_hold(monkeypatch, field, value):
    """``pack_format="compact"``: a batch (or a stack) with a value past a
    narrow field's width crosses as int32 instead of raising, and arrives
    as ``batch_to_device``'s dict; the others cross compact."""
    from gcn_tpu_torch.train import transfer

    monkeypatch.setattr(transfer.PinnedRing, "take", lambda self, nbytes: (
        0, torch.empty(nbytes, dtype=torch.uint8)))
    monkeypatch.setattr(transfer.PinnedRing, "release",
                        lambda self, slot: None)
    batch = wide_batch()
    if field is not None:
        batch[field] = batch[field].copy()
        batch[field][1, 3] = value
    staging = transfer.Staging(torch.device("cpu"), True, "compact", 1)
    stack = [wide_batch(), batch]
    sig = staging.signature(stack)
    assert sig[1] == ("compact" if field is None else "int32")
    static = staging.allocate(stack)
    staging.send(stack, static)
    assert staging.copies == 1
    for i, b in enumerate(stack):
        got = staging.device_batch(static, i)
        want = batch_to_device(b, torch.device("cpu"))
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
