"""Vocabulary handling and GloVe embedding construction (a copy of
``gcn_tpu.data.vocab``, so that the port imports nothing of gcn_tpu).

File-format compatible with the reference (``utils/vocab.py``): ``vocab.pkl``
is a pickled ``list[str]`` (id→word) and ``embedding.npy`` a ``[V, dim]``
float array, so vocabularies prepared for the reference drop straight into
this framework and vice versa.
"""

from __future__ import annotations

import os
import pickle
from typing import Iterable

import numpy as np

from gcn_tpu_torch import constants


def load_glove_vocab(path: str, wv_dim: int) -> set:
    """All tokens present in a GloVe text file (reference
    ``utils/vocab.py:30-40``).

    Tokens may themselves contain spaces in GloVe 840B, hence the join of
    all fields except the trailing ``wv_dim`` floats.
    """
    vocab = set()
    with open(path, encoding="utf8") as f:
        for line in f:
            elems = line.split()
            vocab.add("".join(elems[0:-wv_dim]))
    return vocab


def build_embedding(
    wv_file: str, vocab: list[str], wv_dim: int, seed: int | None = None
) -> np.ndarray:
    """GloVe rows for in-vocab words, uniform(-1,1) for OOV, zeros for PAD
    (reference ``utils/vocab.py:16-28``)."""
    rng = np.random if seed is None else np.random.RandomState(seed)
    emb = rng.uniform(-1, 1, (len(vocab), wv_dim))
    emb[constants.PAD_ID] = 0.0
    w2id = {w: i for i, w in enumerate(vocab)}
    with open(wv_file, encoding="utf8") as f:
        for line in f:
            elems = line.split()
            token = "".join(elems[0:-wv_dim])
            if token in w2id:
                emb[w2id[token]] = [float(v) for v in elems[-wv_dim:]]
    return emb


class Vocab:
    """Word↔id mapping with reference-compatible pickle IO
    (``utils/vocab.py:42-99``)."""

    def __init__(self, id2word: list[str]):
        self.id2word = list(id2word)
        self.word2id = {w: i for i, w in enumerate(self.id2word)}
        self.size = len(self.id2word)

    @classmethod
    def load(cls, filename: str) -> "Vocab":
        with open(filename, "rb") as f:
            return cls(pickle.load(f))

    @classmethod
    def from_counter(cls, word_counter: dict, threshold: int = 0) -> "Vocab":
        wc = dict(word_counter)
        if threshold > 1:
            wc = {k: v for k, v in wc.items() if v >= threshold}
        id2word = constants.VOCAB_PREFIX + sorted(wc, key=wc.get, reverse=True)
        return cls(id2word)

    def save(self, filename: str) -> None:
        os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
        with open(filename, "wb") as f:
            pickle.dump(self.id2word, f)

    def map(self, tokens: Iterable[str]) -> list[int]:
        w2id = self.word2id
        return [w2id.get(t, constants.UNK_ID) for t in tokens]

    def unmap(self, ids: Iterable[int]) -> list[str]:
        return [self.id2word[i] for i in ids]


def map_to_ids(tokens: Iterable[str], table: dict) -> list[int]:
    """Token→id with UNK fallback (reference ``data/loader.py:158-160``)."""
    return [table.get(t, constants.UNK_ID) for t in tokens]
