"""Records → batches, as the C-GCN reference's loader builds them: entity
tokens masked by type, tags through TACRED's tables, positions, the pruned
tree; a training split shuffled once with ``random.Random(seed)`` and cut
into batches of ``batch`` sentences, each padded to the smallest length
bucket that holds it and on the batch axis to ``batch`` rows, with
word → UNK dropout drawn per sentence from one
``numpy.random.RandomState(seed)`` (an UNK is never dropped again)."""

from __future__ import annotations

import random
from dataclasses import dataclass

import numpy as np
import torch

from portbench.reference import tacred_ids as ids
from portbench.reference.prune import prune

BUCKETS = (16, 32, 48, 64, 96, 128)


@dataclass
class Sentence:
    words: np.ndarray
    pos: np.ndarray
    ner: np.ndarray
    deprel: np.ndarray
    subj: np.ndarray      # bool, the subject's tokens
    obj: np.ndarray
    label: int
    parents: list
    children: list

    @property
    def length(self) -> int:
        return len(self.words)


def sentence(rec: dict, word2id: dict, k: int) -> Sentence:
    toks = list(rec["token"])
    ss, se, os_, oe = (rec["subj_start"], rec["subj_end"], rec["obj_start"],
                       rec["obj_end"])
    toks[ss:se + 1] = ["SUBJ-" + rec["subj_type"]] * (se - ss + 1)
    toks[os_:oe + 1] = ["OBJ-" + rec["obj_type"]] * (oe - os_ + 1)
    n = len(toks)
    subj = np.zeros(n, bool)
    subj[ss:se + 1] = True
    obj = np.zeros(n, bool)
    obj[os_:oe + 1] = True
    head = [int(h) for h in rec["stanford_head"]]
    parents, children = prune(head, list(range(ss, se + 1)),
                              list(range(os_, oe + 1)), k)

    def table(names, tab):
        return np.asarray([tab.get(x, ids.UNK_ID) for x in names], np.int64)

    return Sentence(
        words=table(toks, word2id), pos=table(rec["stanford_pos"],
                                              ids.POS_TO_ID),
        ner=table(rec["stanford_ner"], ids.NER_TO_ID),
        deprel=table(rec["stanford_deprel"], ids.DEPREL_TO_ID),
        subj=subj, obj=obj, label=ids.LABEL_TO_ID[rec["relation"]],
        parents=parents, children=children)


def train_chunks(n: int, batch: int, seed: int) -> list[list[int]]:
    order = list(range(n))
    random.Random(seed).shuffle(order)
    return [order[i:i + batch] for i in range(0, n, batch)]


def file_chunks(n: int, batch: int) -> list[list[int]]:
    return [list(range(i, min(n, i + batch))) for i in range(0, n, batch)]


def word_dropout(sents: list[Sentence], rate: float,
                 rng: np.random.RandomState) -> list[np.ndarray]:
    """Each sentence's words after dropout, drawn in order."""
    out = []
    for s in sents:
        drop = (rng.random_sample(s.length) < rate) & (s.words != ids.UNK_ID)
        out.append(np.where(drop, ids.UNK_ID, s.words))
    return out


def bucket(n: int) -> int:
    return next((b for b in BUCKETS if n <= b), n)


def batch(sents: list[Sentence], words: list[np.ndarray], rows: int,
          device) -> dict:
    """One padded batch as tensors on ``device``: ids, masks, lengths,
    labels and the forward adjacency counts ``adj[b, parent, child]``."""
    n = bucket(max(s.length for s in sents))
    out = {k: np.zeros((rows, n), np.int64)
           for k in ("words", "pos", "ner", "deprel")}
    subj = np.zeros((rows, n), bool)
    obj = np.zeros((rows, n), bool)
    lengths = np.zeros(rows, np.int64)
    labels = np.zeros(rows, np.int64)
    valid = np.zeros(rows, bool)
    adj = np.zeros((rows, n, n), np.float32)
    for b, (s, w) in enumerate(zip(sents, words)):
        L = s.length
        out["words"][b, :L] = w
        out["pos"][b, :L] = s.pos
        out["ner"][b, :L] = s.ner
        out["deprel"][b, :L] = s.deprel
        subj[b, :L] = s.subj
        obj[b, :L] = s.obj
        lengths[b] = L
        labels[b] = s.label
        valid[b] = True
        np.add.at(adj[b], (np.asarray(s.parents, np.int64),
                           np.asarray(s.children, np.int64)), 1.0)
    t = {k: torch.from_numpy(v).to(device) for k, v in out.items()}
    t.update(subj=torch.from_numpy(subj).to(device),
             obj=torch.from_numpy(obj).to(device),
             lengths=torch.from_numpy(lengths).to(device),
             labels=torch.from_numpy(labels).to(device),
             valid=torch.from_numpy(valid).to(device),
             adj=torch.from_numpy(adj).to(device))
    return t
