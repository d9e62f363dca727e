"""TACRED / SemEval loading and static-shape batching.

Counterpart of ``gcn_tpu.data.dataset`` (``RelationDataset`` and the
unpacked ``Batcher``), giving the same numpy batch dicts:

* JSON → id arrays once at load (entity anonymization for TACRED, position
  sequences), through the dataset's own tag and label tables
  (``constants_for``); with ``bert_embeddings`` each sentence's words are
  its float ``[L, D]`` rows instead of ids,
* dependency trees pruned once per example by ``graph.prune`` in
  Python/numpy (the port never loads the native graph builder),
* batches padded to the smallest length bucket ≥ their longest sentence,
  and on the batch axis with an ``example_mask``.

Training batches follow the JAX ``Batcher`` bit for bit: one
``random.Random(seed)`` shuffle at construction, an optional stable sort by
length bucket, fixed chunks every epoch, and word→UNK dropout re-drawn at
every materialization from one ``np.random.RandomState(seed)`` in the same
call order (never re-dropping an UNK; float words are never dropped).
Evaluation batches keep file order and drop no words.  Only TACRED
batches carry ``ner``.  Cross-sentence packing is not ported yet.
"""

from __future__ import annotations

import json
import random
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from gcn_tpu_torch import constants, constants_semeval
from gcn_tpu_torch.config import Config
from gcn_tpu_torch.data.vocab import Vocab, map_to_ids
from gcn_tpu_torch.graph.prune import PrunedGraph, prune_graph


def get_positions(start_idx: int, end_idx: int, length: int) -> list[int]:
    """Entity-relative positions: negative before the span, 0 inside,
    positive after."""
    return (
        list(range(-start_idx, 0))
        + [0] * (end_idx - start_idx + 1)
        + list(range(1, length - end_idx))
    )


def constants_for(dataset: str):
    """The tag and label tables of ``dataset`` ("tacred" or "semeval")."""
    return constants if dataset == "tacred" else constants_semeval


@dataclass
class Example:
    words: np.ndarray          # [L] int32 token ids, or [L, D] f32 (BERT)
    pos: np.ndarray            # [L] int32
    ner: Optional[np.ndarray]  # [L] int32 (TACRED only)
    deprel: np.ndarray         # [L] int32
    subj_pos: np.ndarray       # [L] int32
    obj_pos: np.ndarray        # [L] int32
    relation: int
    graph: PrunedGraph

    @property
    def length(self) -> int:
        return int(self.pos.shape[0])


class RelationDataset:
    """Load and preprocess a TACRED or SemEval JSON file, pruning every
    tree once.  ``bert_embeddings`` maps each example's ``id`` to its
    ``[L, D]`` float rows, which then stand in for the word ids."""

    def __init__(self, filename: str, cfg: Config, vocab: Vocab,
                 bert_embeddings: Optional[dict] = None):
        self.cfg = cfg
        self.vocab = vocab
        self.dataset = cfg.model.dataset
        self.C = constants_for(self.dataset)
        self.bert_embeddings = bert_embeddings
        self.label2id = self.C.LABEL_TO_ID
        self.id2label = {v: k for k, v in self.label2id.items()}
        with open(filename) as f:
            self.examples = [self._preprocess(d) for d in json.load(f)]

    def _preprocess(self, d: dict) -> Example:
        C = self.C
        tokens = list(d["token"])
        if self.cfg.train.lower:
            tokens = [t.lower() for t in tokens]
        ss, se = d["subj_start"], d["subj_end"]
        os_, oe = d["obj_start"], d["obj_end"]
        if self.dataset == "tacred":
            tokens[ss : se + 1] = ["SUBJ-" + d["subj_type"]] * (se - ss + 1)
            tokens[os_ : oe + 1] = ["OBJ-" + d["obj_type"]] * (oe - os_ + 1)
        if self.bert_embeddings is not None:
            words = np.asarray(self.bert_embeddings[d["id"]],
                               dtype=np.float32)
        else:
            words = np.asarray(self.vocab.map(tokens), dtype=np.int32)
        pos = np.asarray(map_to_ids(d["stanford_pos"], C.POS_TO_ID),
                         dtype=np.int32)
        ner = None
        if self.dataset == "tacred":
            ner = np.asarray(map_to_ids(d["stanford_ner"],
                                        constants.NER_TO_ID), dtype=np.int32)
        deprel = np.asarray(
            map_to_ids(d["stanford_deprel"], C.DEPREL_TO_ID), dtype=np.int32)
        head = np.asarray([int(x) for x in d["stanford_head"]],
                          dtype=np.int32)
        if not (head == 0).any():
            raise ValueError("dependency tree has no root")
        length = len(pos)
        subj_pos = np.asarray(get_positions(ss, se, length), dtype=np.int32)
        obj_pos = np.asarray(get_positions(os_, oe, length), dtype=np.int32)
        graph = prune_graph(head, deprel, length, self.cfg.model.prune_k,
                            subj_pos, obj_pos)
        return Example(words=words, pos=pos, ner=ner, deprel=deprel,
                       subj_pos=subj_pos, obj_pos=obj_pos,
                       relation=self.label2id[d["relation"]], graph=graph)

    def __len__(self) -> int:
        return len(self.examples)


class Batcher:
    """Chunk a dataset into static-shape padded batches: shuffled once and
    with word dropout for training, in file order and without for
    evaluation (``evaluation=True``)."""

    def __init__(self, dataset: RelationDataset, batch_size: int,
                 evaluation: bool = False, seed: int = 1234,
                 length_buckets=None, pad_batches: bool = True,
                 group_by_length: bool = False):
        self.ds = dataset
        self.batch_size = batch_size
        self.evaluation = evaluation
        self.rng = np.random.RandomState(seed)
        self.pad_batches = pad_batches
        self.length_buckets = sorted(
            length_buckets or dataset.cfg.data.length_buckets)
        order = list(range(len(dataset)))
        if not evaluation:
            random.Random(seed).shuffle(order)
        if group_by_length:
            order = sorted(order, key=lambda i: self._bucket_len(
                dataset.examples[i].length))
        self.order = order
        self.num_examples = len(order)
        self.gold_labels = [
            dataset.id2label[dataset.examples[i].relation] for i in order
        ]
        self.chunks = [
            order[i : i + batch_size] for i in range(0, len(order), batch_size)
        ]

    def gold(self) -> list[str]:
        """Gold labels in iteration order."""
        return self.gold_labels

    def __len__(self) -> int:
        return len(self.chunks)

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        for chunk in self.chunks:
            yield self.materialize(chunk)

    def _bucket_len(self, max_len: int) -> int:
        for b in self.length_buckets:
            if max_len <= b:
                return b
        return max_len

    def materialize(self, chunk: list[int]) -> dict[str, np.ndarray]:
        exs = [self.ds.examples[i] for i in chunk]
        pad_b = self.batch_size if self.pad_batches else len(exs)
        n = self._bucket_len(max(e.length for e in exs))
        e_cap = n  # a tree over n tokens has < n edges
        use_bert = exs[0].words.ndim == 2

        if use_bert:  # float [L, D] rows, zero-padded
            words = np.zeros((pad_b, n, exs[0].words.shape[1]),
                             dtype=np.float32)
        else:
            words = np.full((pad_b, n), constants.PAD_ID, dtype=np.int32)
        pos = np.zeros((pad_b, n), dtype=np.int32)
        ner = np.zeros((pad_b, n), dtype=np.int32)
        deprel = np.zeros((pad_b, n), dtype=np.int32)
        subj_mask = np.zeros((pad_b, n), dtype=bool)
        obj_mask = np.zeros((pad_b, n), dtype=bool)
        pad_mask = np.ones((pad_b, n), dtype=bool)
        lengths = np.zeros((pad_b,), dtype=np.int32)
        labels = np.zeros((pad_b,), dtype=np.int32)
        example_mask = np.zeros((pad_b,), dtype=bool)
        edge_parent = np.zeros((pad_b, e_cap), dtype=np.int32)
        edge_child = np.zeros((pad_b, e_cap), dtype=np.int32)
        edge_deprel = np.zeros((pad_b, e_cap), dtype=np.int32)
        edge_mask = np.zeros((pad_b, e_cap), dtype=bool)

        word_do = 0.0 if self.evaluation else self.ds.cfg.train.word_dropout
        for b, ex in enumerate(exs):
            L = ex.length
            w = ex.words
            if word_do > 0 and not use_bert:
                # UNK substitution, never re-dropping an existing UNK
                drop = (self.rng.random_sample(L) < word_do) & (
                    w != constants.UNK_ID)
                w = np.where(drop, constants.UNK_ID, w)
            words[b, :L] = w
            pos[b, :L] = ex.pos
            if ex.ner is not None:
                ner[b, :L] = ex.ner
            deprel[b, :L] = ex.deprel
            subj_mask[b, :L] = ex.subj_pos == 0
            obj_mask[b, :L] = ex.obj_pos == 0
            pad_mask[b, :L] = False
            lengths[b] = L
            labels[b] = ex.relation
            example_mask[b] = True
            g = ex.graph
            ne = g.num_edges
            edge_parent[b, :ne] = g.edge_parent
            edge_child[b, :ne] = g.edge_child
            edge_deprel[b, :ne] = g.edge_deprel
            edge_mask[b, :ne] = True

        batch = {
            "words": words,
            "pad_mask": pad_mask,
            "pos": pos,
            "deprel": deprel,
            "subj_mask": subj_mask,
            "obj_mask": obj_mask,
            "lengths": lengths,
            "labels": labels,
            "example_mask": example_mask,
            "edge_parent": edge_parent,
            "edge_child": edge_child,
            "edge_deprel": edge_deprel,
            "edge_mask": edge_mask,
        }
        if self.ds.dataset == "tacred":
            batch["ner"] = ner
        return batch
