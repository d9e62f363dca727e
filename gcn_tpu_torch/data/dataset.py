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
``Batcher.advance`` makes those draws for batches a resumed run skips;
``Batcher.warmup_batches`` gives one batch a shape without touching them.
Evaluation batches keep file order, drop no words, and are built once and
replayed every epoch; a dataset loaded with ``evaluation=True`` drops no
words in any batcher.  ``RelationDataset.raw_data`` keeps the JSON records
(the misclassified-example dumps).  Only TACRED batches carry ``ner``.

``PackedBatcher`` is gcn_tpu's cross-sentence packing: rows filled
greedily with whole sentences up to ``pack_len`` tokens or ``max_slots``
sentences, over one shuffle of the order; edges offset into the row,
``seg_start`` marking each sentence's first token, per-slot [B, S, N]
masks, and ``labels`` / ``example_mask`` flattened [B·S] in row-major slot
order.  It has ``Batcher``'s iteration surface (``advance``,
``warmup_batches``, the evaluation cache), and takes word ids only.

With ``halo_devices`` K > 1 (set by the driver under
``graph_partition="halo"``) both batchers add each batch's halo exchange
plans for K node slabs (``parallel.halo.attach_halo_plans``, the
``hplan_*`` arrays), cached by a hash of the edge arrays up to a byte
budget.
"""

from __future__ import annotations

import json
import random
import sys
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from gcn_tpu_torch import constants, constants_semeval
from gcn_tpu_torch.config import Config
from gcn_tpu_torch.data.vocab import Vocab, map_to_ids
from gcn_tpu_torch.graph.prune import PrunedGraph, prune_graph
from gcn_tpu_torch.parallel.halo import attach_halo_plans, is_plan_key


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
    ``[L, D]`` float rows, which then stand in for the word ids;
    ``evaluation=True`` turns word dropout off."""

    def __init__(self, filename: str, cfg: Config, vocab: Vocab,
                 evaluation: bool = False,
                 bert_embeddings: Optional[dict] = None):
        self.cfg = cfg
        self.vocab = vocab
        self.evaluation = evaluation
        self.dataset = cfg.model.dataset
        self.C = constants_for(self.dataset)
        self.bert_embeddings = bert_embeddings
        self.label2id = self.C.LABEL_TO_ID
        self.id2label = {v: k for k, v in self.label2id.items()}
        with open(filename) as f:
            self.raw_data = json.load(f)
        self.examples = [self._preprocess(d) for d in self.raw_data]

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


class _Batches:
    """The iteration surface of ``Batcher`` and ``PackedBatcher``: each has
    ``ds``, ``evaluation``, ``rng``, ``chunks``, ``gold_labels``,
    ``_cache``, ``halo_devices``, ``materialize(chunk)`` and
    ``_examples(chunk)`` (the chunk's example indices in the order its word
    dropout is drawn)."""

    # A chunk's plans depend only on its edges, which no epoch changes, so
    # they are cached across epochs by a hash of the edge arrays, up to
    # this many bytes; past it a chunk rebuilds its plans every epoch.
    _HALO_CACHE_BUDGET = 256 << 20

    def gold(self) -> list[str]:
        """Gold labels in iteration order."""
        return self.gold_labels

    def __len__(self) -> int:
        return len(self.chunks)

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        if not self.evaluation:  # word dropout is drawn anew every epoch
            for chunk in self.chunks:
                yield self.materialize(chunk)
        elif self._cache is not None:
            yield from self._cache
        else:
            cache = []
            for chunk in self.chunks:
                batch = self.materialize(chunk)
                cache.append(batch)
                yield batch
            self._cache = cache

    def _attach_halo(self, batch: dict, n: int) -> dict:
        """``batch`` with the ``hplan_*`` exchange plans of ``halo_devices``
        node slabs over its ``n`` nodes (as it is for 1 slab or none)."""
        if self.halo_devices <= 1:
            return batch
        from hashlib import blake2b

        hsh = blake2b(digest_size=16)
        for f in ("edge_parent", "edge_child", "edge_mask"):
            a = np.ascontiguousarray(batch[f])
            hsh.update(str(a.shape).encode())
            hsh.update(a.tobytes())
        key = (hsh.hexdigest(), n, self.halo_devices)
        cache = getattr(self, "_halo_plan_cache", None)
        if cache is None:
            cache = self._halo_plan_cache = {}
            self._halo_cache_bytes = 0
        hit = cache.get(key)
        if hit is not None:
            out = dict(batch)
            out.update(hit)
            return out
        full = attach_halo_plans(batch, n, self.halo_devices)
        plans = {k: v for k, v in full.items() if is_plan_key(k)}
        size = sum(v.nbytes for v in plans.values())
        if self._halo_cache_bytes + size <= self._HALO_CACHE_BUDGET:
            cache[key] = plans
            self._halo_cache_bytes += size
        else:
            # said once: from here on these chunks rebuild their plans
            self._halo_cache_misses = getattr(
                self, "_halo_cache_misses", 0) + 1
            if self._halo_cache_misses == 1:
                print(f"[gcn_tpu_torch] halo-plan cache budget "
                      f"({self._HALO_CACHE_BUDGET >> 20} MB) exhausted at "
                      f"{len(cache)} chunks; further chunks rebuild plans "
                      f"each epoch", file=sys.stderr, flush=True)
        return full

    def word_dropout(self) -> float:
        """The word→UNK rate of this batcher's batches."""
        if self.evaluation or self.ds.evaluation:
            return 0.0
        return self.ds.cfg.train.word_dropout

    def advance(self, batches: int) -> None:
        """Draw the word dropout of the next ``batches`` batches (epochs
        wrap round the chunks) without building them, as a resumed run
        skips them, so the batches after them are an uninterrupted run's."""
        if self.word_dropout() <= 0:
            return
        for i in range(batches):
            for j in self._examples(self.chunks[i % len(self.chunks)]):
                ex = self.ds.examples[j]
                if ex.words.ndim == 1:
                    self.rng.random_sample(ex.length)


class Batcher(_Batches):
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
        self._cache: Optional[list] = None
        self.halo_devices = 0

    @staticmethod
    def _examples(chunk: list[int]) -> list[int]:
        return chunk

    def warmup_batches(self) -> list[dict]:
        """One representative batch per distinct (rows, bucket) shape, for
        ``Trainer.warmup``.  Built with a throwaway ``RandomState``: the
        word-dropout stream (``self.rng``) is left as it was, and an
        evaluation batcher's cache is not filled."""
        reps: list[dict] = []
        seen: set = set()
        saved_rng = self.rng
        try:
            self.rng = np.random.RandomState(0)
            for chunk in self.chunks:
                n = self._bucket_len(
                    max(self.ds.examples[i].length for i in chunk))
                pad_b = self.batch_size if self.pad_batches else len(chunk)
                if (pad_b, n) in seen:
                    continue
                seen.add((pad_b, n))
                reps.append(self.materialize(chunk))
        finally:
            self.rng = saved_rng
        return reps

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

        word_do = self.word_dropout()
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
        return self._attach_halo(batch, n)


class PackedBatcher(_Batches):
    """Cross-sentence packing (gcn_tpu's ``PackedBatcher``): several
    sentences share one node row, filled greedily in one shuffle of the
    order (file order for evaluation) up to ``pack_len`` tokens (the
    largest length bucket by default, at least the longest sentence) or
    ``max_slots`` sentences; ``rows_per_batch`` rows a batch, the last
    batch's rows padded.  ``batch_size`` counts rows.  ``order`` and
    ``gold_labels`` follow the flattened slots, row by row."""

    def __init__(self, dataset: RelationDataset, rows_per_batch: int,
                 pack_len: Optional[int] = None, max_slots: int = 10,
                 evaluation: bool = False, seed: int = 1234):
        if any(ex.words.ndim != 1 for ex in dataset.examples):
            raise ValueError("PackedBatcher packs integer word ids, not "
                             "float word vectors")
        self.ds = dataset
        self.evaluation = evaluation
        self.rng = np.random.RandomState(seed)
        self.rows_per_batch = rows_per_batch
        buckets = sorted(dataset.cfg.data.length_buckets)
        max_len = max((ex.length for ex in dataset.examples), default=1)
        self.pack_len = max(pack_len or buckets[-1], max_len)
        self.max_slots = max_slots
        order = list(range(len(dataset)))
        if not evaluation:
            random.Random(seed).shuffle(order)
        rows: list[list[int]] = []
        cur: list[int] = []
        filled = 0
        for i in order:
            length = dataset.examples[i].length
            if cur and (filled + length > self.pack_len
                        or len(cur) >= max_slots):
                rows.append(cur)
                cur, filled = [], 0
            cur.append(i)
            filled += length
        if cur:
            rows.append(cur)
        self.rows = rows
        self.order = [i for row in rows for i in row]
        self.gold_labels = [
            dataset.id2label[dataset.examples[i].relation]
            for i in self.order
        ]
        self.chunks = [rows[j:j + rows_per_batch]
                       for j in range(0, len(rows), rows_per_batch)]
        self.num_examples = len(self.order)
        self.batch_size = rows_per_batch  # rows, not examples
        self._cache: Optional[list] = None
        self.halo_devices = 0

    @staticmethod
    def _examples(chunk: list[list[int]]) -> list[int]:
        return [i for row in chunk for i in row]

    def warmup_batches(self) -> list[dict]:
        """The one batch shape's representative, built with a throwaway
        ``RandomState`` (the word-dropout stream stays as it was)."""
        if not self.chunks:
            return []
        saved = self.rng
        try:
            self.rng = np.random.RandomState(0)
            return [self.materialize(self.chunks[0])]
        finally:
            self.rng = saved

    def materialize(self, chunk: list[list[int]]) -> dict[str, np.ndarray]:
        b, n, s = self.rows_per_batch, self.pack_len, self.max_slots
        words = np.full((b, n), constants.PAD_ID, np.int32)
        pos = np.zeros((b, n), np.int32)
        ner = np.zeros((b, n), np.int32)
        deprel = np.zeros((b, n), np.int32)
        pad_mask = np.ones((b, n), bool)
        seg_start = np.zeros((b, n), bool)
        lengths = np.zeros((b,), np.int32)
        slot_mask = np.zeros((b, s, n), bool)
        subj_mask = np.zeros((b, s, n), bool)
        obj_mask = np.zeros((b, s, n), bool)
        labels = np.zeros((b, s), np.int32)
        example_mask = np.zeros((b, s), bool)
        e_cap = n  # the trees of a row's sentences have < n edges
        edge_parent = np.zeros((b, e_cap), np.int32)
        edge_child = np.zeros((b, e_cap), np.int32)
        edge_deprel = np.zeros((b, e_cap), np.int32)
        edge_mask = np.zeros((b, e_cap), bool)

        word_do = self.word_dropout()
        for r, row in enumerate(chunk):
            off = ne_off = 0
            for si, i in enumerate(row):
                ex = self.ds.examples[i]
                length = ex.length
                w = ex.words
                if word_do > 0:
                    drop = (self.rng.random_sample(length) < word_do) & (
                        w != constants.UNK_ID)
                    w = np.where(drop, constants.UNK_ID, w)
                sl = slice(off, off + length)
                words[r, sl] = w
                pos[r, sl] = ex.pos
                if ex.ner is not None:
                    ner[r, sl] = ex.ner
                deprel[r, sl] = ex.deprel
                pad_mask[r, sl] = False
                seg_start[r, off] = True
                slot_mask[r, si, sl] = True
                subj_mask[r, si, sl] = ex.subj_pos == 0
                obj_mask[r, si, sl] = ex.obj_pos == 0
                labels[r, si] = ex.relation
                example_mask[r, si] = True
                g = ex.graph
                ne = g.num_edges
                edge_parent[r, ne_off:ne_off + ne] = g.edge_parent + off
                edge_child[r, ne_off:ne_off + ne] = g.edge_child + off
                edge_deprel[r, ne_off:ne_off + ne] = g.edge_deprel
                edge_mask[r, ne_off:ne_off + ne] = True
                ne_off += ne
                off += length
            lengths[r] = off

        batch = {
            "words": words,
            "pad_mask": pad_mask,
            "pos": pos,
            "deprel": deprel,
            "seg_start": seg_start,
            "slot_mask": slot_mask,
            "subj_mask": subj_mask,
            "obj_mask": obj_mask,
            "lengths": lengths,
            "labels": labels.reshape(-1),
            "example_mask": example_mask.reshape(-1),
            "edge_parent": edge_parent,
            "edge_child": edge_child,
            "edge_deprel": edge_deprel,
            "edge_mask": edge_mask,
        }
        if self.ds.dataset == "tacred":
            batch["ner"] = ner
        return self._attach_halo(batch, n)
