"""The benchmark's one traffic generator: TACRED-schema JSON records from a
mix's parameters (``traffic/<name>.json``) and a seed.

What a mix fixes, and what the seed draws:

* sentence lengths: one multiset per mix, drawn once from a gamma
  distribution with the mix's mean and shape under the mix's own
  ``draw_seed``, floored at ``min`` (at least 8, as the spans
  need) and cut at ``cap`` (a cut length is set to ``cap``).  Every run
  seed gets the same lengths in the same order, and a training mix's
  shuffle is its own (``shuffle_seed``), so every seed trains and scores
  the same sequence of batch shapes: seeds change what the sentences say,
  not the work they make;
* words: Zipf-distributed ranks over the vocabulary's word rows;
* POS, NER and deprel tags, and relation labels: drawn from the counts
  in ``data/tacred_tags.json``; the root token's deprel is ``ROOT``;
* trees: one root at a uniform position, every other token's head on the
  root's side of it at a geometric distance (mean ``mean_arc``), cut at the
  root, so arcs are mostly short and every chain of heads ends at the
  root;
* entity spans as ``tools/make_sample_data.py`` draws them: a subject of
  two or three tokens, an object of two that does not overlap it.

The vocabulary is ``vocabulary(rows)``: PAD, UNK, TACRED's entity masks
(``SUBJ-<type>``, ``OBJ-<type>``), then ``w<id>`` words up to ``rows``.
Nothing here imports the program.
"""

from __future__ import annotations

import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
TAGS_FILE = os.path.join(HERE, "data", "tacred_tags.json")
PAD, UNK = "<PAD>", "<UNK>"


def load_tags() -> dict:
    with open(TAGS_FILE) as f:
        return json.load(f)


def vocabulary(rows: int, tags: dict | None = None) -> list[str]:
    """The id → word list of a ``rows``-row vocabulary."""
    tags = tags or load_tags()
    masks = (["SUBJ-" + t for t in tags["subj_types"]]
             + ["OBJ-" + t for t in tags["obj_types"]])
    head = [PAD, UNK] + masks
    return head + [f"w{i}" for i in range(len(head), rows)]


def first_word_id(tags: dict | None = None) -> int:
    """The id of the vocabulary's first ``w<id>`` word."""
    tags = tags or load_tags()
    return 2 + len(tags["subj_types"]) + len(tags["obj_types"])


def lengths_of(mix: dict, sentences: int | None = None) -> np.ndarray:
    """The mix's length multiset (seed-independent), in draw order."""
    spec = mix["lengths"]
    n = int(sentences or mix["sentences"])
    rng = np.random.default_rng(int(spec["draw_seed"]))
    scale = float(spec["mean"]) / float(spec["shape"])
    raw = rng.gamma(float(spec["shape"]), scale, n)
    lengths = np.maximum(np.rint(raw).astype(np.int64), int(spec["min"]))
    return np.minimum(lengths, int(spec["cap"]))


def _categorical(rng, counts: dict, size: int) -> np.ndarray:
    names = np.asarray(list(counts), dtype=object)
    p = np.asarray(list(counts.values()), np.float64)
    cdf = np.cumsum(p / p.sum())
    cdf[-1] = 1.0
    return names[np.searchsorted(cdf, rng.random(size), side="right")]


def _zipf_ids(rng, size: int, first: int, rows: int, s: float) -> np.ndarray:
    ranks = np.arange(1, rows - first + 1, dtype=np.float64)
    cdf = np.cumsum(ranks ** -s)
    cdf /= cdf[-1]
    return first + np.searchsorted(cdf, rng.random(size), side="right")


def _heads(rng, lengths: np.ndarray, mean_arc: float):
    """(1-indexed heads, root position of each sentence) over the
    concatenated tokens."""
    total = int(lengths.sum())
    sent = np.repeat(np.arange(len(lengths)), lengths)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    pos = np.arange(total) - starts[sent]
    root = np.floor(rng.random(len(lengths)) * lengths).astype(np.int64)
    r = root[sent]
    dist = rng.geometric(1.0 / mean_arc, total)
    head = np.where(pos < r, np.minimum(pos + dist, r),
                    np.maximum(pos - dist, r))
    head = np.where(pos == r, -1, head)  # 0 after the +1: the root
    return head + 1, root


def _spans(rng, lengths: np.ndarray):
    """(ss, se, os, oe) as ``make_sample_data.make_example`` draws them."""
    n = lengths
    ss = np.floor(rng.random(len(n)) * (n - 2)).astype(np.int64)
    se = np.minimum(n - 1, ss + rng.integers(1, 3, len(n)))
    os_ = np.zeros_like(ss)
    if (n < 8).any():
        raise ValueError("entity spans need sentences of 8 tokens or more")
    todo = np.ones(len(n), bool)
    while todo.any():
        cand = np.floor(rng.random(int(todo.sum())) * (n[todo] - 1)).astype(
            np.int64)
        oe = np.minimum(n[todo] - 1, cand + 1)
        ok = (oe < ss[todo]) | (cand > se[todo])
        idx = np.nonzero(todo)[0]
        os_[idx[ok]] = cand[ok]
        todo[idx[ok]] = False
    oe = np.minimum(n - 1, os_ + 1)
    return ss, se, os_, oe


def make_records(mix: dict, seed: int, rows: int,
                 sentences: int | None = None) -> list[dict]:
    """The mix's records for ``seed`` over a ``rows``-row vocabulary
    (``sentences`` overrides the mix's count, for tests)."""
    tags = load_tags()
    rng = np.random.default_rng([int(seed) % 2**63, 0x7ac4ed])
    lengths = lengths_of(mix, sentences)
    total = int(lengths.sum())
    first = first_word_id(tags)
    words = _zipf_ids(rng, total, first, rows,
                      float(mix["words"]["zipf_exponent"]))
    tokens = np.asarray(vocabulary(rows, tags), dtype=object)[words]
    pos = _categorical(rng, tags["pos"], total)
    ner = _categorical(rng, tags["ner"], total)
    deprel = _categorical(rng, tags["deprel"], total)
    head, root = _heads(rng, lengths, float(mix["trees"]["mean_arc"]))
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    deprel[starts + root] = "ROOT"
    ss, se, os_, oe = _spans(rng, lengths)
    rel = _categorical(rng, tags["relation"], len(lengths))
    subj = _categorical(rng, {t: 1 for t in tags["subj_types"]},
                        len(lengths))
    obj = _categorical(rng, {t: 1 for t in tags["obj_types"]}, len(lengths))
    tokens, pos, ner, deprel = (a.tolist() for a in (tokens, pos, ner, deprel))
    head = head.tolist()
    recs = []
    for i, (a, n) in enumerate(zip(starts.tolist(), lengths.tolist())):
        b = a + n
        recs.append({
            "id": f"pb{seed}-{i}", "relation": rel[i],
            "token": tokens[a:b],
            "subj_start": int(ss[i]), "subj_end": int(se[i]),
            "obj_start": int(os_[i]), "obj_end": int(oe[i]),
            "subj_type": subj[i], "obj_type": obj[i],
            "stanford_pos": pos[a:b], "stanford_ner": ner[a:b],
            "stanford_head": head[a:b], "stanford_deprel": deprel[a:b],
        })
    return recs


def write_records(recs: list[dict], path: str) -> None:
    text = json.dumps(recs, separators=(",", ":"))
    with open(path, "w") as f:
        f.write(text)


def bucket_histogram(lengths_in_order, batch: int, buckets) -> dict:
    """Batches by length bucket, for batches of ``batch`` consecutive
    sentences of ``lengths_in_order``."""
    hist: dict = {}
    ls = list(lengths_in_order)
    for i in range(0, len(ls), batch):
        m = max(ls[i:i + batch])
        b = next((x for x in sorted(buckets) if m <= x), m)
        hist[b] = hist.get(b, 0) + 1
    return dict(sorted(hist.items()))
