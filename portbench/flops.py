"""Operations and bytes from shapes: the whole model step's, and each
kernel group's, counted on a batch's real tokens and kept edges (padding is
waste and counts for nothing).

The model step takes a batch's sums (real tokens, kept edges, sentences);
a kernel group's launches take a ``BatchShape``: the sentences' lengths
and (for the grouped matmul's bytes) the relation groups the real tokens
use.  FLOPs count a multiply-add as two; only products are counted
(gate nonlinearities, softmax and other elementwise work are left out), so
every share computed from them is a lower bound.

The model step (``model_flops``), from the configuration's widths:

* BiLSTM, per direction and token: ``x W_ih`` (2·D·4H) and ``h W_hh``
  (2·H·4H);
* ``full_deprel`` layer of input width T: the two bands' and the self
  loop's transforms, 3 × 2·T·H a token (the factored form, ``h S[r]``),
  the relation matrices ``S = table W`` once a step (2·R·D·T·H with the
  R = 87 rows of the relation table, and 2·R·D·H for the biases; the self
  loop's 2·D·T·H + 2·D·H), and the aggregation by edges, 2·E·H a band;
* ``regular`` layer: the aggregation by edges, 2·E·T a band, and the
  transform 2·T·H a token;
* the head: 2·(3H·H + H·H) + 2·H·C a sentence (two MLP layers);
* backward: twice each product whose operands both take a gradient, once
  the aggregation's (the adjacency takes none);
* the sgd update: 5 a parameter (the norm's square and add, the clip's
  scale, the step's multiply and add).
"""

from __future__ import annotations

from dataclasses import dataclass

RELATION_ROWS = 87  # the deprel table's 85 rows + the all-ones and zero rows
F32 = 4


@dataclass
class BatchShape:
    lengths: list[int]
    groups: int = RELATION_ROWS  # relation groups the real tokens use

    @property
    def tokens(self) -> int:
        return sum(self.lengths)


def layer_widths(m: dict) -> list[int]:
    t0 = 2 * m["rnn_hidden"] if m["rnn"] else (
        m["emb_dim"] + m["pos_dim"] + m["ner_dim"])
    return [t0] + [m["hidden_dim"]] * (m["num_layers"] - 1)


def param_count(m: dict) -> int:
    from portbench.reference.model import param_spec

    total = 0
    for _, shape, _, _ in param_spec(m):
        n = 1
        for s in shape:
            n *= s
        total += n
    return total


def model_terms(m: dict, tok: int, e: int,
                n_sent: int) -> list[tuple[str, float, int]]:
    """(term, forward FLOPs, backward multiple) of one forward over
    ``tok`` real tokens, ``e`` kept edges and ``n_sent`` sentences."""
    hid = m["hidden_dim"]
    terms = []
    if m["rnn"]:
        d_in = m["emb_dim"] + m["pos_dim"] + m["ner_dim"]
        rh = m["rnn_hidden"]
        terms += [("lstm input", 2 * 2 * tok * d_in * 4 * rh, 2),
                  ("lstm recurrence", 2 * 2 * tok * rh * 4 * rh, 2)]
    for t in layer_widths(m):
        if m["adj_type"] == "full_deprel":
            d = m["deprel_emb_dim"]
            terms += [("deprel transforms", 3 * 2 * tok * t * hid, 2),
                      ("relation matrices", 2 * RELATION_ROWS * d * t * hid
                       + 2 * RELATION_ROWS * d * hid, 2),
                      ("self loop matrix", 2 * d * t * hid + 2 * d * hid, 2),
                      ("aggregation", 2 * 2 * e * hid, 1)]
        else:
            terms += [("aggregation", 2 * 2 * e * t, 1),
                      ("transform", 2 * tok * t * hid, 2)]
    terms.append(("head", n_sent * (2 * (3 * hid * hid + hid * hid)
                                    + 2 * hid * m["num_class"]), 2))
    return terms


def model_flops(m: dict, tok: int, e: int, n_sent: int,
                train: bool) -> float:
    """One step's model FLOPs (train: forward, backward and the sgd
    update; else the forward) over a batch's real tokens, kept edges and
    sentences."""
    terms = model_terms(m, tok, e, n_sent)
    if not train:
        return float(sum(f for _, f, _ in terms))
    return float(sum(f * (1 + k) for _, f, k in terms)
                 + 5 * param_count(m))


# ------------------------------------------------------------ kernel groups
def scan_launches(m: dict, shape: BatchShape, train: bool):
    """(FLOPs, bytes) of each scan launch group of one step: the forward
    kernel, then (train) the backward's three launches together.  Per real
    token and direction: the forward reads xp (4H) and writes h and c (2H)
    and does ``h W_hh``; the backward reads the output gradient, xp, h and c
    (7H), writes dxp (4H) and does the chain's and dW_hh's products; both
    read W_hh once, the backward writes dW_hh once."""
    if not m["rnn"]:
        return []
    h = m["rnn_hidden"]
    tok2 = 2 * shape.tokens  # both directions
    w = 2 * h * 4 * h * F32
    out = [(2 * tok2 * h * 4 * h, tok2 * 6 * h * F32 + w)]
    if train:
        out.append((2 * 2 * tok2 * h * 4 * h, tok2 * 11 * h * F32 + 2 * w))
    return out


def grouped_matmul_launches(m: dict, shape: BatchShape, train: bool):
    """(FLOPs, bytes) of each grouped-matmul launch group of one step: a
    forward a ``full_deprel`` layer over the two bands' rows (2 a real
    token), then (train) each layer's backward (dx and dS).  The forward
    reads x (T a row) and the groups' S [T, H] and writes H a row; the
    backward reads g (H) and x (T) a row and S, and writes dx (T) a row and
    dS."""
    if m["adj_type"] != "full_deprel":
        return []
    hid = m["hidden_dim"]
    rows = 2 * shape.tokens
    fwd, bwd = [], []
    for t in layer_widths(m):
        s_bytes = shape.groups * t * hid * F32
        fwd.append((2 * rows * t * hid,
                    rows * (t + hid) * F32 + s_bytes))
        bwd.append((4 * rows * t * hid,
                    rows * (hid + 2 * t) * F32 + 2 * s_bytes))
    return fwd + (bwd if train else [])


def least_seconds(launches, peak_flops: float, peak_bytes: float) -> float:
    """Σ over launches of max(FLOPs / peak, bytes / bandwidth)."""
    return sum(max(f / peak_flops, b / peak_bytes) for f, b in launches)
