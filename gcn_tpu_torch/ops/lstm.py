"""Masked bidirectional LSTM.

Counterpart of ``gcn_tpu.ops.lstm`` with the packed-sequence semantics of
the reference's cuDNN BiLSTM reproduced by masking:

* h/c freeze once ``t >= length``; outputs at padded positions are 0,
* the reverse direction runs over the length-reversed valid prefix,
* gate order i, f, g, o; ``w_ih [D, 4H]``, ``w_hh [H, 4H]`` as in JAX.

Both directions advance together as the G=2 groups of one
``lstm_scan`` call, differentiable through the scan kernel's full-BPTT
backward; the input projections and the length reversal are plain
differentiable tensor ops.  ``impl="scan"`` runs the scan's plain versions
instead of the kernels (the JAX package's ``rnn_impl="scan"`` likewise
skips its kernel).

Cross-sentence-packed rows (``seg_start`` [B, T] bool, the first token of
each sentence in the row) reset the carry at every sentence boundary, so
each packed sentence gets the outputs it gets in a row of its own: the
forward direction resets where a sentence starts, the reverse one,
walking the length-reversed row, where it meets a sentence's last token
(``_segment_resets``).  The resets reach the scan as its carry factor
``keep`` [T, 2, B] f32 (f32 whatever the compute dtype).
"""

from __future__ import annotations

import torch

from gcn_tpu_torch.ops.dropout import dropout
from gcn_tpu_torch.ops.lstm_scan import lstm_scan


def _reverse_by_length(x, lengths):
    """Reverse each row's first ``length`` steps; the padded tail is 0."""
    t = x.shape[1]
    pos = torch.arange(t, device=x.device)[None, :]
    idx = (lengths[:, None] - 1 - pos).clamp(0, t - 1)
    gathered = torch.take_along_dim(x, idx[:, :, None].long(), dim=1)
    valid = pos < lengths[:, None]
    return torch.where(valid[:, :, None], gathered,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def _segment_resets(seg_start, lengths):
    """(reset_fwd [B, T], reset_bwd [B, T]) bool carry-reset masks of
    packed rows: the forward cell resets at each sentence's first token;
    the reverse cell walks the length-reversed row, whose first token of
    each sentence is that sentence's LAST, so its mask is the
    length-reversal of the sentence-end mask (not of ``seg_start``)."""
    t = seg_start.shape[1]
    pos = torch.arange(t, device=seg_start.device)[None, :]
    valid = pos < lengths[:, None]
    nxt = torch.nn.functional.pad(seg_start[:, 1:], (0, 1))
    seg_end = (nxt | (pos == lengths[:, None] - 1)) & valid
    reset_f = seg_start & valid
    reset_b = _reverse_by_length(seg_end[:, :, None].float(),
                                 lengths)[:, :, 0] > 0.5
    return reset_f, reset_b


def _bidirectional(x, lengths, layer, impl, keep=None):
    t = x.shape[1]
    fwd, bwd = layer["fwd"], layer["bwd"]
    x_rev = _reverse_by_length(x, lengths)
    xp_f = (x @ fwd["w_ih"] + (fwd["b_ih"] + fwd["b_hh"])).transpose(0, 1)
    xp_b = (x_rev @ bwd["w_ih"] + (bwd["b_ih"] + bwd["b_hh"])).transpose(0, 1)
    xp = torch.stack([xp_f, xp_b], dim=1).contiguous()      # [T, 2, B, 4H]
    w_hh = torch.stack([fwd["w_hh"], bwd["w_hh"]]).contiguous()  # [2, H, 4H]
    hs = lstm_scan(xp, lengths.to(torch.int32).contiguous(), w_hh, keep,
                   use_kernel=impl != "scan")
    valid = (torch.arange(t, device=x.device)[None, :]
             < lengths[:, None])[:, :, None]
    zero = torch.zeros((), dtype=hs.dtype, device=hs.device)
    y_f = torch.where(valid, hs[:, 0].transpose(0, 1), zero)
    y_b = _reverse_by_length(
        torch.where(valid, hs[:, 1].transpose(0, 1), zero), lengths)
    return torch.cat([y_f, y_b], dim=-1).to(x.dtype)


def bilstm(params, x, lengths, impl: str = "auto",
           inter_dropout: float = 0.0, deterministic: bool = True,
           generator=None, seg_start=None):
    """Multi-layer BiLSTM.  ``params`` is a list (one per layer) of
    ``{'fwd': {w_ih, w_hh, b_ih, b_hh}, 'bwd': {...}}``; x is [B, T, D];
    returns [B, T, 2H] with zeros at padded positions.  ``impl``:
    "auto"/"pallas" = the scan kernels on CUDA tensors, "scan" = their
    plain versions.  ``inter_dropout`` applies between stacked layers
    (``nn.LSTM`` semantics: not after the last), drawn from ``generator``
    unless ``deterministic``.  ``seg_start`` [B, T] bool (packed rows)
    resets the carry at each sentence boundary of every layer."""
    if impl not in ("auto", "pallas", "scan"):
        raise ValueError(f"unknown rnn impl: {impl}")
    keep = None
    if seg_start is not None:
        reset_f, reset_b = _segment_resets(seg_start.bool(), lengths)
        # [T, 2, B] carry factor, 0 at a sentence's first step
        keep = (1.0 - torch.stack((reset_f.T, reset_b.T), dim=1).float()
                ).contiguous()
    h = x
    for li, layer in enumerate(params):
        h = _bidirectional(h, lengths, layer, impl, keep)
        if li < len(params) - 1:
            h = dropout(h, inter_dropout, deterministic, generator)
    return h
