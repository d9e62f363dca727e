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


def _bidirectional(x, lengths, layer, impl):
    t = x.shape[1]
    fwd, bwd = layer["fwd"], layer["bwd"]
    x_rev = _reverse_by_length(x, lengths)
    xp_f = (x @ fwd["w_ih"] + (fwd["b_ih"] + fwd["b_hh"])).transpose(0, 1)
    xp_b = (x_rev @ bwd["w_ih"] + (bwd["b_ih"] + bwd["b_hh"])).transpose(0, 1)
    xp = torch.stack([xp_f, xp_b], dim=1).contiguous()      # [T, 2, B, 4H]
    w_hh = torch.stack([fwd["w_hh"], bwd["w_hh"]]).contiguous()  # [2, H, 4H]
    hs = lstm_scan(xp, lengths.to(torch.int32).contiguous(), w_hh,
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
           generator=None):
    """Multi-layer BiLSTM.  ``params`` is a list (one per layer) of
    ``{'fwd': {w_ih, w_hh, b_ih, b_hh}, 'bwd': {...}}``; x is [B, T, D];
    returns [B, T, 2H] with zeros at padded positions.  ``impl``:
    "auto"/"pallas" = the scan kernels on CUDA tensors, "scan" = their
    plain versions.  ``inter_dropout`` applies between stacked layers
    (``nn.LSTM`` semantics: not after the last), drawn from ``generator``
    unless ``deterministic``."""
    if impl not in ("auto", "pallas", "scan"):
        raise ValueError(f"unknown rnn impl: {impl}")
    h = x
    for li, layer in enumerate(params):
        h = _bidirectional(h, lengths, layer, impl)
        if li < len(params) - 1:
            h = dropout(h, inter_dropout, deterministic, generator)
    return h
