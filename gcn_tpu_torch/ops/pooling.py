"""Masked pooling over the token axis.

Counterpart of ``gcn_tpu.ops.pooling.pool`` and ``pool_slots``: the mask is
True for tokens to EXCLUDE; ``max`` fills them with −1e12, ``avg`` divides
by the kept count clamped at 1, ``sum`` adds the kept tokens.
``pool_slots`` pools each slot of a packed row over its own tokens.
"""

from __future__ import annotations

from gcn_tpu_torch.constants import INFINITY_NUMBER


def pool(h, exclude_mask, kind: str = "max"):
    """h: [B, N, H]; exclude_mask: [B, N] bool (True = drop) → [B, H]."""
    m = exclude_mask[:, :, None]
    if kind == "max":
        return h.masked_fill(m, -INFINITY_NUMBER).amax(dim=1)
    if kind == "avg":
        count = (~exclude_mask).sum(dim=1, keepdim=True).to(h.dtype)
        return h.masked_fill(m, 0.0).sum(dim=1) / count.clamp(min=1.0)
    if kind == "sum":
        return h.masked_fill(m, 0.0).sum(dim=1)
    raise ValueError(f"unknown pooling kind: {kind}")


def pool_slots(h, exclude_mask, kind: str = "max"):
    """Per-slot pooling of cross-sentence-packed rows: h [B, N, H],
    exclude_mask [B, S, N] bool (True = drop), slot s of row b pooled over
    its own tokens → [B, S, H], with ``pool``'s semantics.  The [B, S, N,
    H] select is real memory here (51 MB in f32 at B=50, S=10, N=128,
    H=200), where XLA fuses it into the reduction."""
    m = exclude_mask[:, :, :, None]          # [B, S, N, 1]
    hx = h[:, None, :, :]                    # [B, 1, N, H]
    if kind == "max":
        return hx.masked_fill(m, -INFINITY_NUMBER).amax(dim=2)
    if kind == "avg":
        count = (~exclude_mask).sum(dim=2, keepdim=True).to(h.dtype)
        return hx.masked_fill(m, 0.0).sum(dim=2) / count.clamp(min=1.0)
    if kind == "sum":
        return hx.masked_fill(m, 0.0).sum(dim=2)
    raise ValueError(f"unknown pooling kind: {kind}")
