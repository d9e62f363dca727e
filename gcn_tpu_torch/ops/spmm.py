"""Edge-list SpMM and node degrees from padded edge lists.

Counterpart of ``gcn_tpu.ops.spmm``: messages are gathered per edge and
summed per node, O(E·H) with no [B, N, N] band.

* ``spmm_forward``: ``out[b, p] += w_e · src[b, c]`` for each edge (p, c),
  i.e. ``A_f @ src`` with ``A_f`` carrying the edge weights;
* ``spmm_reverse``: ``out[b, c] += w_e · src[b, p]``, i.e. ``A_fᵀ @ src``;
* ``node_degrees``: the fused edge-list path takes its pooling mask and
  its degree normalizer from these O(E) counts instead of a dense band.

``src`` is ``gate * h`` when a gate is given, else ``h``.  An edge counts
when its mask is set and both of its ends lie in ``[0, n)``; an edge
outside is dropped whole, as JAX's scatter with ``mode="drop"`` and the
kernels' band builds drop it (JAX's gather of an out-of-range child gives
NaN, which its scatter then carries: the port drops the edge instead).
The sums are ``scatter_add``s, which add with float atomics on the card,
so two runs there agree within float error, not bit for bit.

The values may be bf16 with f32 edge weights (the attention edge
backend at ``compute_dtype="bfloat16"``).  The port then does what JAX
does: the weights are cast to the values' dtype before the product, each
message is rounded to bf16, and the messages are summed in bf16 into a
bf16 target (``scatter_add`` in the values' dtype, JAX's ``.at[].add``
likewise), each addition rounding.  On the card a bf16 ``scatter_add``
is float atomics too.
"""

from __future__ import annotations

import torch


def valid_edges(edge_parent, edge_child, edge_mask, n: int):
    """[B, E] bool: the edge is unmasked and both ends lie in [0, n)."""
    inside = ((edge_parent >= 0) & (edge_parent < n)
              & (edge_child >= 0) & (edge_child < n))
    return edge_mask.bool() & inside


def gather_rows(x, idx):
    """``x[b, idx[b, e]]`` for x [B, N, H] and idx [B, E] → [B, E, H]
    (indices clamped into range; the caller masks the edges outside)."""
    n = x.shape[1]
    i = idx.long().clamp(0, n - 1)[:, :, None].expand(-1, -1, x.shape[2])
    return torch.gather(x, 1, i)


def scatter_rows(values, dst, n: int):
    """Sum per-edge messages [B, E, H] into their destination rows
    [B, N, H]; a message whose edge is dropped must already be zero."""
    b, _, h = values.shape
    i = dst.long().clamp(0, n - 1)[:, :, None].expand(-1, -1, h)
    out = torch.zeros((b, n, h), dtype=values.dtype, device=values.device)
    return out.scatter_add(1, i, values)


def _spmm(h, src_idx, dst_idx, ok, gate, edge_weights):
    src = gate * h if gate is not None else h
    msgs = gather_rows(src, src_idx)
    if edge_weights is not None:
        msgs = msgs * edge_weights[:, :, None].to(src.dtype)
    msgs = torch.where(ok[:, :, None], msgs, torch.zeros((), dtype=msgs.dtype,
                                                         device=msgs.device))
    return scatter_rows(msgs, dst_idx, h.shape[1])


def spmm_forward(h, edge_parent, edge_child, edge_mask, gate=None,
                 edge_weights=None):
    """Child→parent messages: ``A_f @ (gate * h)`` for h [B, N, H], edge
    lists [B, E], an optional sender gate [B, N, H] and optional per-edge
    weights [B, E]."""
    ok = valid_edges(edge_parent, edge_child, edge_mask, h.shape[1])
    return _spmm(h, edge_child, edge_parent, ok, gate, edge_weights)


def spmm_reverse(h, edge_parent, edge_child, edge_mask, gate=None,
                 edge_weights=None):
    """Parent→child messages: ``A_fᵀ @ (gate * h)``."""
    ok = valid_edges(edge_parent, edge_child, edge_mask, h.shape[1])
    return _spmm(h, edge_parent, edge_child, ok, gate, edge_weights)


def node_degrees(edge_parent, edge_child, edge_mask, n: int,
                 dtype=torch.float32):
    """(deg_out [B, N], deg_in [B, N], incident [B, N] bool) for edge lists
    [B, E]: children and parents of each node, and whether it touches an
    edge (the same degrees as ``adjacency.build_adjacency``)."""
    ok = valid_edges(edge_parent, edge_child, edge_mask, n)
    vals = ok.to(dtype)
    b = edge_parent.shape[0]
    zeros = torch.zeros((b, n), dtype=dtype, device=edge_parent.device)
    deg_out = zeros.scatter_add(1, edge_parent.long().clamp(0, n - 1), vals)
    deg_in = zeros.scatter_add(1, edge_child.long().clamp(0, n - 1), vals)
    incident = (deg_out + deg_in) > 0
    return deg_out, deg_in, incident
