"""Node degrees from padded edge lists.

Counterpart of ``gcn_tpu.ops.spmm.node_degrees``: the fused edge-list path
takes its pooling mask and its degree normalizer from these O(E) counts
instead of a dense band.  An edge counts when its mask is set and both of
its ends lie in ``[0, n)``; an edge outside is dropped, as JAX's scatter
with ``mode="drop"`` and the kernels' band builds drop it.
"""

from __future__ import annotations

import torch


def valid_edges(edge_parent, edge_child, edge_mask, n: int):
    """[B, E] bool: the edge is unmasked and both ends lie in [0, n)."""
    inside = ((edge_parent >= 0) & (edge_parent < n)
              & (edge_child >= 0) & (edge_child < n))
    return edge_mask.bool() & inside


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
