"""Dense adjacency bands from padded edge lists.

Counterpart of ``gcn_tpu.ops.adjacency``: one scatter-add builds the forward
band ``A_f[b, parent, child]``, which counts the edges p → c (0/1 on a
tree; a duplicated edge counts twice, and the dense attention backend
weights its softmax by these counts); the reverse band is its transpose; nodes
touching an edge get the self loop; ``denom = deg_out + deg_in + incident +
1``; tokens with no incident edge are excluded from sentence pooling.  An edge
whose parent or child lies outside ``[0, n)`` is dropped, as JAX's scatter
with ``mode="drop"`` drops it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gcn_tpu_torch.ops.spmm import valid_edges


class Adjacency(NamedTuple):
    forward: torch.Tensor    # [B, N, N] parent→child edge counts
    incident: torch.Tensor   # [B, N] bool — node touches ≥1 edge
    denom: torch.Tensor      # [B, N, 1] degree normalizer
    pool_mask: torch.Tensor  # [B, N] bool — True = exclude from pooling

    @property
    def reverse(self) -> torch.Tensor:
        return self.forward.transpose(1, 2)

    @property
    def combined(self) -> torch.Tensor:
        """Forward + reverse band + the self loop of every incident node:
        the reference's ``adj_matrix`` of the regular mode (0/1 on a
        tree)."""
        diag = torch.diag_embed(self.incident.to(self.forward.dtype))
        return self.forward + self.reverse + diag


def build_adjacency(edge_parent, edge_child, edge_mask, n: int,
                    dtype=torch.float32) -> Adjacency:
    """Scatter [B, E] edge lists into the dense forward band.  Padded edge
    slots carry (0, 0) with mask 0, and an edge with an end outside
    [0, n) is folded into the mask, so neither adds anything."""
    b = edge_parent.shape[0]
    vals = valid_edges(edge_parent, edge_child, edge_mask, n).to(dtype)
    flat = (torch.arange(b, device=edge_parent.device)[:, None] * (n * n)
            + edge_parent.long().clamp(0, n - 1) * n
            + edge_child.long().clamp(0, n - 1))
    forward = torch.zeros(b * n * n, dtype=dtype, device=edge_parent.device)
    forward.index_add_(0, flat.reshape(-1), vals.reshape(-1))
    forward = forward.reshape(b, n, n)
    deg_out = forward.sum(dim=2)
    deg_in = forward.sum(dim=1)
    incident = (deg_out + deg_in) > 0
    denom = (deg_out + deg_in + incident.to(dtype) + 1.0)[:, :, None]
    return Adjacency(forward=forward, incident=incident, denom=denom,
                     pool_mask=~incident)
