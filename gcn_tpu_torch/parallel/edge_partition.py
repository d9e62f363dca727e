"""Edge-partitioned aggregation over the mesh's ``model`` axis
(counterpart of ``gcn_tpu.parallel.edge_partition``).

The ``model`` group's K ranks hold the same rows of a batch and the same
node features.  The batch's edge lists [B, E] are padded to a multiple of
K with masked slots (``pad_edges_for_axis``), and model rank m takes the
contiguous share ``[m·E/K, (m+1)·E/K)`` (``local_edges``, gcn_tpu's
``P(data, model)``).  Each rank scatters the messages of its own edges
into a full [B, N, H] buffer, and one all-reduce over the group adds the
partial buffers up.  The edges run on ``ops.spmm``, which drops an edge
with an end outside [0, n) whole.

Every rank of the group computes the same loss, so the gradient arriving
at an aggregate is the same on each of them, and the autograd rules are
the tensor-parallel pair:

* a whole tensor that a rank reads only through its own edges (the
  messages' source, attention's q, k and values) passes through
  ``copy_to_model``: identity forward, all-reduce backward, so each rank's
  gradient of it holds every rank's edges;
* a rank's partial aggregate passes through ``reduce_from_model``:
  all-reduce forward, identity backward;
* attention's per-destination exp-sum, which rank-local work divides by,
  passes through ``all_reduce_both`` (all-reduce forward and backward),
  and its max shift is a ``MAX`` all-reduce without a gradient.

Every rank then ends the backward with the whole parameter gradients, and
the trainer sums them over the ``data`` group only.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from gcn_tpu_torch.ops.spmm import spmm_forward, spmm_reverse, valid_edges

EDGE_KEYS = ("edge_parent", "edge_child", "edge_deprel", "edge_mask")


def _all_reduce(x, group, op=dist.ReduceOp.SUM):
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=group)
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def copy_to_model(x, group):
    """``x`` as it is; its gradient summed over ``group``."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x, group):
    """``x`` summed over ``group``; its gradient as it is."""
    return _ReduceFromModel.apply(x, group)


def all_reduce_both(x, group):
    """``x`` summed over ``group``, and its gradient too."""
    return _AllReduceBoth.apply(x, group)


def pad_edges(t: torch.Tensor, axis_size: int) -> torch.Tensor:
    """[B, E] → [B, E'] with E' the next multiple of ``axis_size``, the
    new slots 0 (False for a mask)."""
    pad = (-t.shape[1]) % axis_size
    if pad == 0:
        return t
    return torch.cat([t, t.new_zeros((t.shape[0], pad))], dim=1)


def pad_edges_for_axis(batch: dict, axis_size: int) -> dict:
    """The batch with its edge arrays padded to a multiple of
    ``axis_size`` (masked slots)."""
    return {k: pad_edges(v, axis_size) if k in EDGE_KEYS else v
            for k, v in batch.items()}


def local_edges(part, t: torch.Tensor) -> torch.Tensor:
    """This model rank's contiguous share of the padded [B, E] array
    ``t``."""
    k, m = part.mesh.model, part.groups.model_index
    t = pad_edges(t, k)
    share = t.shape[1] // k
    return t[:, m * share:(m + 1) * share]


def partial_aggregate(part, x, ep, ec, em, reverse: bool = False):
    """This rank's share of ``A_f @ x`` (``A_fᵀ @ x`` with ``reverse``) over
    its local edges ``ep``, ``ec``, ``em`` (``local_edges``), before the
    sum over the group."""
    op = spmm_reverse if reverse else spmm_forward
    return op(copy_to_model(x, part.groups.model), ep, ec, em)


def partitioned_aggregate(part, x, ep, ec, em, reverse: bool = False):
    """``A_f @ x`` (``A_fᵀ @ x``) over the whole edge list, from this
    rank's local edges and one all-reduce."""
    return reduce_from_model(partial_aggregate(part, x, ep, ec, em, reverse),
                             part.groups.model)


def partitioned_aggregate_pair(part, x_f, x_r, ep, ec, em_f, em_r):
    """``A_f @ x_f + A_fᵀ @ x_r``, each band on its own local mask, both
    partials summed before one all-reduce."""
    agg = (partial_aggregate(part, x_f, ep, ec, em_f)
           + partial_aggregate(part, x_r, ep, ec, em_r, reverse=True))
    return reduce_from_model(agg, part.groups.model)


def partitioned_attention_layer(part, q, k, hw, ep, ec, em):
    """Both attention bands over the whole edge list from this rank's
    local edges: scores ``q[dst]·k[src]`` (f32) of its own edges, each
    destination's max over the ranks (one ``MAX`` all-reduce, no
    gradient) as the softmax shift, its exp-sum summed over the ranks
    (``all_reduce_both``), the weighted messages of both bands summed into
    one partial and one all-reduce.  ``q`` comes scaled.  The forward band
    is normalized at the parent, the reverse one at the child; an edge
    outside [0, n) or masked counts nowhere."""
    group = part.groups.model
    q, k, hw = (copy_to_model(t, group) for t in (q, k, hw))
    b, n = q.shape[:2]
    ok = valid_edges(ep, ec, em, n)
    neg = torch.full((), -1e30, dtype=torch.float32, device=q.device)
    zero = torch.zeros((), dtype=torch.float32, device=q.device)

    def rows(x, idx):
        i = idx.long().clamp(0, n - 1)
        return torch.gather(x, 1, i[:, :, None].expand(-1, -1, x.shape[2]))

    def band(reverse: bool):
        dst, src = (ec, ep) if reverse else (ep, ec)
        di = dst.long().clamp(0, n - 1)
        s = (rows(q, dst).float() * rows(k, src).float()).sum(-1)
        sm = torch.where(ok, s, neg)
        with torch.no_grad():
            m_loc = torch.full((b, n), -1e30, dtype=torch.float32,
                               device=q.device).scatter_reduce(
                1, di, sm, "amax")
            m = _all_reduce(m_loc, group, dist.ReduceOp.MAX)
        ex = torch.where(ok, torch.exp(sm - torch.gather(m, 1, di)), zero)
        den_loc = torch.zeros((b, n), dtype=torch.float32,
                              device=q.device).scatter_add(1, di, ex)
        den = all_reduce_both(den_loc, group)
        alpha = ex / torch.gather(den, 1, di).clamp(min=1e-30)
        op = spmm_reverse if reverse else spmm_forward
        return op(hw, ep, ec, ok, edge_weights=alpha)

    return reduce_from_model(band(False) + band(True), group)
