"""Products over parameters that are sharded on the mesh's ``model`` axis
(the counterpart of what XLA's GSPMD inserts for gcn_tpu's
``param_shardings``).

A ``DistributedTrainer`` whose model axis is above 1 cuts the word table
by vocabulary, the full_deprel weights by output hidden and the MLP and
classifier kernels by output (``parallel.mesh.param_shardings``), and
sets a ``ModelShards`` handle on its model and its optimizer.  The model
reads the handle, never the ``graph_partition`` context: under
``graph_partition="none"`` that context is empty, and the evaluator's and
the warm-up's forwards see the handle all the same.

The rule.  Outside a sharded product every tensor is whole and equal on a
model group's ranks, in value and in gradient.  A sharded product (a
rank's columns of ``x @ W``) has three parts:

* its whole input enters through ``copy_to_model`` (identity forward,
  all-reduce backward: each rank's input gradient holds its columns'
  share only);
* any replicated parameter it reads (a bias, the relation table) enters
  through ``copy_to_model`` once a forward, then is cut to the rank's
  columns where it has them;
* its output leaves through ``gather_columns``, an all-gather along the
  sharded axis whose backward takes the rank's slice of the (whole,
  equal) gradient.

The vocabulary lookup is the exception (``vocab_lookup``): each rank
looks up the ids in its range [lo, hi), writes zeros elsewhere, and the
result passes through ``reduce_from_model`` (all-reduce forward, identity
backward).  Each rank thus ends the backward with its shard's whole
gradient, and the replicated parameters' whole gradients; the trainer
sums over the ``data`` group only, as before.  ``model_sum`` sums a value
over the group outside autograd (the clip's norm of the sharded
gradients).  The collectives' payload bytes are counted in
``edge_partition.TRAFFIC``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from gcn_tpu_torch.parallel.edge_partition import (
    TRAFFIC,
    copy_to_model,
    reduce_from_model,
)
from gcn_tpu_torch.parallel.mesh import REPLICATED, unshard
from gcn_tpu_torch.parallel.train_step import all_reduce_sum


@dataclass(frozen=True)
class ModelShards:
    """One rank's share of the sharded parameters: its ``model`` group,
    the axis size, its model index, and each parameter's placement (the
    sharded dim or ``REPLICATED``, ``parallel.mesh.param_shardings``)."""
    group: Any
    size: int
    index: int
    placement: dict

    def dim(self, name: str) -> Optional[int]:
        """The dim ``name`` is sharded on, else None."""
        place = self.placement.get(name, REPLICATED)
        return None if place == REPLICATED else place

    def span(self, local: int) -> tuple[int, int]:
        """[lo, hi) of this rank's part in the whole, for a part of
        ``local`` entries."""
        return self.index * local, (self.index + 1) * local


class _GatherColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shards):
        ctx.shards = shards
        ctx.width = x.shape[-1]
        out = unshard(x, x.dim() - 1, shards.group, shards.size)
        TRAFFIC.add(out.numel() * out.element_size())
        return out

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.shards.span(ctx.width)
        return g[..., lo:hi].contiguous(), None


def gather_columns(x: torch.Tensor, shards: ModelShards) -> torch.Tensor:
    """Every rank's columns ``x`` [..., H/K] → the whole [..., H], in rank
    order; the gradient of ``x`` is this rank's columns of the whole
    gradient."""
    return _GatherColumns.apply(x, shards)


def columns(t: torch.Tensor, shards: ModelShards,
            width: int) -> torch.Tensor:
    """This rank's ``width`` columns (last dim) of the whole ``t``."""
    lo, hi = shards.span(width)
    return t[..., lo:hi]


def vocab_lookup(table: torch.Tensor, ids: torch.Tensor,
                 shards: ModelShards,
                 gather: Callable = lambda t, i: t[i]) -> torch.Tensor:
    """The rows of the whole table at ``ids`` from this rank's part
    ``table`` [V/K, D]: ``gather(table, local ids)`` where the id lies in
    the rank's range, zeros elsewhere, summed over the group (identity
    backward, so the part's gradient is its rows' whole gradient)."""
    lo, _ = shards.span(table.shape[0])
    local = ids - lo
    inside = (local >= 0) & (local < table.shape[0])
    rows = gather(table, torch.where(inside, local, 0))
    rows = torch.where(inside[..., None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))
    return reduce_from_model(rows, shards.group)


def column_dense(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                 shards: ModelShards, dtype: torch.dtype) -> torch.Tensor:
    """``x @ W + b`` from this rank's columns of W [in, out/K] (the whole
    ``bias`` replicated), in ``dtype`` as ``models.gcn.TorchDense``; the
    whole [..., out]."""
    x = copy_to_model(x, shards.group)
    b = columns(copy_to_model(bias, shards.group), shards, kernel.shape[1])
    y = x.to(dtype) @ kernel.to(dtype) + b.to(dtype)
    return gather_columns(y, shards)


def model_sum(t: torch.Tensor, shards: ModelShards) -> torch.Tensor:
    """``t`` summed over the model group (a new tensor, no gradient)."""
    TRAFFIC.add(t.numel() * t.element_size())
    return all_reduce_sum(t, shards.group)
