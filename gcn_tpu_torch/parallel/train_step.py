"""The training loss and the data-parallel step's reductions (counterpart
of ``gcn_tpu.parallel.train_step``).

``make_loss_fn`` is the loss of every trainer: the f32 cross-entropy over
the batch's valid rows (``example_mask``) over their count, plus
``conv_l2`` times the squared GCN transform weights and ``pooling_l2``
times the valid rows' squared pooling output over the same count.  Under
data parallelism each rank computes it on its rows with

* ``count`` summing the valid rows over the ``data`` group, so every rank
  divides by the global batch's count, as one device does;
* ``conv_l2`` on data index 0 only (``penalties=False`` elsewhere): the
  penalty depends on the parameters alone, and the gradients are summed
  over the ``data`` group, so it must be counted once;

so that the sum over the ``data`` group of the losses and of the
gradients is the single-device step's (the ranks of one data index, a
``model`` group, each hold that index's whole loss and gradients).  ``all_reduce_flat`` sums a list of tensors in
one collective over one flat buffer (gcn_tpu's GSPMD inserts the same
reduction); ``gather_rows`` sums zero-padded slots, so every rank gets
each rank's rows in rank order.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from gcn_tpu_torch.config import Config
from gcn_tpu_torch.parallel.edge_partition import reduce_from_model


def conv_l2_penalty(model: torch.nn.Module) -> torch.Tensor:
    """Σ‖W‖² over the GCN layer transforms (``gcn_w*``, ``gcn_deprel_*``),
    as ``gcn_tpu.train.trainer.conv_l2_penalty`` scopes it.  A part of a
    weight sharded on the model axis (``model.shards``) adds its sum over the
    model group (``reduce_from_model``), so every rank holds the whole
    penalty and each part its own gradient."""
    shards = getattr(model, "shards", None)
    total = 0.0
    for name, p in model.named_parameters():
        if name.startswith(("gcn_w", "gcn_deprel_")):
            sq = p.square().sum()
            if shards is not None and shards.dim(name) is not None:
                sq = reduce_from_model(sq, shards.group)
            total = total + sq
    return total


def make_loss_fn(model: torch.nn.Module, cfg: Config,
                 count: Optional[Callable] = None,
                 penalties: bool = True) -> Callable:
    """``loss_fn(batch, generator)``: the stochastic forward's training loss
    (module docstring).  ``count`` maps the batch's valid-row count (an f32
    scalar) to the divisor's count; ``penalties=False`` leaves out
    ``conv_l2``."""
    train = cfg.train

    def loss_fn(batch: dict, generator) -> torch.Tensor:
        logits, pooled = model(batch, deterministic=False,
                               generator=generator)
        em = batch["example_mask"].float()
        n = em.sum()
        denom = (n if count is None else count(n)).clamp(min=1.0)
        ce = F.cross_entropy(logits.float(), batch["labels"],
                             reduction="none")
        loss = (ce * em).sum() / denom
        if train.conv_l2 > 0 and penalties:
            loss = loss + train.conv_l2 * conv_l2_penalty(model)
        if train.pooling_l2 > 0:
            pen = (pooled.float().square().sum(1) * em).sum() / denom
            loss = loss + train.pooling_l2 * pen
        return loss

    return loss_fn


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` summed over the ranks (a new tensor)."""
    out = t.clone()
    dist.all_reduce(out, group=group)
    return out


def all_reduce_flat(tensors: Sequence[torch.Tensor],
                    group=None) -> list[torch.Tensor]:
    """Each tensor summed over the ranks, by one all-reduce of their
    concatenation (one dtype); views of that buffer, in order."""
    if len({t.dtype for t in tensors}) != 1:
        raise ValueError("all_reduce_flat takes tensors of one dtype")
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out


def row_slots(t: torch.Tensor, rank: int, world: int) -> torch.Tensor:
    """[world, *t.shape] zeros with ``t`` in slot ``rank``: summed over the
    ranks, every slot holds its rank's ``t`` exactly."""
    slots = t.new_zeros((world, *t.shape))
    slots[rank] = t
    return slots


def gather_rows(t: torch.Tensor, rank: int, world: int,
                group=None) -> torch.Tensor:
    """Every rank's ``t`` (one shape on all), concatenated in rank order
    along the first axis."""
    out = all_reduce_sum(row_slots(t, rank, world), group)
    return out.reshape(world * t.shape[0], *t.shape[1:])
