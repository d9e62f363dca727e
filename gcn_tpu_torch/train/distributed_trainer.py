"""Training over ``torch.distributed`` on a (data × model) mesh, one
process a device (counterpart of gcn_tpu's ``DistributedTrainer`` and
``MultiHostTrainer``, which torch's one-process-a-card idiom makes one
class).

``DistributedTrainer`` is a ``Trainer`` whose every rank holds the whole
model and optimizer state (``parallel.mesh``) on a ``make_mesh(world,
data_axis, graph_axis)`` layout.  The ranks of one data index (its
``model`` group) hold the same rows of each global batch
(``data.sharding.ShardedBatcher`` by data index and data size); with a
model axis above 1 and ``graph_partition="edges"`` they split the edge
lists, with ``"halo"`` the nodes (each rank its slab, the batch's
``hplan_*`` exchange plans cut to the data index's rows and moved to the
rank's device with the rest of the batch), and run the GCN layers
together (``utils.shard_ctx.graph_partition``,
``parallel.edge_partition``, ``parallel.halo``), so each of them ends a
backward with the whole gradients of its rows.  A
step:

1. the valid rows are counted over the ``data`` group (one all-reduce),
   and each rank's loss divides by that global count; ``conv_l2`` is added
   on data index 0 only (``parallel.train_step.make_loss_fn``);
2. each dropout mask is drawn at the global batch's shape from the step's
   stream and cut to the data index's rows (``ops.dropout.RowShard``), so
   the ranks draw the single-device step's masks, and a model group's
   ranks the same ones;
3. the gradients and the loss are summed over the ``data`` group by one
   all-reduce of a flat buffer (``torch.autograd.grad`` bypasses DDP's
   reducer, so the step reduces explicitly); the row-sparse word update
   (``sparse_emb_grad true``; "auto" is off here, as in gcn_tpu) also
   gathers every data index's rows and word ids, so each rank coalesces
   the global batch's rows;
4. freeze, clip and update run on every rank as on one device, on the same
   sums, so the replicas stay equal.

On the card with NCCL a fused step, collectives included, is a replay of a
CUDA graph, as ``Trainer``'s; gloo's collectives cannot be captured, so
under gloo (the CPU, or ranks sharing one card) the steps run eagerly
(``_graphs_on``), and so does a partitioned evaluation, whose forward
holds the model group's collectives.  ``evaluate`` and ``predict_batch``
run each rank's rows and all-gather the predictions, probabilities and
losses over the ``data`` group (the ranks of a model group hold the same
rows), so every rank scores the whole split.  ``save`` writes on rank 0
and then waits for every rank; ``load`` reads on every rank.  The
parameters and state are broadcast from rank 0 when the trainer is built.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from gcn_tpu_torch.config import Config
from gcn_tpu_torch.ops.dropout import RowShard
from gcn_tpu_torch.parallel import distributed
from gcn_tpu_torch.parallel.mesh import (
    REPLICATED,
    make_groups,
    make_mesh,
    opt_shardings,
    param_shardings,
)
from gcn_tpu_torch.parallel.train_step import (
    all_reduce_flat,
    all_reduce_sum,
    gather_rows,
    make_loss_fn,
    row_slots,
)
from gcn_tpu_torch.train import checkpoint as ckpt
from gcn_tpu_torch.train.dispatch import graphs_on
from gcn_tpu_torch.train.evaluator import resolve_device
from gcn_tpu_torch.train.trainer import Trainer
from gcn_tpu_torch.utils.shard_ctx import graph_partition


class DistributedTrainer(Trainer):
    """A ``Trainer`` over the default process group (started by
    ``parallel.distributed.initialize`` from the environment, or else one
    of this process alone).  ``backend`` None: NCCL on the card, gloo on
    the CPU; a group that is running already keeps its own."""

    def __init__(self, cfg: Config, state_dict: Optional[dict] = None,
                 emb_matrix: Optional[np.ndarray] = None,
                 rng_seed: Optional[int] = None, device="cuda",
                 backend: Optional[str] = None):
        dev = resolve_device(device)
        if backend is None:
            backend = "nccl" if dev.type == "cuda" else "gloo"
        if not distributed.initialize(backend=backend, device=dev):
            distributed.initialize_single(backend)
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self.backend = dist.get_backend()
        self.mesh = make_mesh(self.world, cfg.mesh.data_axis,
                              max(1, cfg.mesh.graph_axis))
        self.groups = make_groups(self.mesh, self.rank)
        dev = distributed.local_device(dev)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        super().__init__(cfg, state_dict, emb_matrix=emb_matrix,
                         rng_seed=rng_seed, device=dev)
        # auto row-sparse updates stay off under data parallelism, as in
        # gcn_tpu; "true" forces them
        if str(cfg.train.sparse_emb_grad).lower() == "auto":
            self._set_sparse_emb(False)
        data = self.groups.data
        self._loss_fn = make_loss_fn(
            self.model, cfg, count=lambda n: all_reduce_sum(n, data),
            penalties=self.groups.data_index == 0)
        if self.mesh.model > 1:
            # the partitioned forward holds the model group's collectives
            self._evaluator.backend = self.backend
        self._place_state()

    def partition(self):
        """The context a step's or an evaluation's forward runs in."""
        return graph_partition(self.cfg.model.graph_partition, self.mesh,
                               self.groups)

    def _place_state(self) -> None:
        """Each tensor where ``parallel.mesh`` places it: on the data axis
        all are replicated, so every rank takes rank 0's values."""
        params = param_shardings(self.mesh, self.params)
        state = opt_shardings(self.mesh, self.opt.state)
        placed = [(params[n], p) for n, p in self.params.items()] + [
            (state[n][s], t) for n, slots in self.opt.state.items()
            for s, t in slots.items()]
        with torch.no_grad():
            for place, t in placed:
                if place != REPLICATED:
                    raise NotImplementedError(f"placement {place}")
                dist.broadcast(t.detach(), 0)

    def _graphs_on(self) -> bool:
        """Graphs hold a step's NCCL collectives, not gloo's."""
        return graphs_on(self.device, self.model, self.backend)

    def _loss(self, batch: dict, generator):
        rows = batch["words"].shape[0]
        d, size = self.groups.data_index, self.mesh.data
        with self.partition():
            return self._loss_fn(batch, RowShard(
                generator, d * rows, (d + 1) * rows, size * rows))

    def _reduce(self, loss, grads: dict, ids=None):
        """Loss and gradients summed over the ``data`` group in one
        all-reduce; with ``ids`` (the row-sparse step) every data index's
        rows and ids too, in data order."""
        names = list(grads)
        tensors = [grads[k] for k in names]
        d, size, group = (self.groups.data_index, self.mesh.data,
                          self.groups.data)
        if ids is not None:
            rows = grads["rows"]
            tensors[names.index("rows")] = row_slots(rows, d, size)
        *summed, total = all_reduce_flat(tensors + [loss.reshape(1)],
                                         group=group)
        out = dict(zip(names, summed))
        if ids is not None:
            out["rows"] = out["rows"].reshape(size * rows.shape[0],
                                              *rows.shape[1:])
            ids = gather_rows(ids, d, size, group)
        return total.reshape(()), out, ids

    def warmup(self, batches, *, eval_batches=None) -> dict:
        with self.partition():
            return super().warmup(batches, eval_batches=eval_batches)

    def _scores(self, batches: Iterable[dict]):
        """Predictions, probabilities, and each global batch's loss, valid
        count and whether it is off ``batch_size`` rows or packed, in the
        global batches' row order; each data index's rows from this rank's
        ``data`` group."""
        local = []
        with self.partition():
            for b in batches:
                _, probs, loss = self._evaluator.predict_batch(b)
                mask = np.asarray(b["example_mask"])
                local.append((probs, loss, int(mask.sum()), len(mask),
                              "slot_mask" in b))
        # each data index's list, in data order
        parts: list = [None] * self.mesh.data
        dist.all_gather_object(parts, local, group=self.groups.data)
        preds, probs, per_batch = [], [], []
        bs = self.cfg.train.batch_size
        for i in range(len(local)):
            ranks = [p[i] for p in parts]
            for rank_probs, *_ in ranks:
                probs.extend(rank_probs)
                preds.extend(int(np.argmax(p)) for p in rank_probs)
            n = sum(r[2] for r in ranks)
            loss = sum(r[1] * r[2] for r in ranks) / max(n, 1)
            per_batch.append((loss, n, sum(r[3] for r in ranks) != bs
                              or ranks[0][4]))
        return preds, probs, per_batch

    def predict_batch(self, batch: dict):
        """Eval-mode predictions for the valid rows of every rank's part of
        one global batch: (predictions, probs, loss)."""
        preds, probs, per_batch = self._scores([batch])
        return preds, probs, per_batch[0][0]

    def evaluate(self, batches: Iterable[dict]):
        """(preds, probs, avg_loss) over the global batches whose parts
        this rank is given, weighted as ``Evaluator.evaluate`` weights
        them."""
        preds, probs, per_batch = self._scores(batches)
        if not per_batch:
            return preds, probs, 0.0
        n = sum(w for _, w, _ in per_batch)
        if any(off for *_, off in per_batch):
            avg = sum(l * w for l, w, _ in per_batch) / max(n, 1)
        else:
            avg = (sum(l for l, _, _ in per_batch) / max(n, 1)
                   * self.cfg.train.batch_size)
        return preds, probs, avg

    def save(self, directory: str, epoch: Optional[int] = None,
             extra_meta: Optional[dict] = None) -> None:
        """Rank 0 writes the checkpoint; every rank waits for it."""
        if self.rank == 0:
            super().save(directory, epoch=epoch, extra_meta=extra_meta)
            ckpt.wait_for_async_saves()
        dist.barrier()
