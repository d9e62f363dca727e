"""Each rank's rows of every batch (counterpart of
``gcn_tpu.data.sharding``).

In a distributed job every process loads the dataset and builds the same
batches; ``ShardedBatcher`` hands the ranks of data index d rows
``[d·B/D, (d+1)·B/D)`` of each (D data indices, B rows a batch; B % D must
be 0, as in gcn_tpu).  The ranks of one data index (a ``model`` group of
the mesh) take the same rows.  A
cross-sentence-packed batch (``PackedBatcher``: ``slot_mask`` [B, S, N])
has per-slot leaves of B·S (``labels``, ``example_mask``), which are cut at
``[lo·S, hi·S)`` so that they stay with their rows.  The halo plans
(``hplan_*``, ``parallel.halo``) put their batch axis after the slab
axes: they are cut on dim 2 ([K, K, B, Hp]) or dim 1 ([K, B, E]).
Everything else (``gold``, ``order``, ``chunks``, ``advance``,
``halo_devices``) is the wrapped batcher's: the scores are of the whole
split, gathered from the ranks in rank order.
"""

from __future__ import annotations

from typing import Iterator, Optional

from gcn_tpu_torch.parallel import distributed
from gcn_tpu_torch.parallel.halo import is_plan_key


class ShardedBatcher:
    """Wraps a ``Batcher`` or ``PackedBatcher``, yielding the rows of data
    index ``data_index`` of ``data_size`` of each of its batches (by
    default the rank and the world size: a mesh whose model axis is 1)."""

    def __init__(self, batcher, data_index: Optional[int] = None,
                 data_size: Optional[int] = None):
        self.batcher = batcher
        self.data_index = (distributed.rank() if data_index is None
                           else data_index)
        self.data_size = (distributed.world_size() if data_size is None
                          else data_size)
        if batcher.batch_size % self.data_size:
            raise ValueError(f"batch size {batcher.batch_size} not divisible "
                             f"by {self.data_size} data indices")
        self.local_rows = batcher.batch_size // self.data_size

    @property
    def order(self):
        return self.batcher.order

    @property
    def chunks(self):
        return self.batcher.chunks

    def gold(self):
        return self.batcher.gold()

    def advance(self, batches: int) -> None:
        self.batcher.advance(batches)

    def __len__(self) -> int:
        return len(self.batcher)

    @property
    def halo_devices(self) -> int:
        return self.batcher.halo_devices

    @halo_devices.setter
    def halo_devices(self, value: int) -> None:
        # the wrapped batcher builds the plans on the global batch (and
        # caches them); ``slice`` cuts them
        self.batcher.halo_devices = value

    def slice(self, batch: dict) -> dict:
        """This rank's rows of a global batch."""
        rows = batch["words"].shape[0]
        if rows != self.batcher.batch_size:
            raise ValueError(f"a batch of {rows} rows, expected "
                             f"{self.batcher.batch_size}")
        lo = self.data_index * self.local_rows
        hi = lo + self.local_rows
        slots = batch["slot_mask"].shape[1] if "slot_mask" in batch else 1
        out = {}
        for k, v in batch.items():
            if is_plan_key(k):  # the batch axis after the slab axes
                out[k] = v[:, :, lo:hi] if v.ndim == 4 else v[:, lo:hi]
            elif v.shape[0] == rows:
                out[k] = v[lo:hi]
            elif v.shape[0] == rows * slots:  # per slot, row-major
                out[k] = v[lo * slots:hi * slots]
            else:
                raise ValueError(f"{k}: leading axis {v.shape[0]} is neither "
                                 f"{rows} rows nor {rows * slots} slots")
        return out

    def materialize(self, chunk) -> dict:
        return self.slice(self.batcher.materialize(chunk))

    def warmup_batches(self) -> list[dict]:
        return [self.slice(b) for b in self.batcher.warmup_batches()]

    def __iter__(self) -> Iterator[dict]:
        for batch in self.batcher:
            yield self.slice(batch)
