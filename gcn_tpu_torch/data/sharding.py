"""Each rank's rows of every batch (counterpart of
``gcn_tpu.data.sharding``).

In a data-parallel job every process loads the dataset and builds the same
batches; ``ShardedBatcher`` hands rank r rows ``[r·B/W, (r+1)·B/W)`` of
each (W ranks, B rows a batch; B % W must be 0, as in gcn_tpu).  A
cross-sentence-packed batch (``PackedBatcher``: ``slot_mask`` [B, S, N])
has per-slot leaves of B·S (``labels``, ``example_mask``), which are cut at
``[lo·S, hi·S)`` so that they stay with their rows.  Everything else
(``gold``, ``order``, ``chunks``, ``advance``) is the wrapped batcher's:
the scores are of the whole split, gathered from the ranks in rank order.
"""

from __future__ import annotations

from typing import Iterator, Optional

from gcn_tpu_torch.parallel import distributed


class ShardedBatcher:
    """Wraps a ``Batcher`` or ``PackedBatcher``, yielding this rank's rows
    of each of its batches."""

    def __init__(self, batcher, process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        self.batcher = batcher
        self.process_index = (distributed.rank() if process_index is None
                              else process_index)
        self.process_count = (distributed.world_size()
                              if process_count is None else process_count)
        if batcher.batch_size % self.process_count:
            raise ValueError(f"batch size {batcher.batch_size} not divisible "
                             f"by {self.process_count} processes")
        self.local_rows = batcher.batch_size // self.process_count

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

    def slice(self, batch: dict) -> dict:
        """This rank's rows of a global batch."""
        rows = batch["words"].shape[0]
        if rows != self.batcher.batch_size:
            raise ValueError(f"a batch of {rows} rows, expected "
                             f"{self.batcher.batch_size}")
        lo = self.process_index * self.local_rows
        hi = lo + self.local_rows
        slots = batch["slot_mask"].shape[1] if "slot_mask" in batch else 1
        out = {}
        for k, v in batch.items():
            if v.shape[0] == rows:
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
