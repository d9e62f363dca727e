"""The host-to-card move of numpy batches into a CUDA graph's static inputs.

Counterpart of gcn_tpu's ``Trainer._maybe_pack`` / ``_place_stack`` (the
``pack_transfers`` and ``pack_format`` options):

* a packable batch (``data.packing.packable``), or a stack of k of them, is
  packed straight into a pinned host buffer (compact uint8 or int32, as
  ``pack_format`` says; int32 where a field does not fit the compact
  widths) and crosses in ONE ``non_blocking`` copy;
* a cross-sentence-packed batch (``data.packing.sentence_packable``, one
  at a time, as gcn_tpu sends them) crosses in one copy in the sentence
  format (``pack_sentence_batch``), whatever ``pack_format`` says;
* any other batch (float BERT words, extra keys, ``pack_transfers=False``)
  crosses field by field, each field also from pinned memory.

The pinned buffers form a small ring (``PinnedRing``): a buffer is written
again only after a CUDA event says that the copy which last read it has
finished, so the host may run several batches ahead of the card without
overwriting a batch in flight.  ``Staging`` counts the copies it starts and
their bytes.  On the device, ``device_batch`` gives the dict that
``train.evaluator.batch_to_device`` gives: integers int64, masks bool.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from gcn_tpu_torch.data.packing import (
    fits_compact,
    pack_batch,
    pack_batch_compact,
    pack_sentence_batch,
    packable,
    packed_width,
    sentence_packable,
    sp_width,
    unpack_batch,
    unpack_sentence_batch,
)

_ALIGN = 64  # bytes between fields in a pinned buffer


class PinnedRing:
    """``slots`` pinned host buffers used in turn; ``take`` waits for the
    copy that last read the buffer it hands out."""

    def __init__(self, slots: int):
        self._bufs: list = [None] * slots
        self._events: list = [None] * slots
        self._next = 0

    def take(self, nbytes: int) -> tuple[int, torch.Tensor]:
        """(slot, a pinned uint8 tensor of ``nbytes``) free to write."""
        slot = self._next
        self._next = (slot + 1) % len(self._bufs)
        if self._events[slot] is not None:
            self._events[slot].synchronize()
            self._events[slot] = None
        buf = self._bufs[slot]
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                              pin_memory=True)
            self._bufs[slot] = buf
        return slot, buf[:nbytes]

    def release(self, slot: int) -> None:
        """Mark the slot busy until the copies enqueued so far on the
        current stream have run."""
        event = torch.cuda.Event()
        event.record()
        self._events[slot] = event


@dataclass
class StaticBatch:
    """A graph's input buffers on the card: one packed [k, B, W] tensor,
    or a dict of one tensor a field (in the host arrays' dtypes).
    ``slots``: (N, S) of a sentence-packed buffer, else None."""
    buffers: object
    has_ner: bool
    slots: tuple | None = None

    @property
    def count(self) -> int:
        """The batches it holds."""
        return (self.buffers.shape[0]
                if isinstance(self.buffers, torch.Tensor) else 1)


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype)).dtype


class Staging:
    """Moves batches to ``device`` for one consumer of static inputs.
    ``pack``: packable batches cross packed (``fmt`` "compact", int32 for
    batches a field of which the compact widths cannot hold, or "int32");
    ``copies`` and ``bytes`` count what was sent."""

    def __init__(self, device: torch.device, pack: bool, fmt: str,
                 slots: int):
        if fmt not in ("compact", "int32"):
            raise ValueError(f"unknown pack_format {fmt!r}")
        self.device = device
        self.pack = pack
        self.fmt = fmt
        self.ring = PinnedRing(slots)
        self.copies = 0
        self.bytes = 0

    def packs(self, batch: dict) -> bool:
        """Whether ``batch`` crosses packed in a format that stacks k
        batches (the chunked paths take only these)."""
        return self.pack and packable(batch)

    def packs_sentences(self, batch: dict) -> bool:
        """Whether ``batch`` crosses in the sentence-packed format."""
        return self.pack and sentence_packable(batch)

    def signature(self, batches: list) -> tuple:
        """What a graph's static inputs depend on: the packed buffer's
        shape, or every field's shape and dtype."""
        b = batches[0]
        if self.packs(b):
            rows, n = b["words"].shape
            fmt = ("compact" if self.fmt == "compact"
                   and all(fits_compact(x) for x in batches) else "int32")
            return ("packed", fmt, len(batches), rows,
                    packed_width(n, "ner" in b, fmt), "ner" in b)
        if len(batches) != 1:
            raise ValueError("only packed batches cross k at a time")
        if self.packs_sentences(b):
            rows, n = b["words"].shape
            return ("sentences", rows, n, b["slot_mask"].shape[1],
                    "ner" in b)
        return ("fields",) + tuple(sorted(
            (k, np.shape(v), np.asarray(v).dtype.str) for k, v in b.items()))

    def allocate(self, batches: list) -> StaticBatch:
        """Static input buffers on the card for ``batches``' signature."""
        sig = self.signature(batches)
        if sig[0] == "packed":
            _, fmt, k, rows, width, has_ner = sig
            dtype = torch.uint8 if fmt == "compact" else torch.int32
            return StaticBatch(torch.empty((k, rows, width), dtype=dtype,
                                           device=self.device), has_ner)
        if sig[0] == "sentences":
            _, rows, n, s, has_ner = sig
            return StaticBatch(torch.empty(
                (1, rows, sp_width(n, s, has_ner)), dtype=torch.uint8,
                device=self.device), has_ner, (n, s))
        return StaticBatch(
            {k: torch.empty(shape, dtype=_torch_dtype(np.dtype(dt)),
                            device=self.device)
             for k, shape, dt in sig[1:]}, "ner" in batches[0])

    def send(self, batches: list, static: StaticBatch) -> None:
        """Start the copies of ``batches`` into ``static`` on the current
        stream; returns without waiting for them."""
        if isinstance(static.buffers, torch.Tensor):
            self._send_packed(batches, static)
        else:
            self._send_fields(batches[0], static.buffers)

    def _send_packed(self, batches: list, target: StaticBatch) -> None:
        static = target.buffers
        np_dtype = np.uint8 if static.dtype == torch.uint8 else np.int32
        nbytes = static.numel() * static.element_size()
        slot, buf = self.ring.take(nbytes)
        host = buf.numpy().view(np_dtype).reshape(tuple(static.shape))
        packer = (pack_sentence_batch if target.slots is not None
                  else pack_batch_compact if static.dtype == torch.uint8
                  else pack_batch)
        for i, b in enumerate(batches):
            packer(b, out=host[i])
        static.copy_(buf.view(static.dtype).view(static.shape),
                     non_blocking=True)
        self.ring.release(slot)
        self.copies += 1
        self.bytes += nbytes

    def _send_fields(self, batch: dict, static: dict) -> None:
        offsets, total = {}, 0
        for k, t in static.items():
            offsets[k] = total
            size = t.numel() * t.element_size()
            total += -(-size // _ALIGN) * _ALIGN
        slot, buf = self.ring.take(total)
        raw = buf.numpy()
        for k, t in static.items():
            size = t.numel() * t.element_size()
            arr = np.asarray(batch[k])
            raw[offsets[k]:offsets[k] + size].view(arr.dtype).reshape(
                arr.shape)[...] = arr
            t.copy_(buf[offsets[k]:offsets[k] + size].view(t.dtype).view(
                t.shape), non_blocking=True)
            self.copies += 1
            self.bytes += size
        self.ring.release(slot)

    @staticmethod
    def device_batch(static: StaticBatch, i: int) -> dict:
        """The i-th batch of ``static`` as the model reads it (on the
        card, inside or outside a capture)."""
        if static.slots is not None:
            return unpack_sentence_batch(static.buffers[i], *static.slots,
                                         static.has_ner)
        if isinstance(static.buffers, torch.Tensor):
            return unpack_batch(static.buffers[i], static.has_ner)
        return {k: t if t.is_floating_point() or t.dtype == torch.bool
                else t.long() for k, t in static.buffers.items()}
