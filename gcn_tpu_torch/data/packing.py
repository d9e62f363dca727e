"""Single-buffer batch transfer: pack the batch dict into ONE array on the
host and unpack it on the card.

Counterpart of ``gcn_tpu.data.packing``.  A batch of word ids crosses to
the card as one buffer, copied once, instead of 13-16 arrays copied one
by one; ``unpack_batch`` and ``unpack_sentence_batch`` take it apart on
the device with slices and views, into the dict
``train.evaluator.batch_to_device`` gives (integers int64, masks bool).

Three wire formats, as in gcn_tpu:

* int32 (``pack_batch``), ``[B, k*N + 3]``: words | pos | (ner) | deprel |
  edge_parent | edge_child | edge_deprel | edge_mask | subj_mask |
  obj_mask | pad_mask (N columns each) | lengths | labels | example_mask;
* compact uint8 (``pack_batch_compact``), ``[B, 16N + 9]`` (15N + 9
  without NER): words as int32 LE (4N) | pos, (ner), deprel, edge_deprel
  one byte each | edge_parent, edge_child as uint16 LE (2N each) | the 4
  masks a byte each | lengths, labels int32 LE | example_mask one byte;
* sentence-packed (``pack_sentence_batch``, a ``PackedBatcher`` batch,
  ``sentence_packable``), uint8 ``[B, sp_width(N, S)]``: words int32 LE
  (4N) | pos, (ner), deprel, edge_deprel a byte each | edge_parent,
  edge_child uint16 LE | edge_mask, pad_mask, seg_start a byte each |
  slot_mask, subj_mask, obj_mask bit-packed along N (``np.packbits``
  order), S·ceil(N/8) bytes each | lengths int32 LE | labels S int32 LE |
  example_mask S bytes.

Batches of float words (precomputed BERT vectors) and batches with keys
beyond these are not packable (``packable``, ``sentence_packable``).
The packers can write into ``out``, a buffer of the packed shape (a view
of pinned host memory).  ``fits_compact`` says whether the
compact format can hold a batch.
"""

from __future__ import annotations

import numpy as np
import torch

_INT_FIELDS = ("words", "pos", "ner", "deprel", "edge_parent",
               "edge_child", "edge_deprel")
_MASK_FIELDS = ("edge_mask", "subj_mask", "obj_mask", "pad_mask")
_SCALAR_FIELDS = ("lengths", "labels")  # + example_mask (bool)
_BYTE_FIELDS = ("pos", "ner", "deprel", "edge_deprel")  # values < 256
_U16_FIELDS = ("edge_parent", "edge_child")             # values < 65536


def packable(batch: dict) -> bool:
    """True when the batch is exactly the integer-id layout (not float
    words) in host numpy arrays, every per-token field of one width.  A
    batch with any other key does not pack: the packers would drop it."""
    w = batch["words"]
    if not isinstance(w, np.ndarray) or w.ndim != 2 or w.dtype == np.float32:
        return False
    expected = set(field_order("ner" in batch)) | set(_SCALAR_FIELDS) | {
        "example_mask"}
    if set(batch) != expected:
        return False
    n = w.shape[1]
    return all(
        isinstance(batch[f], np.ndarray) and batch[f].shape == (w.shape[0], n)
        for f in field_order("ner" in batch) if f != "words"
    )


def field_order(has_ner: bool) -> tuple:
    fields = [f for f in _INT_FIELDS if f != "ner" or has_ner]
    return tuple(fields) + _MASK_FIELDS


def packed_width(n: int, has_ner: bool, fmt: str) -> int:
    """Columns of a packed row of ``n`` tokens in format ``fmt``
    ("compact": bytes; "int32": int32 values)."""
    if fmt == "compact":
        return _compact_width(n, has_ner)
    return len(field_order(has_ner)) * n + 3


def pack_batch(batch: dict, out: np.ndarray | None = None) -> np.ndarray:
    """[B, k*N + 3] int32 single-buffer view of the batch (host-side)."""
    has_ner = "ner" in batch
    cols = [np.asarray(batch[f], np.int32) for f in field_order(has_ner)]
    cols.append(np.asarray(batch["lengths"], np.int32)[:, None])
    cols.append(np.asarray(batch["labels"], np.int32)[:, None])
    cols.append(np.asarray(batch["example_mask"], np.int32)[:, None])
    return np.concatenate(cols, axis=1, out=out)


def _in_range(a: np.ndarray, hi: int) -> bool:
    return not a.size or (a.min() >= 0 and a.max() < hi)


def fits_compact(batch: dict) -> bool:
    """Whether every narrow field of ``batch`` fits its compact wire width
    (``pack_batch_compact`` raises where one does not)."""
    return all(_in_range(np.asarray(batch[f]), hi)
               for fields, hi in ((_BYTE_FIELDS, 256), (_U16_FIELDS, 65536))
               for f in fields if f in batch)


def _check_range(a: np.ndarray, field: str, hi: int) -> np.ndarray:
    """Raise where a value does not fit its narrow wire width: a negative
    value would wrap through uint8/uint16 and corrupt the batch."""
    if not _in_range(a, hi):
        raise ValueError(
            f"{field} range [{a.min()}, {a.max()}] does not fit the "
            f"[0, {hi}) wire width")
    return a


def _compact_width(n: int, has_ner: bool) -> int:
    return (16 if has_ner else 15) * n + 9


def pack_batch_compact(batch: dict,
                       out: np.ndarray | None = None) -> np.ndarray:
    """[B, 16N + 9] uint8 (15N + 9 without NER) single-buffer view of the
    batch (host-side), each field at its natural width."""
    has_ner = "ner" in batch
    words = np.ascontiguousarray(batch["words"], "<i4")
    b, n = words.shape
    shape = (b, _compact_width(n, has_ner))
    if out is None:
        out = np.empty(shape, np.uint8)
    elif out.shape != shape or out.dtype != np.uint8:
        raise ValueError(f"out must be {shape} uint8, got {out.shape} "
                         f"{out.dtype}")
    col = 0

    def put(raw: np.ndarray) -> None:
        nonlocal col
        w = raw.shape[1] * raw.dtype.itemsize
        out[:, col:col + w] = raw.view(np.uint8).reshape(b, w)
        col += w

    put(words)
    for f in _BYTE_FIELDS:
        if f == "ner" and not has_ner:
            continue
        a = _check_range(np.asarray(batch[f]), f, 256)
        put(np.ascontiguousarray(a, np.uint8))
    for f in _U16_FIELDS:
        a = _check_range(np.asarray(batch[f]), f, 65536)
        put(np.ascontiguousarray(a, "<u2"))
    for f in _MASK_FIELDS:
        put(np.ascontiguousarray(batch[f], np.uint8))
    put(np.ascontiguousarray(batch["lengths"], "<i4")[:, None])
    put(np.ascontiguousarray(batch["labels"], "<i4")[:, None])
    put(np.ascontiguousarray(batch["example_mask"], np.uint8)[:, None])
    if col != shape[1]:
        raise AssertionError(f"packed {col} of {shape[1]} columns")
    return out


def unpack_batch(packed: torch.Tensor, has_ner: bool) -> dict:
    """The batch dict of a packed buffer (either format, told apart by its
    dtype: uint8 compact, int32 the other), on the buffer's device:
    integers int64, masks bool, as ``batch_to_device`` gives them."""
    if packed.dtype == torch.uint8:
        return unpack_batch_compact(packed, has_ner)
    fields = field_order(has_ner)
    n = (packed.shape[1] - 3) // len(fields)
    batch = {}
    for i, f in enumerate(fields):
        col = packed[:, i * n:(i + 1) * n]
        batch[f] = col.bool() if f in _MASK_FIELDS else col.long()
    base = len(fields) * n
    batch["lengths"] = packed[:, base].long()
    batch["labels"] = packed[:, base + 1].long()
    batch["example_mask"] = packed[:, base + 2].bool()
    return batch


def _le(by: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[B, w·k] bytes → [B, k] int64 of the little-endian ``dtype``
    values they hold (the card and the host are both little-endian)."""
    return by.contiguous().view(dtype).long()


def unpack_batch_compact(packed: torch.Tensor, has_ner: bool) -> dict:
    """The inverse of ``pack_batch_compact`` on the buffer's device."""
    n = (packed.shape[1] - 9) // (16 if has_ner else 15)
    batch = {}
    col = 0

    def take(w):
        nonlocal col
        s = packed[:, col:col + w]
        col += w
        return s

    batch["words"] = _le(take(4 * n), torch.int32)
    for f in _BYTE_FIELDS:
        if f == "ner" and not has_ner:
            continue
        batch[f] = take(n).long()
    for f in _U16_FIELDS:
        # int16 holds a uint16 below 2**15 as it is; the mask restores
        # the ones above
        batch[f] = _le(take(2 * n), torch.int16) & 0xFFFF
    for f in _MASK_FIELDS:
        batch[f] = take(n).bool()
    batch["lengths"] = _le(take(4), torch.int32)[:, 0]
    batch["labels"] = _le(take(4), torch.int32)[:, 0]
    batch["example_mask"] = take(1)[:, 0].bool()
    return batch


# ------------------------------------------------ sentence-packed batches
_SP_TOKEN_FIELDS = ("pos", "ner", "deprel", "edge_deprel")
_SP_BYTE_MASKS = ("edge_mask", "pad_mask", "seg_start")
_SP_BIT_MASKS = ("slot_mask", "subj_mask", "obj_mask")


def _sp_expected_keys(has_ner: bool) -> set:
    fields = [f for f in _SP_TOKEN_FIELDS if f != "ner" or has_ner]
    return ({"words", "lengths", "labels", "example_mask"}
            | set(fields) | set(_U16_FIELDS)
            | set(_SP_BYTE_MASKS) | set(_SP_BIT_MASKS))


def sentence_packable(batch: dict) -> bool:
    """True for a ``PackedBatcher`` batch of word ids in host numpy arrays
    with exactly the fields ``pack_sentence_batch`` writes."""
    if "slot_mask" not in batch or not isinstance(
            batch.get("words"), np.ndarray):
        return False
    if set(batch) != _sp_expected_keys("ner" in batch):
        return False
    return batch["words"].ndim == 2


def sp_width(n: int, s: int, has_ner: bool) -> int:
    """Bytes of a sentence-packed row of ``n`` tokens and ``s`` slots."""
    return ((15 if has_ner else 14) * n
            + 3 * s * ((n + 7) // 8) + 5 * s + 4)


def pack_sentence_batch(batch: dict,
                        out: np.ndarray | None = None) -> np.ndarray:
    """[B, sp_width] uint8 single-buffer view of a ``PackedBatcher``
    batch (host-side), the bytes of gcn_tpu's ``pack_sentence_batch``."""
    has_ner = "ner" in batch
    words = np.ascontiguousarray(batch["words"], "<i4")
    b, n = words.shape
    s = batch["slot_mask"].shape[1]
    shape = (b, sp_width(n, s, has_ner))
    if out is None:
        out = np.empty(shape, np.uint8)
    elif out.shape != shape or out.dtype != np.uint8:
        raise ValueError(f"out must be {shape} uint8, got {out.shape} "
                         f"{out.dtype}")
    col = 0

    def put(raw: np.ndarray) -> None:
        nonlocal col
        raw = raw.reshape(b, -1)
        w = raw.shape[1] * raw.dtype.itemsize
        out[:, col:col + w] = raw.view(np.uint8).reshape(b, w)
        col += w

    put(words)
    for f in _SP_TOKEN_FIELDS:
        if f == "ner" and not has_ner:
            continue
        a = _check_range(np.asarray(batch[f]), f, 256)
        put(np.ascontiguousarray(a, np.uint8))
    for f in _U16_FIELDS:
        a = _check_range(np.asarray(batch[f]), f, 65536)
        put(np.ascontiguousarray(a, "<u2"))
    for f in _SP_BYTE_MASKS:
        put(np.ascontiguousarray(batch[f], np.uint8))
    for f in _SP_BIT_MASKS:
        put(np.packbits(np.asarray(batch[f], bool), axis=-1))
    put(np.ascontiguousarray(batch["lengths"], "<i4")[:, None])
    put(np.ascontiguousarray(batch["labels"], "<i4").reshape(b, s))
    put(np.ascontiguousarray(batch["example_mask"], np.uint8)
        .reshape(b, s))
    if col != shape[1]:
        raise AssertionError(f"packed {col} of {shape[1]} columns")
    return out


def _unbits(by: torch.Tensor, s: int, n: int) -> torch.Tensor:
    """[B, s·ceil(n/8)] bytes → [B, s, n] bool, ``np.packbits``'s order
    (the first value in the high bit)."""
    cn8 = (n + 7) // 8
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=by.device)
    bits = (by.reshape(by.shape[0], s, cn8, 1) >> shifts) & 1
    return bits.reshape(by.shape[0], s, cn8 * 8)[:, :, :n].bool()


def unpack_sentence_batch(packed: torch.Tensor, n: int, s: int,
                          has_ner: bool) -> dict:
    """The inverse of ``pack_sentence_batch`` on the buffer's device, for
    rows of ``n`` tokens and ``s`` slots: integers int64, masks bool,
    ``labels`` and ``example_mask`` [B·S]."""
    batch = {}
    col = 0

    def take(w):
        nonlocal col
        sl = packed[:, col:col + w]
        col += w
        return sl

    batch["words"] = _le(take(4 * n), torch.int32)
    for f in _SP_TOKEN_FIELDS:
        if f == "ner" and not has_ner:
            continue
        batch[f] = take(n).long()
    for f in _U16_FIELDS:
        batch[f] = _le(take(2 * n), torch.int16) & 0xFFFF
    for f in _SP_BYTE_MASKS:
        batch[f] = take(n).bool()
    for f in _SP_BIT_MASKS:
        batch[f] = _unbits(take(s * ((n + 7) // 8)), s, n)
    batch["lengths"] = _le(take(4), torch.int32)[:, 0]
    batch["labels"] = _le(take(4 * s), torch.int32).reshape(-1)
    batch["example_mask"] = take(s).reshape(-1).bool()
    return batch
