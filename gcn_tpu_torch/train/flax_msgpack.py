"""The msgpack subset that ``flax.serialization`` writes, in Python and numpy.

A flax checkpoint file (``params.msgpack``, ``opt_state.msgpack``) is one
msgpack map tree: maps with string keys whose leaves are ext type 1, an
ndarray whose payload is itself the packing of ``(shape, dtype name,
C-order bytes)`` (a scalar has shape ``[]``).  This module packs and
unpacks that subset: maps, arrays (lists and tuples), str, bin, ints,
floats, nil, bool and ext types 1 (ndarray) and 3 (numpy scalar),
without the ``msgpack`` package, which the card's host lacks.

``to_bytes`` of a nested dict of numpy arrays gives the bytes
``flax.serialization.to_bytes`` gives for it (keys in the dict's order;
flax writes a parameter tree's keys sorted, as JAX's pytrees order
them); ``from_bytes`` is its inverse.  Arrays above flax's 1 GiB chunk
limit, which flax splits into chunk maps, are refused both ways.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
MAX_ARRAY_BYTES = 2**30  # flax chunks arrays above this; not supported here


# ------------------------------------------------------------------ pack
def _pack_len(out: bytearray, n: int, fix_base: int | None, fix_max: int,
              codes: tuple[int, int, int]) -> None:
    """A container or string header: a fix form below ``fix_max``, else
    the 8-, 16- or 32-bit length code (``codes``; 0 where none exists)."""
    if fix_base is not None and n < fix_max:
        out.append(fix_base | n)
    elif codes[0] and n < 1 << 8:
        out += struct.pack(">BB", codes[0], n)
    elif n < 1 << 16:
        out += struct.pack(">BH", codes[1], n)
    elif n < 1 << 32:
        out += struct.pack(">BI", codes[2], n)
    else:
        raise ValueError(f"msgpack object of length {n} is too long")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 128:
        out.append(v)
    elif -32 <= v < 0:
        out += struct.pack(">b", v)
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">BB", 1 << 8), (0xCD, ">BH", 1 << 16),
                               (0xCE, ">BI", 1 << 32),
                               (0xCF, ">BQ", 1 << 64)):
            if v < top:
                out += struct.pack(fmt, code, v)
                return
        raise ValueError(f"integer {v} does not fit msgpack")
    else:
        for code, fmt, low in ((0xD0, ">Bb", -(1 << 7)),
                               (0xD1, ">Bh", -(1 << 15)),
                               (0xD2, ">Bi", -(1 << 31)),
                               (0xD3, ">Bq", -(1 << 63))):
            if v >= low:
                out += struct.pack(fmt, code, v)
                return
        raise ValueError(f"integer {v} does not fit msgpack")


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out += struct.pack(">Bb", fixed[n], code)
    elif n < 1 << 8:
        out += struct.pack(">BBb", 0xC7, n, code)
    elif n < 1 << 16:
        out += struct.pack(">BHb", 0xC8, n, code)
    else:
        out += struct.pack(">BIb", 0xC9, n, code)
    out += data


def ndarray_payload(arr: np.ndarray) -> bytes:
    """Ext type 1's payload: the packing of (shape, dtype name, bytes)."""
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise ValueError("object and structured dtypes are not supported")
    if arr.nbytes > MAX_ARRAY_BYTES:
        raise ValueError(f"array of {arr.nbytes} bytes is above flax's "
                         f"{MAX_ARRAY_BYTES}-byte chunk limit")
    return packb((list(arr.shape), arr.dtype.name, arr.tobytes("C")))


def _pack(out: bytearray, obj: Any) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, np.ndarray):
        _pack_ext(out, EXT_NDARRAY, ndarray_payload(obj))
    elif isinstance(obj, np.generic):  # a numpy scalar, as flax packs one
        _pack_ext(out, EXT_NPSCALAR, ndarray_payload(np.asarray(obj)))
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out += struct.pack(">Bd", 0xCB, obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(out, len(data), None, 0, (0xC4, 0xC5, 0xC6))
        out += data
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 16, (0, 0xDC, 0xDD))
        for item in obj:
            _pack(out, item)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 16, (0, 0xDE, 0xDF))
        for key, value in obj.items():
            _pack(out, key)
            _pack(out, value)
    else:
        raise TypeError(f"cannot msgpack {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """msgpack bytes of ``obj`` (str as str, bytes as bin, as
    ``msgpack.packb`` with ``use_bin_type=True`` writes them)."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


# ---------------------------------------------------------------- unpack
class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        view = self.data[self.pos:self.pos + n]
        self.pos += n
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_FIXED_EXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_SIZED = {  # code → (struct format of the length or value, kind)
    0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
    0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
    0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
    0xDC: (">H", "array"), 0xDD: (">I", "array"),
    0xDE: (">H", "map"), 0xDF: (">I", "map"),
}
_SCALARS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
            0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}


def _dtype(name: str) -> np.dtype:
    if name == "bfloat16":
        raise ValueError("bfloat16 arrays are not supported by the port")
    return np.dtype(name)


def ndarray_from_payload(data: bytes) -> np.ndarray:
    """The inverse of ``ndarray_payload`` (a writable copy)."""
    shape, name, buf = unpackb(data, raw=True)
    if isinstance(name, bytes):
        name = name.decode("ascii")
    return np.frombuffer(bytes(buf), dtype=_dtype(name)).reshape(
        shape, order="C").copy()


def _ext(code: int, data: bytes):
    if code == EXT_NDARRAY:
        return ndarray_from_payload(data)
    if code == EXT_NPSCALAR:
        return ndarray_from_payload(data)[()]
    raise ValueError(f"unsupported msgpack ext type {code}")


def _read(r: _Reader, raw: bool):
    b = r.unpack(">B")
    if b < 0x80:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _read_map(r, b & 0x0F, raw)
    if 0x90 <= b <= 0x9F:
        return [_read(r, raw) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return _str(r.take(b & 0x1F), raw)
    if b == 0xC0:
        return None
    if b in (0xC2, 0xC3):
        return b == 0xC3
    if b in _SCALARS:
        return r.unpack(_SCALARS[b])
    if b in _FIXED_EXT:
        code = r.unpack(">b")
        return _ext(code, bytes(r.take(_FIXED_EXT[b])))
    if b in _SIZED:
        fmt, kind = _SIZED[b]
        n = r.unpack(fmt)
        if kind == "bin":
            return bytes(r.take(n))
        if kind == "str":
            return _str(r.take(n), raw)
        if kind == "array":
            return [_read(r, raw) for _ in range(n)]
        if kind == "map":
            return _read_map(r, n, raw)
        code = r.unpack(">b")
        return _ext(code, bytes(r.take(n)))
    raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")


def _str(view: memoryview, raw: bool):
    return bytes(view) if raw else bytes(view).decode("utf-8")


def _read_map(r: _Reader, n: int, raw: bool) -> dict:
    out = {}
    for _ in range(n):
        key = _read(r, raw)
        out[key] = _read(r, raw)
    return out


def unpackb(data: bytes, raw: bool = False):
    """The object packed in ``data`` (arrays as lists, ext type 1 as a
    numpy array); ``raw=True`` leaves str as bytes."""
    r = _Reader(data)
    obj = _read(r, raw)
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes after the object")
    return obj


# ----------------------------------------------------------------- trees
def to_bytes(tree: dict) -> bytes:
    """flax's bytes of a nested dict (string keys) of numpy arrays."""
    return packb(tree)


def from_bytes(data: bytes) -> dict:
    """The nested dict of numpy arrays in flax's bytes."""
    tree = unpackb(data)
    if not isinstance(tree, dict):
        raise ValueError("a flax checkpoint holds a map at its top")
    return tree
