"""ctypes bindings of the port's native (C++) graph builder.

Counterpart of ``gcn_tpu.graph.native``: ``prune_graph_batch_native``
prunes a whole padded batch of dependency trees in one call, with the
semantics of ``gcn_tpu_torch.graph.prune.prune_graph``, many times
faster than the per-example Python walker (``PERF.md`` has the rates).
``RelationDataset`` prunes every tree of a split through it at load time.

The library is the port's own: ``csrc/graph_builder.cpp``, built at first
use with the host compiler (``ops._cuda.HostLibrary``: ``g++ -O3
-std=c++17 -fPIC -shared``, no ``-march`` flag) into
``gcn_tpu_torch/_build/``, under a name that carries a hash of the source
and the flags.

One deliberate difference from ``gcn_tpu``: there is no silent fallback.
``gcn_tpu`` quietly prunes in Python when its library is absent; here a
build or load that fails raises, with the compiler's output, and only
``GCN_TPU_NATIVE=0`` (``gcn_tpu``'s switch, kept under its name) selects
the Python walker: ``load_library`` then returns None and
``native_available`` False.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from gcn_tpu_torch.ops._cuda import HostLibrary

ABI_VERSION = 1
SWITCH = "GCN_TPU_NATIVE"

_I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_U8P = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_FUNCTIONS = {
    "prune_graph_batch": ([_I32P, _I32P, _I32P, _I32P, _I32P,
                           ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                           _I32P, _I32P, _I32P, _U8P, _U8P, _I32P, _I32P],
                          ctypes.c_int32),
    "graph_builder_abi_version": ([], ctypes.c_int32),
}


def host_library(**kwargs) -> HostLibrary:
    """The graph builder's ``HostLibrary`` (``kwargs``: its ``build_dir``
    and ``cxx``, for tests)."""
    return HostLibrary("graph_builder.cpp", _FUNCTIONS, **kwargs)


LIBRARY = host_library()


def open_library(library: HostLibrary) -> ctypes.CDLL:
    """Build ``library`` if need be, load it and check its ABI version;
    raises ``RuntimeError`` naming the Python walker's switch when any of
    that fails."""
    try:
        lib = library.load()
    except RuntimeError as e:
        raise RuntimeError(
            f"the native graph builder could not be built or loaded: {e}\n"
            f"Set {SWITCH}=0 to prune with the Python walker instead.") from e
    version = lib.graph_builder_abi_version()
    if version != ABI_VERSION:
        raise RuntimeError(
            f"{library.lib_path()}: ABI version {version}, expected "
            f"{ABI_VERSION}; set {SWITCH}=0 to prune with the Python walker")
    return lib


def load_library() -> Optional[ctypes.CDLL]:
    """The graph builder's library, built at first use; None when
    ``GCN_TPU_NATIVE=0`` selects the Python walker."""
    if os.environ.get(SWITCH, "1") == "0":
        return None
    return open_library(LIBRARY)


def native_available() -> bool:
    """Whether the native builder prunes (False only under
    ``GCN_TPU_NATIVE=0``; a failed build raises)."""
    return load_library() is not None


def prune_graph_batch_native(
    heads: np.ndarray,     # [B, N] int32, 1-indexed, 0 = root
    deprels: np.ndarray,   # [B, N] int32
    subj_pos: np.ndarray,  # [B, N] int32
    obj_pos: np.ndarray,   # [B, N] int32
    lengths: np.ndarray,   # [B] int32
    prune_k: int,
):
    """Batched pruning through the native builder.

    Returns (edge_parent, edge_child, edge_deprel, edge_mask, keep,
    num_edges, roots): the edge arrays and ``keep`` [B, N] (zero past each
    row's edges and length), ``num_edges`` and ``roots`` [B].  Raises
    ValueError for arguments the builder refuses, for a head past its
    row's length, and for malformed rows (a cycle, or no common ancestor
    of the entities).
    """
    lib = load_library()
    if lib is None:
        raise RuntimeError(f"the native graph builder is off ({SWITCH}=0)")
    heads = np.ascontiguousarray(heads, np.int32)
    deprels = np.ascontiguousarray(deprels, np.int32)
    subj_pos = np.ascontiguousarray(subj_pos, np.int32)
    obj_pos = np.ascontiguousarray(obj_pos, np.int32)
    lengths = np.ascontiguousarray(lengths, np.int32)
    b, n = heads.shape
    for name, a in (("deprels", deprels), ("subj_pos", subj_pos),
                    ("obj_pos", obj_pos)):
        if a.shape != (b, n):
            raise ValueError(f"{name} is {a.shape}, heads {(b, n)}")
    if lengths.shape != (b,):
        raise ValueError(f"lengths is {lengths.shape}, expected {(b,)}")
    # the builder follows heads without a bound check: refuse one that
    # points past its row's tokens
    inside = np.arange(n)[None, :] < np.minimum(lengths, n)[:, None]
    past = inside & (heads > lengths[:, None])
    if past.any():
        rows = np.nonzero(past.any(axis=1))[0]
        raise ValueError(f"native graph builder: a head past the sentence's "
                         f"length at rows {rows.tolist()}")
    edge_parent = np.zeros((b, n), np.int32)
    edge_child = np.zeros((b, n), np.int32)
    edge_deprel = np.zeros((b, n), np.int32)
    edge_mask = np.zeros((b, n), np.uint8)
    keep = np.zeros((b, n), np.uint8)
    num_edges = np.zeros((b,), np.int32)
    roots = np.zeros((b,), np.int32)
    rc = lib.prune_graph_batch(
        heads, deprels, subj_pos, obj_pos, lengths, b, n, prune_k,
        edge_parent, edge_child, edge_deprel, edge_mask, keep, num_edges,
        roots,
    )
    if rc != 0:
        raise ValueError(f"native graph builder: invalid arguments (rc={rc})")
    if (num_edges < 0).any():
        bad = np.nonzero(num_edges < 0)[0]
        raise ValueError(
            f"native graph builder: malformed dependency trees at rows "
            f"{bad.tolist()} (a cycle, or no common ancestor)"
        )
    return (edge_parent, edge_child, edge_deprel, edge_mask.astype(bool),
            keep.astype(bool), num_edges, roots)
