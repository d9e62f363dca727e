"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/*.cu`` file exposes a plain ``extern "C"`` interface (no
PyTorch headers), so it compiles in seconds into its own shared library
under ``gcn_tpu_torch/_build/``.  The library's name carries a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags: a changed
source or header builds anew, an unchanged one is loaded as it is.  A
build writes to a temporary name and renames it into place, so an
interrupted build leaves no lock and no half-written library.

Nothing here runs at import time; the first launch of a kernel builds it,
and ``build_all`` builds several at once (one ``nvcc`` each, in parallel).

Launch counts survive CUDA graphs: a replay makes no Python call, so the
launches made while a graph is captured are tallied (``tally_launches``)
and added again at each replay (``count_replay``).  Each kernel counts its
launches in all and by exported function (``by_function``), so that a
kernel's f32 and bf16 instances are told apart (``launches_of``).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
NVCC_TIMEOUT_S = 600
# the open tallies, innermost last: a launch counts in the innermost one
# instead of ``CudaKernel.launches``.  Module-wide, not per thread:
# autograd runs a captured step's backward kernels on a thread of its own.
_TALLIES: list[dict] = []


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


class CudaKernel:
    """One kernel entry of a ``csrc`` source: its exported C functions and
    a launch count.

    ``functions`` maps each exported name to its ctypes argument types;
    every exported launcher returns the ``cudaGetLastError()`` code.
    ``launches`` counts successful launches, replays of captured launches
    included, and ``by_function`` the same by exported function;
    ``reset`` sets both to 0 for callers that want to know whether a path
    went through the kernel.  Several entries
    may share one source (``name`` tells them apart); they share its
    library and count their launches apart.
    """

    def __init__(self, source: str, functions: dict[str, list],
                 name: str | None = None):
        self.source = CSRC / source
        self.functions = functions
        self.name = name or self.source.stem
        self.launches = 0
        self.by_function: dict[str, int] = {}
        self._lib = None

    def reset(self) -> None:
        """Set the launch counts to 0."""
        self.launches = 0
        self.by_function = {}

    def count(self, fname: str, n: int = 1) -> None:
        """Add ``n`` launches of the exported function ``fname``."""
        self.launches += n
        self.by_function[fname] = self.by_function.get(fname, 0) + n

    def launches_of(self, suffix: str) -> int:
        """Launches of the exported functions whose names end in
        ``suffix`` (``"_f32"``, ``"_bf16"``: one instance of the kernel)."""
        return sum(n for f, n in self.by_function.items()
                   if f.endswith(suffix))

    def lib_path(self) -> Path:
        headers = b"".join(h.read_bytes()
                           for h in sorted(CSRC.glob("*.cuh")))
        digest = hashlib.sha256(
            self.source.read_bytes() + headers
            + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.source.stem}-{digest}.so"

    def _start_build(self):
        out = self.lib_path()
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp, out

    def _error_string(self, lib):
        return getattr(lib, f"{self.source.stem}_error_string")

    def load(self):
        if self._lib is None:
            build_all([self])
            lib = ctypes.CDLL(str(self.lib_path()))
            for fname, argtypes in self.functions.items():
                fn = getattr(lib, fname)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            err = self._error_string(lib)
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def query(self, fname: str, *args) -> None:
        """Call an exported function that returns a CUDA error code and
        launches nothing (an occupancy query); raises on an error."""
        lib = self.load()
        rc = getattr(lib, fname)(*args)
        if rc != 0:
            msg = self._error_string(lib)(rc).decode()
            raise RuntimeError(f"{fname}: CUDA error {rc} ({msg})")

    def launch(self, fname: str, *args) -> None:
        self.query(fname, *args)
        if _TALLIES:
            tally = _TALLIES[-1]
            tally[self, fname] = tally.get((self, fname), 0) + 1
        else:
            self.count(fname)


@contextlib.contextmanager
def tally_launches():
    """Count the launches made inside the block in a dict of its own
    ((kernel, function) → launches) instead of the kernels' counts."""
    tally: dict = {}
    _TALLIES.append(tally)
    try:
        yield tally
    finally:
        _TALLIES.remove(tally)


def count_replay(tally: dict) -> None:
    """Add a captured graph's launches to the kernels' counts: one
    replay launched them all again."""
    for (kernel, fname), n in tally.items():
        kernel.count(fname, n)


def build_all(kernels: list[CudaKernel]) -> dict[str, dict]:
    """Build every source that has no library yet, one ``nvcc`` per
    source, all started together.  Returns, per source, the build's
    seconds (0 when the library was already there) and the compiler's
    output (the ``ptxas -v`` register and shared-memory report)."""
    t0 = time.perf_counter()
    started = {}
    try:
        report = {}
        for k in kernels:
            stem = k.source.stem
            if stem in report:
                continue
            report[stem] = {"seconds": 0.0, "log": ""}
            job = k._start_build()
            if job is not None:
                started[stem] = job
        for stem, (proc, tmp, out) in started.items():
            log, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {stem} (rc {proc.returncode}):\n{log}")
            os.replace(tmp, out)
            report[stem] = {"seconds": time.perf_counter() - t0, "log": log}
    finally:
        for proc, tmp, _ in started.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()
    return report
