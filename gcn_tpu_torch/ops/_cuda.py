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

``HostLibrary`` is the same scheme for a C++ source that runs on the host
(``csrc/graph_builder.cpp``): built with the host compiler (``$CXX``, else
``g++``) and ``HOST_FLAGS``, which carry no ``-march`` flag, so the library
runs on any CPU of the architecture it was built for.

Launch counts survive CUDA graphs: a replay makes no Python call, so the
launches made while a graph is captured are tallied (``tally_launches``)
and added again at each replay (``count_replay``).  Each kernel counts its
launches in all and by exported function (``by_function``), so that a
kernel's f32 and bf16 instances are told apart (``launches_of``).
``BUILDS`` counts the libraries this process has compiled (a library
found in the build directory is loaded, not counted) and the builds'
wall seconds: a build inside a timed window shows there.
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
HOST_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared",
              "-frecord-gcc-switches"]  # the flags, readable in the library
NVCC_TIMEOUT_S = 600  # a build's time limit, host builds too
# the open tallies, innermost last: a launch counts in the innermost one
# instead of ``CudaKernel.launches``.  Module-wide, not per thread:
# autograd runs a captured step's backward kernels on a thread of its own.
_TALLIES: list[dict] = []
BUILDS = {"libraries": 0, "seconds": 0.0}  # compiled in this process


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
        return _start_compile(
            self.lib_path(),
            lambda tmp: [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                         str(self.source)])

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


class HostLibrary:
    """A ``csrc`` C++ source built into a shared library for the host and
    loaded with ctypes: ``functions`` maps each exported name to its
    (argument types, result type).  ``build_dir`` and ``cxx`` (the
    compiler, default ``$CXX`` or ``g++``) are there for tests."""

    def __init__(self, source: str, functions: dict[str, tuple],
                 build_dir: Path | None = None, cxx: str | None = None):
        self.source = CSRC / source
        self.functions = functions
        self.build_dir = Path(build_dir) if build_dir else BUILD_DIR
        self.cxx = cxx or os.environ.get("CXX", "g++")
        self._lib = None

    def lib_path(self) -> Path:
        digest = hashlib.sha256(
            self.source.read_bytes()
            + " ".join([self.cxx, *HOST_FLAGS]).encode()).hexdigest()[:16]
        return self.build_dir / f"lib{self.source.stem}-{digest}.so"

    def _start_build(self):
        return _start_compile(
            self.lib_path(),
            lambda tmp: [self.cxx, *HOST_FLAGS, "-o", str(tmp),
                         str(self.source)])

    def load(self) -> ctypes.CDLL:
        """The loaded library, built first if it is not there; raises
        ``RuntimeError`` (with the compiler's output) when the build or the
        load fails."""
        if self._lib is None:
            build_all([self])
            try:
                lib = ctypes.CDLL(str(self.lib_path()))
            except OSError as e:
                raise RuntimeError(f"loading {self.lib_path()}: {e}") from e
            for fname, (argtypes, restype) in self.functions.items():
                fn = getattr(lib, fname)
                fn.argtypes = argtypes
                fn.restype = restype
            self._lib = lib
        return self._lib


def _start_compile(out: Path, command):
    """Start ``command(tmp)`` (a compiler writing ``tmp``) unless ``out``
    exists; returns (process, tmp, out), or None when ``out`` is there.
    The build writes to a name of this process's own, which ``build_all``
    renames to ``out`` when it succeeds."""
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = command(tmp)
    try:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        raise RuntimeError(f"{cmd[0]} could not be started: {e}") from e
    return proc, tmp, out


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


def build_all(kernels: list[CudaKernel | HostLibrary]) -> dict[str, dict]:
    """Build every source that has no library yet, one compiler process
    per source, all started together.  Returns, per source, the build's
    seconds (0 when the library was already there) and the compiler's
    output (for ``nvcc``, the ``ptxas -v`` register and shared-memory
    report)."""
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
                    f"{proc.args[0]} failed for {stem} "
                    f"(rc {proc.returncode}):\n{log}")
            os.replace(tmp, out)
            report[stem] = {"seconds": time.perf_counter() - t0, "log": log}
        if started:
            BUILDS["libraries"] += len(started)
            BUILDS["seconds"] += time.perf_counter() - t0
    finally:
        for proc, tmp, _ in started.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()
    return report
