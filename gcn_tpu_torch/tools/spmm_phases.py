#!/usr/bin/env python3
"""Where the fused GCN layer's forward spends its time: SM cycles a block by
phase.

    python3 gcn_tpu_torch/tools/spmm_phases.py

Builds ``csrc/spmm_fused.cu`` with ``-DSPMM_PHASES``, which compiles in the
forward kernels' phase clocks (``PhaseClock`` in that file), into
``gcn_tpu_torch/_build/phases/``.  At the paper GCN's two layers (B=50,
N=96, T=360 and 200, H=200; seeded random trees of 48-96 nodes, seeded
inputs) it runs the f32 and the bf16 instance ten times each and prints
one JSON line per (instance, T): the SM cycles a block of each phase
(summed over the clocked threads of every block, over the blocks), the
blocks a call, the card's SM clock, and, for the same inputs, the
uninstrumented kernel's ms a call (the package's wrapper, a replayed CUDA
graph) and its error against the plain version.  The phases are named in
``PHASES``.  The last line is the card's name and power limit.  Run from
another checkout of the repository, it measures that checkout's kernels.
Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, REPO)

B, N, H = 50, 96, 200
WIDTHS = (360, 200)
RUNS = 10
SLOTS = 15  # csrc/spmm_fused.cu kPhaseSlots
# slot names by instance: thread 0 of each block clocks them, in the
# order they follow one another
PHASES = {
    "f32": ["edge load and first W copies", "gather of (S h)",
            "W wait and product", "epilogue"],
    "bf16": ["h copies issued", "edge load", "neighbour lists",
             "wait for the staged h", "gather of (S h) and the tile barrier",
             "W wait", "ldmatrix and mma", "epilogue"],
}


def build(out_dir: str):
    """spmm_fused.cu built with its phase clocks."""
    from gcn_tpu_torch.ops._cuda import CSRC, NVCC_FLAGS, NVCC_TIMEOUT_S, _nvcc

    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "libspmm_fused_phases.so")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-DSPMM_PHASES", "-o", lib,
         str(CSRC / "spmm_fused.cu")],
        capture_output=True, text=True, timeout=NVCC_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for spmm_fused.cu:\n{proc.stdout}"
                           f"{proc.stderr}")
    return ctypes.CDLL(lib)


def graph_ms(torch, fn, reps: int = 10, calls: int = 20) -> float:
    """ms a call of ``fn``: ``calls`` calls captured in one CUDA graph,
    replayed ``reps`` times."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def tree_edges(rng, b: int, n: int):
    """[b, n] edge lists of b seeded random trees of n/2..n nodes (one of
    n), the padded slots masked."""
    import numpy as np

    parent = np.zeros((b, n), np.int32)
    child = np.zeros((b, n), np.int32)
    mask = np.zeros((b, n), bool)
    for i in range(b):
        length = n if i == 0 else int(rng.randint(n // 2, n + 1))
        order = rng.permutation(length)
        for k in range(1, length):
            parent[i, k - 1] = order[rng.randint(0, k)]
            child[i, k - 1] = order[k]
        mask[i, :length - 1] = True
    return parent, child, mask


def main() -> int:
    import functools

    import numpy as np
    import torch

    from gcn_tpu_torch.ops import spmm_fused as mod
    from gcn_tpu_torch.ops._cuda import BUILD_DIR

    if not torch.cuda.is_available():
        print("spmm_phases: no CUDA device is available", file=sys.stderr)
        return 2
    lib = build(os.path.join(BUILD_DIR, "phases"))
    lib.spmm_phases_read.argtypes = [ctypes.c_void_p]
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(0)
    edges = [torch.from_numpy(a).to(dev) for a in tree_edges(rng, B, N)]
    stream = torch.cuda.current_stream().cuda_stream
    clock_khz = torch.cuda.get_device_properties(0).clock_rate
    for t in WIDTHS:
        h32 = torch.tensor(rng.randn(B, N, t), dtype=torch.float32,
                           device=dev)
        w32 = torch.tensor(rng.uniform(-1, 1, (t, H)) / np.sqrt(t),
                           dtype=torch.float32, device=dev)
        b32 = torch.tensor(rng.uniform(-0.1, 0.1, H), dtype=torch.float32,
                           device=dev)
        for key, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            h, w, bias = (a.to(dtype) for a in (h32, w32, b32))
            out = torch.empty(B, N, H, dtype=dtype, device=dev)
            symbol = f"spmm_fused_forward_{key}"
            fn = getattr(lib, symbol)
            fn.argtypes = mod.KERNEL.functions[symbol]
            args = (*(a.data_ptr() for a in edges), h.data_ptr(),
                    w.data_ptr(), bias.data_ptr(), out.data_ptr(), B, N,
                    edges[0].shape[1], t, H, stream)
            if fn(*args) != 0:  # warm-up
                raise RuntimeError(f"spmm_phases: the {key} launch failed")
            torch.cuda.synchronize()
            lib.spmm_phases_zero()
            for _ in range(RUNS):
                fn(*args)
            torch.cuda.synchronize()
            slots = (ctypes.c_ulonglong * (SLOTS + 1))()
            lib.spmm_phases_read(slots)
            blocks = max(slots[SLOTS], 1)
            call = functools.partial(mod.gcn_spmm_forward, *edges, h, w, bias)
            want = mod.gcn_spmm_plain(*edges, h, w, bias).float()
            err = float((call().float() - want).abs().max()) / max(
                1.0, float(want.abs().max()))
            print(json.dumps({
                "kernel": f"spmm_fused_forward_{key}", "T": t,
                "shape": {"B": B, "N": N, "T": t, "H": H},
                "ms": graph_ms(torch, call), "max_err": err,
                "cycles_per_block": {name: slots[i] / blocks
                                     for i, name in enumerate(PHASES[key])},
                "blocks_per_call": blocks / RUNS,
                "sm_clock_khz": clock_khz}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
