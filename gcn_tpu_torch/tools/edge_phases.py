#!/usr/bin/env python3
"""Where the bf16 band aggregation forward (5b) and the bf16 sym pair (8b)
spend their time: SM cycles a warp by phase.

    python3 gcn_tpu_torch/tools/edge_phases.py

Builds ``csrc/band_aggregate.cu`` and ``csrc/spmm_fused.cu`` with
``-DEDGE_PHASES``, which compiles in the two kernels' phase clocks
(``EdgeClock`` in ``csrc/edge_gather.cuh``), and without it (for the
``ptxas`` registers of the kernels the package runs), into
``gcn_tpu_torch/_build/phases/``.  Cases: ``path`` (B=50, N=E=96, seeded
random trees of 48-96 nodes: 5b at H=200, 8b at T=360 and 200, as on the
main path) and ``star`` (B=3, N=E=1200, node 7 the parent of every edge:
one row with 1200 neighbours).  It runs each kernel ten times and prints
one JSON line per (kernel, case, width): the SM cycles a warp of each
phase (``PHASES``; lane 0 of each warp clocks them into its block's
slots, summed over the warps and divided by their count; a load's wait
falls in the phase that first uses its value; 8b's pipelined groups fold
their loads into the epilogue's phase), a warp's mean and longest span,
the warps a call, the card's SM clock, and for the same inputs the
uninstrumented kernel's ms a call (the package's wrapper,
``chip_smoke.graph_ms``: 20 calls in one replayed CUDA graph), its error
against the plain version, the blocks an SM holds, the grid's blocks and the blocks in a wave (SMs x blocks an
SM), and the ``ptxas`` lines of the kernel's instances.  The last line is
the card's name and power limit.  Run from another checkout of the
repository, it measures that checkout's kernels.  Needs a CUDA device and
nvcc.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, REPO)

RUNS = 10
PHASE_BLOCKS = 8192  # csrc/edge_gather.cuh kPhaseBlocks
PHASES = ["own row issued", "edge load and barrier", "ballot walk",
          "neighbour loads and adds", "epilogue and store"]
# (case, B, N): the main path's bucket, one row of 1200 neighbours
CASES = {"path": (50, 96), "star": (3, 1200)}
WIDTHS = {"band_aggregate_forward_bf16": {"path": (200,), "star": (200,)},
          "spmm_fused_sym_pair_bf16": {"path": (360, 200), "star": (200,)}}
SOURCES = {"band_aggregate_forward_bf16": ("band_aggregate.cu",
                                           "band_aggregate_fwd"),
           "spmm_fused_sym_pair_bf16": ("spmm_fused.cu", "sym_pair")}


def build(out_dir: str) -> dict:
    """Both sources with and without the phase clocks, one nvcc each, in
    parallel: {(source, phases): (library path, ptxas log)}."""
    from gcn_tpu_torch.ops._cuda import CSRC, NVCC_FLAGS, NVCC_TIMEOUT_S, _nvcc

    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for source in sorted({s for s, _ in SOURCES.values()}):
        for phases in (True, False):
            stem = source[:-3] + ("_phases" if phases else "_plain_build")
            lib = os.path.join(out_dir, f"lib{stem}.so")
            cmd = [_nvcc(), *NVCC_FLAGS,
                   *(["-DEDGE_PHASES"] if phases else []), "-o", lib,
                   str(CSRC / source)]
            jobs[source, phases] = (lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    out = {}
    for key, (lib, proc) in jobs.items():
        log, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key[0]}:\n{log}")
        out[key] = (lib, log)
    return out


def edges_of(rng, name: str, b: int, n: int):
    """[b, n] parent, child int32 and mask bool: random trees (path) or a
    star around node 7 (every slot set)."""
    import numpy as np

    if name == "star":
        child = rng.randint(0, n, (b, n)).astype(np.int32)
        return (np.full((b, n), 7, np.int32), child, np.ones((b, n), bool))
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
    import numpy as np
    import torch

    from gcn_tpu_torch.ops import band_aggregate as band
    from gcn_tpu_torch.ops import spmm_fused as spmm
    from gcn_tpu_torch.ops._cuda import BUILD_DIR

    if not torch.cuda.is_available():
        print("edge_phases: no CUDA device is available", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location(
        "smoke_clock", os.path.join(REPO, "chip_smoke.py"))
    clock = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(clock)
    builds = build(os.path.join(BUILD_DIR, "phases"))
    dev = torch.device("cuda", 0)
    props = torch.cuda.get_device_properties(0)
    sms = props.multi_processor_count
    clock_khz = getattr(props, "clock_rate", None)
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.RandomState(0)
    for case, (b, n) in CASES.items():
        edges = [torch.from_numpy(a).to(dev)
                 for a in edges_of(rng, case, b, n)]
        for kernel, (source, tag) in SOURCES.items():
            lib_path, _ = builds[source, True]
            lib = ctypes.CDLL(lib_path)
            lib.edge_phases_read.argtypes = [ctypes.c_void_p]
            fn = getattr(lib, kernel)
            module = band if source == "band_aggregate.cu" else spmm
            owner = module.KERNEL if module is band else module.SYM_PAIR_KERNEL
            fn.argtypes = owner.functions[kernel]
            ptxas = clock.ptxas_of(clock.ptxas_by_function(
                builds[source, False][1]), tag + "_bf16_kernel")
            for width in WIDTHS[kernel][case]:
                xs = [torch.tensor(rng.randn(b, n, width),
                                   dtype=torch.bfloat16, device=dev)
                      for _ in range(3 if module is band else 2)]
                outs = [torch.empty_like(x) for x in xs[:1 if module is band
                                                         else 2]]
                if module is band:
                    args = (*(a.data_ptr() for a in edges),
                            *(x.data_ptr() for x in xs), outs[0].data_ptr(),
                            b, n, n, width, 1, stream)
                    call = lambda: band.band_aggregate_forward(*edges, *xs)
                    want = [band.band_aggregate_plain(*edges, *xs)]
                    blocks = band.forward_blocks(*edges, *xs)
                else:
                    args = (*(a.data_ptr() for a in edges),
                            *(x.data_ptr() for x in xs),
                            *(o.data_ptr() for o in outs), b, n, n, width,
                            width, stream)
                    call = lambda: spmm.sym_pair(*edges, *xs)
                    want = list(spmm.sym_pair_plain(*edges, *xs))
                    blocks = spmm.sym_pair_blocks(*edges, *xs)
                if fn(*args) != 0:  # warm-up
                    raise RuntimeError(f"edge_phases: {kernel} failed")
                torch.cuda.synchronize()
                lib.edge_phases_zero()
                for _ in range(RUNS):
                    fn(*args)
                torch.cuda.synchronize()
                per_block = np.zeros((PHASE_BLOCKS, len(PHASES) + 3),
                                     np.uint64)
                lib.edge_phases_read(per_block.ctypes.data)
                slots = [int(v) for v in per_block.sum(0)]
                slots[-1] = int(per_block[:, -1].max())
                warps = max(slots[len(PHASES)], 1)
                got = call()
                got = [got] if module is band else list(got)
                err = max(clock.scaled_err(g, w) for g, w in zip(got, want))
                print(json.dumps({
                    "kernel": kernel, "case": case,
                    "shape": {"B": b, "N": n, "E": n,
                              ("H" if module is band else "T"): width},
                    "ms": clock.graph_ms(call), "max_err": err,
                    "cycles_per_warp": {p: slots[i] / warps
                                        for i, p in enumerate(PHASES)},
                    "span_mean": slots[len(PHASES) + 1] / warps,
                    "span_longest": slots[len(PHASES) + 2],
                    "warps_per_call": warps / RUNS,
                    "blocks_per_sm": blocks[0], "grid_blocks": blocks[1],
                    "wave_blocks": blocks[0] * sms, "sms": sms,
                    "sm_clock_khz": clock_khz, "ptxas": ptxas}),
                    flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
