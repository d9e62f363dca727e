#!/usr/bin/env python3
"""Where the SDDMM backward (kernel 10 in f32, 10b in bf16) spends its
time: each launch's ms and SM cycles a warp by phase.

    python3 gcn_tpu_torch/tools/sddmm_phases.py

Builds ``csrc/sddmm.cu`` with ``-DSDDMM_PHASES``, which compiles in the
backward kernels' phase clocks (``Clock`` in the source), and without it
(for the ``ptxas`` lines of the kernels the package runs), into
``gcn_tpu_torch/_build/phases/``.  Cases: ``chip_smoke.py``
``check_sddmm``'s two shapes, the main path's N=96 batch (B=50, E=96,
H=200, the synthetic sentences of ``load_batches``) and a seeded forest
at N = E = 1200 (``forest_edges``), each in f32 and bf16 (the same
inputs, rounded; g f32).  For each it prints one JSON line: the ms a
call by the 20-call graph (``chip_smoke.graph_ms``) of the package's
wrapper, each launch's ms by the profiler (over five eager calls), the
SM cycles a warp of each phase of each kernel the entry point launches
(lane 0 of each warp clocks them; summed over the warps that reached the
phase and divided by their count, with that count a call; and the same
in the block slot that holds the longest span), the warps a call and
their mean and longest span, the ``ptxas`` lines of the
source's backward kernels, and the SHA-256 of du and dv (the wrapper's,
and the instrumented build's, which must agree).  The last line is the
card's name and power limit.  Run from another checkout of the
repository, it measures that checkout's kernels; where that checkout's
source has no clocks, the phases are null.  Needs a CUDA device and nvcc.
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
H = 200
# csrc/sddmm.cu: ClockKernel, kClockPhases, kClockBlocks
CLOCK_PHASES, CLOCK_BLOCKS = 12, 4096
PHASES = {
    "sddmm_lists_kernel": ["zeroing and counting", "scans and starts",
                           "placement (warps 0-1)"],
    "sddmm_gather_kernel<float>": ["index loads", "row loads and adds",
                                   "store"],
    "sddmm_gather_kernel<bf16>": ["index loads", "row loads and adds",
                                  "store"],
    "sddmm_bwd_bf16_kernel": ["edges staged and counted",
                              "barrier after the counts",
                              "totals and warp scan", "barrier of the scan",
                              "starts and offsets",
                              "barrier after the scan", "placement",
                              "zero rows", "barrier after the placement",
                              "entries, row loads and adds", "stores"],
}
# the kernels an entry point launches, by dtype
LAUNCHED = {"float32": ["sddmm_lists_kernel", "sddmm_gather_kernel<float>"],
            "bfloat16": ["sddmm_lists_kernel", "sddmm_gather_kernel<bf16>",
                         "sddmm_bwd_bf16_kernel"]}
KERNEL_TAGS = ("sddmm_lists", "sddmm_gather", "sddmm_bwd")


def build(out_dir: str) -> dict:
    """sddmm.cu with and without the clocks, one nvcc each, in parallel:
    {phases: (library path, ptxas log)}."""
    from gcn_tpu_torch.ops._cuda import CSRC, NVCC_FLAGS, NVCC_TIMEOUT_S, _nvcc

    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for phases in (True, False):
        stem = "sddmm" + ("_phases" if phases else "_plain_build")
        lib = os.path.join(out_dir, f"lib{stem}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-DSDDMM_PHASES"] if phases else []),
               "-o", lib, str(CSRC / "sddmm.cu")]
        jobs[phases] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for key, (lib, proc) in jobs.items():
        log, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed (phases={key}):\n{log}")
        out[key] = (lib, log)
    return out


def cases(torch, clock, dev) -> dict:
    """{name: ((parent, child, mask) on the card, n)}: check_sddmm's two
    shapes."""
    import numpy as np

    from gcn_tpu_torch.config import cgcn_preset
    from gcn_tpu_torch.data.vocab import Vocab

    vocab = Vocab.load(os.path.join(REPO, "dataset", "vocab", "vocab.pkl"))
    synth = clock.load_batches(cgcn_preset(), vocab,
                               np.random.RandomState(clock.SEED))[1]
    return {"N96": (clock.edge_lists(torch, synth[0], dev), clock.N_BUCKET),
            "N1200": (clock.forest_edges(torch, np.random.RandomState(1),
                                         dev, 1200), 1200)}


def slowest(per_block, names) -> dict:
    """Cycles a warp by phase in the block slot of the longest span."""
    import numpy as np

    row = per_block[int(np.argmax(per_block[:, 2 * CLOCK_PHASES + 2]))]
    return {p: (float(row[i]) / float(row[CLOCK_PHASES + i])
                if row[CLOCK_PHASES + i] else 0.0)
            for i, p in enumerate(names)}


def phase_report(slots, kernels) -> dict | None:
    """Cycles a warp by phase of each kernel, from the slots' block sums."""
    import numpy as np

    if slots is None:
        return None
    out = {}
    for k in kernels:
        per_block = slots[list(PHASES).index(k)]
        tot = per_block.sum(0)
        warps = int(tot[2 * CLOCK_PHASES])
        if warps == 0:
            continue
        names = PHASES[k]
        out[k] = {
            "cycles_per_warp": {
                p: (float(tot[i]) / float(tot[CLOCK_PHASES + i])
                    if tot[CLOCK_PHASES + i] else 0.0)
                for i, p in enumerate(names)},
            "warps_reaching": {p: int(tot[CLOCK_PHASES + i]) / RUNS
                               for i, p in enumerate(names)},
            "warps_per_call": warps / RUNS,
            "span_mean": float(tot[2 * CLOCK_PHASES + 1]) / warps,
            "span_longest": int(np.max(per_block[:, 2 * CLOCK_PHASES + 2])),
            # the block slot that holds the longest span, by phase
            "longest_block_cycles_per_warp": slowest(per_block, names),
        }
    return out


def main() -> int:
    import numpy as np
    import torch

    from gcn_tpu_torch.ops import sddmm as mod
    from gcn_tpu_torch.ops._cuda import BUILD_DIR

    if not torch.cuda.is_available():
        print("sddmm_phases: no CUDA device is available", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location(
        "smoke_clock", os.path.join(REPO, "chip_smoke.py"))
    clock = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(clock)
    builds = build(os.path.join(BUILD_DIR, "phases"))
    ptxas = {k: v for k, v in clock.ptxas_by_function(builds[False][1])
             .items() if any(t in k for t in KERNEL_TAGS)}
    ptxas_clocks = {k: v for k, v in clock.ptxas_by_function(
        builds[True][1]).items() if "sddmm_bwd" in k}
    lib = ctypes.CDLL(builds[True][0])
    has_clocks = hasattr(lib, "sddmm_phases_read")
    if has_clocks:
        lib.sddmm_phases_read.argtypes = [ctypes.c_void_p]
    dev = torch.device("cuda", 0)
    props = torch.cuda.get_device_properties(0)
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.RandomState(0)
    for case, (edges, n) in cases(torch, clock, dev).items():
        b, e = edges[0].shape
        u32, v32 = (torch.tensor(rng.randn(b, n, H) / np.sqrt(H),
                                 dtype=torch.float32, device=dev)
                    for _ in range(2))
        g = torch.tensor(rng.randn(b, e), dtype=torch.float32, device=dev)
        for dtype in ("float32", "bfloat16"):
            u, v = u32.to(getattr(torch, dtype)), v32.to(getattr(torch, dtype))
            suffix = "f32" if dtype == "float32" else "bf16"

            def call():
                return mod.sddmm_backward(*edges, g, u, v)

            got = call()
            want = mod.sddmm_backward_plain(*edges, g, u, v)
            err = max(clock.scaled_err(a, w) for a, w in zip(got, want))
            fn = getattr(lib, f"sddmm_backward_{suffix}")
            fn.argtypes = mod.BACKWARD_KERNEL.functions[
                f"sddmm_backward_{suffix}"]
            du, dv = torch.empty_like(u), torch.empty_like(v)
            lists = torch.empty((b, mod.list_ints(n, e)), dtype=torch.int32,
                                device=dev)
            args = (*(a.data_ptr() for a in edges), g.data_ptr(),
                    u.data_ptr(), v.data_ptr(), du.data_ptr(), dv.data_ptr(),
                    lists.data_ptr(), b, n, e, H, stream)
            if fn(*args) != 0:  # warm-up
                raise RuntimeError(f"sddmm_phases: {suffix} failed")
            torch.cuda.synchronize()
            slots = None
            if has_clocks:
                lib.sddmm_phases_zero()
                for _ in range(RUNS):
                    fn(*args)
                torch.cuda.synchronize()
                slots = np.zeros((len(PHASES), CLOCK_BLOCKS,
                                  2 * CLOCK_PHASES + 3), np.uint64)
                lib.sddmm_phases_read(slots.ctypes.data)
            split = clock.device_time(torch, lambda: [call()
                                                      for _ in range(5)])
            print(json.dumps({
                "case": case, "dtype": dtype,
                "shape": {"B": b, "N": n, "E": e, "H": H,
                          "valid_edges": clock.edge_facts(torch, edges,
                                                          n)[1]},
                "ms": clock.graph_ms(call),
                "split_ms_profiler": None if split is None else {
                    k: t / 5 for k, t in split["top_kernels_ms"].items()
                    if "sddmm" in k},
                "max_err": err,
                "phases": phase_report(slots, LAUNCHED[dtype]),
                "sm_clock_khz": getattr(props, "clock_rate", None),
                "sha256": clock.out_sha256(torch, got),
                "sha256_instrumented": clock.out_sha256(torch, (du, dv)),
                "ptxas": ptxas, "ptxas_with_clocks": ptxas_clocks}),
                flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
