#!/usr/bin/env python3
"""Where the bf16 grouped matmul backward spends its time: SM cycles a CTA
by phase, for its dx and its dS kernel.

    python3 gcn_tpu_torch/tools/gmm_phases.py

Builds ``csrc/grouped_matmul_backward.cu`` with ``-DGMM_PHASES``, which
compiles in the bf16 kernels' phase clocks (``PhaseClock`` in that file),
into ``gcn_tpu_torch/_build/phases/``.  At the C-GCN layer's shapes (M =
9600 stacked band rows, the group sizes of ``chip_smoke.py``'s synthetic
N=96 batch, H = 200, T = 400 and 200; seeded inputs) it runs the bf16
backward ten times and prints one JSON line per T: for each kernel the SM
cycles a CTA of each phase, thread 0 (a consumer) and the producer's
copying thread each clocking their own, a CTA's cycles from the kernel's
entry to its exit (the mean, and the longest CTA's over the ten calls),
the CTAs and units a call, the card's SM clock, and, for the same inputs,
the uninstrumented wrapper's ms a call (a replayed CUDA graph of 20
calls) and the instrumented build's error against the plain version.  The last line is the card's name and power limit.  Run
from another checkout of the repository, it measures that checkout's
kernels.  Needs a CUDA device and nvcc.
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

M, H = 9600, 200
WIDTHS = (400, 200)
RUNS = 10
SLOTS = 16  # csrc/grouped_matmul_backward.cu kPhases, a product
PHASES = ["consumer: find the unit", "consumer: wait for a chunk",
          "consumer: zero the next group's rows",
          "consumer: issue products, hand back",
          "consumer: wait for the last products", "consumer: epilogue",
          "producer: find the unit", "producer: wait for a free slot",
          "producer: issue the copies"]
PRODUCTS = ("dx", "dS")
CTA_CYCLES, LONGEST, CTAS, UNITS = 10, 11, 12, 13  # PhaseSlot


def build(out_dir: str):
    """grouped_matmul_backward.cu built with its phase clocks."""
    from gcn_tpu_torch.ops._cuda import CSRC, NVCC_FLAGS, NVCC_TIMEOUT_S, _nvcc

    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "libgrouped_matmul_backward_phases.so")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-DGMM_PHASES", "-o", lib,
         str(CSRC / "grouped_matmul_backward.cu")],
        capture_output=True, text=True, timeout=NVCC_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed for grouped_matmul_backward.cu:\n"
                           f"{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(lib)


def group_sizes(torch, dev):
    """The C-GCN's stacked band group sizes of chip_smoke.py's first
    synthetic N=96 batch (R = 87)."""
    import numpy as np

    import chip_smoke as cs
    from gcn_tpu_torch.config import cgcn_preset
    from gcn_tpu_torch.data.vocab import Vocab

    vocab = Vocab.load(os.path.join(REPO, "dataset", "vocab", "vocab.pkl"))
    _, synth, *_ = cs.load_batches(cgcn_preset(), vocab,
                                   np.random.RandomState(cs.SEED))
    return cs.band_group_sizes(torch, synth[0], dev)


def main() -> int:
    import functools

    import numpy as np
    import torch

    import chip_smoke as cs
    from gcn_tpu_torch.ops import grouped_matmul as mod
    from gcn_tpu_torch.ops._cuda import BUILD_DIR

    if not torch.cuda.is_available():
        print("gmm_phases: no CUDA device is available", file=sys.stderr)
        return 2
    lib = build(os.path.join(BUILD_DIR, "phases"))
    lib.grouped_matmul_phases_read.argtypes = [ctypes.c_void_p]
    symbol = "grouped_matmul_backward_bf16"
    fn = getattr(lib, symbol)
    fn.argtypes = mod.BACKWARD_KERNEL.functions[symbol]
    dev = torch.device("cuda", 0)
    gs = group_sizes(torch, dev)
    ends = torch.cumsum(gs, 0, dtype=torch.int32)
    r = gs.shape[0]
    rng = np.random.RandomState(0)
    stream = torch.cuda.current_stream().cuda_stream
    clock_khz = torch.cuda.get_device_properties(0).clock_rate
    slots_n = lib.grouped_matmul_backward_partials(M)
    for t in WIDTHS:
        x = torch.tensor(rng.uniform(-1, 1, (M, t)), device=dev).bfloat16()
        s = torch.tensor(rng.randn(r, t, H) / np.sqrt(t),
                         device=dev).bfloat16()
        g = torch.tensor(rng.randn(M, H) * 0.1, device=dev).bfloat16()
        dx = torch.empty(M, t, dtype=torch.bfloat16, device=dev)
        ds = torch.empty(r, t, H, dtype=torch.float32, device=dev)
        part = torch.empty(slots_n, t, H, dtype=torch.float32, device=dev)
        args = (x.data_ptr(), g.data_ptr(), s.data_ptr(), ends.data_ptr(),
                dx.data_ptr(), ds.data_ptr(), part.data_ptr(), M, t, H, r,
                stream)
        if fn(*args) != 0:  # warm-up
            raise RuntimeError("gmm_phases: the launch failed")
        torch.cuda.synchronize()
        lib.grouped_matmul_phases_zero()
        for _ in range(RUNS):
            fn(*args)
        torch.cuda.synchronize()
        got = (ctypes.c_ulonglong * (2 * SLOTS))()
        lib.grouped_matmul_phases_read(got)
        want = mod.grouped_matmul_backward_plain(x, g, s, gs)
        err = max(cs.scaled_err(a, b) for a, b in zip((dx, ds), want))
        call = functools.partial(mod.grouped_matmul_backward, x, g, s, gs)
        line = {"kernel": "grouped_matmul_backward_bf16", "T": t,
                "shape": {"M": M, "T": t, "H": H, "R": r},
                "ms": cs.graph_ms(call), "max_scaled_err_phases_build": err,
                "sm_clock_khz": clock_khz}
        for k, product in enumerate(PRODUCTS):
            base = SLOTS * k
            ctas = max(got[base + CTAS], 1)
            line[product] = {
                "ctas_per_call": got[base + CTAS] / RUNS,
                "units_per_call": got[base + UNITS] / RUNS,
                "cta_cycles_mean": got[base + CTA_CYCLES] / ctas,
                "cta_cycles_longest": got[base + LONGEST],
                "cycles_per_cta": {name: got[base + i] / ctas
                                   for i, name in enumerate(PHASES)}}
        print(json.dumps(line), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
