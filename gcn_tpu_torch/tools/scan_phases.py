#!/usr/bin/env python3
"""Where the BiLSTM scan kernels' time goes: SM cycles a step by phase.

    python3 gcn_tpu_torch/tools/scan_phases.py [--dtype bfloat16] [--keep]

Builds ``csrc/lstm_scan.cu`` and ``csrc/lstm_scan_backward.cu`` with
``-DLSTM_PHASES``, which compiles in the kernels' phase clocks
(``lstm::PhaseClock`` in ``csrc/lstm_cluster.cuh``), into
``gcn_tpu_torch/_build/phases/``.  At the C-GCN's shapes (T=96, G=2, B=50,
H=200, seeded inputs; ``--dtype`` float32 (the default) or bfloat16, the
kernels' two instances; ``--keep`` adds a seeded 0/1 carry factor) under
``scan_plan``'s partition it runs each instrumented kernel ten times and
prints one JSON line per kernel: the SM cycles a step of each phase (the
mean over every CTA's thread 0 and every step that runs the product), the
steps a CTA runs, the card's SM clock, and, for the same inputs, the
uninstrumented kernel's ms a call (the package's wrapper, a replayed CUDA
graph), its error against the plain version and the SHA-256 of each of
its outputs (``h``, ``c``; ``gates``, the backward's first launch's
scratch, ``dxp``, ``dw``), so that two checkouts' bits can be compared.
The phases are named in ``PHASES`` (the chain's third phase is its
product alone where the checkout's clocks time the sends apart, as
``sends of the partials``); the backward's line also gives the
dW kernel's mainloop cycles a 32-deep chunk and the cycles of its partial
tiles' sum, the gates kernel's mainloop and epilogue cycles a block
(where the checkout's gates kernel has clocks), and each of the three
launches' device ms by the profiler over ten eager calls; each line its
kernels' ``ptxas`` registers and spills (the package's build, where this
run built it).  The last line is the card's name and power limit.  Run from another checkout of the
repository (``.smoke_parent/gcn_tpu_torch/tools/scan_phases.py``), it
measures that checkout's kernels.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, REPO)

T, G, B, H = 96, 2, 50, 200
RUNS = 10
PHASES = {"forward": ["wait for h[t-1]", "gate product",
                      "cell update and h exchange",
                      "state stores and next loads"],
          "backward": ["wait for the partials and their sum",
                       "gate gradients", "partial dh_prev and sends",
                       "dxp stores and next loads"]}
# the chain's sends of its partials, apart from phase 2 (the product) where
# the checkout's clocks split them
SENDS_SLOT = 14
LAUNCHES = ("lstm_gates", "lstm_chain", "lstm_dw")  # names begin so


def build(out_dir: str) -> dict:
    """The two scan sources built with their phase clocks, in parallel."""
    from gcn_tpu_torch.ops._cuda import CSRC, NVCC_FLAGS, NVCC_TIMEOUT_S, _nvcc

    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for kind, stem in (("forward", "lstm_scan"),
                       ("backward", "lstm_scan_backward")):
        lib = os.path.join(out_dir, f"lib{stem}_phases.so")
        procs[kind] = (lib, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-DLSTM_PHASES", "-o", lib,
             str(CSRC / f"{stem}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for kind, (lib, proc) in procs.items():
        log, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {kind} scan:\n{log}")
        libs[kind] = ctypes.CDLL(lib)
    return libs


def smoke_module():
    """This checkout's ``chip_smoke.py``, for its ``ptxas`` and SHA-256
    helpers."""
    spec = importlib.util.spec_from_file_location(
        "smoke_helpers", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def ptxas_lines(smoke, kernels, bf16: bool) -> dict:
    """The package's build of the scan sources (``CudaKernel``'s, without
    the clocks): the ``ptxas`` registers and spills of each kernel of the
    instance, by mangled name; empty where the library was built before
    this run."""
    from gcn_tpu_torch.ops._cuda import build_all

    out = {}
    for report in build_all(kernels).values():
        out.update(smoke.ptxas_by_function(report["log"]))
    return {k: v for k, v in out.items() if ("bfloat16" in k) == bf16}


def graph_ms(torch, fn, reps: int = 50) -> float:
    """ms a call of ``fn``: captured once in a CUDA graph, replayed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def launch_ms(torch, fn) -> dict:
    """Device ms a call of each of the backward's launches: the profiler
    over ``RUNS`` eager calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(RUNS):
            fn()
        torch.cuda.synchronize()
    out = {name: 0.0 for name in LAUNCHES}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for name in LAUNCHES:
            if name in evt.name:
                out[name] += evt.time_range.elapsed_us() / 1e3 / RUNS
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--dtype", choices=("float32", "bfloat16"),
                        default="float32")
    parser.add_argument("--keep", action="store_true",
                        help="pass a seeded 0/1 carry factor")
    args_ns = parser.parse_args(argv)

    import numpy as np
    import torch

    from gcn_tpu_torch.ops import lstm_scan as mod
    from gcn_tpu_torch.ops._cuda import BUILD_DIR

    if not torch.cuda.is_available():
        print("scan_phases: no CUDA device is available", file=sys.stderr)
        return 2
    dtype = getattr(torch, args_ns.dtype)
    suffix = "bf16" if dtype == torch.bfloat16 else "f32"
    smoke = smoke_module()
    ptxas = ptxas_lines(smoke, [mod.KERNEL, mod.BACKWARD_KERNEL],
                        suffix == "bf16")
    libs = build(os.path.join(BUILD_DIR, "phases"))
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(0)
    lengths = rng.randint(1, T + 1, B)
    lengths[:2] = (1, T)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    xp = torch.tensor(rng.randn(T, G, B, 4 * H) * 0.5, dtype=torch.float32,
                      device=dev).to(dtype)
    w = torch.tensor(rng.uniform(-1, 1, (G, H, 4 * H)) / np.sqrt(H),
                     dtype=torch.float32, device=dev).to(dtype)
    keep = None
    if args_ns.keep:
        keep = torch.tensor((rng.rand(T, G, B) > 0.1).astype(np.float32),
                            device=dev)
    hs, cs = mod.lstm_scan_plain(xp, lengths, w, keep)
    gy = torch.where(torch.arange(T, device=dev)[:, None, None, None]
                     < lengths[None, None, :, None], hs.float(),
                     0.0).contiguous()
    stream = torch.cuda.current_stream().cuda_stream
    clock_khz = torch.cuda.get_device_properties(0).clock_rate
    keep_ptr = keep.data_ptr() if keep is not None else None
    for kind, lib in libs.items():
        backward = kind == "backward"
        plan = mod.scan_plan(B, H, backward=backward)
        if backward:
            symbol = f"lstm_scan_backward_{suffix}"
            kernel = mod.BACKWARD_KERNEL
            dxp = torch.empty(T, G, B, 4 * H, device=dev)
            dw = torch.empty(G, H, 4 * H, device=dev)
            gates = torch.empty_like(dxp)
            args = (gy.data_ptr(), xp.data_ptr(), hs.data_ptr(),
                    cs.data_ptr(), w.data_ptr(), keep_ptr,
                    lengths.data_ptr(), gates.data_ptr(), dxp.data_ptr(),
                    dw.data_ptr(), T, G, B, H, *plan.args(), stream)
            call = functools.partial(mod.lstm_scan_backward, gy, xp, lengths,
                                     w, hs, cs, keep)
            want = mod.lstm_scan_backward_plain(gy, xp, lengths, w, hs, cs,
                                                keep)
            got = call()
            # the uninstrumented library's gates scratch, for its bits
            kernel.launch(symbol, *args)
            outputs = {"gates": gates.clone(), "dxp": got[0], "dw": got[1]}
        else:
            symbol, kernel = f"lstm_scan_forward_{suffix}", mod.KERNEL
            h_out, c_out = torch.empty_like(hs), torch.empty_like(cs)
            args = (xp.data_ptr(), lengths.data_ptr(), w.data_ptr(),
                    keep_ptr, h_out.data_ptr(), c_out.data_ptr(), T, G, B, H,
                    *plan.args(), stream)
            call = functools.partial(mod.lstm_scan_forward, xp, lengths, w,
                                     keep)
            want = (hs, cs)
            got = call()
            outputs = {"h": got[0], "c": got[1]}
        torch.cuda.synchronize()
        err = max(float((a.float() - b.float()).abs().max()) / max(
            1.0, float(b.float().abs().max())) for a, b in zip(got, want))
        fn = getattr(lib, symbol)
        fn.argtypes = kernel.functions[symbol]
        lib.lstm_phases_read.argtypes = [ctypes.c_void_p]
        if fn(*args) != 0:  # warm-up
            raise RuntimeError(f"scan_phases: the {kind} launch failed")
        torch.cuda.synchronize()
        lib.lstm_phases_zero()
        for _ in range(RUNS):
            fn(*args)
        torch.cuda.synchronize()
        slots = (ctypes.c_ulonglong * 16)()
        lib.lstm_phases_read(slots)
        steps, ctas = max(slots[8], 1), max(slots[9], 1)
        ms = graph_ms(torch, call)
        row = {"kernel": f"lstm_scan_{kind}", "dtype": args_ns.dtype,
               "keep": keep is not None,
               "plan": {"cluster": plan.cluster, "rows": plan.rows,
                        "rows_per_thread": plan.rows_per_thread,
                        "threads": plan.threads},
               "ms": ms, "ms_per_step": ms / T, "max_err": err,
               "sha256": {k: smoke.out_sha256(torch, v)
                          for k, v in outputs.items()},
               "cycles_per_step": {name: slots[i] / steps
                                   for i, name in enumerate(PHASES[kind])},
               "steps_per_cta": steps / ctas, "sm_clock_khz": clock_khz}
        row["ptxas"] = {k: v for k, v in ptxas.items()
                        if ("lstm_scan_fwd" in k) != backward}
        if backward:
            row["cycles_per_step"]["sends of the partials"] = (
                slots[SENDS_SLOT] / steps if slots[SENDS_SLOT] else None)
            chunks, dw_ctas = max(slots[10], 1), max(slots[11], 1)
            row["dw_cycles"] = {"mainloop_per_chunk": slots[4] / chunks,
                                "sum_per_cta": slots[5] / dw_ctas,
                                "chunks_per_cta": chunks / dw_ctas}
            blocks = slots[13]
            row["gates_cycles"] = None if blocks == 0 else {
                "mainloop_per_block": slots[6] / blocks,
                "epilogue_per_block": slots[7] / blocks,
                "chunks_per_block": slots[12] / blocks}
            row["launch_ms_profiler"] = launch_ms(torch, call)
        print(json.dumps(row), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
