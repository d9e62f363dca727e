"""Wall-clock timing by chains of data-dependent iterations, on the card.

Counterpart of ``gcn_tpu.utils.timing`` with the same methodology:

* iterations are CHAINED through a data dependency and execution is forced
  by one host fetch (``.item()``) of a scalar reduced from the final
  result;
* per-iteration time is the SLOPE between two chain lengths, which cancels
  the fixed cost of the launch and of the fetch;
* a known-FLOPs bf16 matmul chain is timed first (``calibrate``): if that
  calibration is off, nothing else can be trusted either.

``diag``, ``timeit`` and ``slope_time`` are ``gcn_tpu``'s code.  Where
``gcn_tpu`` compiles a ``fori_loop`` once, ``device_chain`` captures a CUDA
graph for each chain length, with the step unrolled in it; where XLA's
``cost_analysis`` counts FLOPs, ``step_flops`` runs ``torch``'s
``FlopCounterMode``.  Deliberate differences: ``chip_peak`` raises for a
card it does not know (``gcn_tpu`` falls back to v5e's 197 TFLOP/s, which
means nothing on a GPU), and ``device_chain`` raises where there is no
card instead of falling back to eager calls.
"""

from __future__ import annotations

import json
import sys
import time

import torch
from torch.utils.flop_counter import FlopCounterMode

# bf16 dense peak FLOP/s by device name (NVIDIA's data sheets, without
# sparsity, at the full power limit); used for the calibration's fraction
PEAK_FLOPS = {"h100 80gb hbm3": 989e12}  # the H100 SXM


def chip_peak(name: str | None = None) -> float:
    """The bf16 dense peak FLOP/s of the card ``name`` (default: card 0's
    ``torch.cuda.get_device_name``).  Raises ``ValueError`` for a name not
    in ``PEAK_FLOPS``: unlike ``gcn_tpu``, which falls back to a TPU v5e's
    197 TFLOP/s, no default would mean anything here."""
    if name is None:
        name = torch.cuda.get_device_name(0)
    low = name.lower()
    for k, v in PEAK_FLOPS.items():
        if k in low:
            return v
    raise ValueError(f"no bf16 peak known for the device {name!r}; add it "
                     f"to gcn_tpu_torch.utils.timing.PEAK_FLOPS")


def diag(**rec) -> None:
    """One diagnostic JSON record to stderr."""
    print(json.dumps(rec), file=sys.stderr, flush=True)


def timeit(run_chain, k: int) -> float:
    t0 = time.perf_counter()
    run_chain(k)
    return time.perf_counter() - t0


def slope_time(run_chain, k1: int = 20, k2: int = 60, repeats: int = 3):
    """Per-iteration wall time as the slope between two chain lengths.

    ``run_chain(k)`` must execute k data-dependent iterations and block on
    a host fetch of the final result.  The launch and the fetch are a
    fixed cost that cancels in the difference.

    The (k1, k2) samples are INTERLEAVED and the minimum per chain length
    is taken across repeats: contention only ever adds time, and
    interleaving keeps a load shift between the k1 phase and the k2 phase
    from corrupting the slope.  If every window was contended such that
    t(k2) <= t(k1), fall back to the conservative average t(k2)/k2
    (includes the fixed cost: overstates, never understates).
    """
    t1s, t2s = [], []
    for _ in range(repeats):
        t1s.append(timeit(run_chain, k1))
        t2s.append(timeit(run_chain, k2))
    t1, t2 = min(t1s), min(t2s)
    if t2 <= t1:
        return t2 / k2
    return (t2 - t1) / (k2 - k1)


def _card() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("device timing needs a CUDA device; there is "
                           "none here")
    return torch.device("cuda", torch.cuda.current_device())


def device_chain(step):
    """Warmed ``chain(k)`` running ``step(s: 0-d f32) -> 0-d f32`` k times
    on the card as one CUDA graph replay: the graph of length k (``step``
    unrolled k times on a 0-d f32 carry from 0) is captured at the first
    call with that k and cached, and ``chain(k)`` is one replay and one
    ``.item()``, whose value it returns.  No host dispatch sits inside the
    chain, so kernels faster than a launch's host cost are timed;
    ``slope_time`` cancels the replay's and the fetch's fixed cost.
    Raises ``RuntimeError`` where there is no CUDA device (no graph to
    capture; no fallback to eager calls)."""
    dev = _card()
    seed = torch.zeros((), dtype=torch.float32, device=dev)
    graphs: dict[int, tuple] = {}

    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):  # warm-up outside any capture
        step(seed).item()
    torch.cuda.current_stream(dev).wait_stream(side)

    def chain(k: int) -> float:
        if k not in graphs:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                s = seed
                for _ in range(k):
                    s = step(s)
            graphs[k] = (graph, s)
        graph, out = graphs[k]
        graph.replay()
        return out.item()

    chain(3)  # capture + warm, as gcn_tpu's run_k(3)
    return chain


def scalar_chain_time(step, k1: int = 10, k2: int = 30,
                      repeats: int = 3, on_device: bool = False) -> float:
    """Slope-time a ``step(s: 0-d f32 tensor) -> 0-d f32 tensor``.

    The scalar carry forces each iteration to depend on the previous one,
    so the chain cannot overlap with itself; the final ``.item()`` forces
    full execution.

    ``on_device=True`` uses ``device_chain`` (see there), with the graphs
    of both lengths captured before the timing; otherwise each step is an
    eager call from the host, on the device of the tensors ``step`` uses
    (the carry starts on the CPU).
    """
    if on_device:
        chain = device_chain(step)
        chain(k1)
        chain(k2)
    else:
        step(torch.zeros((), dtype=torch.float32)).item()  # warm

        def chain(k):
            s = torch.zeros((), dtype=torch.float32)
            for _ in range(k):
                s = step(s)
            s.item()

    return slope_time(chain, k1, k2, repeats)


def calibrate(n: int = 4096) -> float:
    """Time a known-FLOPs bf16 matmul chain on the card; return
    measured/peak (``chip_peak``).  The matmul is a yardstick of the card,
    not a port of a kernel."""
    dev = _card()
    x = torch.full((n, n), 1e-3, dtype=torch.bfloat16, device=dev)
    w = torch.full((n, n), 1e-3, dtype=torch.bfloat16, device=dev)
    torch.matmul(x, w).float().sum().item()  # warm

    def chain(k):
        y = x
        for _ in range(k):
            y = torch.matmul(y, w)
        y.float().sum().item()

    dt = slope_time(chain, 20, 60)
    frac = 2 * n**3 / dt / chip_peak()
    diag(record="calibration", matmul_n=n, ms=round(dt * 1e3, 4),
         fraction_of_peak=round(frac, 3))
    return frac


def step_flops(step, *args) -> float | None:
    """FLOPs of one call ``step(*args)`` as ``torch.utils.flop_counter``
    counts them (the backward too, when the call runs one), or None when
    it counts none.  The port's own kernels are ctypes calls, invisible to
    the counter, as Pallas custom calls are to XLA's ``cost_analysis``:
    what a step runs through them is left out."""
    with FlopCounterMode(display=False) as counter:
        step(*args)
    return float(counter.get_total_flops()) or None
