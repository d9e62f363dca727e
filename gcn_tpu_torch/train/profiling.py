"""Throughput counters and a profiler trace for the train driver
(counterpart of ``gcn_tpu.train.profiling``'s ``trace`` and
``ThroughputMeter``).

* ``trace(logdir)`` — ``torch.profiler`` over the enclosed block (the
  card's kernels too where there is one), written as a Chrome trace
  ``<logdir>/trace.json`` (Perfetto and ``chrome://tracing`` read it),
* ``ThroughputMeter`` — running edges/s and examples/s of the host loop,
  and ``sustained()``: the epoch's rate after one synchronisation of the
  card, so it counts work done, not work queued.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a profiler trace of the enclosed block into ``logdir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@dataclass
class ThroughputMeter:
    """Running edges/s and examples/s with exponential smoothing.

    The per-step EMA measures the host loop's inter-step time: the card
    runs behind it, so ``summary()`` calls it an enqueue rate.  The epoch's
    true rate is ``sustained()``, which synchronises ``device`` first.
    """

    device: torch.device | str | None = None
    ema_alpha: float = 0.1
    _last: float | None = field(default=None, repr=False)
    _epoch_t0: float | None = field(default=None, repr=False)
    edges_per_sec: float = 0.0
    examples_per_sec: float = 0.0
    steps: int = 0
    total_edges: int = 0
    total_examples: int = 0

    def start(self) -> None:
        self._last = time.perf_counter()
        self._epoch_t0 = self._last
        self.total_edges = 0
        self.total_examples = 0
        self.steps = 0

    def step(self, num_edges: int, num_examples: int) -> None:
        now = time.perf_counter()
        if self._last is None:
            self._last = now
            return
        dt = max(now - self._last, 1e-9)
        self._last = now
        eps = num_edges / dt
        xps = num_examples / dt
        if self.steps == 0:
            self.edges_per_sec = eps
            self.examples_per_sec = xps
        else:
            a = self.ema_alpha
            self.edges_per_sec = (1 - a) * self.edges_per_sec + a * eps
            self.examples_per_sec = (1 - a) * self.examples_per_sec + a * xps
        self.steps += 1
        self.total_edges += num_edges
        self.total_examples += num_examples

    def summary(self) -> str:
        return (
            f"{self.edges_per_sec:,.0f} edges/s enqueued, "
            f"{self.examples_per_sec:,.1f} ex/s "
            f"({self.steps} steps, {self.total_edges:,} edges)"
        )

    def sustained(self) -> tuple[float, float, float]:
        """(edges/s, examples/s, wall_s) since ``start()``, after the card
        has finished the epoch's work."""
        dev = torch.device(self.device) if self.device is not None else None
        if dev is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = max(time.perf_counter() - (self._epoch_t0 or 0.0), 1e-9)
        return self.total_edges / wall, self.total_examples / wall, wall
