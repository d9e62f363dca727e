"""The port's timing utilities against gcn_tpu's, on the CPU.

* ``slope_time`` gives gcn_tpu's number on the same fake chains, under a
  patched ``time.perf_counter``: the slope where t(k2) > t(k1), the
  conservative t(k2)/k2 where contention made t(k2) <= t(k1); the samples
  interleaved (k1, k2) in both.
* ``scalar_chain_time(on_device=False)`` runs a CPU step one warm-up and
  ``repeats`` × (k1 + k2) times, each on the previous step's result.
* ``device_chain`` raises where there is no CUDA device.
* ``chip_peak`` knows the H100 SXM (989 TFLOP/s bf16) and raises for a
  name it does not know, where gcn_tpu falls back to a TPU v5e's peak.
* ``step_flops`` of a matmul is 2mnk, as XLA's ``cost_analysis`` counts
  gcn_tpu's; None where nothing is counted.
* ``triple_pool`` and ``annotate`` against gcn_tpu's.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_tpu.ops import pooling as jax_pooling
from gcn_tpu.train import profiling as jax_profiling
from gcn_tpu.utils import timing as jax_timing
from gcn_tpu_torch.ops.pooling import triple_pool
from gcn_tpu_torch.train.profiling import annotate
from gcn_tpu_torch.utils import timing
from tests.test_torch_port_cuda import one_torch_thread  # noqa: F401


class FakeClock:
    """A ``perf_counter`` that only chains move: ``chain(k)`` advances it
    by the next fixed cost of ``costs`` plus ``per_step`` times k, and
    records k."""

    def __init__(self, costs, per_step):
        self.now = 0.0
        self.costs = list(costs)
        self.per_step = per_step
        self.calls = []

    def __call__(self):
        return self.now

    def chain(self, k):
        self.calls.append(k)
        self.now += self.costs[(len(self.calls) - 1) % len(self.costs)]
        self.now += self.per_step * k


# fixed costs a call, in the order the calls come (k1, k2, k1, k2, ...)
CLOCKS = {
    # quiet, then a contended k1 sample: the slope of the minima
    "slope": ([0.5, 0.5, 3.0, 0.6, 0.5, 0.9], 0.01),
    # every k2 sample contended more than the chain's length makes up:
    # t(k2) <= t(k1), so t(k2)/k2
    "contended": ([2.0, 0.1, 2.5, 0.2, 2.2, 0.15], 0.001),
}


@pytest.mark.parametrize("case", sorted(CLOCKS))
def test_slope_time_is_gcn_tpus(case, monkeypatch):
    got = {}
    for name, mod in (("port", timing), ("gcn_tpu", jax_timing)):
        clock = FakeClock(*CLOCKS[case])
        monkeypatch.setattr(time, "perf_counter", clock)
        got[name] = mod.slope_time(clock.chain, 20, 60, repeats=3)
        assert clock.calls == [20, 60] * 3, name
    assert got["port"] == got["gcn_tpu"]
    costs, per_step = CLOCKS[case]
    t1 = min(costs[0::2]) + 20 * per_step
    t2 = min(costs[1::2]) + 60 * per_step
    if case == "slope":
        assert t2 > t1
        assert got["port"] == pytest.approx((t2 - t1) / 40, rel=1e-12)
    else:
        assert t2 <= t1
        assert got["port"] == pytest.approx(t2 / 60, rel=1e-12)


def test_scalar_chain_time_on_a_cpu_step():
    x = torch.randn(32, 32)
    carries = []

    def step(s):
        carries.append(float(s))
        return (x @ x).mean() * 0.0 + s + 1.0

    dt = timing.scalar_chain_time(step, k1=3, k2=7, repeats=2)
    assert np.isfinite(dt) and dt > 0
    assert len(carries) == 1 + 2 * (3 + 7)
    # each chain starts from 0 and carries the previous step's result
    assert carries[1:11] == [0.0, 1.0, 2.0] + [float(i) for i in range(7)]


def test_device_chain_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        timing.device_chain(lambda s: s + 1.0)
    with pytest.raises(RuntimeError, match="CUDA device"):
        timing.scalar_chain_time(lambda s: s + 1.0, on_device=True)
    with pytest.raises(RuntimeError, match="CUDA device"):
        timing.calibrate(64)


def test_chip_peak_knows_the_h100_and_refuses_other_names():
    assert timing.chip_peak("NVIDIA H100 80GB HBM3") == 989e12
    for name in ("NVIDIA A100-SXM4-80GB", "cpu", "TPU v5 lite"):
        with pytest.raises(ValueError, match="no bf16 peak"):
            timing.chip_peak(name)
    # gcn_tpu's falls back to a v5e's peak on a device it does not know
    assert jax.devices()[0].device_kind.lower() == "cpu"
    assert jax_timing.chip_peak() == 197e12


@pytest.mark.parametrize("m,n,k", [(3, 5, 4), (64, 32, 48)])
def test_step_flops_of_a_matmul_is_2mnk(m, n, k):
    a, b = np.ones((m, k), np.float32), np.ones((k, n), np.float32)
    mine = timing.step_flops(torch.matmul, torch.from_numpy(a),
                             torch.from_numpy(b))
    theirs = jax_timing.step_flops(jax.jit(jnp.dot), jnp.asarray(a),
                                   jnp.asarray(b))
    assert mine == 2.0 * m * n * k == theirs
    assert timing.step_flops(torch.add, torch.ones(4), torch.ones(4)) is None


@pytest.mark.parametrize("kind", ["max", "avg", "sum"])
def test_triple_pool_matches_gcn_tpu(kind):
    rng = np.random.RandomState(5)
    h = rng.randn(4, 9, 6).astype(np.float32)
    masks = [rng.rand(4, 9) < p for p in (0.3, 0.7, 0.8)]
    masks[1][2] = True  # a row with every token dropped
    mine = triple_pool(torch.from_numpy(h),
                       *(torch.from_numpy(m) for m in masks), kind)
    theirs = jax_pooling.triple_pool(jnp.asarray(h),
                                     *(jnp.asarray(m) for m in masks), kind)
    assert mine.shape == (4, 18)
    np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), rtol=1e-6,
                               atol=1e-6)


def test_annotate_names_a_profiler_region_as_gcn_tpus_does():
    x = np.arange(6, dtype=np.float32)
    with jax_profiling.annotate("batch_building"):
        theirs = np.asarray(jnp.asarray(x) * 2)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with annotate("batch_building"):
            mine = (torch.from_numpy(x) * 2).numpy()
    np.testing.assert_array_equal(mine, theirs)
    assert "batch_building" in {e.key for e in prof.key_averages()}
