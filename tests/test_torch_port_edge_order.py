"""The exact-order reference of the bf16 band aggregation forward (5b) and
the bf16 sym pair (8b) (``tests/edge_order.py``), on the CPU.

* Over the CPU tests' edge cases (``EDGE_CASES``: duplicated edges,
  self-edges, an all-masked sentence, isolated nodes, ends out of range)
  and a multigraph of 70 slots (three ballot steps a direction), at widths
  that take each of the kernels' lane maps (multiples of 8, of 4, and
  neither), the reference is held to the same function in f64 (within one
  bf16 rounding step of |y| beyond a sum's f32 error) and to the port's
  bf16 plain versions (``band_aggregate_plain``, ``sym_pair_plain``: the
  dense band and ``bmm`` in f32, another order), their bits or one
  rounding step (``bf16_flip``).
* The kernels' walk and queue (``csrc/edge_gather.cuh`` ``walk_each``:
  each ballot step's set bits low to high; ``Queue<kB>``: a full queue's
  loads issued together and added oldest first before the next push),
  emulated in numpy, add each row's forward neighbours in edge order and
  then its reverse ones: the reference's order, at kB = 1, 2, 4 and 8.
  A star case (one node the parent of 65 of 70 edges) walks three ballot
  steps and fills the queue many times.
"""

import numpy as np
import pytest
import torch

from gcn_tpu_torch.ops import band_aggregate as band_mod
from gcn_tpu_torch.ops import spmm_fused as spmm_mod
from tests.edge_order import (band_forward_exact, bf16_bits, bf16_values,
                              sym_pair_exact, valid_slots)
from tests.test_torch_port_cuda import EDGE_CASES, bf16_flip, edge_case
from tests.test_torch_port_cuda import one_torch_thread  # noqa: F401

B, N = 3, 10
F32_TOL = 1e-5  # the f32 instances' tolerance: sums in another order


def edges_of(case):
    """(parent, child, mask, n) of a case: ``edge_case`` at B=3, N=E=10,
    or 70 slots of doubled edges over 12 nodes (multigraph), or node 0 the
    parent of 65 of 70 and node 1 of the first 5 (star: node 0's 65
    neighbours span three ballot steps)."""
    if case == "multigraph":
        return (*edge_case("duplicates", B, 12, 70), 12)
    if case == "star":
        parent, child, mask = edge_case("random", B, 12, 70)
        parent[:], mask[:] = 0, True
        parent[:, :5] = 1
        return parent, child, mask, 12
    return (*edge_case(case, B, N, N), N)


def bf16_inputs(seed, *shapes):
    """float32 arrays of bf16 values, seeded."""
    rng = np.random.RandomState(seed)
    return [bf16_values(bf16_bits(rng.randn(*s).astype(np.float32)))
            for s in shapes]


def dense_bands(parent, child, mask, n):
    """[B, N, N] f64 A_f (A_f[p, c] counts the valid edges p -> c)."""
    ok = valid_slots(parent, child, mask, n)
    a = np.zeros((parent.shape[0], n, n))
    for s, q in zip(*np.nonzero(ok)):
        a[s, parent[s, q], child[s, q]] += 1.0
    return a


def assert_within_a_rounding(bits, want64, scale):
    """bf16 ``bits`` within one bf16 step of the f64 ``want64`` (the step
    at |want64|), beyond an f32 sum's error of ``scale``."""
    got = bf16_values(bits).astype(np.float64)
    step = np.exp2(np.floor(np.log2(np.maximum(np.abs(want64), 2.0 ** -126)))
                   - 7)
    assert np.all(np.abs(got - want64) <= step + 1e-6 * scale)


def as_torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("h", [16, 20, 14])  # % 8, % 4, neither
@pytest.mark.parametrize("case", EDGE_CASES + ["multigraph", "star"])
def test_band_forward_exact_order(case, h, relu):
    parent, child, mask, n = edges_of(case)
    xf, xr, xs = bf16_inputs(len(case) + h, *[(B, n, h)] * 3)
    bits = band_forward_exact(parent, child, mask, xf, xr, xs, relu)
    a = dense_bands(parent, child, mask, n)
    deg = a.sum(2) + a.sum(1)
    z = (a @ xf + a.transpose(0, 2, 1) @ xr + xs) / (
        deg + (deg > 0) + 1)[..., None]
    z = np.maximum(z, 0.0) if relu else z
    assert_within_a_rounding(bits, z, np.abs(xf).max() * (deg.max() + 1))
    t = [x.bfloat16() for x in as_torch(xf, xr, xs)]
    plain = band_mod.band_aggregate_plain(*as_torch(parent, child, mask),
                                          *t, relu)
    got = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    bf16_flip(got, plain, F32_TOL)


@pytest.mark.parametrize("widths", [(16, 24), (20, 12), (14, 9)])
@pytest.mark.parametrize("case", EDGE_CASES + ["multigraph", "star"])
def test_sym_pair_exact_order(case, widths):
    parent, child, mask, n = edges_of(case)
    x1, x2 = bf16_inputs(len(case) + sum(widths), (B, n, widths[0]),
                         (B, n, widths[1]))
    bits = sym_pair_exact(parent, child, mask, x1, x2)
    a = dense_bands(parent, child, mask, n)
    deg = a.sum(2) + a.sum(1)
    s = a + a.transpose(0, 2, 1)
    plain = spmm_mod.sym_pair_plain(*as_torch(parent, child, mask),
                                    *(x.bfloat16() for x in as_torch(x1, x2)))
    for got_bits, x, want in zip(bits, (x1, x2), plain):
        z = s @ x + ((deg > 0) + 1.0)[..., None] * x
        assert_within_a_rounding(got_bits, z, np.abs(x).max() * (
            deg.max() + 2))
        got = torch.from_numpy(got_bits.view(np.int16)).view(torch.bfloat16)
        bf16_flip(got, want, F32_TOL)


def walk_each(ep, ec, e, row):
    """``edge_gather.cuh``'s ``walk_each`` for one row, in numpy: the
    (direction, neighbour) entries it visits, each 32-slot step's set bits
    low to high, and the degree (its popcounts)."""
    visits, deg = [], 0
    for direction, (key, nbr) in enumerate(((ep, ec), (ec, ep))):
        for q0 in range(0, e, 32):
            bits = sum(1 << lane for lane in range(32)
                       if q0 + lane < e and key[q0 + lane] == row)
            deg += bin(bits).count("1")
            while bits:
                lane = (bits & -bits).bit_length() - 1
                visits.append((direction, int(nbr[q0 + lane])))
                bits &= bits - 1
    return visits, deg


def queued_adds(visits, kb):
    """The order in which ``gather_groups`` adds a row's visits through a
    ``Queue<kb>`` (q[0] the newest): a full queue is added oldest first
    before the next push, the rest after the walk; with the batches the
    adds form."""
    queue, adds, batches = [], [], []
    for ent in visits:
        if len(queue) == kb:
            adds += queue[::-1]
            batches.append(len(queue))
            queue = []
        queue.insert(0, ent)
    adds += queue[::-1]
    batches.append(len(queue))
    return adds, batches


@pytest.mark.parametrize("kb", [1, 2, 4, 8])
@pytest.mark.parametrize("case", EDGE_CASES + ["multigraph", "star"])
def test_queued_walk_adds_in_edge_order(case, kb):
    """Per row, the walk visits the forward neighbours in edge order, then
    the reverse ones; the queue adds them in that order, kb loads at a
    time (the reference's order), and the counts are the degrees."""
    parent, child, mask, n = edges_of(case)
    ok = valid_slots(parent, child, mask, n)
    for s in range(parent.shape[0]):
        ep = np.where(ok[s], parent[s], -1)
        ec = np.where(ok[s], child[s], -1)
        for i in range(n):
            visits, deg = walk_each(ep, ec, parent.shape[1], i)
            want = ([(0, int(c)) for p, c in zip(ep, ec) if p == i]
                    + [(1, int(p)) for p, c in zip(ep, ec) if c == i])
            assert visits == want, (s, i)
            assert deg == len(want)
            adds, batches = queued_adds(visits, kb)
            assert adds == want, (s, i)
            assert sum(batches) == deg and max(batches) <= kb
