"""The port's edge-list band aggregation against the JAX package's, on the
CPU (the Pallas kernels in interpret mode, as tests/test_band_aggregate.py
runs them).

* ``fused_band_aggregate`` (ReLU on and off) and ``pair_aggregate`` give
  the JAX kernels' outputs within 1e-5 absolute: sums of a few neighbour
  rows, in another order than the interpreted one-hot matmuls.
* Their gradients follow ``jax.grad`` through JAX's ``custom_vjp`` within
  1e-4 of each tensor's max |grad|.
* ``node_degrees``, ``band_denom`` and ``build_adjacency`` (with
  ``Adjacency.combined``) equal JAX's.
* The ballot gather of the CUDA kernels (``csrc/edge_gather.cuh``),
  emulated in numpy, walks each row's neighbours in the order and with
  the counts of ``sddmm.edge_lists_plain``'s stable sort, and its counts
  are ``node_degrees``: the claim behind the kernels' same bits on every
  run and their denominators (also on a multigraph of 70 slots).  The
  pair kernel's sums, the walk's visits split by direction and added in
  f32 in their order, equal the sums in the lists' order bit for bit and
  JAX's ``pair_aggregate`` within 1e-5.
* Every test runs over ``EDGE_CASES``: duplicated edges, self-edges, an
  all-masked sentence, isolated nodes, and edges with a parent, a child or
  both at or past n, which are dropped as the JAX kernels and JAX's
  ``build_adjacency`` drop them.  JAX's ``node_degrees`` (and so its
  custom VJPs' denominator) still counts the in-range end of such an edge;
  the port drops the whole edge everywhere, so for that case the
  gradients are held against ``jax.grad`` of JAX's dense formulation
  (``band_ref_math``), which drops it too.
"""

import jax
import numpy as np
import pytest
import torch

from gcn_tpu.ops.adjacency import build_adjacency as jax_build_adjacency
from gcn_tpu.ops.pallas.band_aggregate import band_denom as jax_band_denom
from gcn_tpu.ops.pallas.band_aggregate import band_ref_math
from gcn_tpu.ops.pallas.band_aggregate import \
    fused_band_aggregate as jax_fused_band_aggregate
from gcn_tpu.ops.pallas.band_aggregate import \
    pair_aggregate as jax_pair_aggregate
from gcn_tpu.ops.spmm import node_degrees as jax_node_degrees
from gcn_tpu_torch.ops import band_aggregate as mod
from gcn_tpu_torch.ops.adjacency import build_adjacency
from gcn_tpu_torch.ops.sddmm import edge_lists_plain
from gcn_tpu_torch.ops.spmm import node_degrees
from tests.test_torch_port_cuda import EDGE_CASES, edge_case
from tests.test_torch_port_cuda import one_torch_thread  # noqa: F401

B, N, E, H = 3, 10, 10, 12
ATOL = 1e-5


def band_inputs(case):
    parent, child, mask = edge_case(case, B, N, E)
    rng = np.random.RandomState(len(case))
    xs = [rng.randn(B, N, H).astype(np.float32) for _ in range(3)]
    return parent, child, mask, xs


def as_torch(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def assert_grads_close(got, want, tol=1e-4):
    for g, w in zip(got, want):
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g.numpy() - w).max()) <= tol * scale


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("case", EDGE_CASES)
def test_fused_band_aggregate_matches_jax(case, relu):
    parent, child, mask, xs = band_inputs(case)
    want = jax_fused_band_aggregate(parent, child, mask, *xs, relu)
    got = mod.fused_band_aggregate(*as_torch(parent, child, mask, *xs),
                                   relu=relu)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    if case == "all_masked":  # no edge: act(x_s / 1)
        x_s = xs[2][1]
        np.testing.assert_allclose(got[1].numpy(),
                                   np.maximum(x_s, 0) if relu else x_s,
                                   atol=0, rtol=0)


@pytest.mark.parametrize("case", EDGE_CASES)
def test_pair_aggregate_matches_jax(case):
    parent, child, mask, xs = band_inputs(case)
    want = jax_pair_aggregate(parent, child, mask, xs[0])
    got = mod.pair_aggregate(*as_torch(parent, child, mask, xs[0]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("case", EDGE_CASES)
def test_fused_band_aggregate_grads_match_jax(case, relu):
    parent, child, mask, xs = band_inputs(case)
    ct = np.random.RandomState(7).randn(B, N, H).astype(np.float32)
    if case == "out_of_range":
        def fn(*x):
            return band_ref_math(parent, child, mask, *x, relu=relu)
    else:
        def fn(*x):
            return jax_fused_band_aggregate(parent, child, mask, *x, relu)
    want = jax.grad(lambda *x: (fn(*x) * ct).sum(), argnums=(0, 1, 2))(*xs)
    leaves = [t.requires_grad_() for t in as_torch(*xs)]
    out = mod.fused_band_aggregate(*as_torch(parent, child, mask), *leaves,
                                   relu=relu)
    got = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), leaves)
    assert_grads_close(got, want)


@pytest.mark.parametrize("case", EDGE_CASES)
def test_node_degrees_match_jax(case):
    parent, child, mask, _ = band_inputs(case)
    deg_out, deg_in, incident = node_degrees(*as_torch(parent, child, mask),
                                             N)
    adj = jax_build_adjacency(parent, child, mask, N)
    np.testing.assert_array_equal(deg_out.numpy(),
                                  np.asarray(adj.forward.sum(2)))
    np.testing.assert_array_equal(deg_in.numpy(),
                                  np.asarray(adj.forward.sum(1)))
    np.testing.assert_array_equal(incident.numpy(), np.asarray(adj.incident))
    jax_degrees = jax_node_degrees(parent, child, mask, N)
    if case == "out_of_range":
        # JAX's node_degrees still counts the in-range end of an edge
        # whose other end lies outside; its bands and the port drop it
        assert float(np.asarray(jax_degrees[0]).sum()) > float(deg_out.sum())
        assert float(np.asarray(jax_degrees[1]).sum()) > float(deg_in.sum())
        return
    for g, w in zip((deg_out, deg_in, incident), jax_degrees):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        mod.band_denom(*as_torch(parent, child, mask), N).numpy(),
        np.asarray(jax_band_denom(parent, child, mask, N)))


@pytest.mark.parametrize("case", EDGE_CASES)
def test_build_adjacency_matches_jax(case):
    """The repair: an edge with an end at or past n adds nothing, to A_f,
    the degrees, incident or denom, as in JAX (not to the next sentence's
    band, as one flattened index would put it)."""
    parent, child, mask, _ = band_inputs(case)
    got = build_adjacency(*as_torch(parent, child, mask), N)
    want = jax_build_adjacency(parent, child, mask, N)
    for name in ("forward", "incident", "denom", "pool_mask", "combined"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    if case == "out_of_range":
        assert float(got.forward.sum()) == float(
            (mask & (parent < N) & (child < N)).sum())


def ballot_walk(parent, child, mask, n):
    """The neighbour walk of ``csrc/edge_gather.cuh``'s ``gather_row`` (and
    ``gather_pair``, the same walk) for one sentence's edge slots, in
    numpy: per row i, the (direction, edge, neighbour) it visits and the
    popcounts it sums.  The slots that do not
    count read -1 (``load_edges``); each 32-slot step takes the ballot of
    key == i over its lanes and visits the set bits from low to high
    (``__ffs``), the forward direction (key = parent) before the reverse
    one (key = child)."""
    e = parent.shape[0]
    ok = mask & (parent >= 0) & (parent < n) & (child >= 0) & (child < n)
    ep, ec = np.where(ok, parent, -1), np.where(ok, child, -1)
    walks = []
    for i in range(n):
        visits, deg = [], 0
        for direction, (key, nbr) in enumerate(((ep, ec), (ec, ep))):
            for q0 in range(0, e, 32):
                bits = 0
                for lane in range(32):
                    q = q0 + lane
                    bits |= int(q < e and key[q] == i) << lane
                deg += bin(bits).count("1")
                while bits:
                    lane = (bits & -bits).bit_length() - 1
                    visits.append((direction, q0 + lane, int(nbr[q0 + lane])))
                    bits &= bits - 1
        walks.append((visits, deg))
    return walks


@pytest.mark.parametrize("case", EDGE_CASES + ["multigraph"])
def test_ballot_walk_keeps_the_lists_order(case):
    """Per row, the ballot walk visits the entries of ``edge_lists_plain``
    (forward, then reverse, each a stable sort by node) in their order, and
    its counts are ``node_degrees``' deg_out + deg_in."""
    if case == "multigraph":  # 70 slots over 12 nodes: three ballot steps
        n = 12
        parent, child, mask = edge_case("duplicates", B, n, 70)
    else:
        n = N
        parent, child, mask, _ = band_inputs(case)
    lists = edge_lists_plain(*as_torch(parent, child, mask), n).numpy()
    deg_out, deg_in, _ = node_degrees(*as_torch(parent, child, mask), n)
    e = parent.shape[1]
    for s in range(parent.shape[0]):
        starts = lists[s, :2 * (n + 1)].reshape(2, n + 1)
        ents = lists[s, 2 * (n + 1):].reshape(2, e, 2)
        walks = ballot_walk(parent[s], child[s], mask[s], n)
        for i, (visits, deg) in enumerate(walks):
            want = [(d, int(edge), int(nbr)) for d in range(2)
                    for edge, nbr in ents[d, starts[d, i]:starts[d, i + 1]]]
            assert visits == want, (s, i)
            assert deg == int(deg_out[s, i] + deg_in[s, i]), (s, i)


def walk_inputs(case):
    """(parent, child, mask, x, n) of a walk test: a case of
    ``band_inputs``, or 70 slots of doubled edges over 12 nodes (three
    ballot steps a direction)."""
    if case != "multigraph":
        parent, child, mask, xs = band_inputs(case)
        return parent, child, mask, xs[0], N
    n = 12
    parent, child, mask = edge_case("duplicates", B, n, 70)
    x = np.random.RandomState(70).randn(B, n, H).astype(np.float32)
    return parent, child, mask, x, n


@pytest.mark.parametrize("case", EDGE_CASES + ["multigraph"])
def test_pair_walk_sums_each_direction_in_list_order(case):
    """The pair kernel's sums as it takes them: per row, the ballot walk's
    forward visits (the row's children) added in f32 in walk order give
    (A_f x)[i], its reverse visits (its parents) (A_fᵀ x)[i], each from a
    zero.  They equal the same sums in ``edge_lists_plain``'s order bit for
    bit, and JAX's ``pair_aggregate`` within 1e-5."""
    parent, child, mask, x, n = walk_inputs(case)
    lists = edge_lists_plain(*as_torch(parent, child, mask), n).numpy()
    e = parent.shape[1]
    walked = np.zeros((2,) + x.shape, np.float32)  # out_t, out_f
    listed = np.zeros_like(walked)
    for s in range(parent.shape[0]):
        starts = lists[s, :2 * (n + 1)].reshape(2, n + 1)
        ents = lists[s, 2 * (n + 1):].reshape(2, e, 2)
        for i, (visits, _) in enumerate(
                ballot_walk(parent[s], child[s], mask[s], n)):
            for direction, _, nbr in visits:  # forward into out_f
                walked[1 - direction, s, i] += x[s, nbr]
            for d in range(2):
                for _, nbr in ents[d, starts[d, i]:starts[d, i + 1]]:
                    listed[1 - d, s, i] += x[s, nbr]
    np.testing.assert_array_equal(walked.view(np.uint32),
                                  listed.view(np.uint32))
    for got, want in zip(walked, jax_pair_aggregate(parent, child, mask, x)):
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)
