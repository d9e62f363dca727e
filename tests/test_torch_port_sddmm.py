"""The port's SDDMM, edge softmax and weighted edge-list SpMM against the JAX
package's, on the CPU (``sddmm``'s Pallas kernels in interpret mode, as
tests/test_sddmm.py runs them).

* ``sddmm`` gives JAX's scores within 1e-5 absolute (sums of H products in
  another order), and its gradients of u and v follow ``jax.grad``
  through JAX's custom VJP within 1e-4 of each tensor's max |grad|, over
  every ``EDGE_CASES`` case: JAX's one-hot selection scores an edge with
  an end past n 0 and gives it no gradient, as the port does.
* The backward kernel's adjacency lists (``edge_lists_plain``, the
  layout its list build writes) hold every counted edge once, in edge
  order per node, and a gather over them gives JAX's custom-VJP du and
  dv within 1e-5.
* The forward kernel's summation order (``csrc/sddmm.cu``, emulated in
  numpy f32: each lane's 16-byte column groups, then the xor shuffles)
  gives JAX's scores within 1e-6 at H = 12, 70, 200 and 300 (u and v
  scaled by H^-1/4, so that scores are O(1), where 1e-6 is a few f32
  ulps), and exactly 0 at masked and out-of-range slots.
* ``edge_softmax`` gives JAX's weights within 1e-6, and they sum to 1 over
  each destination's edges; ``spmm_forward`` / ``spmm_reverse`` with a gate
  and edge weights give JAX's within 1e-5.
* An edge with an end outside [0, n): JAX's ``edge_softmax`` (its gather
  of the per-node maximum) and ``spmm_*`` (the gather of the sender)
  give NaN; the port scores it 0 and leaves it out of the softmax and the
  aggregate, held against a dense attention formulation in numpy with
  the edge removed (``ROADMAP.md`` §3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_tpu.ops.pallas.sddmm import edge_softmax as jax_edge_softmax
from gcn_tpu.ops.pallas.sddmm import sddmm as jax_sddmm
from gcn_tpu.ops.spmm import spmm_forward as jax_spmm_forward
from gcn_tpu.ops.spmm import spmm_reverse as jax_spmm_reverse
from gcn_tpu_torch.ops import sddmm as mod
from gcn_tpu_torch.ops.spmm import spmm_forward, spmm_reverse, valid_edges
from tests.test_torch_port_band import as_torch, assert_grads_close
from tests.test_torch_port_cuda import EDGE_CASES, edge_case
from tests.test_torch_port_cuda import one_torch_thread  # noqa: F401

B, N, E, H = 3, 10, 10, 12
ATOL = 1e-5
IN_RANGE = [c for c in EDGE_CASES if c != "out_of_range"]


def inputs(case):
    parent, child, mask = edge_case(case, B, N, E)
    rng = np.random.RandomState(len(case) + 7)
    u, v = (rng.randn(B, N, H).astype(np.float32) for _ in range(2))
    return parent, child, mask, u, v, rng


@pytest.mark.parametrize("case", EDGE_CASES)
def test_sddmm_and_its_gradients_match_jax(case):
    parent, child, mask, u, v, rng = inputs(case)
    r = rng.randn(B, E).astype(np.float32)
    want, vjp = jax.vjp(lambda a, b: jax_sddmm(parent, child, mask, a, b),
                        u, v)
    pt, ct, mt, ut, vt = as_torch(parent, child, mask, u, v)
    ut.requires_grad_(True)
    vt.requires_grad_(True)
    got = mod.sddmm(pt, ct, mt, ut, vt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)
    assert_grads_close(torch.autograd.grad(got, (ut, vt),
                                           torch.from_numpy(r)),
                       vjp(jnp.asarray(r)))


def gather_over_lists(lists, g, u, v):
    """The backward kernel's gather in numpy: each node's (edge,
    neighbour) entries of ``lists`` (``mod.edge_lists_plain``'s layout)
    scaled by g and summed in list order, du through v, dv through u."""
    n, e = u.shape[1], g.shape[1]
    du, dv = np.zeros_like(u), np.zeros_like(v)
    for b in range(u.shape[0]):
        for j, (dst, src) in enumerate(((du, v), (dv, u))):
            start = lists[b, j * (n + 1):(j + 1) * (n + 1)]
            at = 2 * (n + 1) + 2 * j * e
            ent = lists[b, at:at + 2 * e].reshape(e, 2)
            for i in range(n):
                for edge, nbr in ent[start[i]:start[i + 1]]:
                    dst[b, i] += g[b, edge] * src[b, nbr]
    return du, dv


@pytest.mark.parametrize("case", EDGE_CASES)
def test_edge_lists_carry_the_jax_backward(case):
    """The backward's adjacency lists (plain version, the layout the list
    build kernel writes): each node's entries in edge order, the slots past
    the counted edges -1, and a gather over them gives JAX's custom-VJP
    du and dv within 1e-5."""
    parent, child, mask, u, v, rng = inputs(case)
    g = rng.randn(B, E).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jax_sddmm(parent, child, mask, a, b), u, v)
    lists = mod.edge_lists_plain(*as_torch(parent, child, mask), N).numpy()
    assert lists.shape == (B, mod.list_ints(N, E))
    ok = valid_edges(*as_torch(parent, child, mask), N).numpy()
    for j in range(2):
        at = 2 * (N + 1) + 2 * j * E
        edges = lists[:, at:at + 2 * E:2]
        for b in range(B):
            kept = edges[b, :ok[b].sum()]
            assert sorted(kept) == list(np.flatnonzero(ok[b]))
            assert (edges[b, ok[b].sum():] == -1).all()
            start = lists[b, j * (N + 1):(j + 1) * (N + 1)]
            for i in range(N):  # each node's entries in edge order
                assert (np.diff(edges[b, start[i]:start[i + 1]]) > 0).all()
    for got, want in zip(gather_over_lists(lists, g, u, v),
                         vjp(jnp.asarray(g))):
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)


# csrc/sddmm.cu kLanes and kMaxV: the forward's lanes an edge and column
# groups a lane at most
SDDMM_LANES, SDDMM_MAX_V = 16, 4


def fma32(a, b, c):
    """fmaf on f32 arrays: the product exact in f64, the sum rounded to f64
    and then to f32 (a double rounding, which may differ from the card's
    single one in the last bit)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def forward_order(parent, child, mask, u, v, lanes=SDDMM_LANES):
    """The SDDMM forward kernel's sums in numpy f32 (``sddmm_fwd_kernel``).
    Lane mapping: an edge takes ``lanes`` lanes; lane l covers columns
    4 (l + lanes g) .. +3 of each round of kV = min(⌈H / 4 lanes⌉,
    SDDMM_MAX_V) groups g (one 16-byte load of each row a group; columns
    past H read 0 and add nothing).  Each lane folds its products into one
    fmaf chain, round by round, group by group, x y z w; then lane l adds
    lane l ^ off for off = lanes / 2 .. 1 (the xor shuffles) and lane 0
    stores.  A slot that does not count stores 0."""
    b_sz, n, h = u.shape
    kv = min(-(-h // (4 * lanes)), SDDMM_MAX_V)
    out = np.zeros(parent.shape, np.float32)
    ok = mask & (parent >= 0) & (parent < n) & (child >= 0) & (child < n)
    lane = np.arange(lanes)
    for b, q in zip(*np.nonzero(ok)):
        up, vc = u[b, parent[b, q]], v[b, child[b, q]]
        acc = np.zeros(lanes, np.float32)
        for k0 in range(0, h, 4 * lanes * kv):
            for g in range(kv):
                for j in range(4):
                    k = k0 + 4 * (lane + lanes * g) + j
                    inside = k < h
                    acc[inside] = fma32(up[k[inside]], vc[k[inside]],
                                        acc[inside])
        off = lanes // 2
        while off:
            acc = acc + acc[lane ^ off]
            off //= 2
        out[b, q] = acc[0]
    return out


@pytest.mark.parametrize("h", [12, 70, 200, 300])
@pytest.mark.parametrize("case", IN_RANGE)
def test_forward_kernel_order_matches_jax(case, h):
    """The forward kernel's summation order gives JAX's scores within 1e-6
    (u, v scaled by H^-1/4: O(1) scores); at H = 200 a lane takes four
    groups, at H = 300 two rounds of four, at H = 70 (4-byte loads on the
    card) two groups, the last ragged."""
    parent, child, mask, _, _, _ = inputs(case)
    rng = np.random.RandomState(h)
    u, v = ((rng.randn(B, N, h) / h ** 0.25).astype(np.float32)
            for _ in range(2))
    want = jax_sddmm(parent, child, mask, u, v)
    np.testing.assert_allclose(forward_order(parent, child, mask, u, v),
                               np.asarray(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("case", EDGE_CASES)
def test_forward_kernel_order_scores_dropped_slots_zero(case):
    """Masked slots and edges with an end outside [0, n) score exactly 0
    in the kernel's order, and every counted edge a nonzero score."""
    parent, child, mask, u, v, _ = inputs(case)
    s = forward_order(parent, child, mask, u, v)
    ok = valid_edges(*as_torch(parent, child, mask), N).numpy()
    assert (s[~ok] == 0).all()
    assert (s[ok] != 0).all()


@pytest.mark.parametrize("case", EDGE_CASES)
def test_masked_and_dropped_edges_score_zero(case):
    parent, child, mask, u, v, _ = inputs(case)
    pt, ct, mt, ut, vt = as_torch(parent, child, mask, u, v)
    s = mod.sddmm_plain(pt, ct, mt, ut, vt)
    ok = valid_edges(pt, ct, mt, N)
    assert not s[~ok].any()
    if ok.any():
        assert s[ok].abs().min() > 0
    # the backward adds nothing for a masked or dropped edge
    g = torch.where(ok, 0.0, torch.ones(B, E))
    for d in mod.sddmm_backward_plain(pt, ct, mt, g, ut, vt):
        assert not d.any()


@pytest.mark.parametrize("case", IN_RANGE)
def test_edge_softmax_matches_jax_and_sums_to_one(case):
    parent, child, mask, _, _, rng = inputs(case)
    scores = (rng.randn(B, E) * 3).astype(np.float32)
    want = jax_edge_softmax(parent, scores, mask, N)
    pt, st, mt = as_torch(parent, scores, mask)
    got = mod.edge_softmax(pt, st, mt, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    sums = torch.zeros(B, N).scatter_add(1, pt.long(), got)
    has_edge = torch.zeros(B, N).scatter_add(1, pt.long(), mt.float()) > 0
    torch.testing.assert_close(sums[has_edge], torch.ones(
        int(has_edge.sum())), atol=1e-6, rtol=0)
    assert not got[~mt].any()


def test_edge_softmax_gradient_matches_jax():
    """The port detaches the per-node maximum (the shift cancels); JAX
    differentiates through it: the same gradient to float error."""
    parent, child, mask, _, _, rng = inputs("duplicates")
    scores = rng.randn(B, E).astype(np.float32)
    r = rng.randn(B, E).astype(np.float32)
    want = jax.grad(lambda s: jnp.sum(jax_edge_softmax(parent, s, mask, N)
                                      * r))(scores)
    pt, st, mt = as_torch(parent, scores, mask)
    st.requires_grad_(True)
    (got,) = torch.autograd.grad(
        (mod.edge_softmax(pt, st, mt, N) * torch.from_numpy(r)).sum(), st)
    assert_grads_close([got], [want])


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("case", IN_RANGE)
def test_weighted_spmm_matches_jax(case, gated):
    parent, child, mask, h, gate, rng = inputs(case)
    weights = rng.rand(B, E).astype(np.float32)
    gate = gate if gated else None
    pt, ct, mt, ht, wt = as_torch(parent, child, mask, h, weights)
    gt = None if gate is None else torch.from_numpy(gate)
    for jax_fn, fn in ((jax_spmm_forward, spmm_forward),
                       (jax_spmm_reverse, spmm_reverse)):
        for w, w_t in ((None, None), (weights, wt)):
            want = jax_fn(h, parent, child, mask, gate=gate, edge_weights=w)
            got = fn(ht, pt, ct, mt, gate=gt, edge_weights=w_t)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=ATOL, rtol=0)


def dense_attention(parent, child, ok, q, k, hw, scale):
    """Both bands of the edge attention layer in numpy, edge by edge over
    the edges in ``ok`` only."""
    out = np.zeros_like(hw)
    for b in range(parent.shape[0]):
        for dst_of, src_of in ((parent, child), (child, parent)):
            es = [e for e in range(parent.shape[1]) if ok[b, e]]
            s = {e: float(q[b, dst_of[b, e]] @ k[b, src_of[b, e]]) * scale
                 for e in es}
            for node in range(q.shape[1]):
                mine = [e for e in es if dst_of[b, e] == node]
                if not mine:
                    continue
                top = max(s[e] for e in mine)
                ex = {e: np.exp(s[e] - top) for e in mine}
                den = sum(ex.values())
                for e in mine:
                    out[b, node] += ex[e] / den * hw[b, src_of[b, e]]
    return out


def test_out_of_range_edges_are_left_out():
    """Edges with a parent, a child or both past n (mask set): JAX's edge
    path gives NaN; the port scores them 0 and aggregates as if they were
    absent."""
    parent, child, mask, q, k, rng = inputs("out_of_range")
    hw = rng.randn(B, N, H).astype(np.float32)
    scale = 1 / np.sqrt(H)
    pt, ct, mt, qt, kt, hwt = as_torch(parent, child, mask, q, k, hw)
    ok = valid_edges(pt, ct, mt, N)
    assert (mt & ~ok).any()
    s_f = mod.sddmm(pt, ct, ok, qt, kt) * scale
    a_f = mod.edge_softmax(pt, s_f, ok, N)
    s_r = mod.sddmm(ct, pt, ok, qt, kt) * scale
    a_r = mod.edge_softmax(ct, s_r, ok, N)
    assert not s_f[~ok].any() and not a_f[~ok].any() and not a_r[~ok].any()
    got = (spmm_forward(hwt, pt, ct, ok, edge_weights=a_f)
           + spmm_reverse(hwt, pt, ct, ok, edge_weights=a_r))
    want = dense_attention(parent, child, ok.numpy(), q, k, hw, scale)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    # and through the masks as given: the port drops the same edges
    a_m = mod.edge_softmax(pt, mod.sddmm(pt, ct, mt, qt, kt) * scale, ok, N)
    torch.testing.assert_close(spmm_forward(hwt, pt, ct, mt,
                                            edge_weights=a_m),
                               spmm_forward(hwt, pt, ct, ok,
                                            edge_weights=a_f))
    # the reference fault this pins (gcn_tpu is left as it is)
    s_j = jax_sddmm(parent, child, mask, q, k) * scale
    a_j = jax_edge_softmax(parent, s_j, mask, N)
    assert np.isnan(np.asarray(a_j)).any()
    assert np.isnan(np.asarray(jax_spmm_forward(hw, parent, child,
                                                mask))).any()
