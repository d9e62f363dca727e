"""The arithmetic of kernels 3b and 7b, the bf16 instances of the grouped
matmul forward (``gcn_tpu_torch/csrc/grouped_matmul.cu``,
``grouped_matmul_fwd_bf16_kernel``) and of the fused GCN layer's forward
(``gcn_tpu_torch/csrc/spmm_fused.cu``, ``spmm_fused_fwd_bf16_kernel``),
emulated in numpy on the CPU.

* Both products take bf16 operands on the bf16 tensor cores (3b
  ``wgmma.m64n208k16``, 7b ``mma.sync.m16n8k16``).  A product of two bf16
  values is exact in f32, so each k-step of 16 adds an exact 16-term dot
  product (taken in f64) into one f32 accumulator that runs over all of T.
  The tensor cores' rounding of that accumulator is modelled toward zero,
  as ``test_torch_port_tf32x3.py`` models the TF32 MMAs', and to nearest;
  the bounds hold either way.  The sum is rounded to bf16 once, at the
  store (to nearest even).
* 3b: each row of group g multiplies S[g]; rows past the last group end
  belong to the last group.
* 7b: (S h) is summed first, row by row in f32 in the kernels' fixed
  order (the row's forward neighbours, its children, in edge order, then
  its reverse ones, its parents, then (deg > 0) + 1 times the row itself),
  and rounded to bf16 once; the product with W is summed as above, then
  ``+ 2b``, ``/ denom`` and the ReLU in f32, and the output rounded once.

Each emulation is held three ways at small shapes that include the main
path's T (400 and 200 for 3b, 360 and 200 for 7b), a ragged T and, for
3b, groups that start mid-tile: against f64; against the port's bf16
plain versions (``grouped_matmul_plain``, ``gcn_spmm_plain``), their bits
or one rounding step (the card tests' ``bf16_flip``); and against
``gcn_tpu``'s ``_gmm_forward`` and ``spmm_fused._forward`` in bf16, Pallas
in interpret mode as gcn_tpu's tests run it, by the gap rule of
``test_torch_port_bf16.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_tpu.ops.pallas import grouped_matmul as jax_gmm
from gcn_tpu.ops.pallas import spmm_fused as jax_spmm
from gcn_tpu_torch.ops import grouped_matmul as gmm_mod
from gcn_tpu_torch.ops import spmm_fused as spmm_mod
from tests.test_torch_port_bf16 import gap_check
from tests.test_torch_port_cuda import bf16_flip, edge_case, tree_edges
from tests.test_torch_port_tf32x3 import to_f32_toward_zero

K_STEP = 16       # depth of one bf16 tensor-core k-step (wgmma and mma.sync)
GMM_TOL = 1e-4    # the f32 grouped matmul's tolerance against its plain version
SPMM_TOL = 1e-5   # the f32 fused layer's
ROUNDINGS = {"toward_zero": to_f32_toward_zero,
             "nearest": lambda a: a.astype(np.float32)}


def bf16_values(a):
    """f32 → bf16 (to nearest even), returned as f32 values."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16() \
        .float().numpy()


def kstep_product(a, b, rounding):
    """a [M, T] @ b [T, H] of bf16 values as the tensor cores sum it: k-steps
    of 16 exact products into one f32 accumulator over all of T."""
    to_f32 = ROUNDINGS[rounding]
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], K_STEP):
        k1 = min(a.shape[1], k0 + K_STEP)
        acc = to_f32(acc.astype(np.float64) + a64[:, k0:k1] @ b64[k0:k1])
    return acc


def half_ulp_bound(out, ref, slack):
    """Whether every bf16 value of out lies within half a bf16 step of the
    f64 ref, beyond slack."""
    half_ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126)))
                       - 8)
    return bool((np.abs(out.astype(np.float64) - ref) <= half_ulp + slack)
                .all())


# ------------------------------------------------------------- kernel 3b
# name: (group sizes, rows past their sum, T, H).  The C-GCN layers' T (M
# and H cut); groups of one row and groups that start mid-tile (the
# 128-row tiles' starts are the groups'); a ragged T and H, the path
# where TMA refuses the operands.
GMM_CASES = {"c_gcn_T400": ([0, 20, 3, 45, 0, 70, 9], 0, 400, 24),
             "c_gcn_T200": ([0, 20, 3, 45, 0, 70, 9], 0, 200, 24),
             "mid_tile": ([1, 130, 7, 0, 133, 1], 5, 64, 16),
             "ragged_t37": ([1, 9, 0, 40, 3], 3, 37, 5)}


def gmm_operands(name):
    """Seeded bf16-valued x [M, T], s [R, T, H] at the kernel phase's scales
    (x ~ U(-1, 1), s ~ N(0, 1)/√T) and the group sizes."""
    sizes, past, t, h = GMM_CASES[name]
    gs = np.array(sizes, np.int32)
    rng = np.random.RandomState(int(gs.sum()) + t * h)
    m = int(gs.sum()) + past
    x = bf16_values(rng.uniform(-1, 1, (m, t)))
    s = bf16_values(rng.randn(gs.shape[0], t, h) / np.sqrt(t))
    return x, s, gs


def gmm_groups(gs, m):
    """(group, first row, end row) of each group with rows; the last group
    runs to m."""
    ends = np.cumsum(gs)
    out = []
    for g in range(gs.shape[0]):
        lo = ends[g - 1] if g else 0
        hi = m if g == gs.shape[0] - 1 else ends[g]
        if hi > lo:
            out.append((g, lo, hi))
    return out


def gmm_kernel_sum(x, s, gs, rounding="toward_zero"):
    """The kernel's f32 sums before their one rounding."""
    y = np.zeros((x.shape[0], s.shape[2]), np.float32)
    for g, lo, hi in gmm_groups(gs, x.shape[0]):
        y[lo:hi] = kstep_product(x[lo:hi], s[g], rounding)
    return y


def gmm_reference(x, s, gs):
    y = np.zeros((x.shape[0], s.shape[2]))
    for g, lo, hi in gmm_groups(gs, x.shape[0]):
        y[lo:hi] = x[lo:hi].astype(np.float64) @ s[g].astype(np.float64)
    return y


@pytest.mark.parametrize("rounding", sorted(ROUNDINGS))
@pytest.mark.parametrize("name", sorted(GMM_CASES))
def test_gmm_kernel_sum_keeps_f32_error(name, rounding):
    """Before its rounding the sum errs a tenth of the f32 instance's
    tolerance or less against f64; after it, half a bf16 step and that."""
    x, s, gs = gmm_operands(name)
    ref = gmm_reference(x, s, gs)
    got = gmm_kernel_sum(x, s, gs, rounding)
    slack = GMM_TOL / 10 * max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(got - ref).max()) <= slack
    assert half_ulp_bound(bf16_values(got), ref, slack)


@pytest.mark.parametrize("rounding", sorted(ROUNDINGS))
@pytest.mark.parametrize("name", sorted(GMM_CASES))
def test_gmm_kernel_is_the_plain_version_in_bf16(name, rounding):
    """grouped_matmul_plain's bits or one rounding step, both orders."""
    x, s, gs = gmm_operands(name)
    plain = gmm_mod.grouped_matmul_plain(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(s).bfloat16(),
        torch.from_numpy(gs))
    got = torch.from_numpy(gmm_kernel_sum(x, s, gs, rounding)).bfloat16()
    print(f"{name} {rounding}: largest difference "
          f"{bf16_flip(got, plain, GMM_TOL):.3g}, "
          f"{int((got != plain).sum())} of {got.numel()} values differ")


@pytest.mark.parametrize("name", ["c_gcn_T200", "ragged_t37"])
def test_gmm_kernel_matches_jax_in_bf16(name):
    """gcn_tpu's ``_gmm_forward`` in bf16 and f32 (interpret mode) against
    the emulated kernel and the port's f32 plain version."""
    x, s, gs = gmm_operands(name)
    out = {}
    for key, jdt in (("j16", jnp.bfloat16), ("j32", jnp.float32)):
        out[key] = jax_gmm._gmm_forward(jnp.asarray(x, jdt),
                                        jnp.asarray(s, jdt),
                                        jnp.asarray(gs), interpret=True)
    assert out["j16"].dtype == jnp.bfloat16
    p32 = gmm_mod.grouped_matmul_plain(torch.from_numpy(x),
                                       torch.from_numpy(s),
                                       torch.from_numpy(gs))
    got = torch.from_numpy(gmm_kernel_sum(x, s, gs)).bfloat16()
    gap_check(f"grouped matmul bf16 kernel {name}", got, p32, out["j16"],
              out["j32"])


# ------------------------------------------------------------- kernel 7b
# name: (B, N, T, H, edges).  The paper GCN's two layers' T (B, N and H
# cut; N = 50 crosses the kernel's 48-row tile); a ragged T and H; every
# edge twice and ends past N (dropped).
SPMM_CASES = {"gcn_T360": (2, 50, 360, 16, "trees"),
              "gcn_T200": (2, 50, 200, 16, "trees"),
              "ragged_t37": (3, 10, 37, 5, "random"),
              "duplicates": (3, 10, 40, 8, "duplicates"),
              "out_of_range": (3, 10, 24, 8, "out_of_range")}


def spmm_operands(name):
    """Seeded edge lists and bf16-valued h [B, N, T], W [T, H], b [H] at
    the kernel phase's scales (h ~ N(0, 1), W ~ U(-1, 1)/√T, b ~ U(-0.1,
    0.1))."""
    b, n, t, h, kind = SPMM_CASES[name]
    rng = np.random.RandomState(b * n * t + h)
    edges = tree_edges(rng, b, n) if kind == "trees" else edge_case(
        kind, b, n, n)
    hv = bf16_values(rng.randn(b, n, t))
    w = bf16_values(rng.uniform(-1, 1, (t, h)) / np.sqrt(t))
    bias = bf16_values(rng.uniform(-0.1, 0.1, h))
    return edges, hv, w, bias


def gather(edges, hv):
    """(S h) as the kernel sums it, in f32, before its rounding, and each
    row's degree: per row its forward neighbours in edge order, then its
    reverse ones, then diag * self."""
    parent, child, mask = edges
    b, n, t = hv.shape
    ah = np.zeros((b, n, t), np.float32)
    deg = np.zeros((b, n), np.int64)
    for s in range(b):
        ok = mask[s] & (parent[s] >= 0) & (parent[s] < n) & \
            (child[s] >= 0) & (child[s] < n)
        for i in range(n):
            acc = np.zeros(t, np.float32)
            for key, nbr in ((parent[s], child[s]), (child[s], parent[s])):
                for q in np.flatnonzero(ok & (key == i)):
                    acc = acc + hv[s, nbr[q]]  # f32 adds, rounded each
                    deg[s, i] += 1
            diag = np.float32((deg[s, i] > 0) + 1)
            ah[s, i] = acc + diag * hv[s, i]
    return ah, deg


def spmm_kernel_out(name, rounding="toward_zero"):
    """The kernel's bf16 output of case ``name``, as a torch tensor, and its
    f32 product sums before 2b, denom and the ReLU."""
    edges, hv, w, bias = spmm_operands(name)
    ah, deg = gather(edges, hv)
    b, n, t = hv.shape
    acc = kstep_product(bf16_values(ah).reshape(b * n, t), w, rounding)
    denom = (deg + (deg > 0) + 1).astype(np.float32).reshape(b * n, 1)
    z = (acc + np.float32(2) * bias) / denom  # f32, each step rounded
    out = np.maximum(z, np.float32(0)).reshape(b, n, -1)
    return torch.from_numpy(out).bfloat16(), acc


def torch_operands(name, dtype):
    edges, hv, w, bias = spmm_operands(name)
    tedges = [torch.from_numpy(np.ascontiguousarray(a)) for a in edges]
    return tedges, [torch.from_numpy(a).to(dtype) for a in (hv, w, bias)]


@pytest.mark.parametrize("rounding", sorted(ROUNDINGS))
@pytest.mark.parametrize("name", sorted(SPMM_CASES))
def test_spmm_gather_and_product_keep_f32_error(name, rounding):
    """The f32 gather errs a few f32 steps from f64; the product, on the
    gather rounded to bf16, a tenth of the f32 instance's tolerance."""
    edges, hv, w, _ = spmm_operands(name)
    ah, deg = gather(edges, hv)
    parent, child, mask = edges
    b, n, t = hv.shape
    ref = np.zeros((b, n, t))
    for s in range(b):  # the dense band of the plain version, in f64
        ok = mask[s] & (parent[s] >= 0) & (parent[s] < n) & \
            (child[s] >= 0) & (child[s] < n)
        band = np.zeros((n, n))
        np.add.at(band, (parent[s][ok], child[s][ok]), 1.0)
        band = band + band.T + np.diag((deg[s] > 0) + 1.0)
        ref[s] = band @ hv[s].astype(np.float64)
    scale = max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(ah - ref).max()) <= 4 * 2.0 ** -24 * scale
    a16 = bf16_values(ah).reshape(b * n, t)
    got = kstep_product(a16, w, rounding)
    pref = a16.astype(np.float64) @ w.astype(np.float64)
    slack = SPMM_TOL / 10 * max(1.0, float(np.abs(pref).max()))
    assert float(np.abs(got - pref).max()) <= slack


@pytest.mark.parametrize("rounding", sorted(ROUNDINGS))
@pytest.mark.parametrize("name", sorted(SPMM_CASES))
def test_spmm_kernel_is_the_plain_version_in_bf16(name, rounding):
    """gcn_spmm_plain's bits or one rounding step, both orders."""
    tedges, (h, w, bias) = torch_operands(name, torch.bfloat16)
    plain = spmm_mod.gcn_spmm_plain(*tedges, h, w, bias)
    got, _ = spmm_kernel_out(name, rounding)
    print(f"{name} {rounding}: largest difference "
          f"{bf16_flip(got, plain, SPMM_TOL):.3g}, "
          f"{int((got != plain).sum())} of {got.numel()} values differ")


@pytest.mark.parametrize("name", ["gcn_T200", "ragged_t37"])
def test_spmm_kernel_matches_jax_in_bf16(name):
    """gcn_tpu's ``spmm_fused._forward`` in bf16 and f32 (interpret mode)
    against the emulated kernel and the port's f32 plain version."""
    edges, hv, w, bias = spmm_operands(name)
    out = {}
    for key, jdt in (("j16", jnp.bfloat16), ("j32", jnp.float32)):
        out[key] = jax_spmm._forward(
            *(jnp.asarray(a) for a in edges),
            *(jnp.asarray(a, jdt) for a in (hv, w, bias)), interpret=True)
    assert out["j16"].dtype == jnp.bfloat16
    tedges, t32 = torch_operands(name, torch.float32)
    p32 = spmm_mod.gcn_spmm_plain(*tedges, *t32)
    got, _ = spmm_kernel_out(name)
    gap_check(f"fused layer bf16 kernel {name}", got, p32, out["j16"],
              out["j32"])
