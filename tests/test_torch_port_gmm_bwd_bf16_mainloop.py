"""The arithmetic of kernel 4b, the bf16 instance of the grouped matmul
backward (``gcn_tpu_torch/csrc/grouped_matmul_backward.cu``,
``grouped_matmul_dx_bf16_kernel`` and ``grouped_matmul_ds_bf16_kernel``,
then ``grouped_matmul_ds_sum_kernel``), emulated in numpy on the CPU.

* Both products take bf16 operands on the bf16 tensor cores
  (``wgmma.m64n200k16``).  A product of two bf16 values is exact in f32,
  so each k-step of 16 adds an exact 16-term dot product (taken in f64)
  into one f32 accumulator, modelled rounded toward zero and to nearest
  as in ``test_torch_port_gmm_spmm_bf16_mainloop.py``.
* dx = g S[g]ᵀ: K = H from 0 in k-steps of 16, one accumulator over all
  of H, rounded to bf16 once at the store.  Rows past the last group end
  belong to the last group.
* dS[g] = x[rows of g]ᵀ g[rows of g], f32: the group's rows are cut into
  chunks of 256 (``GMM_DS_CHUNK``); each chunk sums its rows from its
  first in k-steps of 16 (rows past the chunk's end, which the kernel's
  boxes bring from the next group, are zero), and the chunks are added
  in chunk order, each add rounded to f32.  A group with no rows of its
  own has zero dS, the last one too when rows past the sum fall into it.

Each emulation is held three ways at small shapes that include the main
path's T (400 and 200), a ragged T and H, groups that start in the middle
of a 64-row box, a group of more than one chunk, an empty group and rows
past the sum: against f64; against the port's bf16 plain version
(``grouped_matmul_backward_plain``), dx's bits or one rounding step (the
card tests' ``bf16_flip``) and dS within the f32 instance's tolerance;
and against ``gcn_tpu``'s ``_gmm_bwd`` through ``jax.vjp`` in bf16 and f32,
Pallas in interpret mode as gcn_tpu's tests run it, by the gap rule of
``test_torch_port_bf16.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_tpu.ops.pallas.grouped_matmul import grouped_matmul as jax_gmm
from gcn_tpu_torch.ops import grouped_matmul as gmm_mod
from tests.test_torch_port_bf16 import gap_check
from tests.test_torch_port_cuda import GMM_DS_CHUNK, bf16_flip
from tests.test_torch_port_gmm_spmm_bf16_mainloop import (
    ROUNDINGS, bf16_values, gmm_groups, half_ulp_bound, kstep_product)

BWD_TOL = 1e-4  # the f32 backward's tolerance against its plain version

# name: (group sizes, rows past their sum, T, H).  The C-GCN layers' T (M
# and H cut) with a group of two dS chunks; groups that start mid-box and
# a group of three chunks whose last is ragged; a ragged T and H (the path
# where TMA refuses the operands); an empty last group that takes the
# rows past the sum.
CASES = {"c_gcn_T400": ([0, 20, 3, 45, 0, 300, 9], 0, 400, 24),
         "c_gcn_T200": ([0, 20, 3, 45, 0, 300, 9], 0, 200, 24),
         "mid_box": ([1, 130, 7, 0, 133, 1, 600], 5, 64, 16),
         "ragged_t37": ([1, 9, 0, 40, 3], 3, 37, 5),
         "empty_last_past_sum": ([40, 0, 30, 0], 30, 24, 8)}


def operands(name):
    """Seeded bf16-valued x [M, T], g [M, H], s [R, T, H] at the kernel
    phase's scales (x ~ U(-1, 1), g ~ N(0, 1)/10, s ~ N(0, 1)/√T) and the
    group sizes."""
    sizes, past, t, h = CASES[name]
    gs = np.array(sizes, np.int32)
    rng = np.random.RandomState(int(gs.sum()) + 7 * t * h)
    m = int(gs.sum()) + past
    x = bf16_values(rng.uniform(-1, 1, (m, t)))
    g = bf16_values(rng.randn(m, h) * 0.1)
    s = bf16_values(rng.randn(gs.shape[0], t, h) / np.sqrt(t))
    return x, g, s, gs


def own_rows(gs, m):
    """(group, first row, end row) of each group with rows of its own (the
    last group runs to m)."""
    return [(grp, lo, hi) for grp, lo, hi in gmm_groups(gs, m)
            if gs[grp] > 0]


def kernel_dx(x, g, s, gs, rounding="toward_zero"):
    """dx's f32 sums before their one rounding."""
    dx = np.zeros(x.shape, np.float32)
    for grp, lo, hi in gmm_groups(gs, x.shape[0]):
        dx[lo:hi] = kstep_product(g[lo:hi], s[grp].T, rounding)
    return dx


def kernel_ds(x, g, s, gs, rounding="toward_zero"):
    """dS as the kernels sum it: per chunk of 256 rows in k-steps of 16,
    the chunks added in chunk order."""
    ds = np.zeros(s.shape, np.float32)
    for grp, lo, hi in own_rows(gs, x.shape[0]):
        for c0 in range(lo, hi, GMM_DS_CHUNK):
            c1 = min(hi, c0 + GMM_DS_CHUNK)
            part = kstep_product(x[c0:c1].T, g[c0:c1], rounding)
            ds[grp] = part if c0 == lo else ds[grp] + part
    return ds


def reference(x, g, s, gs):
    """dx and dS in f64."""
    x64, g64, s64 = (a.astype(np.float64) for a in (x, g, s))
    dx, ds = np.zeros(x.shape), np.zeros(s.shape)
    for grp, lo, hi in gmm_groups(gs, x.shape[0]):
        dx[lo:hi] = g64[lo:hi] @ s64[grp].T
    for grp, lo, hi in own_rows(gs, x.shape[0]):
        ds[grp] = x64[lo:hi].T @ g64[lo:hi]
    return dx, ds


def test_cases_cover_the_kernels_edges():
    """Between them the cases hold the main path's T, a ragged T and H,
    groups that start off the 64-row boxes, a group of more than one dS
    chunk, an empty group, and rows past the sum."""
    seen = {"t": set(), "mid_box": False, "chunks": False, "empty": False,
            "past": False, "ragged": False}
    for sizes, past, t, h in CASES.values():
        starts = np.cumsum([0] + sizes[:-1])
        seen["t"].add(t)
        seen["mid_box"] |= bool((starts % 64 != 0).any())
        seen["chunks"] |= max(sizes) > GMM_DS_CHUNK
        seen["empty"] |= 0 in sizes
        seen["past"] |= past > 0
        seen["ragged"] |= t % 8 != 0 and h % 8 != 0
    assert {400, 200} <= seen.pop("t") and all(seen.values())


@pytest.mark.parametrize("rounding", sorted(ROUNDINGS))
@pytest.mark.parametrize("name", sorted(CASES))
def test_sums_keep_f32_error(name, rounding):
    """dx before its rounding errs a tenth of the f32 tolerance or less
    against f64, and after it half a bf16 step and that; dS (f32) errs a
    tenth of the f32 tolerance or less; groups with no rows of their own
    get zero dS."""
    x, g, s, gs = operands(name)
    ref_dx, ref_ds = reference(x, g, s, gs)
    dx = kernel_dx(x, g, s, gs, rounding)
    ds = kernel_ds(x, g, s, gs, rounding)
    slack = BWD_TOL / 10 * max(1.0, float(np.abs(ref_dx).max()))
    assert float(np.abs(dx - ref_dx).max()) <= slack
    assert half_ulp_bound(bf16_values(dx), ref_dx, slack)
    scale = max(1.0, float(np.abs(ref_ds).max()))
    assert float(np.abs(ds - ref_ds).max()) <= BWD_TOL / 10 * scale
    assert not ds[gs == 0].any()


@pytest.mark.parametrize("rounding", sorted(ROUNDINGS))
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_is_the_plain_version_in_bf16(name, rounding):
    """grouped_matmul_backward_plain on the bf16 operands: dx its bits or
    one rounding step, dS within the f32 tolerance, both orders."""
    x, g, s, gs = operands(name)
    plain_dx, plain_ds = gmm_mod.grouped_matmul_backward_plain(
        *(torch.from_numpy(a).bfloat16() for a in (x, g, s)),
        torch.from_numpy(gs))
    assert plain_dx.dtype == torch.bfloat16 and plain_ds.dtype == torch.float32
    dx = torch.from_numpy(kernel_dx(x, g, s, gs, rounding)).bfloat16()
    print(f"{name} {rounding}: dx's largest difference "
          f"{bf16_flip(dx, plain_dx, BWD_TOL):.3g}, "
          f"{int((dx != plain_dx).sum())} of {dx.numel()} values differ")
    ds = torch.from_numpy(kernel_ds(x, g, s, gs, rounding))
    scale = max(1.0, float(plain_ds.abs().max()))
    assert float((ds - plain_ds).abs().max()) <= BWD_TOL * scale


@pytest.mark.parametrize("name", ["c_gcn_T200", "mid_box", "ragged_t37"])
def test_kernel_matches_jax_in_bf16(name):
    """gcn_tpu's ``_gmm_bwd`` (``jax.vjp`` of its grouped matmul, interpret
    mode) in bf16 and f32 against the emulated kernel and the port's f32
    plain version; dS in s's dtype, as both autograd functions return it."""
    x, g, s, gs = operands(name)
    out = {}
    for key, jdt in (("j16", jnp.bfloat16), ("j32", jnp.float32)):
        _, vjp = jax.vjp(lambda a, b: jax_gmm(a, b, jnp.asarray(gs),
                                              interpret=True),
                         jnp.asarray(x, jdt), jnp.asarray(s, jdt))
        out[key] = vjp(jnp.asarray(g, jdt))
    assert out["j16"][0].dtype == out["j16"][1].dtype == jnp.bfloat16
    p32 = gmm_mod.grouped_matmul_backward_plain(
        *(torch.from_numpy(a) for a in (x, g, s)), torch.from_numpy(gs))
    got = (torch.from_numpy(kernel_dx(x, g, s, gs)).bfloat16(),
           torch.from_numpy(kernel_ds(x, g, s, gs)).bfloat16())
    gap_check(f"grouped matmul backward bf16 kernel {name}", list(got),
              list(p32), list(out["j16"]), list(out["j32"]))
