"""The arithmetic of kernels 11b and 12b, the bf16 instances of the deprel
bilinear v2 and v1 (``gcn_tpu_torch/csrc/deprel_bilinear.cu``,
``deprel_bilinear_bf16_kernel``), emulated in numpy on the CPU.

* x, e and W are bf16.  A product of two bf16 values has at most 16
  significand bits, exact in f32, so each k-step of 16 (one
  ``wgmma.m64n208k16``) adds an exact 16-term dot product (taken in f64)
  into the f32 accumulator y_d.  The tensor cores' rounding of that
  accumulator is modelled toward zero, as ``test_torch_port_tf32x3.py``
  models the TF32 MMAs', and to nearest; the bounds hold either way.
* y_d starts from 0 for each relation d and runs over all of T where T
  fits the resident x tile (``PASS`` = 512), else over each 512-wide pass
  of T; then ``acc = fmaf(e[:, d], y_d, acc)`` in f32: the order of JAX's
  ``_kernel_v2`` (one product a relation, gated in f32), or a fold per
  (pass, d).
* The block's d slices (``d`` in [s D / S, (s + 1) D / S), S from
  ``deprel_bilinear_slices``) each sum from 0; their f32 partials are added
  in slice order and the sum is rounded to bf16 once (to nearest even).

The emulation is held three ways at small shapes: against an f64
reference; against the port's ``bilinear_v2_plain`` and
``bilinear_v1_plain`` in bf16, the plain version's bits or one rounding
step (the card tests' ``bf16_flip``); and against ``gcn_tpu``'s
``_core_v2_forward`` in bf16, Pallas in interpret mode as gcn_tpu's tests
run it, by the gap rule of ``test_torch_port_bf16.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_tpu.ops.pallas import deprel_bilinear as jax_bilinear
from gcn_tpu_torch.ops import deprel_bilinear as bilinear_mod
from tests.test_torch_port_bf16 import gap_check
from tests.test_torch_port_cuda import bf16_flip
from tests.test_torch_port_tf32x3 import fmaf, to_f32_toward_zero

K_STEP = 16  # depth of one wgmma.m64nNk16 in bf16
PASS = 512   # t values of the resident x tile: 8 blocks of 64
F32_TOL = 1e-4  # the f32 instance's tolerance against its plain version
ROUNDINGS = {"toward_zero": to_f32_toward_zero,
             "nearest": lambda a: a.astype(np.float32)}
# name: (M, T, D, H, slices, pass width).  The C-GCN layers' T and D
# (M = 4800, H = 200 on the card; fewer rows and columns here) split into
# the card's 3 slices; the same T = 400 inputs in passes of 64 (the
# chunked order); a wide T (the BERT input's 1084 without the BiLSTM) in
# three passes; a ragged T, not a multiple of the k-step.
CASES = {"c_gcn_T400": (32, 400, 50, 16, 3, PASS),
         "c_gcn_T400_chunked": (32, 400, 50, 16, 3, 64),
         "c_gcn_T200": (32, 200, 50, 16, 3, PASS),
         "wide_t": (16, 1084, 3, 16, 1, PASS),
         "ragged": (20, 37, 5, 7, 2, PASS)}


def bf16_values(a):
    """f32 → bf16 (to nearest even), returned as f32 values."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16() \
        .float().numpy()


def operands(name):
    """Seeded bf16-valued x [M, T], e [M, D], W [D, T, H] at the kernel
    phase's scales (x, e ~ N(0, 1), W ~ U(-1, 1)/√T); a case and its
    chunked twin share them."""
    m, t, d, h, _, _ = CASES[name]
    rng = np.random.RandomState(m * t + d * h)
    x = rng.randn(m, t)
    e = rng.randn(m, d)
    w = rng.uniform(-1, 1, (d, t, h)) / np.sqrt(t)
    return tuple(bf16_values(a) for a in (x, e, w))


def kernel_sum(x, e, w, slices, pass_width, rounding="toward_zero"):
    """The kernel's f32 sum before its one rounding: per slice, per pass of
    t, per d, y from 0 in k-steps of 16, folded in by fmaf; the slices'
    partials added in order."""
    to_f32 = ROUNDINGS[rounding]
    m, t = x.shape
    d_dim, _, h = w.shape
    x64, w64 = x.astype(np.float64), w.astype(np.float64)
    total = np.zeros((m, h), np.float32)
    for s in range(slices):
        acc = np.zeros((m, h), np.float32)
        for p0 in range(0, t, pass_width):
            p1 = min(t, p0 + pass_width)
            for d in range(s * d_dim // slices, (s + 1) * d_dim // slices):
                y = np.zeros((m, h), np.float32)
                for k0 in range(p0, p1, K_STEP):
                    k1 = min(p1, k0 + K_STEP)
                    y = to_f32(y.astype(np.float64)
                               + x64[:, k0:k1] @ w64[d, k0:k1])
                acc = fmaf(e[:, d], y, acc)
        total = total + acc
    return total


def kernel_out(name, rounding="toward_zero"):
    """The kernel's bf16 output of case ``name``, as a torch tensor."""
    x, e, w = operands(name)
    _, _, _, _, slices, pass_width = CASES[name]
    return torch.from_numpy(kernel_sum(x, e, w, slices, pass_width,
                                       rounding)).bfloat16()


def reference(x, e, w):
    """Σ_d e_d (x W_d) in f64."""
    return np.einsum("mt,md,dth->mh", *(a.astype(np.float64)
                                        for a in (x, e, w)))


def test_bf16_products_are_exact_in_f32():
    rng = np.random.RandomState(0)
    a, b = (bf16_values(rng.randn(10000) * 10.0 ** rng.randint(-3, 4, 10000))
            for _ in range(2))
    assert np.array_equal((a * b).astype(np.float64),
                          a.astype(np.float64) * b.astype(np.float64))


@pytest.mark.parametrize("rounding", sorted(ROUNDINGS))
@pytest.mark.parametrize("name", ["c_gcn_T400", "c_gcn_T400_chunked",
                                  "wide_t"])
def test_kernel_sum_keeps_f32_error(name, rounding):
    """Before its rounding the sum errs a tenth of the f32 instance's
    tolerance or less against f64; after it, half a bf16 step and that."""
    x, e, w = operands(name)
    _, _, _, _, slices, pass_width = CASES[name]
    ref = reference(x, e, w)
    got = kernel_sum(x, e, w, slices, pass_width, rounding)
    scale = max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(got - ref).max()) <= F32_TOL / 10 * scale
    out = bf16_values(got).astype(np.float64)
    half_ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126)))
                       - 8)
    assert bool((np.abs(out - ref) <= half_ulp + F32_TOL / 10 * scale)
                .all())


@pytest.mark.parametrize("version", ["v2", "v1"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_is_the_plain_version_in_bf16(name, version):
    """The plain version's bits or one rounding step, both orders."""
    x, e, w = (torch.from_numpy(a).bfloat16() for a in operands(name))
    plain = getattr(bilinear_mod, f"bilinear_{version}_plain")(x, e, w)
    assert plain.dtype == torch.bfloat16
    got = kernel_out(name)
    print(f"{name} {version}: largest difference "
          f"{bf16_flip(got, plain, F32_TOL):.3g}, "
          f"{int((got != plain).sum())} of {got.numel()} values differ")


@pytest.mark.parametrize("name", ["ragged", "c_gcn_T200"])
def test_kernel_matches_jax_v2_in_bf16(name):
    """gcn_tpu's ``_core_v2_forward`` in bf16 and f32 (interpret mode)
    against the emulated kernel and the port's f32 plain version."""
    x, e, w = operands(name)
    m = x.shape[0]
    out = {}
    for key, jdt in (("j16", jnp.bfloat16), ("j32", jnp.float32)):
        out[key] = jax_bilinear._core_v2_forward(
            *(jnp.asarray(a, jdt) for a in (x, e, w)), tile_m=m,
            interpret=True)
    assert out["j16"].dtype == jnp.bfloat16
    p32 = bilinear_mod.bilinear_v2_plain(
        *(torch.from_numpy(a) for a in (x, e, w)))
    gap_check(f"bilinear bf16 kernel {name}", kernel_out(name), p32,
              out["j16"], out["j32"])
