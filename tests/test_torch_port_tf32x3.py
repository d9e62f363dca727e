"""The arithmetic of the 3xTF32 split that kernels 2 (its dW_hh), 3, 4, 7,
11 and 12 run on the tensor cores (``gcn_tpu_torch/csrc/tf32x3_tile.cuh``),
emulated in numpy on the CPU.

* ``tf32_rna`` is ``cvt.rna.tf32.f32``: the f32 mantissa rounded to 10
  bits, ties away from zero.
* ``mma_sum`` is the kernels' accumulation: over K in steps of 8
  (``mma.sync.m16n8k8``) each product pass adds its 8-term dot product,
  exact (the products of TF32 parts are exact in f32, their sum is taken
  in f64), into an f32 accumulator rounded toward zero, as the tensor
  cores round it; each chunk of 32 (4 steps) goes into a fresh
  accumulator that one rounded-to-nearest f32 add then folds into the
  running sum, as ``mma_chunk`` does.  3xTF32 makes three passes a step,
  the small ones first: a_lo b_hi, a_hi b_lo, a_hi b_hi.  Run without the
  chunks (one accumulator over all of K, toward zero) the same model gave
  3.03e-6 at kernel 7's row, where the card gave 2.95e-6 before the
  kernels took chunks (``chip_smoke.py``, NVIDIA H100 80GB HBM3,
  700.00 W), and errs more than 2× the f32 product at both rows: the
  reason for the chunks.
* Kernel 12 (the bilinear v1) multiplies x itself and folds each chunk's
  c of (t chunk, d) in as ``acc = fmaf(e[m, d], c, acc)``, t chunks outer
  and d inner (``v1_sum``); its f32 product is the d-streamed loop of its
  first (SIMT) kernel, ``fmaf(e[m, d], x W_d, acc)`` over d with each
  x W_d an ``fma_sum``, and "one accumulator" there is one tensor-core
  accumulator over all of T for each d.
* Held against an f64 reference, at the chip rows' shapes and scales of
  K (kernels 11 and 12: K = D·T = 20000, a = e·x with e, x ~ N(0, 1) and
  W ~ U(-1, 1)/√T at T = 400; kernel 7: K = T = 360, a = (S h) the sum of
  three N(0, 1) rows and W ~ U(-1, 1)/√360): the 3xTF32 error is at most
  2× that of a plain f32 product of the same inputs, and a tenth of the
  kernel's tolerance (1e-4 and 1e-5 of max(1, |ref|)) or less; one TF32
  pass (1xTF32) errs more than 10× the f32 product, which is why the
  kernels do not take it.
* Kernel 2's dW_hh (the LSTM scan backward's third launch) runs the
  mainloop over a depth of K = (T-1)·B = 4750 at the C-GCN's shapes
  (T = 96, B = 50), A = keep·h_prev with h in (-1, 1) and W the gate
  gradients dxp (``dw_operands``), the depth split over the ``DW_SLICES``
  CTAs of a cluster on whole chunks, each slice summed from 0, and the
  slices' sums added in rank order (``dw_sum``); its f32 product is its
  first (SIMT) kernel's one FMA a term in depth order.
* Kernels 3 and 4, the grouped matmul (``csrc/grouped_tiles.cuh``), at
  the C-GCN layer's T = 400: the forward over K = T with x ~ U(-1, 1) and
  S ~ N(0, 1)/√T; the backward's dx over K = H = 200 with g ~ N(0, 0.1)
  and S[g]ᵀ; its dS over K = the 2068 rows of a padding group of the
  chip smoke's batch, A = xᵀ and W = g, cut into chunks of
  ``GMM_DS_CHUNK`` rows, each an ``mma_sum`` from 0, the chunks' sums
  added in chunk order (``runs_sum``).  Their f32 products are their first
  (SIMT) kernels': one FMA a term in k order.
* The plain f32 product is ``fma_sum``: one f32 FMA a term, in k order,
  the arithmetic of the kernels' first (SIMT) loop and of any f32 dot
  product on the CUDA cores.  A blocked CPU SGEMM (numpy's ``float32``
  matmul) sums in short runs and errs 3-8× less than either at these K:
  the summation order, not the split, sets these errors.
"""

import numpy as np
import pytest

# name: (K, tolerance of the kernel against its plain version)
CASES = {"kernel11_bilinear_v2": (20000, 1e-4),
         "kernel12_bilinear_v1": (20000, 1e-4),
         "kernel7_spmm_fused": (360, 1e-5),
         "kernel2_lstm_dw": (95 * 50, 1e-4),
         "kernel3_gmm_forward": (400, 1e-4),
         "kernel4_gmm_dx": (200, 1e-4),
         "kernel4_gmm_ds": (2068, 1e-4)}
DW_SLICES = 3  # kernel 2's dW clusters at the C-GCN's shapes: 132 SMs // 40
               # output tiles (2 directions x 4 x 5 tiles of 64 x 160)
T_BILINEAR = 400
T_GMM = 400          # the grouped matmul's T (first GCN layer)
GMM_DS_CHUNK = 256   # rows a dS chunk of kernel 4 at most
ROWS, COLS = 16, 8   # one m16n8 output tile


def tf32_rna(a):
    """cvt.rna.tf32.f32: keep 10 of the 23 mantissa bits, rounding to
    nearest with ties away from zero (on the magnitude, so the sign bit is
    untouched; a carry moves into the exponent)."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split(a):
    hi = tf32_rna(a)
    return hi, tf32_rna(a - hi)


def to_f32_toward_zero(x):
    """f64 → f32, rounded toward zero."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def mma_sum(passes, chunk=32):
    """The kernels' sum of a sequence of m16n8k8 steps: for each k-step of
    8, each (a_part [M, K], b_part [K, N]) pass in order adds its exact
    8-term dot product to an f32 accumulator rounded toward zero; every
    ``chunk`` of K (None: never) that accumulator is added into the
    running f32 sum, rounded to nearest, and starts again from 0."""
    a0, b0 = passes[0]
    total = np.zeros((a0.shape[0], b0.shape[1]), np.float32)
    acc = np.zeros_like(total)
    for k0 in range(0, a0.shape[1], 8):
        for a, b in passes:
            step = (a[:, k0:k0 + 8].astype(np.float64)
                    @ b[k0:k0 + 8].astype(np.float64))
            acc = to_f32_toward_zero(acc.astype(np.float64) + step)
        if chunk and (k0 + 8) % chunk == 0:
            total, acc = total + acc, np.zeros_like(acc)
    return total + acc


def fma_sum(a, b):
    """The f32 product with one FMA a term in k order: each exact product
    added to the f32 accumulator with one rounding."""
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    for k in range(a.shape[1]):
        acc = (acc + np.outer(a64[:, k], b64[k])).astype(np.float32)
    return acc


def bilinear_operands(name):
    """Seeded f32 x [16, T], e [16, D] and W [D·T, 8] of the bilinear rows."""
    k, _ = CASES[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    e = rng.randn(ROWS, k // T_BILINEAR).astype(np.float32)
    x = rng.randn(ROWS, T_BILINEAR).astype(np.float32)
    w = (rng.uniform(-1, 1, (k, COLS))
         / np.sqrt(T_BILINEAR)).astype(np.float32)
    return x, e, w


def operands(name):
    """Seeded f32 operands A [16, K] and W [K, 8] at the chip rows' scales."""
    if name.startswith("kernel11"):
        x, e, w = bilinear_operands(name)
        a = (e[:, :, None] * x[:, None, :]).reshape(ROWS, -1)  # f32 products
        return a, w
    k, _ = CASES[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    a = (rng.randn(3, ROWS, k).astype(np.float32)).sum(0)
    w = (rng.uniform(-1, 1, (k, COLS)) / np.sqrt(k)).astype(np.float32)
    return a, w


def dw_operands(name):
    """Seeded f32 A = keep·h_prev [16, K] (h in (-1, 1), a tenth of the
    carries dropped) and W = dxp [K, 8] at the scale of gate gradients."""
    k, _ = CASES[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    keep = (rng.rand(k) > 0.1).astype(np.float32)
    a = rng.uniform(-1, 1, (ROWS, k)).astype(np.float32) * keep
    w = (rng.randn(k, COLS) * 0.1).astype(np.float32)
    return a, w


def gmm_operands(name):
    """Seeded f32 A [16, K] and W [K, 8] of a grouped matmul case: x and
    S (forward), g and S[g]ᵀ (dx), xᵀ and g (dS), at the chip rows'
    scales."""
    k, _ = CASES[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    x = rng.uniform(-1, 1, (ROWS, k))
    if name == "kernel3_gmm_forward":
        a, w = x, rng.randn(k, COLS) / np.sqrt(T_GMM)
    elif name == "kernel4_gmm_dx":
        a, w = rng.randn(ROWS, k) * 0.1, rng.randn(k, COLS) / np.sqrt(T_GMM)
    else:
        a, w = x, rng.randn(k, COLS) * 0.1
    return a.astype(np.float32), w.astype(np.float32)


def runs_sum(passes, rows, chunk=32):
    """Kernel 4's dS sum: K cut into runs of ``rows``, each an ``mma_sum``
    from 0 (``chunk=None``: one accumulator a run), the runs' sums added
    in order."""
    k = passes[0][0].shape[1]
    total = np.zeros((passes[0][0].shape[0], passes[0][1].shape[1]),
                     np.float32)
    for k0 in range(0, k, rows):
        total = total + mma_sum([(a[:, k0:k0 + rows], b[k0:k0 + rows])
                                 for a, b in passes], chunk)
    return total


def dw_sum(passes, slices=DW_SLICES, chunk=32):
    """Kernel 2's dW sum: the depth's chunks of 32 split into ``slices``
    runs of whole chunks (rank s takes chunks [s·n/S, (s+1)·n/S)), each run
    an ``mma_sum`` from 0 (``chunk=None``: one accumulator a run), and the
    runs' sums added in rank order."""
    k = passes[0][0].shape[1]
    n = -(-k // 32)
    total = np.zeros((passes[0][0].shape[0], passes[0][1].shape[1]),
                     np.float32)
    for s in range(slices):
        k0, k1 = s * n // slices * 32, min(k, (s + 1) * n // slices * 32)
        total = total + mma_sum([(a[:, k0:k1], b[k0:k1]) for a, b in passes],
                                chunk)
    return total


def fmaf(s, c, acc):
    """f32 fmaf(s[:, None], c, acc): the exact product and sum, rounded
    once to nearest."""
    return (s.astype(np.float64)[:, None] * c.astype(np.float64)
            + acc.astype(np.float64)).astype(np.float32)


def v1_sum(x, e, w, split_parts, chunk):
    """Kernel 12's sum of Σ_d e_d (x W_d): per (t chunk of ``chunk``, d),
    t chunks outer, the chunk's product by ``mma_sum`` from 0 over the
    passes that ``split_parts(x part, W_d part)`` gives, folded in as
    ``fmaf(e[:, d], c, acc)``."""
    t = x.shape[1]
    acc = np.zeros((ROWS, COLS), np.float32)
    for t0 in range(0, t, chunk):
        for d in range(e.shape[1]):
            c = mma_sum(split_parts(x[:, t0:t0 + chunk],
                                    w[d * t + t0:d * t + t0 + chunk]),
                        None)
            acc = fmaf(e[:, d], c, acc)
    return acc


def three_passes(a, w):
    (a_hi, a_lo), (w_hi, w_lo) = split(a), split(w)
    return [(a_lo, w_hi), (a_hi, w_lo), (a_hi, w_hi)]


def v1_errors(name):
    """``errors`` of kernel 12: its fold against its first kernel's."""
    x, e, w = bilinear_operands(name)
    t, d_dim = T_BILINEAR, e.shape[1]
    ref = sum(e[:, d].astype(np.float64)[:, None]
              * (x.astype(np.float64) @ w[d * t:(d + 1) * t].astype(
                  np.float64)) for d in range(d_dim))
    f32 = np.zeros((ROWS, COLS), np.float32)
    for d in range(d_dim):
        f32 = fmaf(e[:, d], fma_sum(x, w[d * t:(d + 1) * t]), f32)
    return {"f32": scaled(f32, ref),
            "3xtf32": scaled(v1_sum(x, e, w, three_passes, 32), ref),
            "3xtf32_one_accumulator": scaled(
                v1_sum(x, e, w, three_passes, t), ref),
            "1xtf32": scaled(v1_sum(
                x, e, w, lambda a, b: [(tf32_rna(a), tf32_rna(b))], 32),
                ref)}


def scaled(got, ref):
    return float(np.abs(got - ref).max()) / max(1.0, float(np.abs(ref).max()))


def errors(name):
    """Scaled errors against f64 of the f32 product, 3xTF32 (with and
    without the chunks) and 1xTF32."""
    if name.startswith("kernel12"):
        return v1_errors(name)
    if name.startswith("kernel2_"):
        a, w = dw_operands(name)
        ref = a.astype(np.float64) @ w.astype(np.float64)
        (a_hi, _), (w_hi, _) = split(a), split(w)
        return {"f32": scaled(fma_sum(a, w), ref),
                "3xtf32": scaled(dw_sum(three_passes(a, w)), ref),
                "3xtf32_one_accumulator": scaled(
                    dw_sum(three_passes(a, w), chunk=None), ref),
                "1xtf32": scaled(dw_sum([(a_hi, w_hi)]), ref)}
    if name.startswith(("kernel3_", "kernel4_")):
        a, w = gmm_operands(name)
        run = GMM_DS_CHUNK if name == "kernel4_gmm_ds" else a.shape[1]
    else:
        a, w = operands(name)
        run = a.shape[1]
    ref = a.astype(np.float64) @ w.astype(np.float64)
    passes = three_passes(a, w)
    (a_hi, _), (w_hi, _) = split(a), split(w)
    return {"f32": scaled(fma_sum(a, w), ref),
            "3xtf32": scaled(runs_sum(passes, run), ref),
            "3xtf32_one_accumulator": scaled(runs_sum(passes, run, None),
                                             ref),
            "1xtf32": scaled(runs_sum([(a_hi, w_hi)], run), ref)}


def test_tf32_rna_rounds_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)  # a TF32 ulp at 1
    cases = {
        one + ulp * np.float32(0.25): one,             # below half: down
        one + ulp * np.float32(0.75): one + ulp,       # above half: up
        one + ulp * np.float32(0.5): one + ulp,        # tie: away from 0
        -(one + ulp * np.float32(0.5)): -(one + ulp),  # tie, negative
        np.float32(2.0) - ulp * np.float32(0.25): np.float32(2.0),  # carry
    }
    for a, want in cases.items():
        got = tf32_rna(np.array([a], np.float32))[0]
        assert got == want, (a, got, want)
    hi, lo = split(np.random.RandomState(0).randn(1000).astype(np.float32))
    for part in (hi, lo):  # both parts are TF32 values
        assert not (part.view(np.uint32) & np.uint32(0x1FFF)).any()


@pytest.mark.parametrize("name", sorted(CASES))
def test_3xtf32_keeps_f32_error(name):
    err = errors(name)
    assert err["3xtf32"] <= 2 * err["f32"], err
    assert err["3xtf32"] <= CASES[name][1] / 10, err


@pytest.mark.parametrize("name", sorted(CASES))
def test_one_tensor_core_accumulator_drifts(name):
    err = errors(name)
    assert err["3xtf32_one_accumulator"] > 2 * err["f32"], err


@pytest.mark.parametrize("name", sorted(CASES))
def test_1xtf32_error_is_far_above_f32(name):
    err = errors(name)
    assert err["1xtf32"] > 10 * err["f32"], err
