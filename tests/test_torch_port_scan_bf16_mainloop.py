"""The arithmetic of the BiLSTM scans' bf16 instances (kernels 1b and 2b:
``gcn_tpu_torch/csrc/lstm_scan.cu``, ``lstm_scan_backward.cu``,
``lstm_cluster.cuh``), emulated in numpy on the CPU on the model of
``tests/test_torch_port_tf32x3.py`` (``tf32_rna``, ``split``,
``mma_sum``, ``dw_sum``).

A bf16 value has 8 significant bits and TF32 has 11, so ``split`` of a
bf16 value widened to f32 gives ``lo == 0`` exactly, and every 3xTF32
pass that multiplies such a lo adds exact zeros.  The bf16 instances
leave those passes out (``tf32x3::mma_chunk``'s ``kExactA`` in
``csrc/tf32x3_tile.cuh``, ``lstm::mma3``'s ``kExactB``):

* the backward's dW (h bf16, dxp f32), without keep: a·b_lo, a·b_hi;
* its chain's partial dh_prev (dg f32, the slice of w_hh bf16) and the
  forward's step product (the carry h f32, w_hh bf16): a_lo·b, a_hi·b;
* a gates pass in TF32 (h and w_hh both bf16) would take one pass, a·b.

At the C-GCN's depths (H = 200, the chain's 4H/C = 52 columns of a
rank, padded to 56; dW's (T-1)·B = 4750 in ``dw_sum``'s three slices)
and on operands at its scales, the sums in fewer passes equal the three
passes' sums in bits: the same roundings of the same accumulators.
With keep the dW kernel keeps three passes: keep·h is exact in bf16 only
for keep 0 or 1, which is all ``ops/lstm.py`` makes but not all the
wrapper takes.

The backward's gates pass runs on the bf16 tensor cores instead
(``lstm_gates_bf16_kernel``: ``mma.sync.m16n8k16``, each 32-deep chunk
into a fresh accumulator folded in k order), which changes the sums'
grouping: 16 exact products a step into the accumulator rounded toward
zero, where the TF32 route adds 8 (``mma16_sum``).  Its error against f64
stays within twice the f32 product's at the C-GCN's depth, and a scan
backward whose gates it forms (``backward_from_gates``, the plain
version's recurrence) stays within the bf16 gap rule of
``tests/test_torch_port_bf16.py`` of ``gcn_tpu``'s ``lstm_scan_stacked``
(Pallas in interpret mode), and within 1e-5 of max(1, |ref|) of the
plain version's bf16 backward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from gcn_tpu.ops.pallas.lstm_scan import lstm_scan_stacked
from gcn_tpu_torch.ops import lstm_scan as lstm_mod
from test_torch_port_tf32x3 import (DW_SLICES, dw_sum, fma_sum, mma_sum,
                                    scaled, split, to_f32_toward_zero)
from tests.test_torch_port_bf16 import gap_check
from tests.test_torch_port_cuda import lstm_inputs

T, B, H, CLUSTER = 96, 50, 200, 16
ROWS, COLS = 32, 16  # two m-tiles by two n-tiles of the outputs
CHAIN_COLS = -(-4 * -(-H // CLUSTER) // 8) * 8  # a rank's gate columns: 56


def bf16_round(a):
    """f32 → bf16 (round to nearest even), widened back to f32."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    bias = np.uint32(0x7FFF) + ((bits >> np.uint32(16)) & np.uint32(1))
    return ((bits + bias) & np.uint32(0xFFFF0000)).view(np.float32)


def widen(bits16):
    """bf16 bit patterns (uint16) as the f32 values they widen to."""
    return (np.asarray(bits16, np.uint32) << np.uint32(16)).view(np.float32)


def three(a, b):
    (a_hi, a_lo), (b_hi, b_lo) = split(a), split(b)
    return [(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)]


def operands(name):
    """Seeded A [ROWS, K] and B [K, COLS] of one product at its scales."""
    rng = np.random.RandomState(sum(map(ord, name)))
    w = lambda k, n: bf16_round(rng.uniform(-1, 1, (k, n)) / np.sqrt(H))
    if name == "gates":  # bf16 h[t-1] · bf16 w_hh
        return (bf16_round(np.tanh(rng.randn(ROWS, H))), w(H, COLS))
    if name == "forward":  # the f32 carry h · bf16 w_hh
        return (np.tanh(rng.randn(ROWS, H)).astype(np.float32), w(H, COLS))
    if name == "chain":  # f32 gate gradients · the bf16 slice, transposed
        return ((rng.randn(ROWS, CHAIN_COLS) * 0.1).astype(np.float32),
                w(CHAIN_COLS, COLS))
    k = (T - 1) * B  # dW: bf16 h_prev (A = hᵀ) · f32 dxp
    return (bf16_round(np.tanh(rng.randn(ROWS, k))),
            (rng.randn(k, COLS) * 0.1).astype(np.float32))


def test_split_of_every_finite_bf16_value_has_no_lo():
    values = widen(np.arange(1 << 16, dtype=np.uint32))
    values = values[np.isfinite(values)]
    hi, lo = split(values)
    assert values.size == (1 << 16) - 2 * 128  # the infinities and NaNs out
    assert np.array_equal(hi.view(np.uint32), values.view(np.uint32))
    assert not lo.view(np.uint32).any()  # +0.0: not even -0.0


@settings(max_examples=500, deadline=None, database=None)
@given(st.integers(0, (1 << 16) - 1))
def test_split_of_a_bf16_value_has_no_lo(bits):
    value = widen([bits])
    if not np.isfinite(value[0]):
        return
    hi, lo = split(value)
    assert hi.view(np.uint32)[0] == value.view(np.uint32)[0]
    assert lo.view(np.uint32)[0] == 0


def test_subnormal_bf16_values_split_exactly():
    sub = widen(np.arange(1, 128, dtype=np.uint32))  # the positive subnormals
    assert (sub > 0).all() and (sub < np.finfo(np.float32).tiny).all()
    hi, lo = split(np.concatenate([sub, -sub]))
    assert not lo.view(np.uint32).any()


@pytest.mark.parametrize("name,passes", [
    ("gates", lambda a, b: [(a, b)]),
    ("forward", lambda a, b: [(split(a)[1], b), (split(a)[0], b)]),
    ("chain", lambda a, b: [(split(a)[1], b), (split(a)[0], b)]),
])
def test_fewer_passes_keep_the_bits(name, passes):
    a, b = operands(name)
    want = mma_sum(three(a, b))
    got = mma_sum(passes(a, b))
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_dw_two_passes_keep_the_bits():
    a, b = operands("dw")
    b_hi, b_lo = split(b)
    want = dw_sum(three(a, b), slices=DW_SLICES)
    got = dw_sum([(a, b_lo), (a, b_hi)], slices=DW_SLICES)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_keep_other_than_0_or_1_needs_the_a_lo_pass():
    """keep·h for keep in {0, 1} stays exact in TF32; a keep of 0.3 does
    not, so the dW kernel keeps all three passes where keep is given."""
    h = bf16_round(np.tanh(np.random.RandomState(3).randn(4096)))
    assert not split(h * np.float32(0.0))[1].any()
    assert not split(h * np.float32(1.0))[1].any()
    assert split(h * np.float32(0.3))[1].any()


def mma16_sum(a, b, chunk=32):
    """The bf16 gates pass's sum: over K in steps of 16
    (``mma.sync.m16n8k16``, K padded with zeros) each step's exact 16-term
    dot product is added to an f32 accumulator rounded toward zero; every
    ``chunk`` of K that accumulator is added into the running f32 sum,
    rounded to nearest, and starts again from 0."""
    k = -(-a.shape[1] // 16) * 16
    a = np.pad(a, ((0, 0), (0, k - a.shape[1])))
    b = np.pad(b, ((0, k - b.shape[0]), (0, 0)))
    total = np.zeros((a.shape[0], b.shape[1]), np.float32)
    acc = np.zeros_like(total)
    for k0 in range(0, k, 16):
        step = (a[:, k0:k0 + 16].astype(np.float64)
                @ b[k0:k0 + 16].astype(np.float64))
        acc = to_f32_toward_zero(acc.astype(np.float64) + step)
        if (k0 + 16) % chunk == 0:
            total, acc = total + acc, np.zeros_like(acc)
    return total + acc


def test_k16_gates_keep_f32_error():
    a, b = operands("gates")
    ref = a.astype(np.float64) @ b.astype(np.float64)
    f32 = scaled(fma_sum(a, b), ref)
    k16 = scaled(mma16_sum(a, b), ref)
    tf32 = scaled(mma_sum([(a, b)]), ref)
    assert k16 <= 2 * f32, (k16, f32, tf32)
    assert k16 <= 1e-6, (k16, f32, tf32)


def k16_gates(xp, h, w, keep):
    """The bf16 gates pass's gates [T, G, B, 4H] f32, in numpy:
    fmaf(keep, mma16_sum(h[t-1], w), xp) (zero h at t = 0), with bf16
    xp, h, w given as f32 arrays."""
    t_dim, g_dim, b_dim, h4 = xp.shape
    h_prev = np.concatenate([np.zeros_like(h[:1]), h[:-1]])
    gates = np.empty(xp.shape, np.float32)
    for g in range(g_dim):
        rows = h_prev[:, g].reshape(t_dim * b_dim, -1)
        s = mma16_sum(rows, w[g]).reshape(t_dim, b_dim, h4)
        kp = np.ones((t_dim, b_dim)) if keep is None else keep[:, g]
        gates[:, g] = (kp[..., None].astype(np.float64) * s
                       + xp[:, g].astype(np.float64)).astype(np.float32)
    return gates


def backward_from_gates(gates, gy, lengths, w_hh, h, c, keep=None):
    """``lstm_scan_backward_plain``'s recurrence with the gates given
    (f32 tensors): (dxp, dw_hh) f32."""
    t_dim, g_dim, b, h4 = gates.shape
    hd = h4 // 4
    w = w_hh.float()
    dh = torch.zeros(g_dim, b, hd)
    dc = torch.zeros_like(dh)
    dw = torch.zeros(g_dim, hd, h4)
    dxp = torch.empty(t_dim, g_dim, b, h4)
    for t in reversed(range(t_dim)):
        if t > 0:
            h_prev, c_prev = h[t - 1].float(), c[t - 1].float()
        else:
            h_prev, c_prev = torch.zeros_like(dh), torch.zeros_like(dh)
        kp = keep[t].float()[:, :, None] if keep is not None else None
        if kp is not None:
            h_prev, c_prev = h_prev * kp, c_prev * kp
        i, f, g, o = gates[t].split(hd, dim=-1)
        i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                      torch.sigmoid(o))
        dh_tot = dh + gy[t]
        tc = torch.tanh(c[t].float())
        dc_all = dc + dh_tot * o * (1.0 - tc * tc)
        dgates = torch.cat([dc_all * g * i * (1.0 - i),
                            dc_all * c_prev * f * (1.0 - f),
                            dc_all * i * (1.0 - g * g),
                            dh_tot * tc * o * (1.0 - o)], dim=-1)
        valid = (lengths > t)[None, :, None]
        dgates = torch.where(valid, dgates, 0.0)
        dh_prev = torch.bmm(dgates, w.transpose(1, 2))
        dc_prev = dc_all * f
        if kp is not None:
            dh_prev, dc_prev = dh_prev * kp, dc_prev * kp
        dh = torch.where(valid, dh_prev, dh_tot)
        dc = torch.where(valid, dc_prev, dc)
        dw += torch.bmm(h_prev.transpose(1, 2), dgates)
        dxp[t] = dgates
    return dxp, dw


def test_k16_gates_backward_matches_jax_in_bf16():
    rng = np.random.RandomState(1)
    xp, lengths, w_hh, _ = lstm_inputs(rng)
    ct = rng.randn(*xp.shape[:3], w_hh.shape[1]).astype(np.float32)
    tpos = np.arange(xp.shape[0])[:, None, None, None]
    out = {}
    for name, jdt, tdt in (("32", jnp.float32, torch.float32),
                           ("16", jnp.bfloat16, torch.bfloat16)):
        _, vjp = jax.vjp(lambda a, b: lstm_scan_stacked(
            a, jnp.asarray(lengths), b, interpret=True),
            jnp.asarray(xp, jdt), jnp.asarray(w_hh, jdt))
        out["j" + name] = vjp(jnp.asarray(ct, jdt))
    x16, w16 = torch.from_numpy(xp).bfloat16(), torch.from_numpy(
        w_hh).bfloat16()
    len_t = torch.from_numpy(lengths)
    h, c = lstm_mod.lstm_scan_plain(x16, len_t, w16)
    gy = torch.from_numpy(np.where(tpos < lengths[None, None, :, None],
                                   torch.from_numpy(ct).bfloat16().float()
                                   .numpy(), 0.0).astype(np.float32))
    gates = torch.from_numpy(k16_gates(x16.float().numpy(),
                                       h.float().numpy(),
                                       w16.float().numpy(), None))
    dxp, dw = backward_from_gates(gates, gy, len_t, w16, h, c)
    out["p16"] = (dxp.bfloat16(), dw.bfloat16())
    h32, c32 = lstm_mod.lstm_scan_plain(torch.from_numpy(xp), len_t,
                                        torch.from_numpy(w_hh))
    gy32 = torch.from_numpy(np.where(tpos < lengths[None, None, :, None],
                                     ct, 0.0).astype(np.float32))
    out["p32"] = lstm_mod.lstm_scan_backward_plain(
        gy32, torch.from_numpy(xp), len_t, torch.from_numpy(w_hh), h32, c32)
    gap_check("scan gradients, gates on the bf16 tensor cores", out["p16"],
              out["p32"], out["j16"], out["j32"])
    # the gates differ from the plain version's f32 sums by f32 roundings
    plain = lstm_mod.lstm_scan_backward_plain(gy, x16, len_t, w16, h, c)
    for a, b in zip((dxp, dw), plain):
        assert scaled(a.numpy(), b.double().numpy()) <= 1e-5
