"""The port's CUDA kernels against their plain PyTorch versions, on a card.

This file imports torch, numpy and the port only (no JAX), so it also runs
on a machine with a GPU and no JAX:

    python -m pytest tests/test_torch_port_cuda.py --noconftest -q

Every test here needs a card and skips where there is none.  It also holds
the seeded input makers that tests/test_torch_port_kernels.py feeds to the
JAX kernels.  Tolerances: 1e-5 absolute (LSTM) and 1e-4 absolute + 1e-5
relative (grouped matmul, sums of 24 products) in f32; bf16 outputs within
2e-2 (one bf16 rounding step at |y| < 2).  The backward kernels: 1e-4 of
max(1, max |reference|) in f32 (BPTT sums up to T·4H products per dW
entry in another order) and 1e-2 of it in bf16.  The edge-list kernels
(band aggregation, fused GCN layer, their backward pairs): 1e-5 of
max(1, max |reference|) in f32, sums of a few neighbour rows (and, in the
fused layer, T products) in another order than the dense band's matmul.
The edge-list kernels' bf16 instances: 1e-2 of max(1, max |reference|)
against their bf16 plain versions (both sum in f32 and round each output
once, so they differ by a rounding flip, 2^-8 of |y|, where the two sums
straddle a rounding boundary; the fused layer rounds S h too).
The SDDMM and its backward: 1e-5 of max(1, max |reference|) (dot products
of H terms, sums over a node's edges).  The bilinear kernels: 1e-4 of
max(1, max |reference|) (sums of D·T products, up to 20000, in another
order than the plain version's matmul).  Their bf16 instances (kernels
9-12) against their bf16 plain versions: every value within one bf16
rounding step of the plain version's beyond the f32 instance's tolerance
(``bf16_flip``: both sum in f32 and round once, so past the f32 sums'
own difference they part only where the two sums straddle a rounding
boundary; the largest difference is printed); the SDDMM's f32 scores
within 1e-5.  Every edge-list and bilinear kernel gives the same bits
when it is called twice (no float atomics).  The bf16 band forward (5b)
and the bf16 sym pair (8b) equal the exact-order reference of
``tests/edge_order.py`` (f32 sums in the kernels' order, one rounding) in
bits, on every edge case and on widths and alignments that take each of
their lane maps; so does the bf16 SDDMM backward (10b) on every SDDMM
case, aligned and not.
"""

import contextlib
import os

import numpy as np
import pytest
import torch

from gcn_tpu_torch.config import cgcn_preset, gcn_preset
from gcn_tpu_torch.data.dataset import PackedBatcher, RelationDataset
from gcn_tpu_torch.data.vocab import Vocab
from gcn_tpu_torch.models.gcn import GCNClassifier, init_params
from gcn_tpu_torch.ops import band_aggregate as band_mod
from gcn_tpu_torch.ops import deprel_bilinear as bilinear_mod
from gcn_tpu_torch.ops import grouped_matmul as gmm_mod
from gcn_tpu_torch.ops import lstm_scan as lstm_mod
from gcn_tpu_torch.ops import sddmm as sddmm_mod
from gcn_tpu_torch.ops import spmm_fused as spmm_mod
from gcn_tpu_torch.ops.spmm import valid_edges
from gcn_tpu_torch.train.evaluator import Evaluator, batch_to_device
from gcn_tpu_torch.train.trainer import Trainer
# tests/ itself is on the path (pytest's rootdir insertion): a card's host
# may have a ``tests`` package of its own installed
from edge_order import band_forward_exact, sddmm_backward_exact, \
    sym_pair_exact

GMM_CASES = ["random", "empty_groups", "one_group", "straddle_tile",
             "rows_past_sum"]
# the card's cases add the shapes of the CUDA kernels' work lists: groups
# of many dS chunks beside small and empty ones, and the C-GCN's widths;
# and the bf16 forward's edges: groups of one row and starts off the
# multiples of 8 (its TMA boxes), T = 37 and H = 5 (the copies TMA cannot
# take), T past its four-stage ring (640, and 1084 with T % 8 = 4).  The
# bf16 backward's dS boxes, which bring the next group's rows, have a case
# of their own, loud_neighbours (every other group's rows 1000 times
# larger), held group by group (test_grouped_matmul_backward_keeps_groups_
# apart): the forward's element-wise tolerance is set for rows of unit
# scale
GMM_CARD_CASES = GMM_CASES + ["padding_heavy", "path_widths_T400",
                              "path_widths_T200", "ragged_starts",
                              "t37_h5", "wide_t640", "wide_t1084"]
JAX_TILE_M = 128  # the Pallas kernel's row tile (the CUDA kernel's too)
GMM_DS_CHUNK = 256  # rows a dS chunk of the CUDA kernel at most
EDGE_CASES = ["random", "duplicates", "self_edge", "all_masked", "isolated",
              "out_of_range"]


def lstm_inputs(rng, t=12, g=2, b=6, h=8):
    lengths = rng.randint(1, t + 1, b).astype(np.int32)
    lengths[:2] = (1, t)
    xp = rng.randn(t, g, b, 4 * h).astype(np.float32)
    w_hh = (rng.randn(g, h, 4 * h) * 0.3).astype(np.float32)
    keep = (rng.rand(t, g, b) > 0.2).astype(np.float32)
    return xp, lengths, w_hh, keep


def gmm_case(name):
    """(x [M, T], s [R, T, H] f32, group_sizes [R] int32) of a case of
    ``GMM_CARD_CASES``: ``padding_heavy`` has two groups of many dS chunks
    (one a whole number of them), 60 groups of 1-100 rows, empty groups and
    a last group with rows past the sum, at odd T and H; ``path_widths_T*``
    the C-GCN layer's widths at a quarter of its rows, two padding groups
    beside 80 groups of 5-30 rows; ``loud_neighbours`` groups that start
    off the 64-row boxes, one of several dS chunks, the rows of every
    other group (``loud_rows``) 1000 times larger."""
    rng = np.random.RandomState(sum(map(ord, name)))
    t, h = 24, 20
    past = 0  # rows past the sum, in the last group
    if name == "padding_heavy":  # T, H and T·H odd: the unaligned copies
        t, h, past = 45, 37, 40
        small = rng.randint(1, 101, 60)
        gs = np.concatenate([[0], small[:30], [5 * GMM_DS_CHUNK + 17, 0],
                             small[30:], [3 * GMM_DS_CHUNK, 0, 0, 30]])
    elif name.startswith("path_widths"):
        t, h = int(name[len("path_widths_T"):]), 200
        small = rng.randint(5, 31, 80)
        gs = np.concatenate([[0, 0], small[:40], [520, 0], small[40:],
                             [0, 520]])
    elif name == "random":
        r, m = 9, 300
        gs = np.bincount(np.sort(rng.randint(0, r, m)), minlength=r)
    elif name == "empty_groups":
        gs = np.array([0, 50, 0, 0, 130, 0, 20, 0])
    elif name == "one_group":
        gs = np.array([200])
    elif name == "straddle_tile":
        gs = np.array([JAX_TILE_M - 3, 7, JAX_TILE_M + 5, 1])
    elif name == "rows_past_sum":
        gs, past = np.array([40, 0, 30, 0]), 30
    elif name == "ragged_starts":
        t, h = 64, 200
        gs = np.array([1, 3, 7, 1, 0, 130, 5, 1, 61, 2])
    elif name == "t37_h5":
        t, h, past = 37, 5, 2
        gs = np.array([1, 9, 0, 140, 3])
    elif name.startswith("wide_t"):
        t, h = int(name[len("wide_t"):]), 200
        gs = np.array([100, 1, 50, 0, 200])
    elif name == "loud_neighbours":
        t, h, past = 128, 200, 3
        gs = np.array([37, 70, 5, 130, 64, 1, 90, 2 * GMM_DS_CHUNK + 9, 0,
                       45, 20])
    m = int(gs.sum()) + past
    if name.startswith(("path_widths", "ragged_starts", "t37", "wide_t",
                        "loud")):
        # the chip smoke's scales
        x = rng.uniform(-1, 1, (m, t)).astype(np.float32)
        s = (rng.randn(gs.shape[0], t, h) / np.sqrt(t)).astype(np.float32)
        x *= loud_rows(name, gs, m)[:, None]
    else:
        x = rng.randn(m, t).astype(np.float32)
        s = rng.randn(gs.shape[0], t, h).astype(np.float32)
    return x, s, gs.astype(np.int32)


def loud_rows(name, gs, m):
    """Each row's scale in case ``name``: 1000 in the groups of odd index
    of ``loud_neighbours`` (and in the rows past the sum where the last
    group is one), 1 elsewhere."""
    scale = np.ones(m, np.float32)
    if name == "loud_neighbours":
        gid = np.minimum(np.searchsorted(np.cumsum(gs), np.arange(m),
                                         side="right"), gs.shape[0] - 1)
        scale[gid % 2 == 1] = 1000.0
    return scale


def edge_case(name, b=3, n=10, e=10):
    """Padded edge lists (parent, child int32 [b, e], mask bool [b, e]) of
    one of ``EDGE_CASES``: random edges with 70 % of the slots set; each
    edge doubled; self-edges; a sentence with every slot masked; nodes 0
    and n-1 touched by no edge; edges with a parent, a child or both at
    or past n (set in the mask, to be dropped)."""
    rng = np.random.RandomState(sum(map(ord, name)))
    lo, hi = (1, n - 1) if name == "isolated" else (0, n)
    parent = rng.randint(lo, hi, (b, e)).astype(np.int32)
    child = rng.randint(lo, hi, (b, e)).astype(np.int32)
    mask = rng.rand(b, e) < 0.7
    if name == "duplicates":
        half = e // 2
        parent[:, half:2 * half] = parent[:, :half]
        child[:, half:2 * half] = child[:, :half]
        mask[:] = True
    elif name == "self_edge":
        child[:, :3] = parent[:, :3]
        mask[:, :3] = True
    elif name == "all_masked":
        mask[1] = False
    elif name == "out_of_range":
        parent[:, 0] = n
        child[:, 1] = n + 3
        parent[:, 2], child[:, 2] = n + 1, n
        mask[:, :3] = True
    return parent, child, mask


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's tests: their tensors are small,
    and the suite runs several workers at once, where torch's default pool
    of one thread per core oversubscribes the cores (a CPU test took 20×
    as long beside five busy processes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def scaled_err(got, want) -> float:
    """max |got - want| over max(1, max |want|)."""
    want = want.float()
    return float((got.float() - want).abs().max()) / max(
        1.0, float(want.abs().max()))


def bf16_flip(got, want, f32_tol: float) -> float:
    """Assert that bf16 ``got`` lies within one rounding step (one bf16 ulp
    of the larger magnitude) of bf16 ``want``, beyond ``f32_tol`` of max(1,
    max |want|): the f32 instance's tolerance, by which the two f32 sums
    may differ before they are rounded (a sum that cancels to near 0 has
    ulps far below it).  Returns the largest difference."""
    assert got.dtype == want.dtype == torch.bfloat16
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    big = torch.maximum(g.abs(), w.abs()).clamp(min=2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
    slack = f32_tol * max(1.0, float(w.abs().max()))
    assert bool((diff <= ulp + slack).all()), float(
        ((diff - slack) / ulp).max())
    return float(diff.max())


def lstm_backward_inputs(rng, dtype, device, with_keep, t=12, g=2, b=6,
                         h=8):
    """Forward states and a data-dependent cotangent, zero past length."""
    xp, lengths, w_hh, keep = lstm_inputs(rng, t, g, b, h)
    xp_t = torch.from_numpy(xp).to(device, dtype)
    w_t = torch.from_numpy(w_hh).to(device, dtype)
    len_t = torch.from_numpy(lengths).to(device)
    keep_t = torch.from_numpy(keep).to(device) if with_keep else None
    hs, cs = lstm_mod.lstm_scan_plain(xp_t, len_t, w_t, keep_t)
    gy = hs.float() * torch.from_numpy(rng.randn(t, g, b, h).astype(
        np.float32)).to(device)
    tpos = torch.arange(t, device=device)[:, None, None, None]
    gy = torch.where(tpos < len_t[None, None, :, None], gy, 0.0)
    return gy.contiguous(), xp_t, len_t, w_t, hs, cs, keep_t


def small_cfg(preset=cgcn_preset, **extra):
    return preset(**{"model.emb_dim": 16, "model.pos_dim": 4,
                          "model.ner_dim": 4, "model.hidden_dim": 16,
                          "model.rnn_hidden": 8, "model.deprel_emb_dim": 6,
                          "model.vocab_size": 30, **extra})


def random_batch(rng, b=6, n=16, vocab=30):
    """A padded batch of random trees over ``vocab`` word ids."""
    lengths = rng.randint(4, n + 1, b).astype(np.int32)
    valid = np.arange(n)[None, :] < lengths[:, None]
    parent = np.zeros((b, n), np.int32)
    child = np.zeros((b, n), np.int32)
    for i, length in enumerate(lengths):
        child[i, :length - 1] = np.arange(1, length)
        parent[i, :length - 1] = [rng.randint(0, c) for c in range(1, length)]
    return {
        "words": np.where(valid, rng.randint(2, vocab, (b, n)), 0),
        "pos": np.where(valid, rng.randint(2, 40, (b, n)), 0),
        "ner": np.where(valid, rng.randint(2, 14, (b, n)), 0),
        "deprel": np.where(valid, rng.randint(2, 42, (b, n)), 0),
        "lengths": lengths,
        "subj_mask": np.eye(b, n, dtype=bool),
        "obj_mask": np.eye(b, n, 2, dtype=bool),
        "edge_parent": parent, "edge_child": child,
        "edge_mask": np.arange(n)[None, :] < (lengths - 1)[:, None],
        "labels": rng.randint(0, 42, b).astype(np.int32),
        "example_mask": np.ones(b, bool),
    }


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("with_keep", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_kernel_matches_plain(cuda_device, dtype, with_keep):
    xp, lengths, w_hh, keep = lstm_inputs(np.random.RandomState(7), t=20,
                                          b=19, h=24)
    args = [torch.from_numpy(xp).to(cuda_device, dtype),
            torch.from_numpy(lengths).to(cuda_device),
            torch.from_numpy(w_hh).to(cuda_device, dtype),
            torch.from_numpy(keep).to(cuda_device) if with_keep else None]
    launches = lstm_mod.KERNEL.launches
    got = lstm_mod.lstm_scan_forward(*args)
    want = lstm_mod.lstm_scan_plain(*args)
    assert lstm_mod.KERNEL.launches == launches + 1
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for a, b in zip(got, want):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=0)


# (T, B, H) of the scan cases: the C-GCN's BiLSTM; H not a multiple of the
# cluster; one row; a ragged last tile; every length below T; every length
# 1; a slice of w_hh too wide for shared memory (the streaming route); rows
# of length 0, the Batcher's padding rows, filling the second 16-row tile
# (whose clusters take no step) and scattered in the others
LSTM_CASES = {"full": (96, 50, 200), "h30": (20, 19, 30), "b1": (20, 1, 24),
              "b19": (20, 19, 24), "short": (24, 19, 24),
              "ones": (12, 19, 24), "streaming": (10, 5, 480),
              "zeros": (20, 40, 24)}


def lstm_case(name, device, dtype, with_keep):
    """A scan case of ``LSTM_CASES`` on ``device``: (xp, lengths, w_hh,
    keep) for the forward, w_hh at the scale of a C-GCN's (U(±1/√H))."""
    t, b, h = LSTM_CASES[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    xp = rng.randn(t, 2, b, 4 * h).astype(np.float32)
    w_hh = rng.uniform(-1, 1, (2, h, 4 * h)).astype(np.float32) / np.sqrt(h)
    keep = (rng.rand(t, 2, b) > 0.2).astype(np.float32)
    lengths = rng.randint(1, t + 1, b).astype(np.int32)
    lengths[-1] = t
    if name == "short":
        lengths = rng.randint(1, t - 4, b).astype(np.int32)
    elif name == "ones":
        lengths[:] = 1
    elif name == "zeros":
        lengths[16:32] = 0
        lengths[[0, 5, 33, 38]] = 0
    return (torch.from_numpy(xp).to(device, dtype),
            torch.from_numpy(lengths).to(device),
            torch.from_numpy(w_hh).to(device, dtype),
            torch.from_numpy(keep).to(device) if with_keep else None)


@pytest.mark.cuda
@pytest.mark.parametrize("with_keep", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(LSTM_CASES))
def test_lstm_cluster_kernels_match_plain(cuda_device, name, dtype,
                                          with_keep):
    """Both scan kernels against their plain versions (forward 1e-5 abs in
    f32, 2e-2 in bf16; backward 1e-4 and 1e-2 of max(1, |ref|)), one
    launch a call, the same bits on a second call; past its length a row
    keeps keep·state and gets no gate gradient."""
    xp, lengths, w_hh, keep = lstm_case(name, cuda_device, dtype, with_keep)
    t, b, h = LSTM_CASES[name]
    plan = lstm_mod.scan_plan(b, h)
    assert plan.resident == (name != "streaming")
    launches = lstm_mod.KERNEL.launches
    hs, cs = lstm_mod.lstm_scan_forward(xp, lengths, w_hh, keep)
    again = lstm_mod.lstm_scan_forward(xp, lengths, w_hh, keep)
    assert lstm_mod.KERNEL.launches == launches + 2
    want = lstm_mod.lstm_scan_plain(xp, lengths, w_hh, keep)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for a, a2, ref in zip((hs, cs), again, want):
        assert a.dtype == dtype and torch.equal(a, a2)
        torch.testing.assert_close(a.float(), ref.float(), atol=tol, rtol=0)

    gy = torch.from_numpy(np.random.RandomState(5).randn(t, 2, b, h).astype(
        np.float32)).to(cuda_device) * hs.float()
    tpos = torch.arange(t, device=cuda_device)[:, None, None, None]
    past = tpos >= lengths[None, None, :, None]
    gy = torch.where(past, 0.0, gy).contiguous()
    args = (gy, xp, lengths, w_hh, hs, cs, keep)
    launches = lstm_mod.BACKWARD_KERNEL.launches
    got = lstm_mod.lstm_scan_backward(*args)
    again = lstm_mod.lstm_scan_backward(*args)
    assert lstm_mod.BACKWARD_KERNEL.launches == launches + 2
    want = lstm_mod.lstm_scan_backward_plain(*args)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    for a, a2, ref in zip(got, again, want):
        assert a.dtype == torch.float32 and torch.equal(a, a2)
        assert scaled_err(a, ref) <= tol
    assert not bool(got[0][past.expand(-1, 2, -1, 4 * h)].any())
    if keep is None:  # frozen rows repeat their last state
        last = (lengths.long() - 1).clamp(min=0)
        frozen = hs.gather(0, last[None, None, :, None].expand(1, 2, b, h))
        assert torch.equal(torch.where(past, frozen.expand_as(hs), hs), hs)


# the bf16 backward's gates pass and dW against f64 products of the same
# bf16 values: the C-GCN's BiLSTM, a width below 16-byte copies of h rows
# (H = 30) and the streaming route (H = 480)
LSTM_BF16_PRODUCT_CASES = ["full", "h30", "streaming"]
DW_TOL = 1e-5  # test_torch_port_tf32x3.py's kernel2_lstm_dw bound (1e-4 / 10)


def lstm_backward_with_gates(gy, xp, lengths, w_hh, hs, cs, keep):
    """(gates, dxp, dw) of one backward launch: the wrapper's call with the
    gates scratch (the first launch's output) kept."""
    t, g, b, h4 = xp.shape
    hd = h4 // 4
    gates = torch.empty(t, g, b, h4, device=xp.device)
    dxp, dw = torch.empty_like(gates), torch.empty(g, hd, h4,
                                                   device=xp.device)
    plan = lstm_mod.scan_plan(b, hd, backward=True)
    lstm_mod.BACKWARD_KERNEL.launch(
        lstm_mod._BACKWARD_SYMBOL[xp.dtype], gy.data_ptr(), xp.data_ptr(),
        hs.data_ptr(), cs.data_ptr(), w_hh.data_ptr(),
        keep.data_ptr() if keep is not None else None, lengths.data_ptr(),
        gates.data_ptr(), dxp.data_ptr(), dw.data_ptr(), t, g, b, hd,
        *plan.args(), torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    return gates, dxp, dw


@pytest.mark.cuda
@pytest.mark.parametrize("with_keep", [False, True])
@pytest.mark.parametrize("name", LSTM_BF16_PRODUCT_CASES)
def test_lstm_bf16_gates_and_dw_match_f64_products(cuda_device, name,
                                                   with_keep):
    """The bf16 backward's gates, xp + keep·(h[t-1] @ w_hh), within 1e-5 of
    max(1, |ref|) of the f64 value from the same bf16 h, w_hh and xp (one
    TF32 pass of exact products, f32 sums); its dW, Σ (keep·h[t-1])ᵀ dxp,
    within the 3xTF32 bound of the f64 product of the same h and of the
    kernel's own dxp; both the same bits as the wrapper's call."""
    xp, lengths, w_hh, keep = lstm_case(name, cuda_device, torch.bfloat16,
                                        with_keep)
    t, b, h = LSTM_CASES[name]
    hs, cs = lstm_mod.lstm_scan_forward(xp, lengths, w_hh, keep)
    gy = torch.from_numpy(np.random.RandomState(5).randn(t, 2, b, h).astype(
        np.float32)).to(cuda_device) * hs.float()
    past = (torch.arange(t, device=cuda_device)[:, None, None, None]
            >= lengths[None, None, :, None])
    gy = torch.where(past, 0.0, gy).contiguous()
    gates, dxp, dw = lstm_backward_with_gates(gy, xp, lengths, w_hh, hs, cs,
                                              keep)
    want = lstm_mod.lstm_scan_backward(gy, xp, lengths, w_hh, hs, cs, keep)
    assert torch.equal(dxp, want[0]) and torch.equal(dw, want[1])

    h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]]).double()
    if keep is not None:
        h_prev = h_prev * keep.double()[..., None]
    ref = xp.double() + torch.einsum("tgbk,gkn->tgbn", h_prev,
                                     w_hh.double())
    assert scaled_err(gates, ref) <= 1e-5
    ref_dw = torch.einsum("tgbk,tgbn->gkn", h_prev, dxp.double())
    assert scaled_err(dw, ref_dw) <= DW_TOL


@pytest.mark.cuda
def test_lstm_plans_fit_the_card(cuda_device):
    """Every cluster of the C-GCN's scans can be resident at once."""
    for backward in (False, True):
        plan = lstm_mod.scan_plan(50, 200, backward=backward)
        clusters = 2 * len(plan.row_tiles(50))
        assert lstm_mod.max_active_clusters(plan, 2) >= clusters


@pytest.mark.cuda
@pytest.mark.parametrize("name", GMM_CARD_CASES)
def test_grouped_matmul_kernel_matches_plain(cuda_device, name):
    x, s, gs = (torch.from_numpy(a).to(cuda_device) for a in gmm_case(name))
    launches = gmm_mod.KERNEL.launches
    got = gmm_mod.grouped_matmul(x, s, gs)
    again = gmm_mod.grouped_matmul(x, s, gs)
    assert gmm_mod.KERNEL.launches == launches + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got, gmm_mod.grouped_matmul_plain(x, s, gs),
                               atol=1e-4, rtol=1e-5)
    check_gmm_bf16(x.bfloat16(), s.bfloat16(), gs)


def check_gmm_bf16(x, s, gs):
    """The bf16 forward on x, s: two launches of its bf16 instance, the
    same bits twice, within 1e-2 of max(1, max |plain|) of its plain
    version (and its bits but one rounding step past 1e-4, bf16_flip)."""
    launches = gmm_mod.KERNEL.launches_of("_bf16")
    got16 = gmm_mod.grouped_matmul(x, s, gs)
    again = gmm_mod.grouped_matmul(x, s, gs)
    assert gmm_mod.KERNEL.launches_of("_bf16") == launches + 2
    assert got16.dtype == torch.bfloat16 and torch.equal(got16, again)
    want16 = gmm_mod.grouped_matmul_plain(x, s, gs)
    scale = max(1.0, float(want16.float().abs().max()))
    assert float((got16.float() - want16.float()).abs().max()) <= 1e-2 * scale
    print(f"grouped matmul bf16 {tuple(x.shape)}: largest difference "
          f"{bf16_flip(got16, want16, 1e-4):.3g}")


@pytest.mark.cuda
def test_grouped_matmul_bf16_takes_an_unaligned_x(cuda_device):
    """x contiguous at an odd element offset of its storage (a base that
    is not 16-byte aligned, which TMA refuses), at the C-GCN's second
    layer's widths."""
    x, s, gs = gmm_case("path_widths_T200")
    flat = torch.from_numpy(np.concatenate([[0.0], x.ravel()]).astype(
        np.float32)).to(cuda_device).bfloat16()
    xb = flat[1:].view(x.shape)
    assert xb.is_contiguous() and xb.data_ptr() % 16 != 0
    check_gmm_bf16(xb, torch.from_numpy(s).to(cuda_device).bfloat16(),
                   torch.from_numpy(gs).to(cuda_device))


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    x, s, gs = (torch.from_numpy(a).to(cuda_device)
                for a in gmm_case("random"))
    with pytest.raises(ValueError, match="contiguous"):
        gmm_mod.grouped_matmul(x.t().contiguous().t(), s, gs)
    with pytest.raises(TypeError):
        gmm_mod.grouped_matmul(x.double(), s.double(), gs)
    xp, lengths, w_hh, _ = (torch.from_numpy(a).to(cuda_device)
                            for a in lstm_inputs(np.random.RandomState(8)))
    with pytest.raises(ValueError, match="int32"):
        lstm_mod.lstm_scan_forward(xp, lengths.long(), w_hh)


@pytest.mark.cuda
def test_evaluator_on_card_matches_cpu(cuda_device):
    """A small C-GCN: the kernel path on the card against the plain path
    on the CPU, logits within 1e-4 on every row of a random batch."""
    cfg = small_cfg()
    model = GCNClassifier(cfg.model)
    init_params(model, torch.Generator().manual_seed(0))
    batch = random_batch(np.random.RandomState(0))
    state = model.state_dict()
    card = Evaluator(cfg, state, device=cuda_device)
    cpu = Evaluator(cfg, state, device="cpu")
    launches = (lstm_mod.KERNEL.launches, gmm_mod.KERNEL.launches)
    with torch.no_grad():
        got, _ = card.model(batch_to_device(batch, cuda_device))
        want, _ = cpu.model(batch_to_device(batch, torch.device("cpu")))
    assert lstm_mod.KERNEL.launches == launches[0] + 1
    assert gmm_mod.KERNEL.launches == launches[1] + cfg.model.num_layers
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("with_keep", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_backward_kernel_matches_plain(cuda_device, dtype, with_keep):
    args = lstm_backward_inputs(np.random.RandomState(9), dtype, cuda_device,
                                with_keep, t=20, b=19, h=24)
    launches = lstm_mod.BACKWARD_KERNEL.launches
    got = lstm_mod.lstm_scan_backward(*args)
    want = lstm_mod.lstm_scan_backward_plain(*args)
    assert lstm_mod.BACKWARD_KERNEL.launches == launches + 1
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        assert scaled_err(a, b) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("name", GMM_CARD_CASES)
def test_grouped_matmul_backward_kernel_matches_plain(cuda_device, name):
    x, s, gs = (torch.from_numpy(a).to(cuda_device) for a in gmm_case(name))
    g = torch.from_numpy(np.random.RandomState(3).randn(
        x.shape[0], s.shape[2]).astype(np.float32)).to(cuda_device)
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
        args = (x.to(dtype), g.to(dtype), s.to(dtype), gs)
        launches = gmm_mod.BACKWARD_KERNEL.launches
        dx, ds = gmm_mod.grouped_matmul_backward(*args)
        again = gmm_mod.grouped_matmul_backward(*args)
        assert gmm_mod.BACKWARD_KERNEL.launches == launches + 2
        assert torch.equal(dx, again[0]) and torch.equal(ds, again[1])
        want_dx, want_ds = gmm_mod.grouped_matmul_backward_plain(*args)
        assert dx.dtype == dtype and ds.dtype == torch.float32
        assert scaled_err(dx, want_dx) <= tol
        assert scaled_err(ds, want_ds) <= tol
        assert not bool(ds[gs == 0].any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_matmul_backward_keeps_groups_apart(cuda_device, dtype):
    """``loud_neighbours`` with g's rows scaled as x's: each group's dS
    within the tolerance of its own scale, so a row of the next (1000
    times larger) group that leaked into a group's sum would fail it."""
    x, s, gs = gmm_case("loud_neighbours")
    m = x.shape[0]
    g = np.random.RandomState(3).randn(m, s.shape[2]).astype(np.float32)
    g *= loud_rows("loud_neighbours", gs, m)[:, None]
    args = [torch.from_numpy(a).to(cuda_device, dtype) for a in (x, g, s)]
    args.append(torch.from_numpy(gs).to(cuda_device))
    dx, ds = gmm_mod.grouped_matmul_backward(*args)
    want_dx, want_ds = gmm_mod.grouped_matmul_backward_plain(*args)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    assert scaled_err(dx, want_dx) <= tol
    for grp in range(gs.shape[0]):
        assert scaled_err(ds[grp], want_ds[grp]) <= tol, grp
    assert not bool(ds[torch.from_numpy(gs) == 0].any())


@pytest.mark.cuda
@pytest.mark.parametrize("operand", ["x", "g"])
def test_grouped_matmul_backward_bf16_takes_an_unaligned_operand(
        cuda_device, operand):
    """x (dS's operand) or g (both products') contiguous at an odd element
    offset of its storage, a base that TMA refuses, at the C-GCN's second
    layer's widths: the copying threads' path, the same bits twice, within
    1e-2 of the plain version."""
    x, s, gs = gmm_case("path_widths_T200")
    g = np.random.RandomState(3).randn(x.shape[0], s.shape[2]).astype(
        np.float32)

    def on_card(a, shifted):
        if not shifted:
            return torch.from_numpy(a).to(cuda_device).bfloat16()
        flat = torch.from_numpy(np.concatenate([[0.0], a.ravel()]).astype(
            np.float32)).to(cuda_device).bfloat16()
        out = flat[1:].view(a.shape)
        assert out.is_contiguous() and out.data_ptr() % 16 != 0
        return out

    args = (on_card(x, operand == "x"), on_card(g, operand == "g"),
            on_card(s, False), torch.from_numpy(gs).to(cuda_device))
    launches = gmm_mod.BACKWARD_KERNEL.launches_of("_bf16")
    dx, ds = gmm_mod.grouped_matmul_backward(*args)
    again = gmm_mod.grouped_matmul_backward(*args)
    assert gmm_mod.BACKWARD_KERNEL.launches_of("_bf16") == launches + 2
    assert torch.equal(dx, again[0]) and torch.equal(ds, again[1])
    want_dx, want_ds = gmm_mod.grouped_matmul_backward_plain(*args)
    assert scaled_err(dx, want_dx) <= 1e-2
    assert scaled_err(ds, want_ds) <= 1e-2
    print(f"grouped matmul backward bf16, unaligned {operand}: dx's largest "
          f"difference {bf16_flip(dx, want_dx, 1e-4):.3g}")


@pytest.mark.cuda
def test_trainer_on_card_matches_cpu(cuda_device):
    """Dropout off: three steps with the kernels on the card against the
    plain versions on the CPU, losses and parameters within 1e-4."""
    cfg = small_cfg(**{"model.input_dropout": 0.0, "model.rnn_dropout": 0.0,
                       "model.gcn_dropout": 0.0})
    model = GCNClassifier(cfg.model)
    init_params(model, torch.Generator().manual_seed(0))
    state = model.state_dict()
    card = Trainer(cfg, state, device=cuda_device)
    cpu = Trainer(cfg, state, device="cpu")
    launches = [k.launches for k in (lstm_mod.BACKWARD_KERNEL,
                                     gmm_mod.BACKWARD_KERNEL)]
    rng = np.random.RandomState(1)
    for _ in range(3):
        batch = random_batch(rng)
        got, want = float(card.update(batch)), float(cpu.update(batch))
        assert abs(got - want) <= 1e-4 * max(1.0, abs(want))
    assert lstm_mod.BACKWARD_KERNEL.launches == launches[0] + 3
    assert gmm_mod.BACKWARD_KERNEL.launches == launches[1] + 3 * 2
    for k, v in cpu.model.state_dict().items():
        assert scaled_err(card.model.state_dict()[k].cpu(), v) <= 1e-4, k


@pytest.mark.cuda
def test_trainer_checkpoint_on_card_loads_on_cpu(cuda_device, tmp_path):
    """Two adam steps on the card, saved; a CPU trainer loads the same
    bits (parameters, adam's moments, count, step, rate), and so does a
    second trainer on the card."""
    cfg = small_cfg(**{"train.optim": "adam"})
    card = Trainer(cfg, device=cuda_device)
    rng = np.random.RandomState(2)
    for _ in range(2):
        card.update(random_batch(rng))
    card.save(str(tmp_path / "ckpt"), epoch=1)
    for device in ("cpu", cuda_device):
        back = Trainer(cfg, rng_seed=5, device=device)
        meta = back.load(str(tmp_path / "ckpt"))
        for k, v in card.model.state_dict().items():
            assert torch.equal(back.model.state_dict()[k].cpu(), v.cpu()), k
        for k, st in card.opt.state.items():
            for key, v in st.items():
                assert torch.equal(back.opt.state[k][key].cpu(), v.cpu())
        assert (back.global_step, back.opt.count, meta["epoch"],
                back.current_lr) == (2, 2, 1, cfg.train.lr)


EDGE_SIZES = {"long": (2, 300, 300),      # a sentence past the 128 bucket
              "past_48kb": (2, 3000, 3000)}  # lists above 48 KB of smem
# the attention edge backend's regime (auto takes it from N = 1159 at
# B = 50), and more edge slots than nodes (a multigraph)
FOREST = {"forest": (50, 1200, 1200), "more_edges": (4, 12, 30)}


# one node the parent of every edge: one list spans the whole sentence
# (star_slots: 7000 edges, more than the bf16 SDDMM backward holds at once)
STAR = {"star": (3, 1200, 1200), "star_slots": (2, 300, 7000)}
# edge slots above 48 KB of shared memory for the ballot-gather kernels
SLOTS = {"slots_past_48kb": (2, 300, 7000)}


def edge_tensors(name, device):
    """An ``edge_case`` (or a long one of ``EDGE_SIZES``, ``FOREST``,
    ``STAR`` or ``SLOTS``) on ``device``, with its (b, n)."""
    sizes = {**EDGE_SIZES, **FOREST, **STAR, **SLOTS}
    b, n, e = sizes.get(name, (3, 10, 10))
    arrays = edge_case("random" if name in sizes else name, b, n, e)
    if name in STAR:
        arrays[0][:], arrays[2][:] = 7, True
    return [torch.from_numpy(a).to(device) for a in arrays], b, n


def features(rng, device, *shapes):
    return [torch.from_numpy(rng.randn(*s).astype(np.float32)).to(device)
            for s in shapes]


# the edge-list kernels' card cases: the CPU tests' cases, the long ones,
# one row whose neighbours span many 32-slot ballot steps (star), E =
# 1200 at B = 50 (forest) and 7000 slots over 300 nodes
EDGE_CARD_CASES = (EDGE_CASES + list(EDGE_SIZES) + ["star", "forest"]
                   + list(SLOTS))


# the edge-list kernels' instances: (operand dtype, tolerance, suffix)
EDGE_DTYPES = {torch.float32: (1e-5, "_f32"), torch.bfloat16: (1e-2, "_bf16")}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [70, 200])  # 4-value loads off; the C-GCN's
@pytest.mark.parametrize("name", EDGE_CARD_CASES)
def test_band_aggregate_kernels_match_plain(cuda_device, name, h, dtype):
    tol, suffix = EDGE_DTYPES[dtype]
    edges, b, n = edge_tensors(name, cuda_device)
    xs = [x.to(dtype) for x in features(np.random.RandomState(5),
                                        cuda_device, *[(b, n, h)] * 3)]
    for relu in (True, False):
        launches = band_mod.KERNEL.launches_of(suffix)
        got = band_mod.band_aggregate_forward(*edges, *xs, relu)
        again = band_mod.band_aggregate_forward(*edges, *xs, relu)
        assert band_mod.KERNEL.launches_of(suffix) == launches + 2
        assert got.dtype == dtype
        assert torch.equal(got, again)  # no float atomics
        want = band_mod.band_aggregate_plain(*edges, *xs, relu)
        assert scaled_err(got, want) <= tol
    launches = band_mod.PAIR_KERNEL.launches_of(suffix)
    got = band_mod.pair_aggregate(*edges, xs[0])
    again = band_mod.pair_aggregate(*edges, xs[0])
    assert band_mod.PAIR_KERNEL.launches_of(suffix) == launches + 2
    for a, a2, w in zip(got, again,
                        band_mod.pair_aggregate_plain(*edges, xs[0])):
        assert a.dtype == dtype
        assert torch.equal(a, a2)  # no float atomics
        assert scaled_err(a, w) <= tol


# (T1, T2): ragged widths on 4-byte loads, and the paper GCN's two layers
# (the sym pair's operands are both T wide there), on 16-byte loads
SPMM_WIDTHS = {"t75x40": (75, 40), "t360": (360, 360), "t200": (200, 200)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("widths", list(SPMM_WIDTHS))
@pytest.mark.parametrize("name", EDGE_CARD_CASES)
def test_spmm_fused_kernels_match_plain(cuda_device, name, widths, dtype):
    tol, suffix = EDGE_DTYPES[dtype]
    edges, b, n = edge_tensors(name, cuda_device)
    t1, t2 = SPMM_WIDTHS[widths]
    rng = np.random.RandomState(6)
    h, x2 = features(rng, cuda_device, (b, n, t1), (b, n, t2))
    w, bias = features(rng, cuda_device, (t1, 70), (70,))
    h, x2, w, bias = (a.to(dtype) for a in (h, x2, w / np.sqrt(t1), bias))
    launches = spmm_mod.KERNEL.launches_of(suffix)
    got = spmm_mod.gcn_spmm_forward(*edges, h, w, bias)
    again = spmm_mod.gcn_spmm_forward(*edges, h, w, bias)
    assert spmm_mod.KERNEL.launches_of(suffix) == launches + 2
    assert got.dtype == dtype
    assert torch.equal(got, again)
    assert scaled_err(got, spmm_mod.gcn_spmm_plain(*edges, h, w, bias)) \
        <= tol
    launches = spmm_mod.SYM_PAIR_KERNEL.launches_of(suffix)
    got = spmm_mod.sym_pair(*edges, h, x2)
    again = spmm_mod.sym_pair(*edges, h, x2)
    assert spmm_mod.SYM_PAIR_KERNEL.launches_of(suffix) == launches + 2
    for a, a2, want in zip(got, again,
                           spmm_mod.sym_pair_plain(*edges, h, x2)):
        assert a.shape == want.shape and a.dtype == dtype
        assert torch.equal(a, a2)  # no float atomics
        assert scaled_err(a, want) <= tol


# 5b's and 8b's shape choices: chunks of 8 columns (widths multiples of
# 8, bases 16-byte aligned), chunks of 4 by 8-byte loads (multiples of 4,
# or a base 8 bytes off 16: offset 4 values), chunks of 4 by single loads
# (neither); the paper GCN's widths
EXACT_BAND_WIDTHS = [200, 100, 70]
EXACT_PAIR_WIDTHS = {"t360": (360, 360), "t200": (200, 200),
                     "t100x36": (100, 36), "t75x40": (75, 40)}


def bf16_at(x, offset):
    """x in bf16, contiguous, ``offset`` values into a larger storage."""
    flat = torch.empty(x.numel() + offset, dtype=torch.bfloat16,
                       device=x.device)
    out = flat[offset:].view(x.shape)
    out.copy_(x)
    return out


def bits_of(t):
    """A bf16 tensor's bits as a uint16 array."""
    return t.view(torch.int16).cpu().numpy().view(np.uint16)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 4])
@pytest.mark.parametrize("h", EXACT_BAND_WIDTHS)
@pytest.mark.parametrize("name", EDGE_CARD_CASES)
def test_band_aggregate_bf16_gives_the_exact_order_bits(cuda_device, name,
                                                        h, offset):
    """5b equals ``tests/edge_order.py``'s reference in bits."""
    edges, b, n = edge_tensors(name, cuda_device)
    xs = [bf16_at(x, offset) for x in features(
        np.random.RandomState(7), cuda_device, *[(b, n, h)] * 3)]
    assert xs[0].data_ptr() % 16 == 2 * offset
    arrays = [a.cpu().numpy() for a in edges]
    values = [x.float().cpu().numpy() for x in xs]
    for relu in (True, False):
        launches = band_mod.KERNEL.launches_of("_bf16")
        got = band_mod.band_aggregate_forward(*edges, *xs, relu)
        assert band_mod.KERNEL.launches_of("_bf16") == launches + 1
        np.testing.assert_array_equal(
            bits_of(got), band_forward_exact(*arrays, *values, relu))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 4])
@pytest.mark.parametrize("widths", list(EXACT_PAIR_WIDTHS))
@pytest.mark.parametrize("name", EDGE_CARD_CASES)
def test_sym_pair_bf16_gives_the_exact_order_bits(cuda_device, name, widths,
                                                  offset):
    """8b equals ``tests/edge_order.py``'s reference in bits."""
    edges, b, n = edge_tensors(name, cuda_device)
    t1, t2 = EXACT_PAIR_WIDTHS[widths]
    x1, x2 = (bf16_at(x, offset) for x in features(
        np.random.RandomState(8), cuda_device, (b, n, t1), (b, n, t2)))
    assert x2.data_ptr() % 16 == 2 * offset
    launches = spmm_mod.SYM_PAIR_KERNEL.launches_of("_bf16")
    got = spmm_mod.sym_pair(*edges, x1, x2)
    assert spmm_mod.SYM_PAIR_KERNEL.launches_of("_bf16") == launches + 1
    want = sym_pair_exact(*(a.cpu().numpy() for a in edges),
                          x1.float().cpu().numpy(), x2.float().cpu().numpy())
    for a, w in zip(got, want):
        np.testing.assert_array_equal(bits_of(a), w)


def tree_edges(rng, b, n):
    """[b, n] edge lists of b seeded random trees, lengths in [n/2, n] (one
    at n), the padded slots masked."""
    parent = np.zeros((b, n), np.int32)
    child = np.zeros((b, n), np.int32)
    mask = np.zeros((b, n), bool)
    for i in range(b):
        length = n if i == 0 else int(rng.randint(max(1, n // 2), n + 1))
        order = rng.permutation(length)
        for k in range(1, length):     # each node hangs off an earlier one
            parent[i, k - 1] = order[rng.randint(0, k)]
            child[i, k - 1] = order[k]
        mask[i, :length - 1] = True
    return parent, child, mask


# The fused layer's forward on its tiles: in f32 48 rows by 224 columns,
# gathering (S h) 256 columns of T at a time; in bf16 32 rows by 224
# columns, (S h) resident in blocks of 128 columns, 384 a pass (wide_t*:
# two and three passes; t37_h5: the element-wise copies):
# (B, N, T, H, edges).
SPMM_TILE_CASES = {
    "gcn_T360": (50, 96, 360, 200, "trees"),   # the paper GCN's layer 1
    "gcn_T200": (50, 96, 200, 200, "trees"),   # and layer 2, full widths
    "rows_past_tile": (3, 49, 75, 70, "random"),   # 48 rows + 1
    "h_below_8": (3, 10, 75, 5, "random"),
    "t_below_chunk": (3, 10, 20, 70, "random"),    # T < one 32-row W chunk
    "one_node": (4, 1, 75, 70, "trees"),           # sentences of N = 1
    "no_valid_edge": (3, 20, 75, 70, "masked"),
    "h_past_tile": (2, 30, 140, 300, "random"),    # two column tiles
    "rows_past_32": (3, 33, 75, 70, "random"),     # 32 rows + 1
    "t37_h5": (3, 20, 37, 5, "random"),
    "wide_t640": (2, 40, 640, 200, "trees"),
    "wide_t1084": (2, 40, 1084, 200, "trees"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(SPMM_TILE_CASES))
def test_spmm_fused_forward_on_its_tiles(cuda_device, name, dtype):
    tol, suffix = EDGE_DTYPES[dtype]
    b, n, t, h, kind = SPMM_TILE_CASES[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    if kind == "trees":
        arrays = tree_edges(rng, b, n)
    else:
        arrays = edge_case("random", b, n, n)
        if kind == "masked":
            arrays[2][:] = False
    edges = [torch.from_numpy(a).to(cuda_device) for a in arrays]
    x, w, bias = features(rng, cuda_device, (b, n, t), (t, h), (h,))
    x, w, bias = (a.to(dtype) for a in (x, w / np.sqrt(t), bias))
    launches = spmm_mod.KERNEL.launches_of(suffix)
    got = spmm_mod.gcn_spmm_forward(*edges, x, w, bias)
    again = spmm_mod.gcn_spmm_forward(*edges, x, w, bias)
    assert spmm_mod.KERNEL.launches_of(suffix) == launches + 2
    assert torch.equal(got, again)
    assert scaled_err(got, spmm_mod.gcn_spmm_plain(*edges, x, w, bias)) \
        <= tol


@pytest.mark.cuda
def test_spmm_fused_bf16_forward_takes_an_unaligned_h(cuda_device):
    """h contiguous at an odd element offset of its storage (its 8-byte
    loads refused), at the paper GCN's second layer's widths."""
    b, n, t, h = 6, 96, 200, 200
    rng = np.random.RandomState(11)
    edges = [torch.from_numpy(a).to(cuda_device)
             for a in tree_edges(rng, b, n)]
    flat, w, bias = features(rng, cuda_device, (b * n * t + 1,), (t, h),
                             (h,))
    x = flat.bfloat16()[1:].view(b, n, t)
    assert x.is_contiguous() and x.data_ptr() % 8 != 0
    w, bias = (w / np.sqrt(t)).bfloat16(), bias.bfloat16()
    launches = spmm_mod.KERNEL.launches_of("_bf16")
    got = spmm_mod.gcn_spmm_forward(*edges, x, w, bias)
    again = spmm_mod.gcn_spmm_forward(*edges, x, w, bias)
    assert spmm_mod.KERNEL.launches_of("_bf16") == launches + 2
    assert torch.equal(got, again)
    want = spmm_mod.gcn_spmm_plain(*edges, x, w, bias)
    assert scaled_err(got, want) <= 1e-2
    print(f"fused layer bf16, unaligned h: largest difference "
          f"{bf16_flip(got, want, 1e-5):.3g}")


@pytest.mark.cuda
def test_edge_list_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    (parent, child, mask), b, n = edge_tensors("random", cuda_device)
    x = torch.randn(b, n, 8, device=cuda_device)
    with pytest.raises(TypeError, match="int32"):
        band_mod.pair_aggregate(parent.long(), child, mask, x)
    with pytest.raises(ValueError, match="contiguous"):
        band_mod.pair_aggregate(parent, child, mask,
                                x.transpose(1, 2).contiguous()
                                .transpose(1, 2))
    with pytest.raises(TypeError):
        spmm_mod.sym_pair(parent, child, mask, x.double(), x.double())
    big = 30000  # edge slots past a block's 232448 bytes at 8 bytes each
    edges = [torch.zeros(1, big, dtype=torch.int32, device=cuda_device)] * 2
    assert band_mod.edges_bytes(big, big) > band_mod.MAX_SHARED_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        band_mod.pair_aggregate(*edges, torch.zeros(
            1, big, dtype=torch.bool, device=cuda_device),
            torch.zeros(1, big, 1, device=cuda_device))
    # slots that fit alone but not beside the fused forward's tiles
    slots = 12000
    edges = [torch.zeros(1, slots, dtype=torch.int32, device=cuda_device)] * 2
    mask = torch.zeros(1, slots, dtype=torch.bool, device=cuda_device)
    h = torch.zeros(1, 1, 8, device=cuda_device)
    w, bias = torch.zeros(8, 4, device=cuda_device), torch.zeros(
        4, device=cuda_device)
    assert band_mod.edges_bytes(1, slots) <= band_mod.MAX_SHARED_BYTES
    with pytest.raises(ValueError, match="gcn_spmm_forward.*shared memory"):
        spmm_mod.gcn_spmm_forward(*edges, mask, h, w, bias)


@pytest.mark.cuda
@pytest.mark.parametrize("preset", [cgcn_preset, gcn_preset])
def test_fused_path_on_card_matches_cpu(cuda_device, preset):
    """use_pallas=True, dropout off: the evaluation forward and three train
    steps with the edge-list kernels on the card against the plain
    versions on the CPU, within 1e-4; every kernel of the path counted."""
    cfg = small_cfg(preset, **{"model.use_pallas": True,
                               "model.input_dropout": 0.0,
                               "model.rnn_dropout": 0.0,
                               "model.gcn_dropout": 0.0})
    mod = band_mod if preset is cgcn_preset else spmm_mod
    pair = mod.PAIR_KERNEL if preset is cgcn_preset else mod.SYM_PAIR_KERNEL
    model = GCNClassifier(cfg.model)
    init_params(model, torch.Generator().manual_seed(0))
    state = model.state_dict()
    batch = random_batch(np.random.RandomState(0))
    launches = mod.KERNEL.launches
    with torch.no_grad():
        got, _ = Evaluator(cfg, state, device=cuda_device).model(
            batch_to_device(batch, cuda_device))
        want, _ = Evaluator(cfg, state, device="cpu").model(
            batch_to_device(batch, torch.device("cpu")))
    assert mod.KERNEL.launches == launches + cfg.model.num_layers
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)
    card = Trainer(cfg, state, device=cuda_device)
    cpu = Trainer(cfg, state, device="cpu")
    launches = pair.launches
    rng = np.random.RandomState(1)
    for _ in range(3):
        batch = random_batch(rng)
        got, want = float(card.update(batch)), float(cpu.update(batch))
        assert abs(got - want) <= 1e-4 * max(1.0, abs(want))
    assert pair.launches == launches + 3 * cfg.model.num_layers
    for k, v in cpu.model.state_dict().items():
        assert scaled_err(card.model.state_dict()[k].cpu(), v) <= 1e-4, k


@pytest.mark.cuda
def test_bf16_fused_path_on_card_matches_cpu(cuda_device):
    """``cgcn_preset`` with use_pallas=True in bf16, dropout off: the
    evaluation forward and three train steps on the card (every kernel of
    the path in its bf16 instance, none in f32) against the plain versions
    in bf16 on the CPU.  Tolerance 1e-2 of max(1, |value|): both round
    at the same points, and a rounding flip where the two sums straddle a
    bf16 boundary (2^-8 of a value) moves what follows it."""
    cfg = small_cfg(cgcn_preset, **{"model.use_pallas": True,
                                    "model.compute_dtype": "bfloat16",
                                    "model.input_dropout": 0.0,
                                    "model.rnn_dropout": 0.0,
                                    "model.gcn_dropout": 0.0})
    model = GCNClassifier(cfg.model)
    init_params(model, torch.Generator().manual_seed(0))
    state = model.state_dict()
    kernels = [lstm_mod.KERNEL, lstm_mod.BACKWARD_KERNEL, gmm_mod.KERNEL,
               gmm_mod.BACKWARD_KERNEL, band_mod.KERNEL,
               band_mod.PAIR_KERNEL]
    for k in kernels:
        k.reset()
    batch = random_batch(np.random.RandomState(0))
    with torch.no_grad():
        got, _ = Evaluator(cfg, state, device=cuda_device).model(
            batch_to_device(batch, cuda_device))
        want, _ = Evaluator(cfg, state, device="cpu").model(
            batch_to_device(batch, torch.device("cpu")))
    assert scaled_err(got.cpu(), want) <= 1e-2
    card = Trainer(cfg, state, device=cuda_device)
    cpu = Trainer(cfg, state, device="cpu")
    rng = np.random.RandomState(1)
    for _ in range(3):
        batch = random_batch(rng)
        got, want = float(card.update(batch)), float(cpu.update(batch))
        assert abs(got - want) <= 1e-2 * max(1.0, abs(want))
    for k, v in cpu.model.state_dict().items():
        assert scaled_err(card.model.state_dict()[k].cpu(), v) <= 1e-2, k
    for k in kernels:
        assert k.launches_of("_bf16") > 0 and k.launches_of("_f32") == 0, \
            (k.name, k.by_function)


# the SDDMM's cases and widths: H = 70 takes the backward's 4-byte
# gather, H = 200 (the attention layer's) its 16-byte one; the slots
# cases have E >> N, past the bf16 backward's window of edges and, in
# star_slots, one list past its entries held at once
SDDMM_CASES = {**{name: 70 for name in EDGE_CASES + list(EDGE_SIZES)
                  + list(FOREST) + list(SLOTS)},
               "forest_h200": 200, "star": 200, "slots_past_48kb_h200": 200,
               "star_slots": 200}


def sddmm_case(name, device):
    """An SDDMM case's edges on ``device``, with its (b, n, h)."""
    edges, b, n = edge_tensors(name.replace("_h200", ""), device)
    return edges, b, n, SDDMM_CASES[name]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(SDDMM_CASES))
def test_sddmm_kernels_match_plain(cuda_device, name, dtype):
    """Both instances: the f32 scores within 1e-5 of the plain version's;
    du and dv within 1e-5 (f32) or the plain version's bits but one
    rounding step (bf16)."""
    suffix = EDGE_DTYPES[dtype][1]
    edges, b, n, h = sddmm_case(name, cuda_device)
    rng = np.random.RandomState(7)
    u, v = (a.to(dtype) for a in features(rng, cuda_device, (b, n, h),
                                          (b, n, h)))
    (g,) = features(rng, cuda_device, tuple(edges[0].shape))
    launches = sddmm_mod.KERNEL.launches_of(suffix)
    got = sddmm_mod.sddmm_forward(*edges, u, v)
    again = sddmm_mod.sddmm_forward(*edges, u, v)
    assert sddmm_mod.KERNEL.launches_of(suffix) == launches + 2
    assert got.dtype == torch.float32
    assert torch.equal(got, again)
    assert scaled_err(got, sddmm_mod.sddmm_plain(*edges, u, v)) <= 1e-5
    # masked edges and edges with an end outside [0, n) score exactly 0
    assert not got[~valid_edges(*edges, n)].any()
    launches = sddmm_mod.BACKWARD_KERNEL.launches_of(suffix)
    got = sddmm_mod.sddmm_backward(*edges, g, u, v)
    again = sddmm_mod.sddmm_backward(*edges, g, u, v)
    assert sddmm_mod.BACKWARD_KERNEL.launches_of(suffix) == launches + 2
    want = sddmm_mod.sddmm_backward_plain(*edges, g, u, v)
    for a, a2, w in zip(got, again, want):
        assert a.dtype == dtype
        assert torch.equal(a, a2)  # no float atomics
        if dtype == torch.float32:
            assert scaled_err(a, w) <= 1e-5
        else:
            print(f"sddmm backward bf16 {name}: largest difference "
                  f"{bf16_flip(a, w, 1e-5):.3g}")


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 4])
@pytest.mark.parametrize("name", list(SDDMM_CASES))
def test_sddmm_backward_bf16_gives_the_exact_order_bits(cuda_device, name,
                                                        offset):
    """10b equals ``tests/edge_order.py``'s reference in bits, with u and
    v 16-byte aligned and 8 bytes off (its 16-byte and 2-byte loads)."""
    edges, b, n, h = sddmm_case(name, cuda_device)
    rng = np.random.RandomState(9)
    u, v = (bf16_at(x, offset) for x in features(rng, cuda_device,
                                                 (b, n, h), (b, n, h)))
    (g,) = features(rng, cuda_device, tuple(edges[0].shape))
    assert u.data_ptr() % 16 == 2 * offset
    launches = sddmm_mod.BACKWARD_KERNEL.launches_of("_bf16")
    got = sddmm_mod.sddmm_backward(*edges, g, u, v)
    assert sddmm_mod.BACKWARD_KERNEL.launches_of("_bf16") == launches + 1
    want = sddmm_backward_exact(*(a.cpu().numpy() for a in edges),
                                g.cpu().numpy(), u.float().cpu().numpy(),
                                v.float().cpu().numpy())
    for a, w in zip(got, want):
        np.testing.assert_array_equal(bits_of(a), w)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SDDMM_CASES))
def test_sddmm_edge_lists_match_stable_sort(cuda_device, name):
    """The backward's list build: starts and (edge, neighbour) entries
    equal a stable argsort of the counted edges by node, bit for bit."""
    edges, b, n, _ = sddmm_case(name, cuda_device)
    launches = sddmm_mod.LISTS_KERNEL.launches
    got = sddmm_mod.edge_lists(*edges, n)
    assert sddmm_mod.LISTS_KERNEL.launches == launches + 1
    assert torch.equal(got, sddmm_mod.edge_lists_plain(*edges, n))


# M, T, D, H.  v2 and v1 take 128 x 208 output tiles, 32 rows of W a
# chunk, and split D into SMs / (row and column tiles) slices (one d each
# in the small cases, 1-2 in mixed_slices, 16-17 at the C-GCN's widths,
# none for D = 1).  The bf16 kernel also keeps x resident for T <= 512
# (wide_t and wide_t_ragged fold a pass of 512 at a time), takes row tiles
# in pairs (m_past_tile: an odd count), multiplies two k-steps of 16 a
# chunk (t_past_chunk: T not a multiple of the chunk) and copies by TMA
# only rows and bases of 16 bytes (ragged, tiny, mixed_slices and
# wide_t_ragged go through its copying threads)
BILINEAR_SHAPES = {"ragged": (70, 37, 5, 70),    # no tile fits
                   "small": (130, 40, 9, 24),
                   "tiny": (129, 20, 3, 5),      # M = 128 + 1, T < 32, H < 8
                   "wide_h": (100, 64, 4, 300),  # two column tiles
                   "one_d": (300, 64, 1, 200),   # one slice: no partials
                   "mixed_slices": (4000, 37, 7, 70),
                   "t_past_chunk": (256, 104, 6, 200),  # 3 chunks + 8
                   "m_past_tile": (257, 64, 5, 200),    # 2 tiles + 1 row
                   "wide_t": (300, 640, 6, 200),        # passes 512 + 128
                   "wide_t_ragged": (130, 1084, 3, 200),  # T % 8 = 4
                   "c_gcn_layer0": (4800, 400, 50, 200),
                   "c_gcn_layer1": (4800, 200, 50, 200)}


def check_bilinear_kernel(x, e, w, version):
    """One call of ``version``'s kernel on x, e, w: within 1e-4 (f32) or
    the plain version's bits but one rounding step (bf16), the same bits
    on a second call, two launches of the dtype's instance, and one slice
    sum a call exactly where the launcher splits K into slices."""
    suffix = EDGE_DTYPES[x.dtype][1]
    (m, t), (d, _, h) = x.shape, w.shape
    kernel = bilinear_mod._KERNELS[version]
    lib = kernel.load()
    launches = kernel.launches_of(suffix)
    sums = lib.deprel_bilinear_sum_launches()
    got = bilinear_mod.bilinear_forward(x, e, w, version)
    # the slice sums the launcher launched in that call, by its own count
    sums = lib.deprel_bilinear_sum_launches() - sums
    again = bilinear_mod.bilinear_forward(x, e, w, version)
    assert kernel.launches_of(suffix) == launches + 2
    assert got.dtype == x.dtype
    assert torch.equal(got, again)
    plain = getattr(bilinear_mod, f"bilinear_{version}_plain")
    if x.dtype == torch.float32:
        assert scaled_err(got, plain(x, e, w)) <= 1e-4
    else:
        print(f"bilinear {version} bf16 {m, t, d, h}: largest difference "
              f"{bf16_flip(got, plain(x, e, w), 1e-4):.3g}")
    # both versions split K into the same slices, and a call sums their
    # partials by a second kernel exactly where there is more than one
    slices = lib.deprel_bilinear_slices(m, d, h)
    assert sums == (slices > 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("version", ["v2", "v1"])
@pytest.mark.parametrize("shape", sorted(BILINEAR_SHAPES))
def test_deprel_bilinear_kernels_match_plain(cuda_device, shape, version,
                                             dtype):
    """Both instances of both versions: within 1e-4 (f32) or the plain
    version's bits but one rounding step (bf16)."""
    m, t, d, h = BILINEAR_SHAPES[shape]
    rng = np.random.RandomState(8)
    x, e, w = features(rng, cuda_device, (m, t), (m, d), (d, t, h))
    x, e, w = (a.to(dtype) for a in (x, e, w / np.sqrt(t)))
    check_bilinear_kernel(x, e, w, version)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("version", ["v2", "v1"])
def test_deprel_bilinear_kernels_take_an_unaligned_x(cuda_device, version,
                                                     dtype):
    """x contiguous at an odd element offset of its storage (a base that
    is not 16-byte aligned, which TMA refuses), at the C-GCN's second
    layer's widths."""
    m, t, d, h = 512, 200, 6, 200
    rng = np.random.RandomState(9)
    flat, e, w = features(rng, cuda_device, (m * t + 1,), (m, d), (d, t, h))
    x = flat.to(dtype)[1:].view(m, t)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    check_bilinear_kernel(x, e.to(dtype), (w / np.sqrt(t)).to(dtype),
                          version)


@pytest.mark.cuda
def test_new_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    (parent, child, mask), b, n = edge_tensors("random", cuda_device)
    u = torch.randn(b, n, 8, device=cuda_device)
    with pytest.raises(ValueError, match="differ"):
        sddmm_mod.sddmm_forward(parent, child, mask, u,
                                torch.zeros(b, n, 4, device=cuda_device))
    with pytest.raises(TypeError):
        sddmm_mod.sddmm_forward(parent, child, mask, u.double(), u.double())
    with pytest.raises(ValueError, match="g must be"):
        sddmm_mod.sddmm_backward(parent, child, mask,
                                 torch.zeros(b, 1, device=cuda_device), u, u)
    x = torch.randn(16, 8, device=cuda_device)
    e = torch.randn(16, 3, device=cuda_device)
    w = torch.randn(3, 8, 5, device=cuda_device)
    with pytest.raises(TypeError):  # one dtype a call
        bilinear_mod.bilinear_forward(x.bfloat16(), e, w)
    with pytest.raises(ValueError, match="contiguous"):
        bilinear_mod.bilinear_forward(x.T.contiguous().T, e, w)
    with pytest.raises(ValueError, match="expected"):
        bilinear_mod.bilinear_forward(x, e, w[:, :4])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["attention", "bilinear"])
def test_new_paths_on_card_match_cpu(cuda_device, mode):
    """The attention edge backend and the non-factored fused full_deprel,
    dropout off: the evaluation forward and three train steps with the
    kernels on the card against the plain versions on the CPU, within
    1e-4; every kernel of the path counted."""
    extra = ({"model.adj_type": "attention", "model.attention_impl": "edge"}
             if mode == "attention" else
             {"model.deprel_factored": False, "model.use_pallas": True})
    cfg = small_cfg(**extra, **{"model.input_dropout": 0.0,
                                "model.rnn_dropout": 0.0,
                                "model.gcn_dropout": 0.0})
    fwd, bwd = ((sddmm_mod.KERNEL, sddmm_mod.BACKWARD_KERNEL)
                if mode == "attention"
                else (bilinear_mod.KERNEL_V2, band_mod.PAIR_KERNEL))
    per_layer = 2  # a kernel call per band and layer, or pair per layer
    per_layer_bwd = 2 if mode == "attention" else 1
    model = GCNClassifier(cfg.model)
    init_params(model, torch.Generator().manual_seed(0))
    state = model.state_dict()
    batch = random_batch(np.random.RandomState(0))
    launches = fwd.launches
    with torch.no_grad():
        got, _ = Evaluator(cfg, state, device=cuda_device).model(
            batch_to_device(batch, cuda_device))
        want, _ = Evaluator(cfg, state, device="cpu").model(
            batch_to_device(batch, torch.device("cpu")))
    assert fwd.launches == launches + per_layer * cfg.model.num_layers
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)
    card = Trainer(cfg, state, device=cuda_device)
    cpu = Trainer(cfg, state, device="cpu")
    launches = bwd.launches
    rng = np.random.RandomState(1)
    for _ in range(3):
        batch = random_batch(rng)
        got, want = float(card.update(batch)), float(cpu.update(batch))
        assert abs(got - want) <= 1e-4 * max(1.0, abs(want))
    assert bwd.launches == launches + 3 * per_layer_bwd * cfg.model.num_layers
    for k, v in cpu.model.state_dict().items():
        assert scaled_err(card.model.state_dict()[k].cpu(), v) <= 1e-4, k


@pytest.mark.cuda
def test_diagonal_fused_on_card_matches_dense_and_cpu(cuda_device):
    """The fused diagonal_deprel path (the band aggregation forward and its
    pair backward, on gates no other path gives them), dropout off: the
    evaluation forward against the dense bands on the card and the CPU,
    and three train steps against the CPU, within 1e-4 of max(1, |ref|);
    both kernels counted, one call a layer."""
    extra = {"model.adj_type": "diagonal_deprel", "model.input_dropout": 0.0,
             "model.rnn_dropout": 0.0, "model.gcn_dropout": 0.0}
    cfg = small_cfg(**extra, **{"model.use_pallas": True})
    dense_cfg = small_cfg(**extra, **{"model.use_pallas": False})
    layers = cfg.model.num_layers
    model = GCNClassifier(cfg.model)
    init_params(model, torch.Generator().manual_seed(0))
    state = model.state_dict()
    batch = random_batch(np.random.RandomState(0))
    launches = band_mod.KERNEL.launches
    with torch.no_grad():
        got, _ = Evaluator(cfg, state, device=cuda_device).model(
            batch_to_device(batch, cuda_device))
        assert band_mod.KERNEL.launches == launches + layers
        dense, _ = Evaluator(dense_cfg, state, device=cuda_device).model(
            batch_to_device(batch, cuda_device))
        cpu, _ = Evaluator(cfg, state, device="cpu").model(
            batch_to_device(batch, torch.device("cpu")))
    assert band_mod.KERNEL.launches == launches + layers
    assert scaled_err(got, dense) <= 1e-4
    assert scaled_err(got.cpu(), cpu) <= 1e-4
    card = Trainer(cfg, state, device=cuda_device)
    on_cpu = Trainer(cfg, state, device="cpu")
    launches = (band_mod.KERNEL.launches, band_mod.PAIR_KERNEL.launches)
    rng = np.random.RandomState(1)
    for _ in range(3):
        batch = random_batch(rng)
        got, want = float(card.update(batch)), float(on_cpu.update(batch))
        assert abs(got - want) <= 1e-4 * max(1.0, abs(want))
    assert (band_mod.KERNEL.launches, band_mod.PAIR_KERNEL.launches) == (
        launches[0] + 3 * layers, launches[1] + 3 * layers)
    for k, v in on_cpu.model.state_dict().items():
        assert scaled_err(card.model.state_dict()[k].cpu(), v) <= 1e-4, k


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("b,h", [(50, 200), (19, 24), (19, 30), (1, 24),
                                 (50, 7), (5, 480), (8, 1000)])
def test_scan_plan_partitions(b, h, backward):
    """Every unit in exactly one CTA, every row in exactly one tile, a CTA
    within 227 KB and 512 threads."""
    plan = lstm_mod.scan_plan(b, h, backward=backward)
    units = [u for u0, n in plan.unit_ranges() for u in range(u0, u0 + n)]
    assert units == list(range(h))
    assert max(n for _, n in plan.unit_ranges()) == plan.units
    rows = [r for r0, n in plan.row_tiles(b) for r in range(r0, r0 + n)]
    assert rows == list(range(b))
    assert plan.smem_bytes <= lstm_mod.SMEM_LIMIT == 227 * 1024
    assert plan.threads <= 512 and plan.threads % 32 == 0
    # a warp for each 8 row slots of 4 units
    rows_a_warp = 8 * plan.rows_per_thread
    assert plan.threads // 32 >= (-(-plan.rows // rows_a_warp)
                                  * -(-plan.units // 4))
    assert plan.cluster <= min(h, 16)


@pytest.mark.parametrize("backward", [False, True])
def test_scan_plan_keeps_cgcn_weights_resident(backward):
    """At the C-GCN's widths (B=50, H=200) the slice of w_hh stays in the
    cluster's shared memory; only a width past it streams."""
    plan = lstm_mod.scan_plan(50, 200, backward=backward)
    assert plan.resident and plan.cluster > 1
    wide = lstm_mod.scan_plan(5, 480, backward=backward)
    assert not wide.resident
    # the slice of w_hh at that width would not fit beside the rest
    _, slice_floats, rest = lstm_mod._layout(
        480, wide.cluster, wide.rows, wide.rows_per_thread, backward)
    assert 4 * (slice_floats + rest) > lstm_mod.SMEM_LIMIT


# ------------------------------------------------------------- dispatch
def _graph_and_eager(cfg, device):
    """Two trainers from one seeded state: the first replays graphs, the
    second runs eagerly (``eager_dispatch``) when driven so."""
    model = GCNClassifier(cfg.model)
    init_params(model, torch.Generator().manual_seed(0))
    state = model.state_dict()
    return Trainer(cfg, state, device=device), Trainer(cfg, state,
                                                       device=device)


def loader_batch(rng, b=6, n=16):
    """``random_batch`` with every field the loader gives (``pad_mask``,
    ``edge_deprel``), so that it packs."""
    batch = random_batch(rng, b=b, n=n)
    batch["pad_mask"] = np.arange(n)[None, :] >= batch["lengths"][:, None]
    batch["edge_deprel"] = np.where(batch["edge_mask"],
                                    rng.randint(1, 42, (b, n)), 0)
    return batch


def _same_params(a, b):
    for k, v in a.model.state_dict().items():
        assert torch.equal(b.model.state_dict()[k], v), k


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["compact", "int32", "fields"])
def test_graph_steps_equal_eager_steps(cuda_device, fmt):
    """Dropout on: steps replayed from graphs (one step, and a 7-batch
    ``update_chunk`` as 4 + 2 + 1) give the eager steps' losses and
    parameters bit for bit, whichever way the batches cross; evaluation
    through graphs, in chunks of 4, gives the eager predictions, probs
    and loss."""
    from gcn_tpu_torch.train.dispatch import eager_dispatch

    cfg = small_cfg(**{"train.steps_per_dispatch": 4,
                       "train.batch_size": 6,
                       "train.effective_batch_size": 6,
                       "train.pack_format": "int32" if fmt == "int32"
                       else "compact",
                       "train.pack_transfers": fmt != "fields"})
    graph, eager = _graph_and_eager(cfg, cuda_device)
    rng = np.random.RandomState(4)
    batches = [loader_batch(rng) for _ in range(3)] + [
        loader_batch(rng, n=24)]
    chunk = [loader_batch(rng) for _ in range(7)]
    got = [graph.update(b) for b in batches] + graph.update_chunk(chunk)
    with eager_dispatch():
        want = [eager.update(b) for b in batches + chunk]
    assert [float(x) for x in got] == [float(x) for x in want]
    _same_params(graph, eager)
    assert graph.global_step == eager.global_step == 11
    # one graph per signature and dispatch size
    assert len(graph.graphs) == (2 if fmt == "fields" else 4)
    mixed = batches + chunk[:5] + [loader_batch(rng, b=3)]
    got = graph.evaluate(mixed)
    with eager_dispatch():
        want = eager.evaluate(mixed)
    assert got[0] == want[0] and got[1] == want[1] and got[2] == want[2]


@pytest.mark.cuda
def test_graph_losses_are_not_overwritten(cuda_device):
    """The loss of step 1, kept as a tensor, still holds step 1's value
    after step 2 replays the same graph; the graph's output does not."""
    from gcn_tpu_torch.train.dispatch import eager_dispatch

    cfg = small_cfg()
    graph, eager = _graph_and_eager(cfg, cuda_device)
    rng = np.random.RandomState(5)
    b1, b2 = loader_batch(rng), loader_batch(rng)
    l1 = graph.update(b1)
    l2 = graph.update(b2)
    with eager_dispatch():
        w1, w2 = eager.update(b1), eager.update(b2)
    assert float(l1) == float(w1) and float(l2) == float(w2)
    assert float(l1) != float(l2)
    (out,) = [g.outputs for g in graph.graphs.values()]
    assert float(out[0]) == float(l2)


@pytest.mark.cuda
def test_launch_counts_hold_under_replay(cuda_device):
    """Each replay adds the launches its graph captured; the eager call
    before a capture is not counted."""
    cfg = small_cfg()
    tr, _ = _graph_and_eager(cfg, cuda_device)
    kernels = (lstm_mod.KERNEL, lstm_mod.BACKWARD_KERNEL, gmm_mod.KERNEL,
               gmm_mod.BACKWARD_KERNEL)
    for k in kernels:
        k.launches = 0
    rng = np.random.RandomState(6)
    for _ in range(3):
        tr.update(random_batch(rng))
    torch.cuda.synchronize()
    layers = cfg.model.num_layers
    assert [k.launches for k in kernels] == [3, 3, 3 * layers, 3 * layers]
    ev = Evaluator.for_model(cfg, tr.model)
    ev.evaluate([random_batch(rng) for _ in range(4)])
    assert lstm_mod.KERNEL.launches == 3 + 4


@pytest.mark.cuda
def test_pinned_ring_waits_for_the_copy_in_flight(cuda_device):
    """A ring of one buffer: the second ``take`` waits until the copy
    that read the first is done, so what the card receives is what was
    written before it, though the stream was busy when the copy went
    out."""
    from gcn_tpu_torch.train.transfer import PinnedRing

    ring = PinnedRing(1)
    n = 1 << 20
    dst = torch.zeros(n, dtype=torch.uint8, device=cuda_device)
    torch.cuda._sleep(200_000_000)  # keep the stream busy for a while
    slot, buf = ring.take(n)
    buf.fill_(1)
    dst.copy_(buf, non_blocking=True)
    ring.release(slot)
    _, again = ring.take(n)
    again.fill_(2)
    torch.cuda.synchronize()
    assert int(dst.min()) == int(dst.max()) == 1


@pytest.mark.cuda
def test_a_failed_capture_raises(cuda_device):
    """A model that claims a graph can hold it while its step reads the
    host (the plain grouped matmul's group sizes): the capture fails and
    the step raises, in a process of its own."""
    import subprocess
    import sys
    import textwrap

    code = textwrap.dedent("""
        import sys
        import numpy as np
        sys.path.insert(0, "tests")
        from test_torch_port_cuda import random_batch, small_cfg
        from gcn_tpu_torch.models.gcn import GCNClassifier
        from gcn_tpu_torch.train.trainer import Trainer
        GCNClassifier.capturable = property(lambda self: True)
        tr = Trainer(small_cfg(**{"model.deprel_factored": "ragged"}),
                     device="cuda")
        try:
            tr.update(random_batch(np.random.RandomState(0)))
        except RuntimeError as e:
            print("raised:", str(e).splitlines()[0])
        else:
            print("no error")
    """)
    repo = __file__.rsplit("/tests/", 1)[0]
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=300)
    assert "raised:" in out.stdout, out.stdout + out.stderr[-3000:]


@pytest.mark.cuda
@pytest.mark.parametrize("plain", ["ragged", "scan"])
def test_plain_versions_train_and_evaluate_on_the_card(cuda_device, plain):
    """The plain versions a config can pick on the card: the grouped
    matmul's (``deprel_factored="ragged"``, which reads the host, so its
    steps run eagerly and nothing is captured) and the scan's
    (``rnn_impl="scan"``, through graphs).  Steps, a 4-batch chunk and
    evaluation give the eager run's bits."""
    from gcn_tpu_torch.train.dispatch import eager_dispatch

    key, value = {"ragged": ("model.deprel_factored", "ragged"),
                  "scan": ("model.rnn_impl", "scan")}[plain]
    cfg = small_cfg(**{key: value, "train.steps_per_dispatch": 4,
                       "train.batch_size": 6,
                       "train.effective_batch_size": 6})
    graph, eager = _graph_and_eager(cfg, cuda_device)
    rng = np.random.RandomState(8)
    batches = [loader_batch(rng) for _ in range(6)]
    got = [graph.update(b) for b in batches[:2]] + graph.update_chunk(
        batches[2:])
    ev = graph.evaluate(batches)
    with eager_dispatch():
        want = [eager.update(b) for b in batches]
        ev_want = eager.evaluate(batches)
    assert all(np.isfinite(float(x)) for x in got)
    assert [float(x) for x in got] == [float(x) for x in want]
    _same_params(graph, eager)
    assert ev[0] == ev_want[0] and ev[1] == ev_want[1]
    assert ev[2] == ev_want[2]
    captured = len(graph.graphs) + len(graph._evaluator.graphs)
    assert (captured == 0) is (plain == "ragged")


@pytest.mark.cuda
def test_eager_steps_on_the_card_are_the_same_bits_twice(cuda_device):
    """3840 tokens a batch (past the 3072 where ``embedding``'s backward
    on the card turns to an algorithm that differs from run to run): two
    eager steps from one state on one batch give the same loss and
    gradients, so graphs can be held to the eager steps in bits."""
    cfg = small_cfg(**{"train.batch_size": 40})
    model = GCNClassifier(cfg.model)
    init_params(model, torch.Generator().manual_seed(0))
    state = model.state_dict()
    batch = loader_batch(np.random.RandomState(9), b=40, n=96)
    runs = [Trainer(cfg, state, device=cuda_device)._loss_and_grads(batch)
            for _ in range(3)]
    for loss, grads in runs[1:]:
        assert float(loss) == float(runs[0][0])
        for k, g in grads.items():
            assert torch.equal(g, runs[0][1][k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["attention", "bilinear"])
def test_bf16_new_paths_on_card_match_cpu(cuda_device, mode):
    """The attention edge backend and the non-factored fused full_deprel
    in bf16, dropout off: the evaluation forward and three train steps on
    the card (kernels 9-10 or 11 in their bf16 instances, none in f32)
    against the plain versions in bf16 on the CPU, within 1e-2 of max(1,
    |value|) (both round at the same points; a rounding flip where two f32
    sums straddle a bf16 boundary moves what follows it)."""
    extra = ({"model.adj_type": "attention", "model.attention_impl": "edge"}
             if mode == "attention" else
             {"model.deprel_factored": False, "model.use_pallas": True})
    cfg = small_cfg(**extra, **{"model.compute_dtype": "bfloat16",
                                "model.input_dropout": 0.0,
                                "model.rnn_dropout": 0.0,
                                "model.gcn_dropout": 0.0})
    kernels = ([sddmm_mod.KERNEL, sddmm_mod.BACKWARD_KERNEL]
               if mode == "attention"
               else [bilinear_mod.KERNEL_V2, band_mod.KERNEL,
                     band_mod.PAIR_KERNEL])
    kernels += [lstm_mod.KERNEL, lstm_mod.BACKWARD_KERNEL]
    for k in kernels:
        k.reset()
    model = GCNClassifier(cfg.model)
    init_params(model, torch.Generator().manual_seed(0))
    state = model.state_dict()
    batch = random_batch(np.random.RandomState(0))
    with torch.no_grad():
        got, _ = Evaluator(cfg, state, device=cuda_device).model(
            batch_to_device(batch, cuda_device))
        want, _ = Evaluator(cfg, state, device="cpu").model(
            batch_to_device(batch, torch.device("cpu")))
    assert scaled_err(got.cpu(), want) <= 1e-2
    card = Trainer(cfg, state, device=cuda_device)
    cpu = Trainer(cfg, state, device="cpu")
    rng = np.random.RandomState(1)
    for _ in range(3):
        batch = random_batch(rng)
        got, want = float(card.update(batch)), float(cpu.update(batch))
        assert abs(got - want) <= 1e-2 * max(1.0, abs(want))
    for k, v in cpu.model.state_dict().items():
        assert scaled_err(card.model.state_dict()[k].cpu(), v) <= 1e-2, k
    for k in kernels:
        assert k.launches_of("_bf16") > 0 and k.launches_of("_f32") == 0, \
            (k.name, k.by_function)


def packed_batches(rows=4, pack_len=64, slots=4, train=True):
    """``PackedBatcher`` batches of the in-repo TACRED split, by the port's
    own loader (word dropout on for training)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    vocab = Vocab.load(os.path.join(repo, "dataset", "vocab", "vocab.pkl"))
    cfg = small_cfg(**{"model.vocab_size": vocab.size,
                       "train.batch_size": rows,
                       "train.effective_batch_size": rows})
    ds = RelationDataset(os.path.join(repo, "dataset", "tacred",
                                      "train.json"), cfg, vocab)
    return cfg, list(PackedBatcher(ds, rows, pack_len=pack_len,
                                   max_slots=slots, evaluation=not train))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_kernels_take_the_packed_rows_resets(cuda_device, dtype):
    """The scan forward and backward kernels with the carry factor that
    ``_segment_resets`` builds from a real ``PackedBatcher`` batch: within
    the tolerances of ``test_lstm_kernel_matches_plain`` and
    ``test_lstm_backward_kernel_matches_plain`` of the plain versions, and
    the packed rows' outputs those of each sentence in a row of its own
    (plain versions, 1e-5)."""
    from gcn_tpu_torch.ops.lstm import _segment_resets

    _, batches = packed_batches()
    batch = batches[0]
    seg = torch.from_numpy(batch["seg_start"]).to(cuda_device)
    lengths = torch.from_numpy(batch["lengths"]).to(cuda_device)
    reset_f, reset_b = _segment_resets(seg, lengths)
    keep = (1.0 - torch.stack((reset_f.T, reset_b.T), 1).float()
            ).contiguous()
    t, g, b, h = keep.shape[0], 2, keep.shape[2], 24
    rng = np.random.RandomState(3)
    xp = torch.from_numpy(rng.randn(t, g, b, 4 * h).astype(np.float32)).to(
        cuda_device, dtype)
    w = torch.from_numpy((rng.randn(g, h, 4 * h) / np.sqrt(h)).astype(
        np.float32)).to(cuda_device, dtype)
    len32 = lengths.to(torch.int32)
    states = lstm_mod.lstm_scan_forward(xp, len32, w, keep)
    want = lstm_mod.lstm_scan_plain(xp, len32, w, keep)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for a, b_ in zip(states, want):
        torch.testing.assert_close(a.float(), b_.float(), atol=tol, rtol=0)
    gy = torch.from_numpy(rng.randn(t, g, b, h).astype(np.float32)).to(
        cuda_device)
    tpos = torch.arange(t, device=cuda_device)[:, None, None, None]
    gy = torch.where(tpos < len32[None, None, :, None], gy, 0.0).contiguous()
    got = lstm_mod.lstm_scan_backward(gy, xp, len32, w, *want, keep)
    ref = lstm_mod.lstm_scan_backward_plain(gy, xp, len32, w, *want, keep)
    btol = 1e-4 if dtype == torch.float32 else 1e-2
    for a, b_ in zip(got, ref):
        assert scaled_err(a, b_) <= btol
    # the forward direction restarts at every sentence of a packed row:
    # each sentence's forward states are those of its tokens alone
    starts = np.flatnonzero(batch["seg_start"][0])
    ends = list(starts[1:]) + [int(batch["lengths"][0])]
    assert len(starts) > 1
    for s0, s1 in zip(starts, ends):
        alone, _ = lstm_mod.lstm_scan_plain(
            xp[s0:s1, :1, :1].contiguous(),
            torch.tensor([s1 - s0], dtype=torch.int32, device=cuda_device),
            w[:1].contiguous())
        torch.testing.assert_close(states[0][s0:s1, 0, 0].float(),
                                   alone[:, 0, 0].float(), atol=tol,
                                   rtol=0)


@pytest.mark.cuda
def test_packed_graph_steps_equal_eager_steps(cuda_device):
    """Dropout on: packed batches (one sentence-format copy each) through
    graphs give the eager steps' losses and parameters in bits, and
    evaluation through graphs gives the eager predictions, probs and the
    weighted loss."""
    from gcn_tpu_torch.train.dispatch import eager_dispatch

    cfg, batches = packed_batches()
    graph, eager = _graph_and_eager(cfg, cuda_device)
    assert graph.staging.packs_sentences(batches[0])
    copies = graph.staging.copies
    got = [graph.update(b) for b in batches]
    assert graph.staging.copies - copies == len(batches)
    with eager_dispatch():
        want = [eager.update(b) for b in batches]
    assert [float(x) for x in got] == [float(x) for x in want]
    _same_params(graph, eager)
    assert len(graph.graphs) == 1  # one packed shape
    _, evals = packed_batches(train=False)
    got = graph.evaluate(evals)
    with eager_dispatch():
        want = eager.evaluate(evals)
    assert got[0] == want[0] and got[1] == want[1] and got[2] == want[2]


# ------------------------------------------- row-sparse update, data parallel
@pytest.mark.cuda
def test_coalesce_on_the_card_gives_the_cpus_bits(cuda_device):
    """4800 ids with repeats (every id about 16 times): the card's
    ``coalesce`` (a stable sort and a segmented scan of fixed order, no
    atomics) gives the same bits twice and the CPU's bits."""
    from gcn_tpu_torch.train.sparse_emb import coalesce

    rng = np.random.RandomState(3)
    ids = torch.from_numpy(rng.randint(0, 300, 4800))
    rows = torch.from_numpy(rng.randn(4800, 300).astype(np.float32))
    want = coalesce(ids, rows)
    for _ in range(2):
        got = coalesce(ids.to(cuda_device), rows.to(cuda_device))
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("optim", ["sgd", "adagrad"])
def test_sparse_steps_same_bits_twice_and_through_graphs(cuda_device,
                                                          optim):
    """B=50, N=96: 4800 ids a batch over 2000 rows, with repeats.  Sparse
    steps through graphs, eagerly, and eagerly again give the same losses
    and parameters in bits, and follow the dense steps within 1e-5 of
    max(1, max |p|)."""
    from gcn_tpu_torch.train.dispatch import eager_dispatch

    base = {"train.batch_size": 50, "train.effective_batch_size": 50,
            "train.optim": optim, "model.vocab_size": 2000}
    cfg = small_cfg(**base, **{"train.sparse_emb_grad": "true"})
    model = GCNClassifier(cfg.model)
    init_params(model, torch.Generator().manual_seed(0))
    state = model.state_dict()
    rng = np.random.RandomState(5)
    batches = [loader_batch(rng, b=50, n=96) for _ in range(3)]
    for b in batches:
        b["words"] = np.where(b["words"] > 0,
                              rng.randint(2, 2000, b["words"].shape), 0)
    runs = []
    for eager in (False, True, True):
        tr = Trainer(cfg, state, device=cuda_device)
        assert tr.sparse_emb
        with eager_dispatch() if eager else contextlib.nullcontext():
            runs.append(([float(tr.update(b)) for b in batches], tr))
    for losses, tr in runs[1:]:
        assert losses == runs[0][0]
        _same_params(tr, runs[0][1])
    dense = Trainer(small_cfg(**base, **{"train.sparse_emb_grad": "false"}),
                    state, device=cuda_device)
    assert not dense.sparse_emb
    want = [float(dense.update(b)) for b in batches]
    np.testing.assert_allclose(runs[0][0], want, rtol=1e-5)
    for k, v in dense.model.state_dict().items():
        assert scaled_err(runs[0][1].model.state_dict()[k], v) <= 1e-5, k


@pytest.mark.cuda
def test_nccl_world_of_one_steps_are_trainers_bits(cuda_device):
    """A world-size-1 NCCL ``DistributedTrainer`` (its all-reduces inside
    the step's CUDA graph) gives ``Trainer``'s losses and parameters in
    bits, dropout on, and its evaluation's predictions and probs."""
    from gcn_tpu_torch.parallel import distributed
    from gcn_tpu_torch.train.distributed_trainer import DistributedTrainer

    cfg = small_cfg(**{"train.batch_size": 6,
                       "train.effective_batch_size": 6})
    model = GCNClassifier(cfg.model)
    init_params(model, torch.Generator().manual_seed(0))
    state = model.state_dict()
    rng = np.random.RandomState(6)
    batches = [loader_batch(rng) for _ in range(3)]
    try:
        dp = DistributedTrainer(cfg, state, device=cuda_device)
        assert dp.backend == "nccl" and dp.world == 1 and dp._graphs_on()
        one = Trainer(cfg, state, device=cuda_device)
        got = [float(dp.update(b)) for b in batches]
        assert len(dp.graphs) == 1
        assert got == [float(one.update(b)) for b in batches]
        _same_params(dp, one)
        mine, theirs = dp.evaluate(batches), one.evaluate(batches)
        assert mine[0] == theirs[0] and mine[1] == theirs[1]
    finally:
        distributed.shutdown()
