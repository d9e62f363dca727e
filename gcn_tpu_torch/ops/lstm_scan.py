"""Masked LSTM scan: G independent LSTMs advanced in lockstep over T steps.

Counterpart of ``gcn_tpu.ops.pallas.lstm_scan``.  On a CUDA tensor
``lstm_scan_forward`` launches the hand-written kernel in
``csrc/lstm_scan.cu`` and ``lstm_scan_backward`` the ones in
``csrc/lstm_scan_backward.cu`` (the gates, the BPTT chain and dW_hh, three
launches from one entry point); on a CPU tensor they run
``lstm_scan_plain`` and ``lstm_scan_backward_plain``, the same functions as
Python loops over t.  ``lstm_scan`` ties them together as a
``torch.autograd.Function``, as ``jax.custom_vjp`` ties the Pallas kernels.
Layouts are the JAX kernel's: ``xp [T, G, B, 4H]`` (gate order i, f, g, o),
``w_hh [G, H, 4H]``.

Both kernels run one thread-block cluster per (direction, tile of batch
rows), each CTA holding the gate columns of its share of the hidden units
in shared memory (``csrc/lstm_cluster.cuh``).  ``scan_plan`` makes that
partition from the shapes alone, so the CPU tests check it.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from gcn_tpu_torch.ops._cuda import CudaKernel

_P, _I = ctypes.c_void_p, ctypes.c_int
_PLAN = [_I] * 6  # cluster, rows, rows_per_thread, resident, threads, smem
KERNEL = CudaKernel("lstm_scan.cu", {
    **{name: [_P] * 6 + [_I] * 4 + _PLAN + [_P]
       for name in ("lstm_scan_forward_f32", "lstm_scan_forward_bf16")},
    "lstm_scan_forward_max_clusters": [_I] * 3 + _PLAN + [_P],
})
_SYMBOL = {torch.float32: "lstm_scan_forward_f32",
           torch.bfloat16: "lstm_scan_forward_bf16"}
BACKWARD_KERNEL = CudaKernel("lstm_scan_backward.cu", {
    **{name: [_P] * 10 + [_I] * 4 + _PLAN + [_P]
       for name in ("lstm_scan_backward_f32", "lstm_scan_backward_bf16")},
    "lstm_scan_backward_max_clusters": [_I] * 3 + _PLAN + [_P],
    "lstm_scan_backward_dw_slices": [_I, _I],
})
_BACKWARD_SYMBOL = {torch.float32: "lstm_scan_backward_f32",
                    torch.bfloat16: "lstm_scan_backward_bf16"}

SMEM_LIMIT = 232448   # bytes of shared memory one block may use (H100)
MAX_THREADS = 512     # the scan kernels' __launch_bounds__
CLUSTER = 16          # CTAs in a cluster (above 8: non-portable, H100) and
ROWS = 16             # rows per cluster, chosen by timing at the C-GCN's
                      # shapes (PERF.md)


@dataclass(frozen=True)
class ScanPlan:
    """The partition of one scan launch: a cluster of ``cluster`` CTAs per
    (direction, tile of ``rows`` batch rows); CTA rank r owns the hidden
    units ``unit_ranges()[r]`` (at most ``units``) and their four gate
    columns, held in shared memory if ``resident`` (else read from L2 each
    step); a thread takes ``rows_per_thread`` rows of one unit.
    ``smem_bytes`` is the dynamic shared memory of the forward's CTA, or of
    the backward chain's (``backward``)."""
    hd: int
    cluster: int
    rows: int
    units: int
    rows_per_thread: int
    threads: int
    smem_bytes: int
    resident: bool
    backward: bool

    def unit_ranges(self) -> list[tuple[int, int]]:
        """(first unit, count) of each rank: the first H % C ranks take
        one unit more (``Layout::unit0`` / ``unit_count``)."""
        q, rem = divmod(self.hd, self.cluster)
        return [(r * q + min(r, rem), q + (r < rem))
                for r in range(self.cluster)]

    def row_tiles(self, b: int) -> list[tuple[int, int]]:
        """(first row, count) of each cluster's tile of the B rows."""
        return [(r0, min(self.rows, b - r0)) for r0 in range(0, b, self.rows)]

    def args(self) -> tuple[int, ...]:
        """The plan's arguments of the C entry points."""
        return (self.cluster, self.rows, self.rows_per_thread,
                int(self.resident), self.threads, self.smem_bytes)


def _padded_ld(n: int) -> int:
    """``tf32x3::padded_ld``: n (a multiple of 8) rounded up to 8 or 24
    mod 32 floats."""
    while n % 32 not in (8, 24):
        n += 8
    return n


def _layout(hd, cluster, rows, rr, backward):
    """(threads, slice floats, other floats) of the CTA's shared memory:
    ``make_layout`` and ``Layout`` of lstm_cluster.cuh."""
    hp = -(-hd // 8) * 8
    h_ld = hp + (4 if hp // 4 % 2 == 0 else 0)
    rows_pad = -(-rows // 16) * 16
    units = -(-hd // cluster)
    cols = -(-4 * units // 8) * 8
    ldw = cols + 4 if backward else _padded_ld(cols)
    tile, h_tile = rows_pad * ldw, rows_pad * h_ld
    elem_warps = -(-rows // (8 * rr)) * -(-units // 4)
    if backward:  # send_partials: 16 rows x 32 units an item
        work = rows_pad // 16 * -(-hd // 32)
        rest = tile + 2 * cluster * units * rows_pad
    else:  # the gate product's 16 x 8 tiles
        work = rows_pad // 16 * (cols // 8)
        rest = 2 * h_tile + tile
    threads = 32 * max(elem_warps, min(work, MAX_THREADS // 32))
    return threads, hp * ldw, rest


def scan_plan(b: int, hd: int, backward: bool = False) -> ScanPlan:
    """The partition of a scan over B rows of H units: clusters of
    ``CLUSTER`` CTAs (at most H) over tiles of ``ROWS`` rows (at most B).
    The slice of w_hh stays resident where the CTA's shared memory fits
    it; past that (H above 400 at B=50) it streams from L2, the tile
    shrinking until the CTA fits.  A thread takes the fewest rows (1 or 2)
    that keep a CTA within 512 threads (warps of 8 rows by 4 units, and up
    to a warp for each tile of the step's product)."""
    if b < 1 or hd < 1:
        raise ValueError(f"scan_plan: empty scan (B={b}, H={hd})")
    c = min(CLUSTER, hd)

    def make(r, res):
        for rr in (1, 2):
            threads, slice_floats, rest = _layout(hd, c, r, rr, backward)
            if threads <= MAX_THREADS:
                break
        else:
            return None
        smem = 4 * ((slice_floats if res else 0) + rest)
        if smem > SMEM_LIMIT:
            return None
        return ScanPlan(hd, c, r, -(-hd // c), rr, threads, smem, res,
                        backward)

    r = min(ROWS, b)
    plan = make(r, True)
    while plan is None and r >= 1:
        plan = make(r, False)
        r //= 2
    if plan is None:
        raise ValueError(f"scan_plan: no partition of B={b}, H={hd} fits "
                         f"a CTA")
    return plan


def lstm_scan_plain(xp, lengths, w_hh, keep=None):
    """Plain PyTorch version: (h_states, c_states), each [T, G, B, H] in
    xp's dtype; f32 gate math; rows freeze at ``t >= length``; ``keep``
    ([T, G, B] float) multiplies the carry before step t."""
    t_dim, g_dim, b, h4 = xp.shape
    hd = h4 // 4
    w = w_hh.float()
    h = xp.new_zeros((g_dim, b, hd), dtype=torch.float32)
    c = torch.zeros_like(h)
    hs, cs = [], []
    for t in range(t_dim):
        if keep is not None:
            k = keep[t].float()[:, :, None]
            h = h * k
            c = c * k
        gates = xp[t].float() + torch.bmm(h, w)
        i, f, g, o = gates.split(hd, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        valid = (lengths > t)[None, :, None]
        h = torch.where(valid, h_new, h)
        c = torch.where(valid, c_new, c)
        hs.append(h)
        cs.append(c)
    return (torch.stack(hs).to(xp.dtype), torch.stack(cs).to(xp.dtype))


def _check(fname, xp, lengths, w_hh, keep, states=()):
    """Device, type, shape and contiguity checks of the CUDA wrappers."""
    if xp.device.type != "cuda":
        raise ValueError(f"{fname}: unsupported device {xp.device}")
    if xp.dim() != 4 or xp.shape[-1] % 4:
        raise ValueError(f"xp must be [T, G, B, 4H], got {tuple(xp.shape)}")
    t_dim, g_dim, b, h4 = xp.shape
    hd = h4 // 4
    if xp.dtype not in _SYMBOL:
        raise TypeError(f"{fname}: unsupported dtype {xp.dtype}")
    if w_hh.dtype != xp.dtype or tuple(w_hh.shape) != (g_dim, hd, h4):
        raise ValueError(f"w_hh must be [{g_dim}, {hd}, {h4}] {xp.dtype}, "
                         f"got {tuple(w_hh.shape)} {w_hh.dtype}")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (b,):
        raise ValueError("lengths must be [B] int32")
    if keep is not None and (keep.dtype != torch.float32
                             or tuple(keep.shape) != (t_dim, g_dim, b)):
        raise ValueError("keep must be [T, G, B] float32")
    for name, a, dtype in states:
        if a.dtype != dtype or tuple(a.shape) != (t_dim, g_dim, b, hd):
            raise ValueError(f"{name} must be [{t_dim}, {g_dim}, {b}, {hd}] "
                             f"{dtype}, got {tuple(a.shape)} {a.dtype}")
    operands = [xp, lengths, w_hh] + [a for _, a, _ in states]
    for a in operands + ([keep] if keep is not None else []):
        if a.device != xp.device:
            raise ValueError(f"{fname}: operands on different devices")
        if not a.is_contiguous():
            raise ValueError(f"{fname}: operands must be contiguous")
    return t_dim, g_dim, b, hd


def lstm_scan_forward(xp, lengths, w_hh, keep=None):
    """(h_states, c_states) [T, G, B, H] of the masked LSTM scan: the CUDA
    kernel for CUDA tensors (partitioned by ``scan_plan``),
    ``lstm_scan_plain`` for CPU tensors."""
    if xp.device.type == "cpu":
        return lstm_scan_plain(xp, lengths, w_hh, keep)
    t_dim, g_dim, b, hd = _check("lstm_scan_forward", xp, lengths, w_hh,
                                 keep)
    h_out = torch.empty((t_dim, g_dim, b, hd), dtype=xp.dtype,
                        device=xp.device)
    c_out = torch.empty_like(h_out)
    if h_out.numel() == 0:
        return h_out, c_out
    plan = scan_plan(b, hd)
    with torch.cuda.device(xp.device):
        KERNEL.launch(
            _SYMBOL[xp.dtype], xp.data_ptr(), lengths.data_ptr(),
            w_hh.data_ptr(), keep.data_ptr() if keep is not None else None,
            h_out.data_ptr(), c_out.data_ptr(), t_dim, g_dim, b, hd,
            *plan.args(), torch.cuda.current_stream(xp.device).cuda_stream,
        )
    return h_out, c_out


def lstm_scan_backward_plain(gy, xp, lengths, w_hh, h, c, keep=None):
    """Plain PyTorch version of the full-BPTT backward: (dxp [T, G, B, 4H],
    dw_hh [G, H, 4H]), both f32.  ``gy`` [T, G, B, H] f32 must be zero at
    ``t >= length``; ``h``/``c`` are the forward's states.  Gates are
    recomputed from ``xp + h_prev @ w_hh``; frozen rows pass dh/dc through
    to t-1; ``keep[t]`` scales h_prev, c_prev and the cotangent sent back."""
    t_dim, g_dim, b, h4 = xp.shape
    hd = h4 // 4
    w = w_hh.float()
    w_t = w.transpose(1, 2)
    dh = xp.new_zeros((g_dim, b, hd), dtype=torch.float32)
    dc = torch.zeros_like(dh)
    dw = xp.new_zeros((g_dim, hd, h4), dtype=torch.float32)
    dxp = xp.new_empty((t_dim, g_dim, b, h4), dtype=torch.float32)
    for t in reversed(range(t_dim)):
        if t > 0:
            h_prev, c_prev = h[t - 1].float(), c[t - 1].float()
        else:
            h_prev, c_prev = torch.zeros_like(dh), torch.zeros_like(dh)
        kp = keep[t].float()[:, :, None] if keep is not None else None
        if kp is not None:
            h_prev, c_prev = h_prev * kp, c_prev * kp
        gates = xp[t].float() + torch.bmm(h_prev, w)
        i, f, g, o = gates.split(hd, dim=-1)
        i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                      torch.sigmoid(o))
        dh_tot = dh + gy[t].float()
        tc = torch.tanh(c[t].float())
        dc_all = dc + dh_tot * o * (1.0 - tc * tc)
        dgates = torch.cat([dc_all * g * i * (1.0 - i),
                            dc_all * c_prev * f * (1.0 - f),
                            dc_all * i * (1.0 - g * g),
                            dh_tot * tc * o * (1.0 - o)], dim=-1)
        valid = (lengths > t)[None, :, None]
        dgates = torch.where(valid, dgates, 0.0)
        dh_prev = torch.bmm(dgates, w_t)
        dc_prev = dc_all * f
        if kp is not None:
            dh_prev, dc_prev = dh_prev * kp, dc_prev * kp
        dh = torch.where(valid, dh_prev, dh_tot)
        dc = torch.where(valid, dc_prev, dc)
        dw += torch.bmm(h_prev.transpose(1, 2), dgates)
        dxp[t] = dgates
    return dxp, dw


def lstm_scan_backward(gy, xp, lengths, w_hh, h, c, keep=None):
    """(dxp [T, G, B, 4H], dw_hh [G, H, 4H]), both f32: the CUDA kernels for
    CUDA tensors (the chain partitioned by ``scan_plan(..., backward=True)``),
    ``lstm_scan_backward_plain`` for CPU tensors."""
    if xp.device.type == "cpu":
        return lstm_scan_backward_plain(gy, xp, lengths, w_hh, h, c, keep)
    t_dim, g_dim, b, hd = _check(
        "lstm_scan_backward", xp, lengths, w_hh, keep,
        states=(("gy", gy, torch.float32), ("h", h, xp.dtype),
                ("c", c, xp.dtype)))
    dxp = torch.empty((t_dim, g_dim, b, 4 * hd), dtype=torch.float32,
                      device=xp.device)
    dw = torch.empty((g_dim, hd, 4 * hd), dtype=torch.float32,
                     device=xp.device)
    if dxp.numel() == 0:
        return dxp, dw.zero_()
    plan = scan_plan(b, hd, backward=True)
    # the gates of every step, formed ahead of the chain
    gates = torch.empty_like(dxp)
    with torch.cuda.device(xp.device):
        BACKWARD_KERNEL.launch(
            _BACKWARD_SYMBOL[xp.dtype], gy.data_ptr(), xp.data_ptr(),
            h.data_ptr(), c.data_ptr(), w_hh.data_ptr(),
            keep.data_ptr() if keep is not None else None,
            lengths.data_ptr(), gates.data_ptr(), dxp.data_ptr(),
            dw.data_ptr(), t_dim, g_dim, b, hd, *plan.args(),
            torch.cuda.current_stream(xp.device).cuda_stream,
        )
    return dxp, dw


def max_active_clusters(plan: ScanPlan, g_dim: int) -> int:
    """``cudaOccupancyMaxActiveClusters`` of the plan's f32 launch (the
    forward, or the backward's chain) on the current card."""
    out = ctypes.c_int(0)
    args = (plan.rows, g_dim, plan.hd, *plan.args())
    if plan.backward:
        BACKWARD_KERNEL.query("lstm_scan_backward_max_clusters", *args,
                              ctypes.byref(out))
    else:
        KERNEL.query("lstm_scan_forward_max_clusters", *args,
                     ctypes.byref(out))
    return out.value


class LstmScan(torch.autograd.Function):
    """``(h_states, c_states)`` of the masked scan with the full-BPTT
    backward (``_lstm_scan_core`` of the JAX package); ``c_states`` is not
    differentiable.  ``use_kernel=False`` runs the plain versions both ways
    on any device (the JAX package's ``rnn_impl="scan"`` skips its kernel
    likewise)."""

    @staticmethod
    def forward(ctx, xp, lengths, w_hh, keep, use_kernel):
        fwd = lstm_scan_forward if use_kernel else lstm_scan_plain
        h, c = fwd(xp, lengths, w_hh, keep)
        ctx.save_for_backward(xp, lengths, w_hh, h, c, keep)
        ctx.use_kernel = use_kernel
        ctx.mark_non_differentiable(c)
        return h, c

    @staticmethod
    def backward(ctx, gy, _gc):
        xp, lengths, w_hh, h, c, keep = ctx.saved_tensors
        # frozen rows copy h[t-1]: their cotangent reaches t-1 through the
        # carry inside the backward, so gy must be zero past the length
        tpos = torch.arange(gy.shape[0], device=gy.device)[:, None, None, None]
        gy = torch.where(tpos < lengths[None, None, :, None], gy.float(),
                         0.0).contiguous()
        bwd = lstm_scan_backward if ctx.use_kernel else \
            lstm_scan_backward_plain
        dxp, dw = bwd(gy, xp, lengths, w_hh, h, c, keep)
        return dxp.to(xp.dtype), None, dw.to(w_hh.dtype), None, None


def lstm_scan(xp, lengths, w_hh, keep=None, use_kernel: bool = True):
    """Differentiable h_states [T, G, B, H] of the masked scan (see
    ``LstmScan``)."""
    h, _ = LstmScan.apply(xp, lengths, w_hh, keep, use_kernel)
    return h
