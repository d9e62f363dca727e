"""Grouped (ragged) matmul ``y[m] = x[m] @ s[gid(m)]`` over group-sorted rows.

Counterpart of ``gcn_tpu.ops.pallas.grouped_matmul``.  On a CUDA tensor
``grouped_matmul`` launches the hand-written kernel in
``csrc/grouped_matmul.cu`` and ``grouped_matmul_backward`` the pair in
``csrc/grouped_matmul_backward.cu`` (``dx = g @ s[gid]ᵀ`` and
``ds[r] = x_rᵀ g_r``); on a CPU tensor they run ``grouped_matmul_plain``
and ``grouped_matmul_backward_plain``, loops over the groups.
``grouped_matmul_fn`` ties them together as a ``torch.autograd.Function``.
Rows past ``sum(group_sizes)`` belong to the last group, as in the JAX
kernel.
"""

from __future__ import annotations

import ctypes

import torch

from gcn_tpu_torch.ops._cuda import CudaKernel

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("grouped_matmul.cu", {
    name: [_P, _P, _P, _P, _I, _I, _I, _I, _P]
    for name in ("grouped_matmul_forward_f32", "grouped_matmul_forward_bf16")
})
_SYMBOL = {torch.float32: "grouped_matmul_forward_f32",
           torch.bfloat16: "grouped_matmul_forward_bf16"}
BACKWARD_KERNEL = CudaKernel("grouped_matmul_backward.cu", {
    **{name: [_P] * 7 + [_I] * 4 + [_P]
       for name in ("grouped_matmul_backward_f32",
                    "grouped_matmul_backward_bf16")},
    "grouped_matmul_backward_partials": [_I],
})
_BACKWARD_SYMBOL = {torch.float32: "grouped_matmul_backward_f32",
                    torch.bfloat16: "grouped_matmul_backward_bf16"}


def grouped_matmul_plain(x, s, group_sizes):
    """Plain PyTorch version: one f32 matmul per non-empty group; output in
    x's dtype."""
    m = x.shape[0]
    r, _, h = s.shape
    ends = torch.cumsum(group_sizes.long(), 0).tolist()
    y = x.new_zeros((m, h), dtype=torch.float32)
    start = 0
    for g, end in enumerate(ends):
        stop = max(end, m) if g == r - 1 else end
        if stop > start:
            y[start:stop] = x[start:stop].float() @ s[g].float()
        start = end
    return y.to(x.dtype)


def _check(fname, x, s, group_sizes, g=None):
    """Device, type, shape and contiguity checks of the CUDA wrappers."""
    if x.device.type != "cuda":
        raise ValueError(f"{fname}: unsupported device {x.device}")
    if x.dim() != 2 or s.dim() != 3 or s.shape[1] != x.shape[1]:
        raise ValueError(f"x must be [M, T] and s [R, T, H], got "
                         f"{tuple(x.shape)} and {tuple(s.shape)}")
    m, t = x.shape
    r, _, h = s.shape
    if x.dtype not in _SYMBOL or s.dtype != x.dtype:
        raise TypeError(f"{fname}: unsupported dtypes {x.dtype}, {s.dtype}")
    if tuple(group_sizes.shape) != (r,) or group_sizes.is_floating_point():
        raise ValueError(f"group_sizes must be [{r}] integers")
    if g is not None and (g.dtype != x.dtype or tuple(g.shape) != (m, h)):
        raise ValueError(f"g must be [{m}, {h}] {x.dtype}, got "
                         f"{tuple(g.shape)} {g.dtype}")
    for a in (x, s, group_sizes) + ((g,) if g is not None else ()):
        if a.device != x.device:
            raise ValueError(f"{fname}: operands on different devices")
        if not a.is_contiguous():
            raise ValueError(f"{fname}: operands must be contiguous")
    return m, t, r, h


def grouped_matmul(x, s, group_sizes):
    """``y[m] = x[m] @ s[gid(m)]``: x [M, T] (group-contiguous rows),
    s [R, T, H], group_sizes [R] int (summing to at most M) → [M, H]."""
    if x.device.type == "cpu":
        return grouped_matmul_plain(x, s, group_sizes)
    m, t, r, h = _check("grouped_matmul", x, s, group_sizes)
    y = torch.empty((m, h), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    group_ends = torch.cumsum(group_sizes, 0, dtype=torch.int32)
    with torch.cuda.device(x.device):
        KERNEL.launch(
            _SYMBOL[x.dtype], x.data_ptr(), s.data_ptr(),
            group_ends.data_ptr(), y.data_ptr(), m, t, h, r,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    return y


def grouped_matmul_backward_plain(x, g, s, group_sizes):
    """Plain PyTorch version of the backward: (dx [M, T] in x's dtype,
    ds [R, T, H] f32), one f32 matmul pair per group.  ``ds`` is zero for a
    group with no rows, the last one included when rows past
    ``sum(group_sizes)`` exist (as the JAX kernel's caller masks it)."""
    m = x.shape[0]
    r, t, h = s.shape
    ends = torch.cumsum(group_sizes.long(), 0).tolist()
    dx = x.new_zeros((m, t), dtype=torch.float32)
    ds = x.new_zeros((r, t, h), dtype=torch.float32)
    start = 0
    for grp, end in enumerate(ends):
        stop = max(end, m) if grp == r - 1 else end
        if stop > start:
            g_rows = g[start:stop].float()
            dx[start:stop] = g_rows @ s[grp].float().T
            if end > start:
                ds[grp] = x[start:stop].float().T @ g_rows
        start = end
    return dx.to(x.dtype), ds


def grouped_matmul_backward(x, g, s, group_sizes):
    """(dx [M, T] in x's dtype, ds [R, T, H] f32) for the cotangent g
    [M, H] (in x's dtype): the CUDA kernels for CUDA tensors,
    ``grouped_matmul_backward_plain`` for CPU tensors."""
    if x.device.type == "cpu":
        return grouped_matmul_backward_plain(x, g, s, group_sizes)
    m, t, r, h = _check("grouped_matmul_backward", x, s, group_sizes, g)
    dx = torch.empty((m, t), dtype=x.dtype, device=x.device)
    ds = torch.empty((r, t, h), dtype=torch.float32, device=x.device)
    if dx.numel() == 0 or ds.numel() == 0:
        return dx.zero_(), ds.zero_()
    group_ends = torch.cumsum(group_sizes, 0, dtype=torch.int32)
    # a group of more than 256 rows sums its dS from per-chunk partials
    slots = BACKWARD_KERNEL.load().grouped_matmul_backward_partials(m)
    part = torch.empty((slots, t, h), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        BACKWARD_KERNEL.launch(
            _BACKWARD_SYMBOL[x.dtype], x.data_ptr(), g.data_ptr(),
            s.data_ptr(), group_ends.data_ptr(), dx.data_ptr(),
            ds.data_ptr(), part.data_ptr(), m, t, h, r,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    return dx, ds


class GroupedMatmul(torch.autograd.Function):
    """``grouped_matmul`` with the backward of the JAX package's custom VJP
    (``_gmm_bwd``).  ``use_kernel=False`` runs the plain versions both ways
    on any device (the JAX package's ``deprel_factored="ragged"``)."""

    @staticmethod
    def forward(ctx, x, s, group_sizes, use_kernel):
        fwd = grouped_matmul if use_kernel else grouped_matmul_plain
        ctx.save_for_backward(x, s, group_sizes)
        ctx.use_kernel = use_kernel
        return fwd(x, s, group_sizes)

    @staticmethod
    def backward(ctx, gy):
        x, s, group_sizes = ctx.saved_tensors
        bwd = grouped_matmul_backward if ctx.use_kernel else \
            grouped_matmul_backward_plain
        dx, ds = bwd(x, gy.to(x.dtype).contiguous(), s, group_sizes)
        return dx, ds.to(s.dtype), None, None


def grouped_matmul_fn(x, s, group_sizes, use_kernel: bool = True):
    """Differentiable ``grouped_matmul`` (see ``GroupedMatmul``)."""
    return GroupedMatmul.apply(x, s, group_sizes, use_kernel)
