"""The deprel-conditioned bilinear transform over flattened tokens.

Counterpart of ``gcn_tpu.ops.pallas.deprel_bilinear``:

    out[m, h] = Σ_d e[m, d] · (x[m] @ W[d])[h]   (+ e @ b)

with x [M, T], e [M, D], W [D, T, H] and b [D, H], the per-token transform
of the non-factored ``full_deprel`` layer (the reference's
``traverse_deprel``).  Two kernels compute it, as in JAX, both in
``csrc/deprel_bilinear.cu``: v2 (``deprel_bilinear_v2`` and
``deprel_bilinear_batched``, what the model runs) and v1 (the public
``deprel_bilinear``), both an implicit GEMM over K = D·T on the tensor
cores in 3xTF32 (``csrc/tf32x3_tile.cuh``, f32-level error), summing each
output over t chunks, then d, then the d slices they split K into (the
slices' partials go through a scratch the wrapper allocates).  v2 scales
its operand by e (``e ⊗ x``); v1 multiplies x itself and scales each
chunk's product by ``e[:, d]`` as it adds it in, streaming over d.  On a
CPU tensor each runs its plain version: v2 forms the [M, D·T] operand
``e ⊗ x`` and multiplies it with W as [D·T, H]; v1 loops over d.

``DeprelBilinear`` is the ``torch.autograd.Function``; its backward
computes what JAX's ``_core_bwd`` computes,

    dx = Σ_d e_d ⊙ (g W_dᵀ),   de[:, d] = Σ_h (x W_d) ⊙ g,
    dW_d = (x ⊙ e_d)ᵀ g,

with three batched products instead of a scan over d: ``G = g Wᵀ`` as
[M, D, T] once, then ``dx`` and ``de`` as batched contractions of G, and
``dW`` as ``xᵀ (e ⊗ g)``.  JAX also leaves that backward to plain
matmuls.  The bias term ``e @ b`` stays outside the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from gcn_tpu_torch.ops._cuda import CudaKernel

_P, _I = ctypes.c_void_p, ctypes.c_int
# deprel_bilinear_sum_launches() counts the slice sums that either
# version's launcher launched (one a call that splits K into slices)
KERNEL_V2 = CudaKernel("deprel_bilinear.cu", {
    "deprel_bilinear_v2_f32": [_P] * 5 + [_I] * 5 + [_P],
    "deprel_bilinear_slices": [_I] * 3,
    "deprel_bilinear_sum_launches": []}, name="deprel_bilinear_v2")
KERNEL_V1 = CudaKernel("deprel_bilinear.cu", {
    "deprel_bilinear_v1_f32": [_P] * 5 + [_I] * 5 + [_P],
    "deprel_bilinear_slices": [_I] * 3,
    "deprel_bilinear_sum_launches": []}, name="deprel_bilinear_v1")
_KERNELS = {"v2": (KERNEL_V2, "deprel_bilinear_v2_f32"),
            "v1": (KERNEL_V1, "deprel_bilinear_v1_f32")}


def bilinear_v2_plain(x, e, w):
    """Plain PyTorch version of v2: ``(e ⊗ x) @ W`` over K = D·T."""
    m, t = x.shape
    d, _, h = w.shape
    z = (e[:, :, None] * x[:, None, :]).reshape(m, d * t)
    return z @ w.reshape(d * t, h)


def bilinear_v1_plain(x, e, w):
    """Plain PyTorch version of v1: ``Σ_d e[:, d] · (x @ W[d])``."""
    out = torch.zeros((x.shape[0], w.shape[2]), dtype=x.dtype,
                      device=x.device)
    for d in range(w.shape[0]):
        out = out + e[:, d:d + 1] * (x @ w[d])
    return out


_PLAIN = {"v2": bilinear_v2_plain, "v1": bilinear_v1_plain}


def bilinear_forward(x, e, w, version: str = "v2"):
    """``Σ_d e[:, d] · (x @ W[d])`` for x [M, T], e [M, D], W [D, T, H],
    f32 → [M, H]: the CUDA kernel ``version`` ("v2" or "v1") for CUDA
    tensors, its plain version for CPU tensors."""
    if x.device.type == "cpu":
        return _PLAIN[version](x, e, w)
    kernel, fname = _KERNELS[version]
    if x.dim() != 2 or e.dim() != 2 or w.dim() != 3 \
            or e.shape[0] != x.shape[0] or w.shape[:2] != (e.shape[1],
                                                          x.shape[1]):
        raise ValueError(f"{fname}: x [M, T], e [M, D] and w [D, T, H] "
                         f"expected, got {tuple(x.shape)}, "
                         f"{tuple(e.shape)}, {tuple(w.shape)}")
    for a in (x, e, w):
        if a.dtype != torch.float32:
            raise TypeError(f"{fname}: unsupported dtype {a.dtype}")
        if a.device != x.device:
            raise ValueError(f"{fname}: operands on different devices")
        if not a.is_contiguous():
            raise ValueError(f"{fname}: operands must be contiguous")
    (m, t), (d, _, h) = x.shape, w.shape
    out = torch.empty((m, h), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        # K is split over d into slices whose partials a second kernel of
        # the same call sums in order
        slices = kernel.load().deprel_bilinear_slices(m, d, h)
        part = (torch.empty((slices, m, h), dtype=torch.float32,
                            device=x.device) if slices > 1 else out)
        kernel.launch(fname, x.data_ptr(), e.data_ptr(), w.data_ptr(),
                      out.data_ptr(), part.data_ptr(), m, t, d, h, slices,
                      torch.cuda.current_stream(x.device).cuda_stream)
    return out


def bilinear_backward(x, e, w, g):
    """``(dx, de, dW)`` of ``Σ_d e_d (x W_d)`` for the cotangent g [M, H]
    (JAX's ``_core_bwd``) in three batched products."""
    m, t = x.shape
    d, _, h = w.shape
    gw = (g @ w.reshape(d * t, h).T).reshape(m, d, t)     # g W_dᵀ per d
    dx = torch.bmm(e[:, None, :], gw)[:, 0]
    de = torch.bmm(gw, x[:, :, None])[:, :, 0]
    eg = (e[:, :, None] * g[:, None, :]).reshape(m, d * h)
    dw = (x.T @ eg).reshape(t, d, h).transpose(0, 1)
    return dx, de, dw


class DeprelBilinear(torch.autograd.Function):
    """``bilinear_forward`` with the backward of JAX's custom VJP."""

    @staticmethod
    def forward(ctx, x, e, w, version):
        ctx.save_for_backward(x, e, w)
        return bilinear_forward(x, e, w, version)

    @staticmethod
    def backward(ctx, g):
        x, e, w = ctx.saved_tensors
        dx, de, dw = bilinear_backward(x, e, w, g)
        return dx, de, dw, None


def _bilinear(x, e, w, b, version):
    out = DeprelBilinear.apply(x.contiguous(), e.contiguous(),
                               w.contiguous(), version)
    if b is not None:
        out = out + e @ b
    return out


def deprel_bilinear(x, e, w, b=None):
    """Fused ``Σ_d e_d (x @ W_d)`` (+ ``e @ b``) over flattened tokens by
    the d-streamed kernel (v1).  x [M, T], e [M, D], w [D, T, H], b
    [D, H] or None → [M, H]."""
    return _bilinear(x, e, w, b, "v1")


def deprel_bilinear_v2(x, e, w, b=None):
    """The same function by the implicit-GEMM kernel (v2)."""
    return _bilinear(x, e, w, b, "v2")


def deprel_bilinear_batched(x, e, w, b=None):
    """[B, N, T] × [B, N, D] → [B, N, H] through v2 (flattens tokens)."""
    bsz, n, t = x.shape
    out = deprel_bilinear_v2(x.reshape(bsz * n, t),
                             e.reshape(bsz * n, -1), w, b)
    return out.reshape(bsz, n, -1)
