"""The deprel-conditioned bilinear transform over flattened tokens.

Counterpart of ``gcn_tpu.ops.pallas.deprel_bilinear``:

    out[m, h] = Σ_d e[m, d] · (x[m] @ W[d])[h]   (+ e @ b)

with x [M, T], e [M, D], W [D, T, H] and b [D, H], the per-token transform
of the non-factored ``full_deprel`` layer (the reference's
``traverse_deprel``).  Two kernels compute it, as in JAX, both in
``csrc/deprel_bilinear.cu``: v2 (``deprel_bilinear_v2`` and
``deprel_bilinear_batched``, what the model runs) and v1 (the public
``deprel_bilinear``).  Each splits K = D·T into d slices whose f32
partials go through a scratch the wrapper allocates and are summed in
slice order by a second launch of the same call.  In f32 both are an
implicit GEMM on the tensor cores in 3xTF32 (``csrc/tf32x3_tile.cuh``,
f32-level error), summing each output over t chunks, then d: v2 scales
its operand by e (``e ⊗ x``); v1 multiplies x itself and scales each
chunk's product by ``e[:, d]`` as it adds it in, streaming over d.  In
bf16 both run one kernel on the bf16 tensor cores (``wgmma``): for each d
``y_d = x W_d`` over all of T (per 512-wide pass of t beyond that) with
f32 sums, then ``acc += e[:, d] · y_d`` in f32, JAX's ``_kernel_v2``
order.  On a CPU tensor each runs its plain version: v2 forms the [M, D·T]
operand ``e ⊗ x`` and multiplies it with W as [D·T, H]; v1 loops over d.

``DeprelBilinear`` is the ``torch.autograd.Function``; its backward
computes what JAX's ``_core_bwd`` computes,

    dx = Σ_d e_d ⊙ (g W_dᵀ),   de[:, d] = Σ_h (x W_d) ⊙ g,
    dW_d = (x ⊙ e_d)ᵀ g,

with three batched products instead of a scan over d: ``G = g Wᵀ`` as
[M, D, T] once, then ``dx`` and ``de`` as batched contractions of G, and
``dW`` as ``xᵀ (e ⊗ g)``.  JAX also leaves that backward to plain
matmuls.  The bias term ``e @ b`` stays outside the kernels.

x, e and W are f32 or bf16 (one dtype a call), and the output takes x's
dtype, as the Pallas kernels' ``out_shape`` does.  In bf16 both kernels
(their ``_bf16`` instances) and their plain versions sum in f32 and round
the output once: the rounding of JAX's v2 (``_kernel_v2``: its product
and gating in f32, one ``.astype``; a bf16 × bf16 product is exact in
f32, so only the sums round before it).  JAX's v1 adds each d's term
into its bf16 output block and so rounds D times; the port's v1 rounds
once, as its v2 (closer to f32, within the gap rule of
``tests/test_torch_port_bf16.py``).  The bias follows JAX's two roundings,
``out + (e @ b)`` with ``e @ b`` in the operands' dtype.  The backward runs
its three products in the operands' dtype, G included (so G, 384 MB in
f32 at M = 4800, T = 400, D = 50, is half that in bf16), each rounding its
result once; JAX's ``_core_bwd`` carries ``dx`` in bf16 across its D steps
and so rounds it D times.
"""

from __future__ import annotations

import ctypes

import torch

from gcn_tpu_torch.ops._cuda import CudaKernel

_P, _I = ctypes.c_void_p, ctypes.c_int
# deprel_bilinear_sum_launches() counts the slice sums that either
# version's launcher launched (one a call that splits K into slices)
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
KERNEL_V2 = CudaKernel("deprel_bilinear.cu", {
    **{f"deprel_bilinear_v2_{t}": [_P] * 5 + [_I] * 5 + [_P]
       for t in _SUFFIX.values()},
    "deprel_bilinear_slices": [_I] * 3,
    "deprel_bilinear_sum_launches": []}, name="deprel_bilinear_v2")
KERNEL_V1 = CudaKernel("deprel_bilinear.cu", {
    **{f"deprel_bilinear_v1_{t}": [_P] * 5 + [_I] * 5 + [_P]
       for t in _SUFFIX.values()},
    "deprel_bilinear_slices": [_I] * 3,
    "deprel_bilinear_sum_launches": []}, name="deprel_bilinear_v1")
_KERNELS = {"v2": KERNEL_V2, "v1": KERNEL_V1}


def bilinear_v2_plain(x, e, w):
    """Plain PyTorch version of v2: ``(e ⊗ x) @ W`` over K = D·T, in f32
    (bf16 operands widened), the result in x's dtype."""
    m, t = x.shape
    d, _, h = w.shape
    z = (e.float()[:, :, None] * x.float()[:, None, :]).reshape(m, d * t)
    return (z @ w.float().reshape(d * t, h)).to(x.dtype)


def bilinear_v1_plain(x, e, w):
    """Plain PyTorch version of v1: ``Σ_d e[:, d] · (x @ W[d])`` in f32,
    the result in x's dtype."""
    xf, ef, wf = x.float(), e.float(), w.float()
    out = torch.zeros((x.shape[0], w.shape[2]), dtype=torch.float32,
                      device=x.device)
    for d in range(w.shape[0]):
        out = out + ef[:, d:d + 1] * (xf @ wf[d])
    return out.to(x.dtype)


_PLAIN = {"v2": bilinear_v2_plain, "v1": bilinear_v1_plain}


def bilinear_forward(x, e, w, version: str = "v2"):
    """``Σ_d e[:, d] · (x @ W[d])`` for x [M, T], e [M, D], W [D, T, H],
    all f32 or all bf16 → [M, H] in their dtype: the instance for that
    dtype of the CUDA kernel ``version`` ("v2" or "v1") for CUDA tensors,
    its plain version for CPU tensors."""
    if x.device.type == "cpu":
        return _PLAIN[version](x, e, w)
    kernel = _KERNELS[version]
    fname = f"deprel_bilinear_{version}_{_SUFFIX.get(x.dtype, '?')}"
    if x.dim() != 2 or e.dim() != 2 or w.dim() != 3 \
            or e.shape[0] != x.shape[0] or w.shape[:2] != (e.shape[1],
                                                          x.shape[1]):
        raise ValueError(f"{fname}: x [M, T], e [M, D] and w [D, T, H] "
                         f"expected, got {tuple(x.shape)}, "
                         f"{tuple(e.shape)}, {tuple(w.shape)}")
    for a in (x, e, w):
        if a.dtype not in _SUFFIX or a.dtype != x.dtype:
            raise TypeError(f"{fname}: unsupported dtypes {x.dtype}, "
                            f"{e.dtype}, {w.dtype}")
        if a.device != x.device:
            raise ValueError(f"{fname}: operands on different devices")
        if not a.is_contiguous():
            raise ValueError(f"{fname}: operands must be contiguous")
    (m, t), (d, _, h) = x.shape, w.shape
    out = torch.empty((m, h), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        # K is split over d into slices whose f32 partials a second kernel
        # of the same call sums in order
        slices = kernel.load().deprel_bilinear_slices(m, d, h)
        part = (torch.empty((slices, m, h), dtype=torch.float32,
                            device=x.device) if slices > 1 else out)
        kernel.launch(fname, x.data_ptr(), e.data_ptr(), w.data_ptr(),
                      out.data_ptr(), part.data_ptr(), m, t, d, h, slices,
                      torch.cuda.current_stream(x.device).cuda_stream)
    return out


def bilinear_backward(x, e, w, g):
    """``(dx, de, dW)`` of ``Σ_d e_d (x W_d)`` for the cotangent g [M, H]
    (JAX's ``_core_bwd``) in three batched products, in the operands'
    dtype."""
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
        out = out + (e @ b.to(e.dtype)).to(out.dtype)
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
