"""Per-edge attention scores (SDDMM) and the edge softmax.

Counterpart of ``gcn_tpu.ops.pallas.sddmm``:

    s[b, e] = mask_e · Σ_h u[b, parent_e, h] · v[b, child_e, h]

On a CUDA tensor ``sddmm_forward`` launches the hand-written kernel in
``csrc/sddmm.cu`` and ``sddmm_backward`` its second kernel; on a CPU
tensor each runs its plain version (a gather and a product; a gather, a
product and a ``scatter_add``).  ``sddmm`` ties them together as a
``torch.autograd.Function`` with the contract of JAX's ``_bwd_kernel``:
``ḡ = g·mask``, ``du = sel_pᵀ(ḡ ⊙ v[child])``, ``dv = sel_cᵀ(ḡ ⊙
u[parent])``.  ``edge_softmax`` normalizes scores over each destination's
edges, in plain PyTorch as JAX leaves it to XLA.

An edge counts when its mask is set and both ends lie in [0, N); an edge
with an end outside scores 0 and takes no part in the softmax or the
gradients (JAX's gathers give NaN there, ``ROADMAP.md`` §3).
"""

from __future__ import annotations

import ctypes

import torch

from gcn_tpu_torch.ops._cuda import CudaKernel
from gcn_tpu_torch.ops.band_aggregate import check_edges
from gcn_tpu_torch.ops.spmm import gather_rows, scatter_rows, valid_edges

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("sddmm.cu", {
    "sddmm_forward_f32": [_P] * 6 + [_I] * 4 + [_P]})
BACKWARD_KERNEL = CudaKernel("sddmm.cu", {
    "sddmm_backward_f32": [_P] * 8 + [_I] * 4 + [_P]},
    name="sddmm_backward")


def sddmm_plain(parent, child, mask, u, v):
    """Plain PyTorch version of ``sddmm_forward``."""
    ok = valid_edges(parent, child, mask, u.shape[1])
    s = (gather_rows(u, parent) * gather_rows(v, child)).sum(-1)
    return torch.where(ok, s, torch.zeros((), dtype=s.dtype,
                                          device=s.device))


def _check(fname, parent, child, mask, u, v, extra_smem=0):
    b, n, e = check_edges(fname, parent, child, mask, (u, v), extra_smem)
    if u.shape != v.shape:
        raise ValueError(f"{fname}: u {tuple(u.shape)} and v "
                         f"{tuple(v.shape)} differ")
    return b, n, e


def sddmm_forward(parent, child, mask, u, v):
    """Per-edge scores: parent/child [B, E] int32, mask [B, E] bool, u, v
    [B, N, H] f32 → [B, E] f32.  The CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if u.device.type == "cpu":
        return sddmm_plain(parent, child, mask, u, v)
    b, n, e = _check("sddmm_forward", parent, child, mask, u, v)
    out = torch.empty((b, e), dtype=torch.float32, device=u.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(u.device):
        KERNEL.launch(
            "sddmm_forward_f32", parent.data_ptr(), child.data_ptr(),
            mask.data_ptr(), u.data_ptr(), v.data_ptr(), out.data_ptr(), b,
            n, e, u.shape[2], torch.cuda.current_stream(u.device).cuda_stream)
    return out


def sddmm_backward_plain(parent, child, mask, g, u, v):
    """Plain PyTorch version of ``sddmm_backward``."""
    n = u.shape[1]
    ok = valid_edges(parent, child, mask, n)
    gm = torch.where(ok, g, torch.zeros((), dtype=g.dtype,
                                        device=g.device))[:, :, None]
    du = scatter_rows(gm * gather_rows(v, child), parent, n)
    dv = scatter_rows(gm * gather_rows(u, parent), child, n)
    return du, dv


def sddmm_backward(parent, child, mask, g, u, v):
    """``(du, dv)`` for the cotangent g [B, E] f32: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if u.device.type == "cpu":
        return sddmm_backward_plain(parent, child, mask, g, u, v)
    # the lists also name each entry's edge: two more ints per edge slot
    b, n, e = _check("sddmm_backward", parent, child, mask, u, v,
                     extra_smem=8 * parent.shape[-1])
    if g.shape != (b, e) or g.dtype != torch.float32 \
            or g.device != u.device or not g.is_contiguous():
        raise ValueError(f"sddmm_backward: g must be a contiguous f32 "
                         f"[{b}, {e}] tensor on {u.device}, got "
                         f"{g.dtype} {tuple(g.shape)} on {g.device}")
    du, dv = torch.empty_like(u), torch.empty_like(v)
    if u.numel() == 0:
        return du, dv
    with torch.cuda.device(u.device):
        BACKWARD_KERNEL.launch(
            "sddmm_backward_f32", parent.data_ptr(), child.data_ptr(),
            mask.data_ptr(), g.data_ptr(), u.data_ptr(), v.data_ptr(),
            du.data_ptr(), dv.data_ptr(), b, n, e, u.shape[2],
            torch.cuda.current_stream(u.device).cuda_stream)
    return du, dv


class Sddmm(torch.autograd.Function):
    """``sddmm_forward`` with the backward of JAX's custom VJP."""

    @staticmethod
    def forward(ctx, parent, child, mask, u, v):
        ctx.save_for_backward(parent, child, mask, u, v)
        return sddmm_forward(parent, child, mask, u, v)

    @staticmethod
    def backward(ctx, g):
        parent, child, mask, u, v = ctx.saved_tensors
        du, dv = sddmm_backward(parent, child, mask, g.contiguous(), u, v)
        return None, None, None, du, dv


def sddmm(parent, child, mask, u, v):
    """Differentiable per-edge scores ``u[parent]·v[child]`` (see
    ``Sddmm``); u and v must be contiguous for the kernels."""
    return Sddmm.apply(parent, child, mask, u, v)


def edge_softmax(parent, scores, mask, n: int):
    """Normalize per-edge scores [B, E] over each destination node's edges:

        α_e = exp(s_e) / Σ_{e': parent_e' = parent_e} exp(s_e')

    by a scatter ``amax`` per destination, ``exp`` and a scatter-add of
    the denominators, as JAX does.  An edge with mask 0 or a destination
    outside [0, n) gets weight 0 and adds to no denominator.  The per-node
    maximum is detached: the shift cancels between each weight's
    numerator and denominator, so it changes no gradient beyond float
    error (JAX differentiates through it, to the same values)."""
    ok = mask.bool() & (parent >= 0) & (parent < n)
    dst = parent.long().clamp(0, n - 1)
    neg = torch.full((), -1e30, dtype=scores.dtype, device=scores.device)
    masked = torch.where(ok, scores, neg)
    node_max = torch.full((scores.shape[0], n), -1e30, dtype=scores.dtype,
                          device=scores.device).scatter_reduce(
        1, dst, masked.detach(), "amax")
    shifted = masked - torch.gather(node_max, 1, dst)
    ex = torch.where(ok, torch.exp(shifted), torch.zeros_like(scores))
    denom = torch.zeros_like(node_max).scatter_add(1, dst, ex)
    return ex / torch.gather(denom, 1, dst).clamp(min=1e-30)
