"""The regular-mode GCN layer from padded edge lists, with no [B, N, N] band.

Counterpart of ``gcn_tpu.ops.pallas.spmm_fused``:

    out = relu((((A_f + A_fᵀ + diag(incident) + I) h) W + 2b) / denom)
    denom = deg_out + deg_in + incident + 1

On a CUDA tensor ``gcn_spmm_forward`` launches the hand-written kernel in
``csrc/spmm_fused.cu``, which does the product with W in its own body on
the tensor cores: in f32 in 3xTF32 (``csrc/tf32x3_tile.cuh``: each operand
split into two TF32 parts, three products a k-step, f32-level error), in
bf16 by ``mma.sync.m16n8k16`` on bf16 fragments, f32 sums, while warps of
its own gather ``S h`` (from the sentence's rows staged in shared memory)
into a resident bf16 tile; and
``sym_pair`` (``(S x1, S x2)`` with ``S = A_f + A_fᵀ +
diag(incident + 1)``, the backward's aggregation) its second kernel; both
find each row's neighbours by warp ballots over the edge slots
(``csrc/edge_gather.cuh``).  On a CPU tensor each runs its plain version
(the dense band from ``build_adjacency``, ``torch.bmm`` and
``torch.matmul``).
``fused_gcn_spmm`` ties them together as a ``torch.autograd.Function``
whose backward follows the JAX package's custom VJP: ``gs = g·relu′ /
denom``, ``db = 2Σgs``, ``gw = gs Wᵀ``, ``(dh, Sh) = sym_pair(gw, h)``,
``dW = (Sh)ᵀ gs``; the two small products with W are ``torch.matmul``,
as JAX leaves them to XLA outside its kernel.

Operands are f32 or bf16 (h, w and b of one dtype), as the Pallas kernels
take their input's dtype.  In bf16 both kernels and their plain versions
sum in f32 and round each output to bf16 once, at its store; the forward
also rounds ``S h`` to bf16 before the product with W, where JAX's kernel
rounds it.  The backward follows JAX's rounding points: ``gs`` in f32,
``gw = gs Wᵀ`` from ``gs`` rounded to h's dtype, ``dW`` summed in f32 and
rounded to w's dtype, ``db = 2 Σ gs`` in f32, rounded to w's dtype.
"""

from __future__ import annotations

import ctypes

import torch

from gcn_tpu_torch.ops._cuda import CudaKernel
from gcn_tpu_torch.ops.adjacency import build_adjacency
from gcn_tpu_torch.ops.band_aggregate import (SUFFIX, band_denom,
                                              check_edges, edges_bytes)

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("spmm_fused.cu", {
    f"spmm_fused_forward_{t}": [_P] * 7 + [_I] * 5 + [_P]
    for t in ("f32", "bf16")})
SYM_PAIR_KERNEL = CudaKernel("spmm_fused.cu", {
    f"spmm_fused_sym_pair_{t}": [_P] * 7 + [_I] * 5 + [_P]
    for t in ("f32", "bf16")}, name="spmm_fused_sym_pair")
def forward_smem_bytes(n: int, e: int, itemsize: int = 4) -> int:
    """Shared memory of the forward for E edge slots and operands of
    ``itemsize`` bytes (csrc/spmm_fused.cu).  f32: the slots' parents and
    children, 16-byte aligned, then 48 row degrees, the f32 (S h) tile of
    48 rows x (256 + 4) and three W chunks of 32 x (224 + 8).  bf16
    (``fwd16``): the slots and the warps' neighbour lists, 4E + 48 ints,
    8 barriers, 12 list lengths, 48 row degrees, the bf16 (S h) tile of
    48 rows x (384 + 8), 1 KB of alignment and at least two swizzled W
    chunks of 32 x 256 (up to six where they fit); the kernel also stages
    the sentence's rows of h in shared memory where they fit beside these,
    and reads them from device memory where not."""
    if itemsize == 2:
        return (4 * (4 * e + 48) + 8 * 8 + 4 * (12 + 48) + 2 * 48 * 392
                + 1024 + 2 * 32 * 256 * 2)
    return (edges_bytes(n, e) + 4 * (48 + 48 * 260)
            + itemsize * 3 * 32 * 232)


def _sym_band(parent, child, mask, n, dtype):
    """(A_f + A_fᵀ, incident + 1 as [B, N, 1], denom [B, N, 1])."""
    adj = build_adjacency(parent, child, mask, n, dtype)
    diag = (adj.incident.to(dtype) + 1.0)[..., None]
    return adj.forward + adj.reverse, diag, adj.denom


def gcn_spmm_plain(parent, child, mask, h, w, b):
    """Plain PyTorch version: the dense band, ``torch.bmm`` and
    ``torch.matmul`` in f32, ``S h`` rounded to h's dtype before the
    product with W, the result in h's dtype."""
    band, diag, denom = _sym_band(parent, child, mask, h.shape[1],
                                  torch.float32)
    hf = h.float()
    ah = (torch.bmm(band, hf) + diag * hf).to(h.dtype).float()
    z = (ah @ w.float() + 2.0 * b.float()) / denom
    return torch.relu(z).to(h.dtype)


def gcn_spmm_forward(parent, child, mask, h, w, b):
    """The fused layer: parent/child [B, E] int32, mask [B, E] bool,
    h [B, N, T], w [T, H], b [H], all f32 or all bf16 → [B, N, H] in their
    dtype.  The CUDA kernel's instance for that dtype for CUDA tensors,
    the plain version for CPU tensors."""
    if h.device.type == "cpu":
        return gcn_spmm_plain(parent, child, mask, h, w, b)
    bsz, n, e = check_edges(
        "gcn_spmm_forward", parent, child, mask, (h,),
        lambda n_, e_: forward_smem_bytes(n_, e_, h.element_size()))
    t = h.shape[2]
    if w.dim() != 2 or w.shape[0] != t or b.shape != (w.shape[1],):
        raise ValueError(f"w must be [{t}, H] and b [H], got "
                         f"{tuple(w.shape)} and {tuple(b.shape)}")
    for a in (w, b):
        if a.dtype != h.dtype or a.device != h.device \
                or not a.is_contiguous():
            raise ValueError("w and b must be contiguous, in h's dtype, on "
                             "h's device")
    hdim = w.shape[1]
    out = torch.empty((bsz, n, hdim), dtype=h.dtype, device=h.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(h.device):
        KERNEL.launch(
            f"spmm_fused_forward_{SUFFIX[h.dtype]}", parent.data_ptr(),
            child.data_ptr(), mask.data_ptr(), h.data_ptr(), w.data_ptr(),
            b.data_ptr(), out.data_ptr(), bsz, n, e, t, hdim,
            torch.cuda.current_stream(h.device).cuda_stream)
    return out


def sym_pair_plain(parent, child, mask, x1, x2):
    """Plain PyTorch version of ``sym_pair``: ``torch.bmm`` in f32, each
    result in its operand's dtype."""
    band, diag, _ = _sym_band(parent, child, mask, x1.shape[1],
                              torch.float32)

    def s_times(x):
        xf = x.float()
        return (torch.bmm(band, xf) + diag * xf).to(x.dtype)

    return s_times(x1), s_times(x2)


def sym_pair(parent, child, mask, x1, x2):
    """``(S x1, S x2)``, ``S = A_f + A_fᵀ + diag(incident + 1)``, for
    x1 [B, N, T1], x2 [B, N, T2], both f32 or both bf16: the CUDA kernel's
    instance for their dtype for CUDA tensors, the plain version for CPU
    tensors."""
    if x1.device.type == "cpu":
        return sym_pair_plain(parent, child, mask, x1, x2)
    bsz, n, e = check_edges("sym_pair", parent, child, mask, (x1, x2),
                            edges_bytes)
    o1, o2 = torch.empty_like(x1), torch.empty_like(x2)
    t1, t2 = x1.shape[2], x2.shape[2]
    if bsz * n == 0 or t1 + t2 == 0:
        return o1, o2
    with torch.cuda.device(x1.device):
        SYM_PAIR_KERNEL.launch(
            f"spmm_fused_sym_pair_{SUFFIX[x1.dtype]}", parent.data_ptr(),
            child.data_ptr(), mask.data_ptr(), x1.data_ptr(), x2.data_ptr(),
            o1.data_ptr(), o2.data_ptr(), bsz, n, e, t1, t2,
            torch.cuda.current_stream(x1.device).cuda_stream)
    return o1, o2


class FusedGcnSpmm(torch.autograd.Function):
    """``gcn_spmm_forward`` with the backward of the JAX package's custom
    VJP (``_bwd``)."""

    @staticmethod
    def forward(ctx, parent, child, mask, h, w, b):
        out = gcn_spmm_forward(parent, child, mask, h, w, b)
        ctx.save_for_backward(parent, child, mask, h, w, out)
        return out

    @staticmethod
    def backward(ctx, g):
        parent, child, mask, h, w, out = ctx.saved_tensors
        denom = band_denom(parent, child, mask, h.shape[1])
        gs = torch.where(out > 0, g.float(), 0.0) / denom
        db = (2.0 * gs.sum(dim=(0, 1))).to(w.dtype)
        gw = (gs.to(h.dtype) @ w.T).contiguous()
        dh, ah = sym_pair(parent, child, mask, gw, h)
        dw = ah.float().reshape(-1, ah.shape[-1]).T @ gs.reshape(
            -1, gs.shape[-1])
        return None, None, None, dh, dw.to(w.dtype), db


def fused_gcn_spmm(parent, child, mask, h, w, b):
    """Differentiable regular-mode GCN layer from edge lists (see
    ``FusedGcnSpmm``)."""
    return FusedGcnSpmm.apply(parent, child, mask, h, w, b)
