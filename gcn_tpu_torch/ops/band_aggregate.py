"""Banded aggregation from padded edge lists, with no [B, N, N] band.

Counterpart of ``gcn_tpu.ops.pallas.band_aggregate``:

    out = act((A_f x_f + A_fᵀ x_r + x_s) / denom)
    denom = deg_out + deg_in + incident + 1

the shape of the full_deprel layer on the fused path.  On a CUDA tensor
``band_aggregate_forward`` launches the hand-written kernel in
``csrc/band_aggregate.cu`` and ``pair_aggregate`` (``(A_fᵀ x, A_f x)``,
the backward's aggregation) its second kernel; both find each row's
neighbours by warp ballots over the edge slots
(``csrc/edge_gather.cuh``).  On a CPU tensor each runs its plain version,
which builds the dense band with ``build_adjacency`` and multiplies with
``torch.bmm``.  ``fused_band_aggregate`` ties them
together as a ``torch.autograd.Function`` whose backward follows the JAX
package's custom VJP: ``gs = g·act′/denom``, ``(dx_f, dx_r) =
pair_aggregate(gs)``, ``dx_s = gs``.  It saves the edge lists and the
output only.  Edges with mask 0 or an end outside [0, N) add nothing.

Operands are f32 or bf16 (one dtype a call), as the Pallas kernels take
their input's dtype: bf16 operands are summed in f32 and each output is
rounded to bf16 once, at its store (the kernels' ``_bf16`` instances and
the plain versions alike); the backward forms ``gs`` in f32 and rounds it
to the cotangent's dtype, as JAX's custom VJP does.
"""

from __future__ import annotations

import ctypes

import torch

from gcn_tpu_torch.ops._cuda import CudaKernel
from gcn_tpu_torch.ops.adjacency import build_adjacency
from gcn_tpu_torch.ops.spmm import node_degrees

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("band_aggregate.cu", {
    **{f"band_aggregate_forward_{t}": [_P] * 7 + [_I] * 5 + [_P]
       for t in ("f32", "bf16")},
    "band_aggregate_forward_bf16_occupancy": [_P] * 7 + [_I] * 5 + [_P]})
PAIR_KERNEL = CudaKernel("band_aggregate.cu", {
    f"band_aggregate_pair_{t}": [_P] * 6 + [_I] * 4 + [_P]
    for t in ("f32", "bf16")}, name="band_aggregate_pair")
# the suffix of each operand dtype's instance of an edge-list kernel
SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
MAX_SHARED_BYTES = 232448  # a block's shared memory on the H100


def edges_bytes(n: int, e: int) -> int:
    """Shared memory of one sentence's edge slots, a parent and a child
    each, 16-byte aligned: what the ballot-gather kernels take
    (``csrc/edge_gather.cuh``)."""
    return (8 * e + 15) // 16 * 16


def check_edges(fname, parent, child, mask, xs, smem):
    """Device, type, shape and contiguity checks of the edge-list kernels'
    wrappers; returns (B, N, E).  ``xs`` are the [B, N, *] operands, all
    f32 or all bf16; ``smem(n, e)`` is the shared memory a block of the
    kernel takes."""
    x = xs[0]
    if x.device.type != "cuda":
        raise ValueError(f"{fname}: unsupported device {x.device}")
    if parent.dim() != 2 or parent.shape != child.shape \
            or parent.shape != mask.shape:
        raise ValueError(f"{fname}: parent, child and mask must be [B, E], "
                         f"got {tuple(parent.shape)}, {tuple(child.shape)}, "
                         f"{tuple(mask.shape)}")
    if parent.dtype != torch.int32 or child.dtype != torch.int32 \
            or mask.dtype != torch.bool:
        raise TypeError(f"{fname}: edges must be int32 and the mask bool, "
                        f"got {parent.dtype}, {child.dtype}, {mask.dtype}")
    b, n = x.shape[0], x.shape[1]
    e = parent.shape[1]
    for a in xs:
        if a.dtype not in SUFFIX or a.dtype != x.dtype:
            raise TypeError(f"{fname}: unsupported dtypes "
                            f"{[t.dtype for t in xs]}")
        if a.dim() != 3 or a.shape[:2] != (b, n):
            raise ValueError(f"{fname}: operands must be [B={b}, N={n}, *], "
                             f"got {tuple(a.shape)}")
    if parent.shape[0] != b:
        raise ValueError(f"{fname}: {parent.shape[0]} edge lists for {b} "
                         "sentences")
    for a in (parent, child, mask, *xs):
        if a.device != x.device:
            raise ValueError(f"{fname}: operands on different devices")
        if not a.is_contiguous():
            raise ValueError(f"{fname}: operands must be contiguous")
    if smem(n, e) > MAX_SHARED_BYTES:
        raise ValueError(
            f"{fname}: N={n} nodes and E={e} edge slots need "
            f"{smem(n, e)} bytes of shared memory, "
            f"more than a block's {MAX_SHARED_BYTES}")
    return b, n, e


def band_denom(parent, child, mask, n: int, dtype=torch.float32):
    """[B, N, 1] degree normalizer from an O(E) count."""
    deg_out, deg_in, incident = node_degrees(parent, child, mask, n, dtype)
    return (deg_out + deg_in + incident.to(dtype) + 1.0)[..., None]


def band_aggregate_plain(parent, child, mask, x_f, x_r, x_s,
                         relu: bool = True):
    """Plain PyTorch version: the dense band and ``torch.bmm`` in f32, the
    result in the operands' dtype."""
    adj = build_adjacency(parent, child, mask, x_f.shape[1])
    z = (torch.bmm(adj.forward, x_f.float())
         + torch.bmm(adj.reverse, x_r.float()) + x_s.float()) / adj.denom
    return (torch.relu(z) if relu else z).to(x_f.dtype)


def band_aggregate_forward(parent, child, mask, x_f, x_r, x_s,
                           relu: bool = True):
    """``act((A_f x_f + A_fᵀ x_r + x_s)/denom)``: parent/child [B, E]
    int32, mask [B, E] bool, x_* [B, N, H] f32 or bf16 → [B, N, H] in
    their dtype.  The CUDA kernel's instance for that dtype for CUDA
    tensors, the plain version for CPU tensors."""
    if x_f.device.type == "cpu":
        return band_aggregate_plain(parent, child, mask, x_f, x_r, x_s, relu)
    b, n, e = check_edges("band_aggregate_forward", parent, child, mask,
                          (x_f, x_r, x_s), edges_bytes)
    if x_r.shape != x_f.shape or x_s.shape != x_f.shape:
        raise ValueError("x_f, x_r and x_s must have one shape")
    out = torch.empty_like(x_f)
    h = x_f.shape[2]
    if out.numel() == 0:
        return out
    with torch.cuda.device(x_f.device):
        KERNEL.launch(
            f"band_aggregate_forward_{SUFFIX[x_f.dtype]}", parent.data_ptr(),
            child.data_ptr(), mask.data_ptr(), x_f.data_ptr(),
            x_r.data_ptr(), x_s.data_ptr(), out.data_ptr(), b, n, e, h,
            int(relu), torch.cuda.current_stream(x_f.device).cuda_stream)
    return out


def forward_blocks(parent, child, mask, x_f, x_r, x_s, relu: bool = True):
    """(blocks an SM holds at once, blocks of the grid) of the launch that
    ``band_aggregate_forward`` makes for these bf16 CUDA operands (and a
    fresh, aligned output): the card's SMs times the first is one
    wave."""
    b, n, e = check_edges("band_aggregate_forward", parent, child, mask,
                          (x_f, x_r, x_s), edges_bytes)
    if x_f.dtype != torch.bfloat16:
        raise TypeError("forward_blocks: the bf16 instance's launch only")
    occ = (ctypes.c_int * 2)()
    with torch.cuda.device(x_f.device):
        KERNEL.query("band_aggregate_forward_bf16_occupancy",
                     parent.data_ptr(), child.data_ptr(), mask.data_ptr(),
                     x_f.data_ptr(), x_r.data_ptr(), x_s.data_ptr(), 0, b,
                     n, e, x_f.shape[2], int(relu), ctypes.addressof(occ))
    return occ[0], occ[1]


def pair_aggregate_plain(parent, child, mask, x):
    """Plain PyTorch version of ``pair_aggregate``: ``torch.bmm`` in f32,
    each result in x's dtype."""
    adj = build_adjacency(parent, child, mask, x.shape[1])
    xf = x.float()
    return (torch.bmm(adj.reverse, xf).to(x.dtype),
            torch.bmm(adj.forward, xf).to(x.dtype))


def pair_aggregate(parent, child, mask, x):
    """``(A_fᵀ x, A_f x)`` for x [B, N, H] f32 or bf16: the CUDA kernel's
    instance for its dtype for CUDA tensors, the plain version for CPU
    tensors."""
    if x.device.type == "cpu":
        return pair_aggregate_plain(parent, child, mask, x)
    b, n, e = check_edges("pair_aggregate", parent, child, mask, (x,),
                          edges_bytes)
    out_t, out_f = torch.empty_like(x), torch.empty_like(x)
    if x.numel() == 0:
        return out_t, out_f
    with torch.cuda.device(x.device):
        PAIR_KERNEL.launch(
            f"band_aggregate_pair_{SUFFIX[x.dtype]}", parent.data_ptr(),
            child.data_ptr(), mask.data_ptr(), x.data_ptr(),
            out_t.data_ptr(), out_f.data_ptr(), b, n, e, x.shape[2],
            torch.cuda.current_stream(x.device).cuda_stream)
    return out_t, out_f


class FusedBandAggregate(torch.autograd.Function):
    """``band_aggregate_forward`` with the backward of the JAX package's
    custom VJP (``_bwd``)."""

    @staticmethod
    def forward(ctx, parent, child, mask, x_f, x_r, x_s, relu):
        out = band_aggregate_forward(parent, child, mask, x_f, x_r, x_s, relu)
        # linear in x_*: the edge lists and the output (for the ReLU mask)
        # are all the backward needs
        ctx.save_for_backward(parent, child, mask, out)
        ctx.relu = relu
        return out

    @staticmethod
    def backward(ctx, g):
        parent, child, mask, out = ctx.saved_tensors
        denom = band_denom(parent, child, mask, out.shape[1])
        gz = torch.where(out > 0, g.float(), 0.0) if ctx.relu else g.float()
        gs = (gz / denom).to(g.dtype).contiguous()
        dx_f, dx_r = pair_aggregate(parent, child, mask, gs)
        return None, None, None, dx_f, dx_r, gs, None


def fused_band_aggregate(parent, child, mask, x_f, x_r, x_s,
                         relu: bool = True):
    """Differentiable ``act((A_f x_f + A_fᵀ x_r + x_s)/denom)`` from edge
    lists (see ``FusedBandAggregate``)."""
    return FusedBandAggregate.apply(parent, child, mask, x_f, x_r, x_s,
                                    relu)
