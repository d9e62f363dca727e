"""Per-edge attention scores (SDDMM) and the edge softmax.

Counterpart of ``gcn_tpu.ops.pallas.sddmm``:

    s[b, e] = mask_e · Σ_h u[b, parent_e, h] · v[b, child_e, h]

On a CUDA tensor ``sddmm_forward`` launches the hand-written kernel in
``csrc/sddmm.cu`` and ``sddmm_backward`` its others: in f32 two, one
that builds each sentence's adjacency lists with edge ids once
(``edge_lists``, whose layout ``edge_lists_plain`` spells out) and one
that sums each node's neighbour rows over them in edge order; in bf16
one, whose blocks build their nodes' lists in shared memory and sum over
them in the same order; on a CPU tensor each runs its
plain version (a gather and a product; a gather, a product and a
``scatter_add``).  ``sddmm`` ties them together as a
``torch.autograd.Function`` with the contract of JAX's ``_bwd_kernel``:
``ḡ = g·mask``, ``du = sel_pᵀ(ḡ ⊙ v[child])``, ``dv = sel_cᵀ(ḡ ⊙
u[parent])``.  ``edge_softmax`` normalizes scores over each destination's
edges, in plain PyTorch as JAX leaves it to XLA.

An edge counts when its mask is set and both ends lie in [0, N); an edge
with an end outside scores 0 and takes no part in the softmax or the
gradients (JAX's gathers give NaN there, ``ROADMAP.md`` §3).

u and v are f32 or bf16 (one dtype a call, as the Pallas kernels take
their operands' dtype); the scores and the cotangent g stay f32, and du,
dv come back in u's dtype.  bf16 rounds where JAX rounds: the forward's
dot sums the widened rows in f32; the backward rounds each message
``ḡ_e · v[child_e]`` to bf16, sums the messages in f32 and rounds du and
dv once (the kernels' ``_bf16`` instances and the plain versions alike).
``edge_softmax`` runs in the scores' f32.
"""

from __future__ import annotations

import ctypes

import torch

from gcn_tpu_torch.ops._cuda import CudaKernel
from gcn_tpu_torch.ops.band_aggregate import SUFFIX, check_edges
from gcn_tpu_torch.ops.spmm import gather_rows, scatter_rows, valid_edges

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("sddmm.cu", {
    f"sddmm_forward_{t}": [_P] * 6 + [_I] * 4 + [_P]
    for t in ("f32", "bf16")})
BACKWARD_KERNEL = CudaKernel("sddmm.cu", {
    f"sddmm_backward_{t}": [_P] * 9 + [_I] * 4 + [_P]
    for t in ("f32", "bf16")}, name="sddmm_backward")
# the backward's list build alone, for its tests
LISTS_KERNEL = CudaKernel("sddmm.cu", {
    "sddmm_lists_i32": [_P] * 4 + [_I] * 3 + [_P]}, name="sddmm_lists")


def list_ints(n: int, e: int) -> int:
    """Ints of one sentence's lists (see ``edge_lists_plain``)."""
    return 2 * (n + 1) + 4 * e


def _no_smem(n: int, e: int) -> int:
    return 0


def _build_smem(n: int, e: int) -> int:
    """Shared memory of the backward's list build: two counts a node."""
    return 8 * (n + 1) + 128


def sddmm_plain(parent, child, mask, u, v):
    """Plain PyTorch version of ``sddmm_forward``: the rows widened to
    f32, the dot in f32."""
    ok = valid_edges(parent, child, mask, u.shape[1])
    s = (gather_rows(u, parent).float()
         * gather_rows(v, child).float()).sum(-1)
    return torch.where(ok, s, torch.zeros((), dtype=s.dtype,
                                          device=s.device))


def _check(fname, parent, child, mask, u, v, smem):
    b, n, e = check_edges(fname, parent, child, mask, (u, v), smem)
    if u.shape != v.shape:
        raise ValueError(f"{fname}: u {tuple(u.shape)} and v "
                         f"{tuple(v.shape)} differ")
    return b, n, e


def sddmm_forward(parent, child, mask, u, v):
    """Per-edge scores: parent/child [B, E] int32, mask [B, E] bool, u, v
    [B, N, H] f32 or bf16 → [B, E] f32.  The CUDA kernel's instance for
    u's dtype for CUDA tensors, the plain version for CPU tensors."""
    if u.device.type == "cpu":
        return sddmm_plain(parent, child, mask, u, v)
    b, n, e = _check("sddmm_forward", parent, child, mask, u, v, _no_smem)
    out = torch.empty((b, e), dtype=torch.float32, device=u.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(u.device):
        KERNEL.launch(
            f"sddmm_forward_{SUFFIX[u.dtype]}", parent.data_ptr(),
            child.data_ptr(), mask.data_ptr(), u.data_ptr(), v.data_ptr(),
            out.data_ptr(), b, n, e, u.shape[2],
            torch.cuda.current_stream(u.device).cuda_stream)
    return out


def edge_lists_plain(parent, child, mask, n: int):
    """Plain PyTorch version of ``edge_lists``: int32 [B, 2(n+1) + 4E], per
    sentence ``start_f [n+1] | start_r [n+1] | ent_f [E, 2] | ent_r [E,
    2]``.  The counted edges (``valid_edges``) stably sorted by parent
    give ent_f as (edge, child) pairs, by child ent_r as (edge, parent);
    node i's entries are ``[start[i], start[i+1])``, so each node's list
    keeps edge order, and the slots past the counted edges hold -1."""
    b, e = parent.shape
    ok = valid_edges(parent, child, mask, n)
    out = torch.full((b, list_ints(n, e)), -1, dtype=torch.int32,
                     device=parent.device)
    for j, (key, other) in enumerate(((parent, child), (child, parent))):
        k = torch.where(ok, key.long(), n)  # uncounted edges sort last
        order = torch.argsort(k, dim=1, stable=True)
        counts = torch.zeros((b, n + 1), dtype=torch.long,
                             device=parent.device).scatter_add_(
            1, k, torch.ones_like(k))
        out[:, j * (n + 1) + 1:(j + 1) * (n + 1)] = \
            torch.cumsum(counts[:, :n], 1)
        out[:, j * (n + 1)] = 0
        ent = torch.stack([order, torch.gather(other.long(), 1, order)], -1)
        ent[~torch.gather(ok, 1, order)] = -1
        at = 2 * (n + 1) + 2 * j * e
        out[:, at:at + 2 * e] = ent.reshape(b, 2 * e)
    return out


def edge_lists(parent, child, mask, n: int):
    """The backward's adjacency lists with edge ids (layout in
    ``edge_lists_plain``): its list-build kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if parent.device.type == "cpu":
        return edge_lists_plain(parent, child, mask, n)
    # check_edges reads N from a [B, N, *] operand: an empty one here
    x = torch.empty((parent.shape[0], n, 0), dtype=torch.float32,
                    device=parent.device)
    b, _, e = check_edges("edge_lists", parent, child, mask, (x,),
                          _build_smem)
    lists = torch.empty((b, list_ints(n, e)), dtype=torch.int32,
                        device=parent.device)
    if lists.numel() == 0:
        return lists
    with torch.cuda.device(parent.device):
        LISTS_KERNEL.launch(
            "sddmm_lists_i32", parent.data_ptr(), child.data_ptr(),
            mask.data_ptr(), lists.data_ptr(), b, n, e,
            torch.cuda.current_stream(parent.device).cuda_stream)
    return lists


def sddmm_backward_plain(parent, child, mask, g, u, v):
    """Plain PyTorch version of ``sddmm_backward``: the messages in f32,
    rounded to u's dtype, summed in f32 and the sums rounded to it."""
    n = u.shape[1]
    ok = valid_edges(parent, child, mask, n)
    gm = torch.where(ok, g.float(), 0.0)[:, :, None]

    def messages(rows):
        return (gm * rows.float()).to(u.dtype).float()

    du = scatter_rows(messages(gather_rows(v, child)), parent, n)
    dv = scatter_rows(messages(gather_rows(u, parent)), child, n)
    return du.to(u.dtype), dv.to(v.dtype)


def sddmm_backward(parent, child, mask, g, u, v):
    """``(du, dv)`` in u's dtype for the cotangent g [B, E] f32: the CUDA
    kernel's instance for u's dtype for CUDA tensors, the plain version for
    CPU tensors."""
    if u.device.type == "cpu":
        return sddmm_backward_plain(parent, child, mask, g, u, v)
    b, n, e = _check("sddmm_backward", parent, child, mask, u, v,
                     _build_smem)
    if g.shape != (b, e) or g.dtype != torch.float32 \
            or g.device != u.device or not g.is_contiguous():
        raise ValueError(f"sddmm_backward: g must be a contiguous f32 "
                         f"[{b}, {e}] tensor on {u.device}, got "
                         f"{g.dtype} {tuple(g.shape)} on {g.device}")
    du, dv = torch.empty_like(u), torch.empty_like(v)
    if u.numel() == 0:
        return du, dv
    # the f32 instance's list build writes a scratch; the bf16 one builds
    # each block's lists in shared memory and takes none
    lists = None if u.dtype == torch.bfloat16 else torch.empty(
        (b, list_ints(n, e)), dtype=torch.int32, device=u.device)
    with torch.cuda.device(u.device):
        BACKWARD_KERNEL.launch(
            f"sddmm_backward_{SUFFIX[u.dtype]}", parent.data_ptr(),
            child.data_ptr(), mask.data_ptr(), g.data_ptr(), u.data_ptr(),
            v.data_ptr(), du.data_ptr(), dv.data_ptr(),
            None if lists is None else lists.data_ptr(), b, n, e,
            u.shape[2], torch.cuda.current_stream(u.device).cuda_stream)
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
