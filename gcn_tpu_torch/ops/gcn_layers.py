"""Dense GCN layer operators: the regular, diagonal_deprel and full_deprel
modes.

Counterpart of ``regular_layer``, ``diagonal_deprel_layer``,
``bilinear_traverse``, ``full_deprel_layer`` and the factored path of
``gcn_tpu.ops.gcn_layers``.
``regular_layer`` is ``((A+I)h)W + 2b`` on a prebuilt combined band, plain
``torch.matmul`` as JAX leaves it to XLA; ``diagonal_deprel_layer`` gates
h element-wise before two ``bmm`` on the forward band;
``full_deprel_layer`` is the non-factored layer (``deprel_factored=False``)
on the dense bands, its per-token transform one 3-operand ``einsum``
(``bilinear_traverse``).  The per-token bilinear transform
``out[m] = Σ_d e[m,d]·(h[m] @ W[d] + b[d])`` with ``e = table[ids]`` is
linear in ``e``, so it equals
``h[m] @ S[ids[m]] + bias[ids[m]]`` with the composed per-relation
matrices ``S[r] = Σ_d table[r,d]·W[d]``: sort the tokens by relation, one
grouped matmul, un-sort.  Every step is differentiable: the grouped
matmul through its ``autograd.Function`` (the backward kernels), the sort
and un-sort through ``permute_rows``, whose backward is the opposite gather
(JAX's ``permute_rows`` VJP; torch's own indexing backward would
scatter-add through a sort), the bias gather as a one-hot matmul whose
backward is ``onehotᵀ @ g`` (as in JAX), and ``S`` and the table through
autograd of the composition.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gcn_tpu_torch.ops.grouped_matmul import grouped_matmul_fn


def regular_layer(h, adj_combined, w, b, no_adj: bool = False):
    """``W(Ah) + W(h)`` in the fused form ``((A+I)h)W + 2b`` for h
    [B, N, T], the combined band [B, N, N], W [T, H] and b [H].
    ``no_adj`` zeroes only the neighbour sum (the caller's denominator
    keeps the true degrees)."""
    ax = h if no_adj else adj_combined @ h + h
    return ax @ w + 2.0 * b


def diagonal_deprel_layer(h, adj_forward, e_fwd, e_rev, e_self):
    """Element-wise deprel gating ``A_f (e_fwd ⊙ h) + A_fᵀ (e_rev ⊙ h) +
    e_self ⊙ h`` for h, e_fwd, e_rev [B, N, H], the forward band [B, N, N]
    and e_self [H]: two ``bmm`` on the band, as JAX leaves it to XLA.  The
    reverse gate is indexed by the message sender's own deprel id (+42),
    so the caller builds ``e_rev`` from the token ids, not the edges'."""
    fwd = torch.bmm(adj_forward, e_fwd * h)
    rev = torch.bmm(adj_forward.transpose(1, 2), e_rev * h)
    return fwd + rev + e_self * h


def compose_relation_transforms(table, w, b):
    """``S[r] = Σ_d table[r,d]·W[d]`` [R, T, H] and ``bias = table @ b``
    [R, H] for table [R, D], W [D, T, H], b [D, H]."""
    return torch.einsum("rd,dth->rth", table, w), table @ b


class GroupPlan(NamedTuple):
    perm: torch.Tensor         # [M] sorted position → token row
    inv_perm: torch.Tensor     # [M] token row → sorted position
    group_sizes: torch.Tensor  # [R] int32 tokens per relation
    onehot: torch.Tensor       # [M, R] f32 relation of each token row


def make_group_plan(ids, n_groups: int) -> GroupPlan:
    """Sort plan over the flattened relation ids (stable, as in JAX); the
    one-hot rows carry the bias gather and give the group sizes by a
    reduction (no host sync on the card).  The one-hot stays f32 whatever
    the compute dtype, so the counts are exact to 2^24 tokens a group (a
    bf16 sum would miscount odd counts above 256)."""
    flat = ids.reshape(-1).long()
    perm = torch.argsort(flat, stable=True)
    inv_perm = torch.argsort(perm, stable=True)
    onehot = torch.nn.functional.one_hot(flat, n_groups).float()
    group_sizes = onehot.sum(dim=0).to(torch.int32)
    return GroupPlan(perm, inv_perm, group_sizes, onehot)


class PermuteRows(torch.autograd.Function):
    """``x[perm]`` whose backward gathers the cotangent by ``inv_perm``."""

    @staticmethod
    def forward(ctx, x, perm, inv_perm):
        ctx.save_for_backward(inv_perm)
        return x[perm]

    @staticmethod
    def backward(ctx, g):
        (inv_perm,) = ctx.saved_tensors
        return g[inv_perm], None, None


def permute_rows(x, perm, inv_perm):
    """Rows of x reordered by the permutation ``perm`` (differentiable)."""
    return PermuteRows.apply(x, perm, inv_perm)


def grouped_bilinear(h, ids, s, bs, impl: str = "auto", plan=None):
    """``out[b,n] = h[b,n] @ S[ids[b,n]] + bias[ids[b,n]]``; h [B, N, T],
    ids [B, N], s [R, T, H], bs [R, H] → [B, N, H].  ``impl``: "auto" /
    "pallas" = the grouped-matmul kernels on CUDA tensors, "ragged" = their
    plain versions."""
    b_sz, n, t = h.shape
    if plan is None:
        plan = make_group_plan(ids, s.shape[0])
    h_sorted = permute_rows(h.reshape(b_sz * n, t), plan.perm,
                            plan.inv_perm).contiguous()
    out_sorted = grouped_matmul_fn(h_sorted, s.contiguous(), plan.group_sizes,
                                   use_kernel=impl != "ragged")
    out = permute_rows(out_sorted, plan.inv_perm, plan.perm)
    bias = plan.onehot.to(out.dtype) @ bs.to(out.dtype)
    return (out + bias).reshape(b_sz, n, s.shape[-1])


def bilinear_traverse(h, e, w, b):
    """``out[b,n] = Σ_d e[b,n,d]·(h[b,n] @ W[d] + bias[d])`` for h
    [B, N, T], e [B, N, D], W [D, T, H], b [D, H] → [B, N, H]: one
    3-operand einsum, whose contraction order PyTorch chooses (it may form
    the [B, N, D, T] outer product, as the reference does)."""
    out = torch.einsum("bnd,bnt,dth->bnh", e, h, w)
    return out + torch.einsum("bnd,dh->bnh", e, b)


def full_deprel_layer(h, adj_forward, e_fwd, e_rev, e_self, w, b,
                      adj_reverse=None):
    """The non-factored full_deprel layer before its denominator:
    ``A_f T(h, e_fwd) + A_r T(h, e_rev) + S(h)``.  ``e_rev`` None: a
    directed model (no reverse band); ``e_self`` None: no self loop;
    ``adj_reverse`` defaults to ``A_fᵀ`` (edge dropout draws its own
    mask per band)."""
    out = adj_forward @ bilinear_traverse(h, e_fwd, w, b)
    if e_rev is not None:
        rev = adj_reverse if adj_reverse is not None \
            else adj_forward.transpose(1, 2)
        out = out + rev @ bilinear_traverse(h, e_rev, w, b)
    if e_self is not None:
        out = out + self_loop_traverse(h, e_self, w, b)
    return out


def self_loop_traverse(h, e_self, w, b):
    """Self-loop path: W collapsed over the deprel axis with the self-loop
    embedding, then one matmul."""
    sl_w = torch.einsum("d,dth->th", e_self, w)
    sl_b = torch.einsum("d,dh->h", e_self, b)
    return h @ sl_w + sl_b
