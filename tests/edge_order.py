"""The edge-list kernels' exact summing order, in numpy (no JAX, no torch):
the reference that the bf16 band aggregation forward (5b,
``band_aggregate_forward_bf16``) and the bf16 sym pair (8b,
``spmm_fused_sym_pair_bf16``) give bit for bit.

Each row sums in f32, from a zero: its forward neighbours (its children)
in edge order, then its reverse neighbours (its parents) in edge order,
then its own row, with masked slots and edges with an end outside [0, N)
dropped whole.  The band forward then divides by deg + [deg > 0] + 1
(IEEE f32 division) and applies the ReLU if asked; the sym pair adds
diag * self with diag = [deg > 0] + 1 (a power of two, so a fused
multiply-add rounds as the product and the sum do).  The result is
rounded once to bf16, to nearest even.  The kernels are built without
``--use_fast_math``, so their adds and divisions are these IEEE ones.

Inputs are float32 arrays of bf16 values (a bf16 tensor's ``.float()``);
outputs are the bf16 bits as uint16.  ``tests/test_torch_port_cuda.py``
holds the card's kernels to them in bits; ``tests/
test_torch_port_edge_order.py`` holds them to f64 and to the port's plain
versions on the CPU and emulates the kernels' list-first walk.
"""

import numpy as np


def bf16_bits(a):
    """float32 → bf16 bits (uint16), rounded to nearest even (finite
    values)."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) >> 16
    return u.astype(np.uint16)


def bf16_values(bits):
    """bf16 bits (uint16) → their float32 values."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16).view(
        np.float32)


def valid_slots(parent, child, mask, n):
    """[B, E] bool: the slots that count (mask set, both ends in [0, n))."""
    return (mask & (parent >= 0) & (parent < n) & (child >= 0)
            & (child < n))


def neighbour_sums(parent, child, mask, xf, xr):
    """[B, N, H] f32 sums of each row's forward neighbours of xf in edge
    order, then its reverse ones of xr, from zero; and [B, N] degrees."""
    b, n = xf.shape[:2]
    ok = valid_slots(parent, child, mask, n)
    acc = np.zeros(xf.shape, np.float32)
    deg = np.zeros((b, n), np.int64)
    rows = np.arange(b)
    for key, nbr, x in ((parent, child, xf), (child, parent, xr)):
        for q in range(parent.shape[1]):  # slot by slot: edge order
            s = rows[ok[:, q]]
            acc[s, key[s, q]] += x[s, nbr[s, q]]
            deg[s, key[s, q]] += 1
    return acc, deg


def band_forward_exact(parent, child, mask, xf, xr, xs, relu=True):
    """bf16 bits [B, N, H] of act((A_f xf + A_fᵀ xr + xs) / denom) summed
    in the kernel's order."""
    xf, xr, xs = (np.asarray(a, np.float32) for a in (xf, xr, xs))
    acc, deg = neighbour_sums(parent, child, mask, xf, xr)
    denom = (deg + (deg > 0) + 1).astype(np.float32)[..., None]
    z = (acc + xs) / denom
    if relu:
        z = np.maximum(z, np.float32(0.0))
    return bf16_bits(z)


def sym_pair_exact(parent, child, mask, x1, x2):
    """bf16 bits of (S x1, S x2), S = A_f + A_fᵀ + diag(incident + 1),
    summed in the kernel's order."""
    out = []
    for x in (x1, x2):
        x = np.asarray(x, np.float32)
        acc, deg = neighbour_sums(parent, child, mask, x, x)
        diag = ((deg > 0) + 1).astype(np.float32)[..., None]
        out.append(bf16_bits(acc + diag * x))
    return tuple(out)
