"""The port's fused regular-mode GCN layer against the JAX package's, on the
CPU (the Pallas kernels in interpret mode, as tests/test_pallas_kernels.py
runs them).

* ``fused_gcn_spmm`` and ``sym_pair`` give the JAX kernels' outputs within
  1e-5 absolute (T = 12 products and a few neighbour rows per element, in
  another order).  T = 12 and H = 10 are no multiples of the card kernel's
  tiles.
* The gradients (h, W, b) follow ``jax.grad`` through JAX's ``custom_vjp``
  within 1e-4 of each tensor's max |grad|.
* The cases are ``EDGE_CASES`` (see tests/test_torch_port_band.py); for
  edges with one end at or past n, whose in-range end JAX's
  ``node_degrees`` still counts in its backward, the gradients are held
  against ``jax.grad`` of JAX's dense formulation (``_ref_math``), which
  drops the whole edge as the port does.
"""

import jax
import numpy as np
import pytest
import torch

from gcn_tpu.ops.pallas.spmm_fused import _ref_math, _sym_pair
from gcn_tpu.ops.pallas.spmm_fused import \
    fused_gcn_spmm as jax_fused_gcn_spmm
from gcn_tpu_torch.ops import spmm_fused as mod
from tests.test_torch_port_band import as_torch, assert_grads_close
from tests.test_torch_port_cuda import EDGE_CASES, edge_case
from tests.test_torch_port_cuda import one_torch_thread  # noqa: F401

B, N, E, T, H = 3, 10, 10, 12, 10
ATOL = 1e-5


def spmm_inputs(case):
    parent, child, mask = edge_case(case, B, N, E)
    rng = np.random.RandomState(len(case) + 1)
    h = rng.randn(B, N, T).astype(np.float32)
    w = (rng.randn(T, H) / np.sqrt(T)).astype(np.float32)
    b = (rng.randn(H) * 0.1).astype(np.float32)
    return parent, child, mask, h, w, b


@pytest.mark.parametrize("case", EDGE_CASES)
def test_fused_gcn_spmm_matches_jax(case):
    parent, child, mask, h, w, b = spmm_inputs(case)
    want = jax_fused_gcn_spmm(parent, child, mask, h, w, b)
    got = mod.fused_gcn_spmm(*as_torch(parent, child, mask, h, w, b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    if case == "all_masked":  # no edge: relu(hW + 2b)
        np.testing.assert_allclose(
            got[1].numpy(), np.maximum(h[1] @ w + 2 * b, 0), atol=ATOL)


@pytest.mark.parametrize("case", EDGE_CASES)
def test_sym_pair_matches_jax(case):
    parent, child, mask, h, _, _ = spmm_inputs(case)
    x2 = np.random.RandomState(3).randn(B, N, 7).astype(np.float32)
    want = _sym_pair(parent, child, mask, h, x2, interpret=True)
    got = mod.sym_pair(*as_torch(parent, child, mask, h, x2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("case", EDGE_CASES)
def test_fused_gcn_spmm_grads_match_jax(case):
    parent, child, mask, h, w, b = spmm_inputs(case)
    ct = np.random.RandomState(8).randn(B, N, H).astype(np.float32)
    layer = _ref_math if case == "out_of_range" else jax_fused_gcn_spmm
    want = jax.grad(
        lambda *a: (layer(parent, child, mask, *a) * ct).sum(),
        argnums=(0, 1, 2))(h, w, b)
    leaves = [t.requires_grad_() for t in as_torch(h, w, b)]
    out = mod.fused_gcn_spmm(*as_torch(parent, child, mask), *leaves)
    got = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), leaves)
    assert_grads_close(got, want)


def test_plain_path_equals_the_wrapper_on_the_cpu():
    """On a CPU tensor the autograd Function runs the plain version: its
    forward is ``gcn_spmm_plain`` bit for bit, and its custom backward
    equals autograd through ``gcn_spmm_plain``."""
    parent, child, mask, h, w, b = spmm_inputs("random")
    edges = as_torch(parent, child, mask)
    grads = []
    for layer in (mod.fused_gcn_spmm, mod.gcn_spmm_plain):
        leaves = [t.requires_grad_() for t in as_torch(h, w, b)]
        out = layer(*edges, *leaves)
        grads.append((out.detach(),
                      torch.autograd.grad(out.square().sum(), leaves)))
    (out_f, g_f), (out_p, g_p) = grads
    torch.testing.assert_close(out_f, out_p, atol=0, rtol=0)
    assert_grads_close(g_f, [g.numpy() for g in g_p])
