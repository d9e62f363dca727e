"""The port's stateless ops against the JAX package's: adjacency, pooling,
length reversal, and the factored full_deprel operators
(``compose_relation_transforms``, ``make_group_plan``, ``grouped_bilinear``
with the Pallas grouped matmul in interpret mode, ``self_loop_traverse``).
Inputs from a numpy seed; tolerance 1e-5 absolute in f32 unless exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_tpu.ops import adjacency as jadj
from gcn_tpu.ops import gcn_layers as jgl
from gcn_tpu.ops import pooling as jpool
from gcn_tpu.ops.lstm import _reverse_by_length as jax_reverse
from gcn_tpu_torch.ops import adjacency, gcn_layers, pooling
from gcn_tpu_torch.ops.lstm import _reverse_by_length
from tests.test_torch_port_cuda import one_torch_thread  # noqa: F401

ATOL = 1e-5


def _edges(rng, b=4, n=10):
    ep = np.zeros((b, n), np.int32)
    ec = np.zeros((b, n), np.int32)
    em = np.zeros((b, n), bool)
    for i in range(b):
        ne = int(rng.randint(0, n))
        ec[i, :ne] = rng.permutation(n)[:ne]
        ep[i, :ne] = rng.randint(0, n, ne)
        em[i, :ne] = True
    em[-1] = False  # a row with no edges at all
    ep[0, 0], ec[0, 0], em[0, 0] = 2, 3, True  # a duplicated edge
    ep[0, 1], ec[0, 1], em[0, 1] = 2, 3, True
    return ep, ec, em


def test_build_adjacency_matches_jax():
    ep, ec, em = _edges(np.random.RandomState(0))
    ref = jadj.build_adjacency(jnp.asarray(ep), jnp.asarray(ec),
                               jnp.asarray(em), 10)
    out = adjacency.build_adjacency(torch.from_numpy(ep),
                                    torch.from_numpy(ec),
                                    torch.from_numpy(em), 10)
    for name in ("forward", "incident", "denom", "pool_mask"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(out.reverse.numpy(),
                                  np.asarray(ref.reverse))


@pytest.mark.parametrize("kind", ["max", "avg", "sum"])
def test_pool_matches_jax(kind):
    rng = np.random.RandomState(1)
    h = rng.randn(4, 9, 5).astype(np.float32)
    mask = rng.rand(4, 9) > 0.5
    mask[2] = True  # a fully excluded row
    ref = jpool.pool(jnp.asarray(h), jnp.asarray(mask), kind)
    out = pooling.pool(torch.from_numpy(h), torch.from_numpy(mask), kind)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


def test_pool_rejects_unknown_kind():
    with pytest.raises(ValueError):
        pooling.pool(torch.zeros(1, 2, 3), torch.zeros(1, 2, dtype=bool),
                     "median")


def test_reverse_by_length_matches_jax():
    rng = np.random.RandomState(2)
    x = rng.randn(4, 7, 3).astype(np.float32)
    lengths = np.array([7, 1, 4, 0], np.int32)
    ref = jax_reverse(jnp.asarray(x), jnp.asarray(lengths))
    out = _reverse_by_length(torch.from_numpy(x), torch.from_numpy(lengths))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _bilinear_inputs(rng, b=3, n=12, t=10, h=6, d=5, r=9):
    table = rng.randn(r, d).astype(np.float32)
    w = (rng.randn(d, t, h) * 0.3).astype(np.float32)
    bias = rng.randn(d, h).astype(np.float32)
    x = rng.randn(b, n, t).astype(np.float32)
    ids = rng.randint(0, r, (b, n)).astype(np.int32)
    ids[0, :] = 4  # a crowded group; others may stay empty
    return table, w, bias, x, ids


def test_compose_and_self_loop_match_jax():
    table, w, bias, x, _ = _bilinear_inputs(np.random.RandomState(3))
    s_ref, bs_ref = jgl.compose_relation_transforms(
        jnp.asarray(table), jnp.asarray(w), jnp.asarray(bias))
    s, bs = gcn_layers.compose_relation_transforms(
        torch.from_numpy(table), torch.from_numpy(w), torch.from_numpy(bias))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=ATOL)
    np.testing.assert_allclose(bs.numpy(), np.asarray(bs_ref), atol=ATOL)
    e_self = table[2]
    ref = jgl.self_loop_traverse(jnp.asarray(x), jnp.asarray(e_self),
                                 jnp.asarray(w), jnp.asarray(bias))
    out = gcn_layers.self_loop_traverse(
        torch.from_numpy(x), torch.from_numpy(e_self), torch.from_numpy(w),
        torch.from_numpy(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_make_group_plan_matches_jax():
    *_, ids = _bilinear_inputs(np.random.RandomState(4))
    perm, inv, gs, _ = jgl.make_group_plan(jnp.asarray(ids), 9)
    plan = gcn_layers.make_group_plan(torch.from_numpy(ids), 9)
    np.testing.assert_array_equal(plan.perm.numpy(), np.asarray(perm))
    np.testing.assert_array_equal(plan.inv_perm.numpy(), np.asarray(inv))
    np.testing.assert_array_equal(plan.group_sizes.numpy(), np.asarray(gs))


@pytest.mark.parametrize("impl", ["auto", "ragged"])
def test_grouped_bilinear_matches_jax(impl):
    table, w, bias, x, ids = _bilinear_inputs(np.random.RandomState(5))
    s, bs = jgl.compose_relation_transforms(
        jnp.asarray(table), jnp.asarray(w), jnp.asarray(bias))
    ref = jgl.grouped_bilinear(jnp.asarray(x), jnp.asarray(ids), s, bs,
                               impl="pallas")
    out = gcn_layers.grouped_bilinear(
        torch.from_numpy(x), torch.from_numpy(ids),
        torch.from_numpy(np.array(s)), torch.from_numpy(np.array(bs)),
        impl=impl)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=1e-6)
    # and the per-token contraction it factors (reference traverse_deprel)
    direct = jgl.bilinear_traverse(jnp.asarray(x), jnp.asarray(table[ids]),
                                   jnp.asarray(w), jnp.asarray(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(direct), atol=1e-4)
