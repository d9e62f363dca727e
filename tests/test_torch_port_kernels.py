"""The port's two kernel modules against the JAX package's Pallas kernels.

Inputs come from a numpy seed and go through both: the Pallas kernels run
in interpret mode on the CPU (as tests/test_lstm_scan.py and
tests/test_grouped_matmul.py run them), the port's wrappers run their plain
PyTorch versions because the tensors lie on the CPU.  Tolerance: 1e-5
absolute in f32 (same math, other summation order).

The CUDA kernels themselves are held against the plain versions on a card
by tests/test_torch_port_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_tpu.ops.lstm import bilstm as jax_bilstm
from gcn_tpu.ops.pallas.grouped_matmul import grouped_matmul as jax_gmm
from gcn_tpu.ops.pallas.lstm_scan import _run_forward
from gcn_tpu_torch.ops import grouped_matmul as gmm_mod
from gcn_tpu_torch.ops import lstm_scan as lstm_mod
from gcn_tpu_torch.ops.lstm import bilstm
from tests.test_torch_port_cuda import (  # noqa: F401
    GMM_CASES,
    gmm_case,
    lstm_inputs,
    one_torch_thread,
)

ATOL = 1e-5


@pytest.mark.parametrize("with_keep", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_lstm_scan_matches_pallas(seed, with_keep):
    xp, lengths, w_hh, keep = lstm_inputs(np.random.RandomState(seed))
    t, g, b, _ = xp.shape
    jkeep = jnp.asarray(keep.reshape(t, g, b, 1)) if with_keep else None
    h_ref, c_ref = _run_forward(jnp.asarray(xp), jnp.asarray(lengths),
                                jnp.asarray(w_hh), jkeep, interpret=True)
    h, c = lstm_mod.lstm_scan_forward(
        torch.from_numpy(xp), torch.from_numpy(lengths),
        torch.from_numpy(w_hh),
        torch.from_numpy(keep) if with_keep else None)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), atol=ATOL,
                               rtol=0)


def _lstm_params(rng, d, h, layers):
    out = []
    for _ in range(layers):
        out.append({
            dr: {k: (rng.randn(*shape) * 0.3).astype(np.float32)
                 for k, shape in (("w_ih", (d, 4 * h)), ("w_hh", (h, 4 * h)),
                                  ("b_ih", (4 * h,)), ("b_hh", (4 * h,)))}
            for dr in ("fwd", "bwd")})
        d = 2 * h
    return out


@pytest.mark.parametrize("layers", [1, 2])
def test_bilstm_matches_pallas(layers):
    rng = np.random.RandomState(3)
    b, t, d, h = 5, 10, 7, 8
    params = _lstm_params(rng, d, h, layers)
    x = rng.randn(b, t, d).astype(np.float32)
    lengths = np.array([10, 1, 4, 7, 10], np.int32)
    ref = np.asarray(jax_bilstm(jax.tree.map(jnp.asarray, params),
                                jnp.asarray(x), jnp.asarray(lengths),
                                impl="pallas"))
    tparams = [{dr: {k: torch.from_numpy(v) for k, v in p.items()}
                for dr, p in layer.items()} for layer in params]
    out = bilstm(tparams, torch.from_numpy(x), torch.from_numpy(lengths))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)
    pad = np.arange(t)[None, :] >= lengths[:, None]
    assert np.all(out.numpy()[pad] == 0.0)
    # the reverse direction's first valid output sees the whole row
    assert not np.allclose(out.numpy()[0, 0, h:], 0.0)


@pytest.mark.parametrize("name", GMM_CASES)
def test_grouped_matmul_matches_pallas(name):
    x, s, gs = gmm_case(name)
    ref = np.asarray(jax_gmm(jnp.asarray(x), jnp.asarray(s),
                             jnp.asarray(gs)))
    out = gmm_mod.grouped_matmul(torch.from_numpy(x), torch.from_numpy(s),
                                 torch.from_numpy(gs))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=1e-6)


def test_rows_past_sum_use_last_group():
    x, s, gs = gmm_case("rows_past_sum")
    out = gmm_mod.grouped_matmul_plain(torch.from_numpy(x),
                                       torch.from_numpy(s),
                                       torch.from_numpy(gs))
    np.testing.assert_allclose(out[70:].numpy(), x[70:] @ s[-1], atol=ATOL)


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU the wrappers run the plain versions and launch nothing."""
    xp, lengths, w_hh, keep = lstm_inputs(np.random.RandomState(5))
    before = (lstm_mod.KERNEL.launches, gmm_mod.KERNEL.launches)
    args = [torch.from_numpy(a) for a in (xp, lengths, w_hh, keep)]
    for a, b in zip(lstm_mod.lstm_scan_forward(*args),
                    lstm_mod.lstm_scan_plain(*args)):
        assert torch.equal(a, b)
    x, s, gs = (torch.from_numpy(a) for a in gmm_case("random"))
    assert torch.equal(gmm_mod.grouped_matmul(x, s, gs),
                       gmm_mod.grouped_matmul_plain(x, s, gs))
    assert (lstm_mod.KERNEL.launches, gmm_mod.KERNEL.launches) == before


def test_plain_versions_keep_bf16_storage():
    xp, lengths, w_hh, _ = lstm_inputs(np.random.RandomState(6))
    h, c = lstm_mod.lstm_scan_plain(torch.from_numpy(xp).bfloat16(),
                                    torch.from_numpy(lengths),
                                    torch.from_numpy(w_hh).bfloat16())
    assert h.dtype == c.dtype == torch.bfloat16
    x, s, gs = (torch.from_numpy(a) for a in gmm_case("random"))
    y = gmm_mod.grouped_matmul_plain(x.bfloat16(), s.bfloat16(), gs)
    assert y.dtype == torch.bfloat16
