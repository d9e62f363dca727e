"""The port's gradients against the JAX package's, on the CPU.

Inputs come from a numpy seed and go through both sides: the JAX side
differentiates through its Pallas kernels' custom VJPs in interpret mode
(``lstm_scan_stacked``, ``grouped_matmul``, ``bilstm(impl="pallas")``,
``rnn_impl="pallas"`` / ``deprel_factored="pallas"`` in the model); the
port's ``autograd.Function``s run their plain backward versions because the
tensors lie on the CPU.  Tolerances (f32): 1e-5 absolute + 1e-4 relative
for the kernels (same math, other summation order); 1e-2 of the largest
value for bf16 storage (one bf16 rounding of dx); and 1e-4 of each tensor's
largest |gradient| for the whole C-GCN loss (BiLSTM BPTT, two or three GCN
layers, pooling and MLP, each summed in another order than XLA's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_tpu.ops.lstm import bilstm as jax_bilstm
from gcn_tpu.ops.pallas.grouped_matmul import grouped_matmul as jax_gmm
from gcn_tpu.ops.pallas.lstm_scan import lstm_scan_stacked
from gcn_tpu.train.trainer import Trainer as JaxTrainer
from gcn_tpu_torch.convert import params_from_jax
from gcn_tpu_torch.ops import grouped_matmul as gmm_mod
from gcn_tpu_torch.ops import lstm_scan as lstm_mod
from gcn_tpu_torch.ops.gcn_layers import permute_rows
from gcn_tpu_torch.ops.lstm import bilstm
from gcn_tpu_torch.train.evaluator import batch_to_device
from gcn_tpu_torch.train.trainer import Trainer
from tests.test_torch_port_cuda import (  # noqa: F401
    GMM_CASES,
    gmm_case,
    lstm_inputs,
    one_torch_thread,
)
from tests.test_torch_port_kernels import _lstm_params
from tests.test_torch_port_model import _batches, _configs

ATOL, RTOL = 1e-5, 1e-4
NO_DROPOUT = {"model.input_dropout": 0.0, "model.rnn_dropout": 0.0,
              "model.gcn_dropout": 0.0}


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


@pytest.mark.parametrize("with_keep", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_lstm_scan_backward_matches_pallas(seed, with_keep):
    rng = np.random.RandomState(seed)
    xp, lengths, w_hh, keep = lstm_inputs(rng)
    ct = rng.randn(*xp.shape[:3], w_hh.shape[1]).astype(np.float32)
    kp = keep if with_keep else None

    @jax.jit
    def ref(xp, w):
        h, vjp = jax.vjp(lambda a, b: lstm_scan_stacked(
            a, jnp.asarray(lengths), b, interpret=True,
            keep=None if kp is None else jnp.asarray(kp)), xp, w)
        gy = h * ct  # a cotangent that depends on the output
        return (gy,) + vjp(gy)

    gy, dxp_ref, dw_ref = ref(jnp.asarray(xp), jnp.asarray(w_hh))
    xp_t, w_t = _t(xp, True), _t(w_hh, True)
    h = lstm_mod.lstm_scan(xp_t, _t(lengths), w_t,
                           None if kp is None else _t(kp))
    np.testing.assert_allclose((h * _t(ct)).detach().numpy(), gy, atol=ATOL)
    dxp, dw = torch.autograd.grad(h, [xp_t, w_t], _t(gy))
    np.testing.assert_allclose(dxp.numpy(), dxp_ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(dw.numpy(), dw_ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("with_keep", [False, True])
def test_lstm_scan_backward_plain_matches_autograd(with_keep):
    """The hand-written BPTT against torch.autograd through the plain
    forward, on a cotangent that is zero past each row's length."""
    rng = np.random.RandomState(4)
    xp, lengths, w_hh, keep = lstm_inputs(rng)
    t, g, b, _ = xp.shape
    kp = _t(keep) if with_keep else None
    xp_t, w_t, len_t = _t(xp, True), _t(w_hh, True), _t(lengths)
    h, c = lstm_mod.lstm_scan_plain(xp_t, len_t, w_t, kp)
    valid = (np.arange(t)[:, None, None, None]
             < lengths[None, None, :, None])
    gy = _t(np.where(valid, rng.randn(*h.shape), 0.0).astype(np.float32))
    want = torch.autograd.grad(h, [xp_t, w_t], gy)
    got = lstm_mod.lstm_scan_backward_plain(gy, xp_t.detach(), len_t,
                                            w_t.detach(), h.detach(),
                                            c.detach(), kp)
    for a, ref in zip(got, want):
        np.testing.assert_allclose(a.numpy(), ref.numpy(), atol=ATOL,
                                   rtol=RTOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", GMM_CASES)
def test_grouped_matmul_backward_matches_pallas(name, dtype):
    x, s, gs = gmm_case(name)
    g = np.random.RandomState(7).randn(x.shape[0], s.shape[2]).astype(
        np.float32)
    jdt = jnp.dtype(dtype)

    @jax.jit
    def ref(x, s, g):
        _, vjp = jax.vjp(lambda a, b: jax_gmm(a, b, jnp.asarray(gs),
                                              interpret=True), x, s)
        return vjp(g.astype(jdt))

    dx_ref, ds_ref = (np.asarray(a, np.float32) for a in ref(
        jnp.asarray(x, jdt), jnp.asarray(s, jdt), jnp.asarray(g)))
    tdt = getattr(torch, dtype)
    x_t = _t(x).to(tdt).requires_grad_()
    s_t = _t(s).to(tdt).requires_grad_()
    y = gmm_mod.grouped_matmul_fn(x_t, s_t, _t(gs))
    dx, ds = torch.autograd.grad(y, [x_t, s_t], _t(g).to(tdt))
    assert dx.dtype == ds.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(dx.numpy(), dx_ref, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(ds.numpy(), ds_ref, atol=ATOL, rtol=RTOL)
    else:
        for a, want in ((dx, dx_ref), (ds, ds_ref)):
            err = np.abs(a.float().numpy() - want).max()
            assert err <= 1e-2 * max(1.0, np.abs(want).max())
    assert not ds[torch.from_numpy(gs) == 0].any()


def test_permute_rows_backward_is_the_inverse_gather():
    rng = np.random.RandomState(8)
    perm = torch.from_numpy(rng.permutation(30))
    x = _t(rng.randn(30, 4).astype(np.float32), True)
    g = _t(rng.randn(30, 4).astype(np.float32))
    got, = torch.autograd.grad(permute_rows(x, perm, torch.argsort(perm)),
                               x, g)
    want, = torch.autograd.grad(x[perm], x, g)
    assert torch.equal(got, want)


@pytest.mark.parametrize("layers", [1, 2])
def test_bilstm_gradients_match_pallas(layers):
    rng = np.random.RandomState(5)
    b, t, d, h = 5, 10, 7, 8
    params = _lstm_params(rng, d, h, layers)
    x = rng.randn(b, t, d).astype(np.float32)
    lengths = np.array([10, 1, 4, 7, 10], np.int32)
    ct = rng.randn(b, t, 2 * h).astype(np.float32)

    @jax.jit
    def ref(p, x):
        return jax.value_and_grad(
            lambda p, x: (jax_bilstm(p, x, jnp.asarray(lengths),
                                     impl="pallas") * ct).sum(),
            argnums=(0, 1))(p, x)

    loss_ref, (gp_ref, gx_ref) = ref(jax.tree.map(jnp.asarray, params),
                                     jnp.asarray(x))
    tparams = [{dr: {k: _t(v, True) for k, v in p.items()}
                for dr, p in layer.items()} for layer in params]
    x_t = _t(x, True)
    loss = (bilstm(tparams, x_t, _t(lengths)) * _t(ct)).sum()
    leaves = [tparams[li][dr][k] for li in range(layers)
              for dr in ("fwd", "bwd") for k in ("w_ih", "w_hh", "b_ih",
                                                  "b_hh")]
    grads = torch.autograd.grad(loss, leaves + [x_t])
    assert float(loss.detach()) == pytest.approx(float(loss_ref), rel=1e-5)
    refs = [gp_ref[li][dr][k] for li in range(layers)
            for dr in ("fwd", "bwd") for k in ("w_ih", "w_hh", "b_ih",
                                                "b_hh")] + [gx_ref]
    for got, want in zip(grads, refs):
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


GRAD_VARIANTS = {
    "two_layers": {},
    "max_depth_1": {"model.deprel_max_depth": 1},
    "directed": {"model.deprel_directed": True},
    "shared_w": {"model.deprel_shared_w": True},
    "conv_l2": {"train.conv_l2": 0.01},
}


@pytest.mark.parametrize("variant", sorted(GRAD_VARIANTS))
def test_loss_and_every_gradient_match_jax(variant):
    """The training loss (dropout rates 0, pooling_l2 on) and the gradient
    of every parameter against jax.value_and_grad of Trainer._loss."""
    jcfg, tcfg = _configs(**NO_DROPOUT, **GRAD_VARIANTS[variant])
    jb, tb = _batches(jcfg, tcfg, "train")
    jbatch, tbatch = next(iter(jb)), next(iter(tb))
    jt = JaxTrainer(jcfg)
    loss_ref, grads_ref = jax.jit(jax.value_and_grad(
        lambda p: jt._loss(p, jbatch, jt._key, 0)))(jt.params)
    grads_ref = params_from_jax(jax.device_get(grads_ref))
    tt = Trainer(tcfg, params_from_jax(jax.device_get(jt.params)),
                 device="cpu")
    loss = tt._loss(batch_to_device(tbatch, tt.device), tt.step_generator(0))
    grads = torch.autograd.grad(loss, list(tt.params.values()))
    assert set(tt.params) == set(grads_ref)
    assert float(loss.detach()) == pytest.approx(float(loss_ref), rel=1e-5)
    for name, got in zip(tt.params, grads):
        want = grads_ref[name].numpy()
        scale = max(float(np.abs(want).max()), 1e-8)
        err = float(np.abs(got.numpy() - want).max())
        assert err <= 1e-4 * scale, (name, err, scale)
