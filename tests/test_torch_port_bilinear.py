"""The port's non-factored full_deprel (``deprel_factored=False``) and its
``deprel_bilinear`` wrappers against the JAX package's, on the CPU (the
Pallas kernels in interpret mode, as tests/test_pallas_kernels.py runs
them).

* ``deprel_bilinear`` (v1), ``deprel_bilinear_v2`` and
  ``deprel_bilinear_batched``: outputs within 1e-4 absolute (sums of D·T
  products in another order) and the gradients of x, e, W and b within
  1e-4 of each tensor's max |grad| of ``jax.grad`` through JAX's custom
  VJP, on rows that end in a partial tile.
* The model with ``deprel_factored=False``, on the dense bands (the
  einsum) and on the fused path (the v2 kernel feeding the band
  aggregation): logits and ``h_out`` within 1e-4 of JAX's same
  configuration, and the torch-reference goldens ``model_*full*.npz`` with
  tests/test_model_parity.py's tolerance (atol 2e-5, rtol 1e-4);
  ``Trainer`` follows JAX's for 5 steps within 1e-4.
* The factored and the non-factored paths draw alike from one generator
  (edge dropout and deprel forgetting on): the same logits within 1e-4.
* A relation group above 256 tokens: the non-factored port, dense and
  fused, equals JAX's einsum path within 1e-4.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_tpu.compat.torch_import import torch_state_to_params
from gcn_tpu.ops.pallas import deprel_bilinear as jax_mod
from gcn_tpu.train.trainer import Trainer as JaxTrainer
from gcn_tpu_torch import config
from gcn_tpu_torch.convert import params_from_jax
from gcn_tpu_torch.models.gcn import GCNClassifier, init_params
from gcn_tpu_torch.ops import deprel_bilinear as mod
from gcn_tpu_torch.ops.gcn_layers import bilinear_traverse
from gcn_tpu_torch.train.evaluator import batch_to_device
from gcn_tpu_torch.train.trainer import Trainer
from tests.conftest import load_golden
from tests.test_model_parity import golden_to_batch, golden_to_cfg
from tests.test_torch_port_band import assert_grads_close
from tests.test_torch_port_cuda import one_torch_thread  # noqa: F401
from tests.test_torch_port_cuda import random_batch
from tests.test_torch_port_model import _batches
from tests.test_torch_port_regular import _configs, _jax_forward
from tests.test_torch_port_train import NO_DROPOUT, _params_close, \
    _train_batchers

ATOL = 1e-4
CPU = torch.device("cpu")
M, T, D, H = 70, 40, 9, 24   # 70 rows: a partial tile of 32 (JAX) and 64
FNS = {"v1": (jax_mod.deprel_bilinear, mod.deprel_bilinear),
       "v2": (jax_mod.deprel_bilinear_v2, mod.deprel_bilinear_v2)}


def bilinear_inputs(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(M, T).astype(np.float32),
            rng.randn(M, D).astype(np.float32),
            (rng.randn(D, T, H) * 0.1).astype(np.float32),
            (rng.randn(D, H) * 0.1).astype(np.float32),
            rng.randn(M, H).astype(np.float32))


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("version", sorted(FNS))
def test_bilinear_and_its_gradients_match_jax(version, with_bias):
    x, e, w, b, r = bilinear_inputs()
    jax_fn, fn = FNS[version]
    jb = b if with_bias else None
    want, vjp = jax.vjp(lambda *a: jax_fn(*a, b=jb, tile_m=32), x, e, w)
    args = [torch.from_numpy(a).requires_grad_() for a in (x, e, w, b)]
    got = fn(*args[:3], args[3] if with_bias else None)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)
    grads = torch.autograd.grad(got, args[:3], torch.from_numpy(r))
    assert_grads_close(grads, vjp(jnp.asarray(r)))
    if with_bias:
        (db,) = torch.autograd.grad(fn(*args).mul(torch.from_numpy(r)).sum(),
                                    args[3])
        want_db = jax.grad(lambda bb: jnp.sum(jax_fn(x, e, w, bb, tile_m=32)
                                              * r))(b)
        assert_grads_close([db], [want_db])


def test_batched_wrapper_and_plain_versions():
    """``_batched`` flattens tokens through v2; both plain versions equal
    the einsum ``bilinear_traverse``."""
    x, e, w, b, _ = bilinear_inputs(1)
    x3, e3 = x.reshape(5, 14, T), e.reshape(5, 14, D)
    want = jax_mod.deprel_bilinear_batched(x3, e3, w, b, tile_m=32)
    tx, te, tw, tb = (torch.from_numpy(a) for a in (x3, e3, w, b))
    got = mod.deprel_bilinear_batched(tx, te, tw, tb)
    assert got.shape == (5, 14, H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    ref = bilinear_traverse(tx, te, tw, torch.zeros_like(tb))
    for plain in (mod.bilinear_v1_plain, mod.bilinear_v2_plain):
        torch.testing.assert_close(
            plain(tx.reshape(-1, T), te.reshape(-1, D), tw),
            ref.reshape(-1, H), atol=ATOL, rtol=0)


NONFACTORED = {
    "dense": {"model.deprel_factored": False, "model.use_pallas": False},
    "fused": {"model.deprel_factored": False, "model.use_pallas": True},
    "fused_directed_depth": {"model.deprel_factored": False,
                             "model.use_pallas": True,
                             "model.deprel_directed": True,
                             "model.num_layers": 3},
    "dense_no_self_loop": {"model.deprel_factored": False,
                           "model.use_pallas": False,
                           "model.deprel_self_loop": False},
}


@pytest.mark.parametrize("variant", sorted(NONFACTORED))
def test_forward_matches_jax(variant):
    jcfg, tcfg = _configs("cgcn", **NONFACTORED[variant])
    jb, tb = _batches(jcfg, tcfg)
    jbatch, tbatch = next(iter(jb)), next(iter(tb))
    params, (logits, h_out) = _jax_forward(jcfg, jbatch)
    port = GCNClassifier(tcfg.model)
    port.load_state_dict(params_from_jax(jax.device_get(params)))
    with torch.no_grad():
        tl, th = port(batch_to_device(tbatch, CPU))
    np.testing.assert_allclose(tl.numpy(), np.asarray(logits), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(th.numpy(), np.asarray(h_out), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("case", ["full_rnn", "full_rnn_directed",
                                  "full_rnn_depth0", "l1_full"])
def test_reference_goldens(case, use_pallas):
    z = load_golden(f"model_{case}.npz")
    opt = json.loads(bytes(z["opt"]).decode())
    jcfg = golden_to_cfg(opt)
    state = {k[len("state."):]: v for k, v in z.items()
             if k.startswith("state.")}
    model = GCNClassifier(config.ModelConfig(**{
        **dataclasses.asdict(jcfg), "deprel_factored": False,
        "use_pallas": use_pallas}))
    model.load_state_dict(params_from_jax(torch_state_to_params(state,
                                                                jcfg)))
    assert model.use_fused(deterministic=True) == use_pallas
    batch = batch_to_device(golden_to_batch(z, opt["prune_k"]), CPU)
    with torch.no_grad():
        logits, pooled = model(batch)
    np.testing.assert_allclose(pooled.numpy(), z["out.pooled"], atol=2e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(logits.numpy(), z["out.logits"], atol=2e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_trainer_trajectory_matches_jax(use_pallas):
    jcfg, tcfg = _configs("cgcn", **NO_DROPOUT, **{
        "model.deprel_factored": False, "model.use_pallas": use_pallas,
        "train.effective_batch_size": 8})
    jt = JaxTrainer(jcfg)
    tt = Trainer(tcfg, params_from_jax(jax.device_get(jt.params)),
                 device="cpu")
    jb, tb = _train_batchers(jcfg, tcfg, seed=3)
    for i, (a, b) in enumerate(zip(jb, tb)):
        want, got = float(jt.update(a)), float(tt.update(b))
        assert got == pytest.approx(want, rel=1e-4), i
    assert tt.global_step == jt.global_step == 5
    _params_close(tt, jt.params)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_factored_and_einsum_paths_draw_alike(use_pallas):
    """Deprel forgetting on both paths and, on the dense bands, edge
    dropout: one generator seed gives the same masks and so the same
    logits, factored or not."""
    extra = {"model.deprel_keep_prop": 0.6, "model.use_pallas": use_pallas,
             "model.rnn_impl": "scan"}
    if not use_pallas:
        extra["model.edge_keep_prob"] = 0.7
    batch = batch_to_device(random_batch(np.random.RandomState(5), b=6,
                                         n=14), CPU)
    outs, state = [], None
    for factored in ("ragged", False):
        _, tcfg = _configs("cgcn", **extra,
                           **{"model.deprel_factored": factored})
        tcfg.model.vocab_size = 30
        model = GCNClassifier(tcfg.model)
        if state is None:
            init_params(model, torch.Generator().manual_seed(0))
            state = model.state_dict()
        model.load_state_dict(state)
        assert model.use_fused(deterministic=False) == use_pallas
        with torch.no_grad():
            logits, _ = model(batch, deterministic=False,
                              generator=torch.Generator().manual_seed(9))
        outs.append(logits)
    torch.testing.assert_close(outs[0], outs[1], atol=ATOL, rtol=0)


def test_relation_group_above_256_tokens():
    """One relation over 300 of 320 tokens: the non-factored port, dense
    and fused, equals gcn_tpu's einsum path."""
    rng = np.random.RandomState(4)
    batch = random_batch(rng, b=8, n=40, vocab=30)
    batch["lengths"][:] = 40
    batch["words"] = rng.randint(2, 30, (8, 40))
    batch["deprel"] = np.where(rng.rand(8, 40) < 0.94, 7,
                               rng.randint(2, 42, (8, 40)))
    batch["edge_mask"][:] = np.arange(40) < 39
    assert np.bincount(batch["deprel"].reshape(-1)).max() > 256
    ov = {"model.rnn_impl": "scan", "model.deprel_factored": False}
    jcfg, _ = _configs("cgcn", **ov, **{"model.use_pallas": False})
    jcfg.model.vocab_size = 30
    params, (want, _) = _jax_forward(jcfg, dict(batch))
    state = params_from_jax(jax.device_get(params))
    for use_pallas in (False, True):
        _, tcfg = _configs("cgcn", **ov, **{"model.use_pallas": use_pallas})
        tcfg.model.vocab_size = 30
        port = GCNClassifier(tcfg.model)
        port.load_state_dict(state)
        with torch.no_grad():
            got, _ = port(batch_to_device(batch, CPU))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)
