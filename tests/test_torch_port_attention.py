"""The port's attention mode (``adj_type="attention"``) against the JAX
package's, on the CPU (``sddmm``'s Pallas kernels in interpret mode).

* Logits and ``h_out`` within 1e-4 absolute for ``attention_impl`` dense,
  edge and auto, without and with the BiLSTM, on the in-repo TACRED batch;
  and on a multigraph (half the edges doubled in extra slots) the port's
  dense backend, its edge backend and JAX agree: the dense softmax weights
  each term by its edge count.
* The training loss and every gradient within 1e-4 of each tensor's max
  |grad| (jax.value_and_grad of JAX's ``Trainer._loss``), and ``Trainer``
  follows JAX's for 5 steps within 1e-4 (dropout off), both backends.
* ``attention_impl="auto"`` picks dense at the byte budget and edge one
  step past it, by a pure function and in the model (with the budget
  patched, so no 268 MB batch is built); a bad ``attention_impl`` raises.
* The edge backend builds no [B, N, N] band and saves none for the
  backward; only the one-wide ``deprel_emb`` gets a zero gradient; the q/k
  projections carry across from a flax tree name for name and stay out
  of the conv L2 penalty.
"""

import jax
import numpy as np
import pytest
import torch

from gcn_tpu.train.trainer import Trainer as JaxTrainer
from gcn_tpu_torch.convert import params_from_jax, params_to_jax
from gcn_tpu_torch.models import gcn as model_mod
from gcn_tpu_torch.models.gcn import (
    ATTN_DENSE_BYTE_BUDGET,
    GCNClassifier,
    init_params,
    resolve_attention_impl,
)
from gcn_tpu_torch.train.evaluator import batch_to_device
from gcn_tpu_torch.train.trainer import Trainer, conv_l2_penalty
from tests.test_torch_port_cuda import one_torch_thread  # noqa: F401
from tests.test_torch_port_cuda import random_batch
from tests.test_torch_port_model import _batches
from tests.test_torch_port_regular import _configs, _jax_forward
from tests.test_torch_port_train import NO_DROPOUT, _params_close, \
    _train_batchers

ATOL = 1e-4
CPU = torch.device("cpu")


def _attn_configs(impl, rnn=False, **extra):
    return _configs("gcn", **{"model.adj_type": "attention",
                              "model.attention_impl": impl,
                              "model.rnn": rnn, **extra})


def _port(tcfg, params):
    port = GCNClassifier(tcfg.model)
    port.load_state_dict(params_from_jax(jax.device_get(params)))
    return port


@pytest.mark.parametrize("rnn", [False, True])
@pytest.mark.parametrize("impl", ["dense", "edge", "auto"])
def test_forward_matches_jax(impl, rnn):
    jcfg, tcfg = _attn_configs(impl, rnn)
    jb, tb = _batches(jcfg, tcfg)
    jbatch, tbatch = next(iter(jb)), next(iter(tb))
    params, (logits, h_out) = _jax_forward(jcfg, jbatch)
    with torch.no_grad():
        tl, th = _port(tcfg, params)(batch_to_device(tbatch, CPU))
    np.testing.assert_allclose(tl.numpy(), np.asarray(logits), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(th.numpy(), np.asarray(h_out), atol=ATOL,
                               rtol=0)


def multigraph_batch():
    """A random-tree batch whose first six edge slots appear twice
    (E = 18 for N = 12)."""
    batch = random_batch(np.random.RandomState(3), b=5, n=12, vocab=30)
    for key in ("edge_parent", "edge_child", "edge_mask"):
        batch[key] = np.concatenate([batch[key], batch[key][:, :6]], axis=1)
    return batch


def test_dense_and_edge_agree_with_jax_on_a_multigraph():
    batch = multigraph_batch()
    outs = {}
    for impl in ("dense", "edge"):
        jcfg, tcfg = _attn_configs(impl)
        jcfg.model.vocab_size = tcfg.model.vocab_size = 30
        params, (want, _) = _jax_forward(jcfg, batch)
        with torch.no_grad():
            outs[impl], _ = _port(tcfg, params)(batch_to_device(batch, CPU))
        np.testing.assert_allclose(outs[impl].numpy(), np.asarray(want),
                                   atol=ATOL, rtol=0)
    torch.testing.assert_close(outs["dense"], outs["edge"], atol=ATOL,
                               rtol=0)
    # the doubled edges count: without the copies the logits differ
    single = dict(batch)
    for key in ("edge_parent", "edge_child", "edge_mask"):
        single[key] = batch[key][:, :12]
    with torch.no_grad():
        once, _ = _port(tcfg, params)(batch_to_device(single, CPU))
    assert not torch.allclose(once, outs["edge"], atol=1e-3)


@pytest.mark.parametrize("impl", ["dense", "edge"])
def test_loss_and_every_gradient_match_jax(impl):
    jcfg, tcfg = _attn_configs(impl, True, **NO_DROPOUT)
    jb, tb = _batches(jcfg, tcfg, "train")
    jbatch, tbatch = next(iter(jb)), next(iter(tb))
    jt = JaxTrainer(jcfg)
    loss_ref, grads_ref = jax.jit(jax.value_and_grad(
        lambda p: jt._loss(p, jbatch, jt._key, 0)))(jt.params)
    grads_ref = params_from_jax(jax.device_get(grads_ref))
    tt = Trainer(tcfg, params_from_jax(jax.device_get(jt.params)),
                 device="cpu")
    loss, grads = tt._loss_and_grads(tbatch)
    assert set(grads) == set(grads_ref)
    assert float(loss) == pytest.approx(float(loss_ref), rel=1e-5)
    for name, got in grads.items():
        want = grads_ref[name].numpy()
        scale = max(float(np.abs(want).max()), 1e-8)
        err = float(np.abs(got.numpy() - want).max())
        assert err <= 1e-4 * scale, (name, err, scale)


@pytest.mark.parametrize("impl", ["dense", "edge"])
def test_trainer_trajectory_matches_jax(impl):
    jcfg, tcfg = _attn_configs(impl, **NO_DROPOUT,
                               **{"train.effective_batch_size": 8})
    jt = JaxTrainer(jcfg)
    tt = Trainer(tcfg, params_from_jax(jax.device_get(jt.params)),
                 device="cpu")
    jb, tb = _train_batchers(jcfg, tcfg, seed=3)
    for i, (a, b) in enumerate(zip(jb, tb)):
        want, got = float(jt.update(a)), float(tt.update(b))
        assert got == pytest.approx(want, rel=1e-4), i
    assert tt.global_step == jt.global_step == 5
    _params_close(tt, jt.params)


def test_auto_straddles_the_byte_budget():
    b, n = 64, 1024
    assert b * n * n * 4 == ATTN_DENSE_BYTE_BUDGET
    assert resolve_attention_impl("auto", b, n) == "dense"
    assert resolve_attention_impl("auto", b + 1, n) == "edge"
    assert resolve_attention_impl("auto", b, n + 1) == "edge"
    for impl in ("dense", "edge"):
        assert resolve_attention_impl(impl, b + 1, n + 1) == impl


@pytest.mark.parametrize("over", [0, 1])
def test_model_resolves_auto_at_the_budget(over, monkeypatch):
    """The model at the budget (dense: one band built) and one byte under
    it (edge: none), with the budget patched to the batch's size."""
    built = []
    real = model_mod.build_adjacency
    monkeypatch.setattr(model_mod, "build_adjacency",
                        lambda *a, **k: built.append(1) or real(*a, **k))
    b, n = 4, 10
    monkeypatch.setattr(model_mod, "ATTN_DENSE_BYTE_BUDGET",
                        b * n * n * 4 - over)
    _, tcfg = _attn_configs("auto")
    model = GCNClassifier(tcfg.model)
    init_params(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        model(batch_to_device(random_batch(np.random.RandomState(0), b=b,
                                           n=n), CPU))
    assert len(built) == (0 if over else 1)


def test_bad_attention_impl_raises():
    _, tcfg = _attn_configs("sparse")
    with pytest.raises(ValueError, match="attention_impl"):
        GCNClassifier(tcfg.model)
    with pytest.raises(ValueError, match="attention_impl"):
        resolve_attention_impl("Dense", 1, 1)


def test_edge_backend_builds_and_saves_no_band(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the edge backend built a dense band")

    monkeypatch.setattr(model_mod, "build_adjacency", refuse)
    n = 13  # differs from every width of the small model
    batch = batch_to_device(random_batch(np.random.RandomState(0), b=5, n=n,
                                         vocab=30), CPU)
    _, tcfg = _attn_configs("edge", True)
    model = GCNClassifier(tcfg.model)
    init_params(model, torch.Generator().manual_seed(0))
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        logits, _ = model(batch, deterministic=False,
                          generator=torch.Generator().manual_seed(1))
    logits.square().sum().backward()
    assert saved and not [s for s in saved if s[-2:] == (n, n)]
    assert model.attn_q0.grad is not None


@pytest.mark.parametrize("impl", ["dense", "edge"])
def test_only_deprel_emb_gets_a_zero_gradient(impl):
    _, tcfg = _attn_configs(impl, True)
    tr = Trainer(tcfg, device="cpu")
    assert tr.model.unused_params == {"deprel_emb"}
    loss, grads = tr._loss_and_grads(random_batch(np.random.RandomState(2),
                                                  b=4, n=10))
    assert torch.isfinite(loss) and set(grads) == set(tr.params)
    assert not grads["deprel_emb"].any()
    zero = [k for k, g in grads.items() if k != "deprel_emb" and not g.any()]
    assert not zero, zero


def test_attention_params_round_trip_and_stay_out_of_conv_l2():
    jcfg, tcfg = _attn_configs("edge", True)
    tree = jax.device_get(JaxTrainer(jcfg).params)
    port = GCNClassifier(tcfg.model)
    state = params_from_jax(tree)
    port.load_state_dict(state)  # strict: the same names and shapes
    t0 = 2 * tcfg.model.rnn_hidden
    for l, t_in in enumerate((t0, tcfg.model.hidden_dim)):
        for name in (f"attn_q{l}", f"attn_k{l}", f"gcn_w{l}_kernel"):
            assert state[name].shape == (t_in, tcfg.model.hidden_dim)
            np.testing.assert_array_equal(state[name].numpy(),
                                          tree["params"][name])
    back = params_to_jax(state)["params"]
    np.testing.assert_array_equal(back["attn_k1"], tree["params"]["attn_k1"])
    before = float(conv_l2_penalty(port).detach())
    with torch.no_grad():
        port.attn_q0.mul_(3.0)
        port.attn_k1.mul_(3.0)
    assert float(conv_l2_penalty(port).detach()) == before
    init_params(port, torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert float(port.attn_q0.abs().max()) <= 1 / np.sqrt(t0)
        assert float(port.attn_k1.abs().max()) <= 1 / np.sqrt(
            tcfg.model.hidden_dim)
