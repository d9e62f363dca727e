"""The port's ``diagonal_deprel`` mode against the JAX package, on the CPU.

The mode gates h element-wise by deprel rows of a [85, hidden] table after
a ``preprocessor`` dense layer: ``A_f (e_fwd ⊙ h) + A_fᵀ (e_rev ⊙ h) +
e_self ⊙ h`` over the layer's denominator, on the dense bands
(``diagonal_deprel_layer``) or, with ``use_pallas=True``, through the band
aggregation kernel's plain version (JAX runs its Pallas kernel in interpret
mode).  Tolerances (f32):

* the torch-reference goldens ``model_diagonal_nornn.npz``,
  ``model_l1_diagonal.npz`` and ``act_diagonal.npz``: atol 2e-5 / rtol 1e-4
  on logits and pooled, as tests/test_model_parity.py holds JAX;
* the port against ``gcn_tpu``'s ``GCNClassifier`` on the same flax
  parameters and batches (narrow ``cgcn_preset``, BiLSTM on): 1e-4
  absolute on logits and ``h_out``;
* every gradient of the training loss within 1e-4 of its tensor's largest
  |gradient| (the reverse gates' rows 42-84 and the self-loop row 84 of
  the table, the preprocessor);
* 5 steps of ``Trainer.update`` against JAX's trainer: losses within 1e-4
  relative, parameters within 1e-4 of max(1, max |p|).  The batches carry
  word dropout (drawn by numpy alike on both sides); the model's dropout
  rates are 0, since the two frameworks' random streams differ.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from gcn_tpu.compat.torch_import import torch_state_to_params
from gcn_tpu.models.gcn import GCNClassifier as JaxGCN
from gcn_tpu.ops.gcn_layers import diagonal_deprel_layer as jax_layer
from gcn_tpu.train.trainer import Trainer as JaxTrainer
from gcn_tpu.train.trainer import conv_l2_penalty as jax_conv_l2
from gcn_tpu_torch import config, constants
from gcn_tpu_torch.convert import params_from_jax, params_to_jax
from gcn_tpu_torch.data.dataset import Batcher, RelationDataset
from gcn_tpu_torch.data.vocab import Vocab
from gcn_tpu_torch.models.gcn import GCNClassifier, init_params
from gcn_tpu_torch.ops.gcn_layers import diagonal_deprel_layer
from gcn_tpu_torch.train.evaluator import batch_to_device
from gcn_tpu_torch.train.trainer import Trainer, conv_l2_penalty
from tests.conftest import load_golden
from tests.test_model_parity import golden_to_batch, golden_to_cfg
from tests.test_torch_port_cuda import one_torch_thread  # noqa: F401
from tests.test_torch_port_model import DATA, VOCAB, _batches, _configs
from tests.test_torch_port_train import NO_DROPOUT, _params_close, \
    _train_batchers

ATOL = 1e-4
DIAGONAL = {"model.adj_type": "diagonal_deprel"}
CPU = torch.device("cpu")


def _golden_model(name, use_pallas):
    z = load_golden(f"{name}.npz")
    opt = json.loads(bytes(z["opt"]).decode())
    jcfg = golden_to_cfg(opt)
    jcfg.use_pallas = use_pallas
    jcfg.use_bert_embeddings = opt.get("use_bert_embeddings", False)
    state = {k[len("state."):]: v for k, v in z.items()
             if k.startswith("state.")}
    model = GCNClassifier(config.ModelConfig(**dataclasses.asdict(jcfg)))
    model.load_state_dict(params_from_jax(torch_state_to_params(state,
                                                                jcfg)))
    assert model.use_fused(deterministic=True) == use_pallas
    batch = batch_to_device(golden_to_batch(z, opt["prune_k"]), CPU)
    return z, model, batch


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("case", ["diagonal_nornn", "l1_diagonal"])
def test_matches_reference_goldens(case, use_pallas):
    z, model, batch = _golden_model(f"model_{case}", use_pallas)
    with torch.no_grad():
        logits, pooled = model(batch)
    np.testing.assert_allclose(pooled.numpy(), z["out.pooled"], atol=2e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(logits.numpy(), z["out.logits"], atol=2e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_three_layer_activation_golden_logits(use_pallas):
    """``act_diagonal.npz``: three layers; its logits (the per-layer
    activations are JAX's own test's)."""
    z, model, batch = _golden_model("act_diagonal", use_pallas)
    assert model.cfg.num_layers == 3
    with torch.no_grad():
        logits, _ = model(batch)
    np.testing.assert_allclose(logits.numpy(), z["out.logits"], atol=2e-5,
                               rtol=1e-4)


def _jax_and_port(use_pallas, **extra):
    jcfg, tcfg = _configs(**DIAGONAL, **{"model.use_pallas": use_pallas},
                          **extra)
    jb, tb = _batches(jcfg, tcfg)
    jbatch, tbatch = next(iter(jb)), next(iter(tb))
    model = JaxGCN(jcfg.model)
    params = model.init({"params": jax.random.key(0),
                         "dropout": jax.random.key(1)}, jbatch, True)
    port = GCNClassifier(tcfg.model)
    port.load_state_dict(params_from_jax(jax.device_get(params)))
    return model, params, jbatch, port, batch_to_device(tbatch, CPU)


@pytest.mark.parametrize("variant", ["dense", "fused", "fused_avg_3_layers"])
def test_forward_matches_jax(variant):
    extra = ({"model.pooling": "avg", "model.num_layers": 3}
             if variant == "fused_avg_3_layers" else {})
    model, params, jbatch, port, tbatch = _jax_and_port(
        variant != "dense", **extra)
    assert port.use_fused(deterministic=True) == (variant != "dense")
    assert tbatch["deprel"].eq(0).any()  # padding inside the batch
    logits, h_out = jax.jit(lambda p, b: model.apply(p, b, True))(params,
                                                                  jbatch)
    with torch.no_grad():
        tl, th = port(tbatch)
    np.testing.assert_allclose(tl.numpy(), np.asarray(logits), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(th.numpy(), np.asarray(h_out), atol=ATOL,
                               rtol=0)


def test_parameters_match_the_flax_tree():
    """A preprocessor, a [85, hidden] gate table, no ``gcn_w*`` or
    ``gcn_deprel_*``, nothing unused; init_params draws JAX's
    distributions."""
    _, params, _, port, _ = _jax_and_port(False)
    tree = params_from_jax(jax.device_get(params))
    state = port.state_dict()
    assert set(state) == set(tree)
    for k, v in tree.items():
        assert state[k].shape == v.shape, k
    cfg = port.cfg
    assert state["deprel_emb"].shape == (len(constants.DEPREL_TO_ID),
                                         cfg.hidden_dim)
    assert state["preprocessor.kernel"].shape == (cfg.gcn_input_dim,
                                                  cfg.hidden_dim)
    assert not any(k.startswith("gcn_") for k in state)
    assert port.unused_params == frozenset()
    init_params(port, torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.all(port.deprel_emb[0] == 0)
        assert float(port.deprel_emb[1:].std()) == pytest.approx(1.0,
                                                                 abs=0.1)
        bound = 1.0 / np.sqrt(cfg.gcn_input_dim)
        for p in (port.preprocessor.kernel, port.preprocessor.bias):
            assert 0.5 * bound < float(p.abs().max()) <= bound


def test_dense_layer_matches_jax():
    """``diagonal_deprel_layer`` on a band with duplicate edges, against
    ``gcn_tpu.ops.gcn_layers.diagonal_deprel_layer``."""
    rng = np.random.RandomState(4)
    b, n, h = 3, 9, 5
    adj = rng.randint(0, 3, (b, n, n)).astype(np.float32)
    hh, e_fwd, e_rev = (rng.randn(b, n, h).astype(np.float32)
                        for _ in range(3))
    e_self = rng.randn(h).astype(np.float32)
    want = jax_layer(hh, adj, e_fwd, e_rev, e_self)
    got = diagonal_deprel_layer(*(torch.from_numpy(a) for a in (
        hh, adj, e_fwd, e_rev, e_self)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_loss_and_every_gradient_match_jax(use_pallas):
    """The training loss (dropout rates 0, pooling_l2 on) and the gradient
    of every parameter against jax.value_and_grad of Trainer._loss."""
    jcfg, tcfg = _configs(**NO_DROPOUT, **DIAGONAL,
                          **{"model.use_pallas": use_pallas})
    jb, tb = _batches(jcfg, tcfg, "train")
    jbatch, tbatch = next(iter(jb)), next(iter(tb))
    jt = JaxTrainer(jcfg)
    loss_ref, grads_ref = jax.jit(jax.value_and_grad(
        lambda p: jt._loss(p, jbatch, jt._key, 0)))(jt.params)
    grads_ref = params_from_jax(jax.device_get(grads_ref))
    tt = Trainer(tcfg, params_from_jax(jax.device_get(jt.params)),
                 device="cpu")
    assert tt.model.use_fused(deterministic=False) == use_pallas
    loss = tt._loss(batch_to_device(tbatch, tt.device), tt.step_generator(0))
    grads = dict(zip(tt.params, torch.autograd.grad(
        loss, list(tt.params.values()))))
    assert set(grads) == set(grads_ref)
    assert float(loss.detach()) == pytest.approx(float(loss_ref), rel=1e-5)
    for name, got in grads.items():
        want = grads_ref[name].numpy()
        scale = max(float(np.abs(want).max()), 1e-8)
        err = float(np.abs(got.numpy() - want).max())
        assert err <= 1e-4 * scale, (name, err, scale)
    # a reverse gate (row 42 + id) gates what a parent sends its children:
    # exactly the rows of the parents' own ids receive gradient, and the
    # self-loop row 84; row 0, the forward gate of padding, none
    table = grads["deprel_emb"]
    rev = constants.DEPREL_FORWARD_BOUND
    deprel = tbatch["deprel"]
    rows = np.arange(deprel.shape[0])[:, None]
    senders = set(deprel[rows, tbatch["edge_parent"]][tbatch["edge_mask"]])
    for i in range(rev):
        assert (float(table[rev + i].abs().max()) > 0) == (i in senders), i
    assert float(table[constants.SELF_LOOP_INDEX].abs().max()) > 0
    assert torch.all(table[0] == 0)
    assert float(grads["preprocessor.kernel"].abs().max()) > 0


def test_conv_l2_penalty_is_zero():
    """The mode has no conv transform weights: JAX's penalty is zero, and
    so is the port's."""
    _, params, _, port, _ = _jax_and_port(False)
    assert float(jax_conv_l2(params, "diagonal_deprel")) == 0.0
    assert float(conv_l2_penalty(port)) == 0.0


def test_stochastic_forward_draws_no_edge_or_forgetting_masks():
    """JAX's diagonal mode draws neither edge dropout nor deprel
    forgetting: with both rates on, a stochastic forward (on the dense
    bands, where ``edge_keep_prob < 1`` sends it) gives the same bits as
    with both off, from one generator seed."""
    outs = []
    for rate in (1.0, 0.5):
        _, tcfg = _configs(**DIAGONAL, **{"model.edge_keep_prob": rate,
                                          "model.deprel_keep_prop": rate,
                                          "model.use_pallas": False})
        ds = RelationDataset(os.path.join(DATA, "test.json"), tcfg,
                             Vocab.load(VOCAB))
        batch = next(iter(Batcher(ds, 8, evaluation=True)))
        model = GCNClassifier(tcfg.model)
        init_params(model, torch.Generator().manual_seed(0))
        with torch.no_grad():
            outs.append(model(batch_to_device(batch, CPU),
                              deterministic=False,
                              generator=torch.Generator().manual_seed(5)))
    assert all(torch.equal(a, b) for a, b in zip(*outs))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_trainer_trajectory_matches_jax(use_pallas):
    jcfg, tcfg = _configs(**NO_DROPOUT, **DIAGONAL, **{
        "model.use_pallas": use_pallas, "model.rnn_impl": "auto",
        "train.effective_batch_size": 8})
    assert tcfg.train.word_dropout > 0
    jt = JaxTrainer(jcfg)
    tt = Trainer(tcfg, params_from_jax(jax.device_get(jt.params)),
                 device="cpu")
    jb, tb = _train_batchers(jcfg, tcfg, seed=3)
    for i, (a, b) in enumerate(zip(jb, tb)):
        want, got = float(jt.update(a)), float(tt.update(b))
        assert got == pytest.approx(want, rel=1e-4), i
    assert tt.global_step == jt.global_step == 5
    _params_close(tt, jt.params)
    # the trained tree carries across and back
    back = params_from_jax(params_to_jax(tt.model.state_dict()))
    assert all(torch.equal(back[k], v.cpu())
               for k, v in tt.model.state_dict().items())
