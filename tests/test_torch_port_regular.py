"""The port's regular mode (the paper's GCN) and its fused edge-list path
(``use_pallas=True``) against the JAX package, on the CPU.

* Logits and ``h_out`` of ``GCNClassifier`` against ``gcn_tpu``'s on the
  same flax parameters, within 1e-4 absolute: ``gcn_preset`` with
  ``use_pallas`` off, on and auto, with the BiLSTM, with ``no_adj``, and
  ``cgcn_preset`` on the fused path (directed, past ``deprel_max_depth``,
  without the self loop).  JAX runs its Pallas kernels in interpret mode.
* The torch-reference goldens ``model_*.npz`` of the regular and
  full_deprel modes on the fused path (``no_adj`` takes the dense path)
  and on the dense bands, with tests/test_model_parity.py's tolerance
  (atol 2e-5, rtol 1e-4).
* ``Trainer.update`` follows JAX's trainer for 5 steps of ``gcn_preset``
  (dropout off) as tests/test_torch_port_train.py holds the C-GCN, and the
  goldens ``train_regular.npz`` / ``train_regular_l2.npz`` replay with
  tests/test_train_parity.py's assertions, both ways of ``use_pallas``.
* The fused path builds no band and saves none for the backward; a
  stochastic full_deprel forward with edge dropout takes the dense bands,
  as JAX's does.
* A batch with a relation group above 256 tokens: exact group sizes, and
  logits (dense and fused) within 1e-4 of ``gcn_tpu``'s non-factored
  einsum path.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from gcn_tpu import config as jax_config
from gcn_tpu.compat.torch_import import torch_state_to_params
from gcn_tpu.models.gcn import GCNClassifier as JaxGCN
from gcn_tpu.train.trainer import Trainer as JaxTrainer
from gcn_tpu_torch import config
from gcn_tpu_torch.convert import params_from_jax, params_to_jax
from gcn_tpu_torch.data.vocab import Vocab
from gcn_tpu_torch.models import gcn as model_mod
from gcn_tpu_torch.models.gcn import GCNClassifier, init_params
from gcn_tpu_torch.ops.gcn_layers import make_group_plan
from gcn_tpu_torch.train.evaluator import batch_to_device
from gcn_tpu_torch.train.optim import build_optimizer
from gcn_tpu_torch.train.trainer import Trainer, conv_l2_penalty
from tests.conftest import load_golden
from tests.test_model_parity import golden_to_batch, golden_to_cfg
from tests.test_torch_port_cuda import one_torch_thread  # noqa: F401
from tests.test_torch_port_cuda import random_batch
from tests.test_torch_port_model import SMALL, VOCAB, _batches
from tests.test_torch_port_train import NO_DROPOUT, _params_close, \
    _train_batchers

ATOL = 1e-4
PRESETS = {"gcn": (jax_config.gcn_preset, config.gcn_preset),
           "cgcn": (jax_config.cgcn_preset, config.cgcn_preset)}
VARIANTS = {
    "gcn_dense": ("gcn", {"model.use_pallas": False}),
    "gcn_fused": ("gcn", {"model.use_pallas": True}),
    "gcn_auto_avg": ("gcn", {"model.pooling": "avg"}),
    "gcn_rnn_fused": ("gcn", {"model.rnn": True, "model.use_pallas": True}),
    "gcn_no_adj": ("gcn", {"model.no_adj": True, "model.use_pallas": True}),
    "cgcn_fused": ("cgcn", {"model.use_pallas": True}),
    "cgcn_fused_directed": ("cgcn", {"model.use_pallas": True,
                                     "model.deprel_directed": True}),
    "cgcn_fused_past_max_depth": ("cgcn", {"model.use_pallas": True,
                                           "model.num_layers": 3}),
    "cgcn_fused_no_self_loop_sum": ("cgcn", {
        "model.use_pallas": True, "model.deprel_self_loop": False,
        "model.pooling": "sum"}),
}


def _configs(preset="gcn", **extra):
    ov = {**SMALL, **extra}
    jpreset, tpreset = PRESETS[preset]
    jcfg, tcfg = jpreset(**ov), tpreset(**ov)
    jcfg.model.vocab_size = tcfg.model.vocab_size = Vocab.load(VOCAB).size
    return jcfg, tcfg


def _jax_forward(jcfg, jbatch, seed=0):
    model = JaxGCN(jcfg.model)
    params = model.init({"params": jax.random.key(seed),
                         "dropout": jax.random.key(1)}, jbatch, True)
    return params, jax.jit(lambda p, b: model.apply(p, b, True))(params,
                                                                 jbatch)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_matches_jax(variant):
    preset, extra = VARIANTS[variant]
    jcfg, tcfg = _configs(preset, **extra)
    jb, tb = _batches(jcfg, tcfg)
    jbatch, tbatch = next(iter(jb)), next(iter(tb))
    params, (logits, h_out) = _jax_forward(jcfg, jbatch)
    port = GCNClassifier(tcfg.model)
    port.load_state_dict(params_from_jax(jax.device_get(params)))
    with torch.no_grad():
        tl, th = port(batch_to_device(tbatch, torch.device("cpu")))
    np.testing.assert_allclose(tl.numpy(), np.asarray(logits), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(th.numpy(), np.asarray(h_out), atol=ATOL,
                               rtol=0)


GOLDENS = ["regular_nornn", "regular_rnn", "full_rnn", "full_rnn_directed",
           "full_rnn_depth0", "regular_rnn2l", "regular_avg", "regular_sum",
           "l1_regular", "l3_regular", "regular_noadj"]


def _golden_outputs(case, use_pallas):
    """(golden, logits, pooled) of the golden's model in the port."""
    z = load_golden(f"model_{case}.npz")
    opt = json.loads(bytes(z["opt"]).decode())
    jcfg = golden_to_cfg(opt)
    jcfg.use_pallas = use_pallas
    state = {k[len("state."):]: v for k, v in z.items()
             if k.startswith("state.")}
    model = GCNClassifier(config.ModelConfig(**dataclasses.asdict(jcfg)))
    model.load_state_dict(params_from_jax(torch_state_to_params(state,
                                                                jcfg)))
    # no_adj takes the dense path whatever use_pallas says, as in JAX
    assert model.use_fused(deterministic=True) == (use_pallas
                                                   and not jcfg.no_adj)
    batch = batch_to_device(golden_to_batch(z, opt["prune_k"]),
                            torch.device("cpu"))
    with torch.no_grad():
        logits, pooled = model(batch)
    return z, logits, pooled


@pytest.mark.parametrize("case", GOLDENS)
def test_fused_path_matches_reference_goldens(case):
    z, logits, pooled = _golden_outputs(case, True)
    np.testing.assert_allclose(pooled.numpy(), z["out.pooled"], atol=2e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(logits.numpy(), z["out.logits"], atol=2e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("case", GOLDENS)
def test_dense_path_matches_reference_goldens(case):
    z, logits, pooled = _golden_outputs(case, False)
    np.testing.assert_allclose(pooled.numpy(), z["out.pooled"], atol=2e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(logits.numpy(), z["out.logits"], atol=2e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_trainer_trajectory_matches_jax(use_pallas):
    jcfg, tcfg = _configs("gcn", **NO_DROPOUT, **{
        "model.use_pallas": use_pallas, "train.effective_batch_size": 8})
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
@pytest.mark.parametrize("name", ["train_regular", "train_regular_l2"])
def test_train_golden_replays(name, use_pallas):
    """25 steps of CE (+ conv and pooling L2) + clip(5) + adagrad from the
    torch reference's weights on its batch, asserted as
    tests/test_train_parity.py does."""
    z = load_golden(f"{name}.npz")
    opt = json.loads(bytes(z["opt"]).decode())
    jcfg = golden_to_cfg(opt)
    state = {k[len("state."):]: v for k, v in z.items()
             if k.startswith("state.")}
    model = GCNClassifier(config.ModelConfig(**{
        **dataclasses.asdict(jcfg), "use_pallas": use_pallas}))
    model.load_state_dict(params_from_jax(torch_state_to_params(state,
                                                                jcfg)))
    assert model.use_fused(deterministic=True) == use_pallas
    batch = golden_to_batch(z, opt["prune_k"])
    batch["labels"] = z["in.labels"].astype(np.int32)
    batch = batch_to_device(batch, torch.device("cpu"))
    conv_l2 = float(opt.get("conv_l2", 0) or 0)
    pooling_l2 = float(opt.get("pooling_l2", 0) or 0)
    params = {k: p for k, p in model.named_parameters()
              if k not in model.unused_params}  # the one-wide dummy
    tx = build_optimizer("adagrad", float(z["lr"]), max_grad_norm=5.0)
    tx.init(params)
    losses = []
    for _ in range(len(z["losses"])):
        logits, pooled = model(batch)
        loss = torch.nn.functional.cross_entropy(logits, batch["labels"])
        if conv_l2 > 0:
            loss = loss + conv_l2 * conv_l2_penalty(model)
        if pooling_l2 > 0:
            loss = loss + pooling_l2 * pooled.square().sum(1).mean()
        grads = torch.autograd.grad(loss, list(params.values()))
        tx.step(params, dict(zip(params, grads)))
        losses.append(float(loss.detach()))
    ref = z["losses"]
    assert abs(losses[0] - ref[0]) < 2e-5, (losses[0], ref[0])
    np.testing.assert_allclose(losses[:15], ref[:15], rtol=5e-3, atol=2e-3)
    assert abs(losses[-1] - ref[-1]) < 0.25, (losses[-1], ref[-1])
    assert losses[-1] < losses[0] * 0.6


def _small_model(preset, **extra):
    _, tcfg = _configs(preset, **{"model.use_pallas": True, **extra})
    model = GCNClassifier(tcfg.model)
    init_params(model, torch.Generator().manual_seed(0))
    return model


@pytest.mark.parametrize("preset", ["gcn", "cgcn"])
def test_fused_path_builds_and_saves_no_band(preset, monkeypatch):
    """Forward and backward with ``build_adjacency`` gone from the model:
    the fused path takes its pooling mask and denominators from the edge
    lists, and no [B, N, N] tensor is saved for the backward."""
    def refuse(*args, **kwargs):
        raise AssertionError("the fused path built a dense band")

    monkeypatch.setattr(model_mod, "build_adjacency", refuse)
    n = 13  # differs from every width of the small model
    batch = batch_to_device(random_batch(np.random.RandomState(0), b=5, n=n,
                                         vocab=30), torch.device("cpu"))
    model = _small_model(preset)
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        logits, _ = model(batch, deterministic=False,
                          generator=torch.Generator().manual_seed(1))
    logits.square().sum().backward()
    assert saved and not [s for s in saved if s[-2:] == (n, n)]
    assert model.word_emb.grad is not None


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("preset", ["gcn", "cgcn"])
def test_only_named_unused_params_get_zero_grads(preset, use_pallas,
                                                 monkeypatch):
    """The trainer's gradient is strict: only what the model names unused
    (the regular mode's one-wide deprel table) gets a zero gradient; any
    other parameter cut off from the loss raises."""
    _, tcfg = _configs(preset, **{"model.use_pallas": use_pallas})
    batch = random_batch(np.random.RandomState(2), b=4, n=10)
    tr = Trainer(tcfg, device="cpu")
    want = {"deprel_emb"} if preset == "gcn" else set()
    assert tr.model.unused_params == want
    loss, grads = tr._loss_and_grads(batch)
    assert torch.isfinite(loss) and set(grads) == set(tr.params)
    for k, g in grads.items():
        assert g.shape == tr.params[k].shape, k
    if preset == "gcn":
        assert not grads["deprel_emb"].any()
        # the table named unused no longer: autograd refuses it
        monkeypatch.setattr(tr.model, "unused_params", frozenset())
        with pytest.raises(RuntimeError):
            tr._loss_and_grads(batch)
    else:
        # a parameter the forward does not reach, not named unused
        tr.params["stray"] = torch.nn.Parameter(torch.zeros(2))
        with pytest.raises(RuntimeError):
            tr._loss_and_grads(batch)


def test_edge_dropout_takes_the_dense_bands(monkeypatch):
    """As in JAX: a stochastic full_deprel forward with edge_keep_prob < 1
    runs the dense bands (per-band edge masks); a deterministic one, or
    one without edge dropout, stays on the fused path."""
    built = []
    real = model_mod.build_adjacency
    monkeypatch.setattr(model_mod, "build_adjacency",
                        lambda *a, **k: built.append(1) or real(*a, **k))
    batch = batch_to_device(random_batch(np.random.RandomState(1)),
                            torch.device("cpu"))
    gen = torch.Generator().manual_seed(0)
    drop = _small_model("cgcn", **{"model.edge_keep_prob": 0.5})
    keep = _small_model("cgcn")
    assert not drop.use_fused(deterministic=False)
    assert drop.use_fused(deterministic=True)
    assert keep.use_fused(deterministic=False)
    keep(batch, deterministic=False, generator=gen)
    drop(batch)
    assert not built
    drop(batch, deterministic=False, generator=gen)
    assert built == [1]
    assert not _small_model("gcn", **{"model.no_adj": True}).use_fused(True)


def test_relation_group_above_256_tokens():
    """One relation over 300 of 320 tokens (the stacked bands hold 640
    rows): the port's group sizes are exact, and its full_deprel logits,
    dense and fused, equal gcn_tpu's non-factored einsum path (the JAX
    factored path's bf16 local plan miscounts such groups, so it is not
    the yardstick here)."""
    rng = np.random.RandomState(4)
    batch = random_batch(rng, b=8, n=40, vocab=30)
    batch["lengths"][:] = 40
    batch["words"] = rng.randint(2, 30, (8, 40))
    batch["deprel"] = np.where(rng.rand(8, 40) < 0.94, 7,
                               rng.randint(2, 42, (8, 40)))
    batch["edge_mask"][:] = np.arange(40) < 39
    ids = torch.from_numpy(batch["deprel"]).long()
    sizes = make_group_plan(ids, 87).group_sizes
    assert sizes.max() > 256
    np.testing.assert_array_equal(sizes.numpy(),
                                  np.bincount(ids.reshape(-1), minlength=87))
    ov = {"model.rnn_impl": "scan"}
    jcfg, _ = _configs("cgcn", **ov, **{"model.deprel_factored": False,
                                        "model.use_pallas": False})
    jcfg.model.vocab_size = 30
    jbatch = {k: v for k, v in batch.items()}
    params, (want, _) = _jax_forward(jcfg, jbatch)
    state = params_from_jax(jax.device_get(params))
    for use_pallas in (False, True):
        _, tcfg = _configs("cgcn", **ov, **{"model.use_pallas": use_pallas})
        tcfg.model.vocab_size = 30
        port = GCNClassifier(tcfg.model)
        port.load_state_dict(state)
        with torch.no_grad():
            got, _ = port(batch_to_device(batch, torch.device("cpu")))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)


def test_gcn_params_round_trip_and_init():
    """A flax ``gcn_preset`` tree flattens onto the port's names
    (``gcn_w{l}_kernel``, ``gcn_w{l}_bias``, a one-wide ``deprel_emb``, no
    ``rnn``) and back; ``init_params`` draws the JAX bounds."""
    jcfg, tcfg = _configs("gcn")
    tree = jax.device_get(JaxTrainer(jcfg).params)
    port = GCNClassifier(tcfg.model)
    state = params_from_jax(tree)
    port.load_state_dict(state)  # strict: the same names and shapes
    back = params_to_jax(state)
    flat = jax.tree_util.tree_leaves_with_path(tree)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        node = back
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, leaf)
    init_params(port, torch.Generator().manual_seed(0))
    t0 = tcfg.model.emb_dim + tcfg.model.pos_dim + tcfg.model.ner_dim
    assert port.gcn_w0_kernel.shape == (t0, tcfg.model.hidden_dim)
    assert port.deprel_emb.shape[1] == 1
    with torch.no_grad():
        assert float(port.gcn_w0_kernel.abs().max()) <= 1 / np.sqrt(t0)
        assert float(port.gcn_w1_bias.abs().max()) <= 1 / np.sqrt(
            tcfg.model.hidden_dim)
    assert not any(k.startswith("rnn.") for k in port.state_dict())
    assert float(conv_l2_penalty(port).detach()) > 0
