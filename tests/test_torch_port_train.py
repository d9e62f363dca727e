"""The port's training step against the JAX package's, on the CPU.

* The train ``Batcher`` gives the JAX one's arrays bit for bit for a seed
  (shuffle, word dropout, ``pad_batches``, ``group_by_length``).
* ``Trainer.update`` follows the JAX ``Trainer`` for 5 steps from the same
  parameters (small widths, dropout rates 0 but word dropout 0.04 in the
  batches), fused, accumulated (``update_gap`` 2) and with ``update_lr``
  mid-run: losses within 1e-4 relative, every parameter within 1e-4 of
  max(1, max |p|) — each step's gradient sums in another order than XLA's
  and the differences carry over through sgd.
* The torch-reference golden ``train_full_rnn.npz`` (25 adagrad steps)
  replays with the assertions of ``tests/test_train_parity.py``.
* The optimizers follow optax over 5 steps within 1e-6 relative: each
  core, each ``topn`` regime, a clip that triggers and one that does not.
* ``convert`` round-trips a flax tree, and the CPU trainer learns with
  dropout on.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import optax
import pytest
import torch

from gcn_tpu.compat.torch_import import torch_state_to_params
from gcn_tpu.data.dataset import Batcher as JaxBatcher
from gcn_tpu.data.dataset import RelationDataset as JaxDataset
from gcn_tpu.data.vocab import Vocab as JaxVocab
from gcn_tpu.train.optim import build_optimizer as jax_build_optimizer
from gcn_tpu.train.optim import set_learning_rate as jax_set_lr
from gcn_tpu.train.trainer import Trainer as JaxTrainer
from gcn_tpu_torch import config
from gcn_tpu_torch.convert import params_from_jax, params_to_jax
from gcn_tpu_torch.data.dataset import Batcher, RelationDataset
from gcn_tpu_torch.data.vocab import Vocab
from gcn_tpu_torch.models.gcn import GCNClassifier
from gcn_tpu_torch.train.evaluator import batch_to_device
from gcn_tpu_torch.train.optim import CORES, build_optimizer, \
    set_learning_rate
from gcn_tpu_torch.train.trainer import Trainer
from tests.conftest import load_golden
from tests.test_model_parity import golden_to_batch, golden_to_cfg
from tests.test_torch_port_cuda import one_torch_thread  # noqa: F401
from tests.test_torch_port_model import DATA, VOCAB, _configs

TRAIN = os.path.join(DATA, "train.json")
NO_DROPOUT = {"model.input_dropout": 0.0, "model.rnn_dropout": 0.0,
              "model.gcn_dropout": 0.0}


def _train_batchers(jcfg, tcfg, seed, **kw):
    jds = JaxDataset(TRAIN, jcfg, JaxVocab.load(VOCAB))
    tds = RelationDataset(TRAIN, tcfg, Vocab.load(VOCAB))
    return JaxBatcher(jds, 8, seed=seed, **kw), Batcher(tds, 8, seed=seed,
                                                        **kw)


@pytest.mark.parametrize("kw", [{}, {"pad_batches": False},
                                {"group_by_length": True}])
@pytest.mark.parametrize("seed", [0, 1234])
def test_train_batcher_matches_jax(seed, kw):
    jcfg, tcfg = _configs()
    jb, tb = _train_batchers(jcfg, tcfg, seed, **kw)
    assert jb.gold() == tb.gold() and jb.order == tb.order
    dropped = 0
    for _ in range(2):  # word dropout is drawn anew every epoch
        for a, b in zip(jb, tb):
            assert set(a) == set(b)
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            dropped += int((b["words"] == 1).sum())
    assert dropped > 0


def _params_close(port, jax_params, tol=1e-4):
    got = params_from_jax(params_to_jax(port.model.state_dict()))
    want = params_from_jax(jax.device_get(jax_params))
    assert set(got) == set(want)
    for k, v in want.items():
        scale = max(1.0, float(v.abs().max()))
        assert float((got[k] - v).abs().max()) <= tol * scale, k


@pytest.mark.parametrize("mode", ["fused", "update_gap_2", "update_lr"])
def test_trainer_trajectory_matches_jax(mode):
    gap = 2 if mode == "update_gap_2" else 1
    jcfg, tcfg = _configs(**NO_DROPOUT, **{
        "model.rnn_impl": "auto", "model.deprel_factored": "auto",
        "train.effective_batch_size": 8 * gap})
    assert jcfg.train.update_gap == tcfg.train.update_gap == gap
    jt = JaxTrainer(jcfg)
    tt = Trainer(tcfg, params_from_jax(jax.device_get(jt.params)),
                 device="cpu")
    jb, tb = _train_batchers(jcfg, tcfg, seed=3)
    for i, (a, b) in enumerate(zip(jb, tb)):
        if mode == "update_lr" and i == 2:
            jt.update_lr(0.1)
            tt.update_lr(0.1)
        want, got = float(jt.update(a)), float(tt.update(b))
        assert got == pytest.approx(want, rel=1e-4), i
    assert tt.global_step == jt.global_step == 5
    jt.flush_gradients()
    tt.flush_gradients()
    _params_close(tt, jt.params)


def test_train_golden_replays():
    """25 steps of CE + clip(5) + adagrad from the torch reference's
    weights on its batch, asserted as tests/test_train_parity.py does."""
    z = load_golden("train_full_rnn.npz")
    opt = json.loads(bytes(z["opt"]).decode())
    jcfg = golden_to_cfg(opt)
    state = {k[len("state."):]: v for k, v in z.items()
             if k.startswith("state.")}
    model = GCNClassifier(config.ModelConfig(**dataclasses.asdict(jcfg)))
    model.load_state_dict(params_from_jax(torch_state_to_params(state,
                                                                jcfg)))
    batch = golden_to_batch(z, opt["prune_k"])
    batch["labels"] = z["in.labels"].astype(np.int32)
    batch = batch_to_device(batch, torch.device("cpu"))
    params = dict(model.named_parameters())
    tx = build_optimizer("adagrad", float(z["lr"]), max_grad_norm=5.0)
    tx.init(params)
    losses = []
    for _ in range(len(z["losses"])):
        logits, _ = model(batch)
        loss = torch.nn.functional.cross_entropy(logits, batch["labels"])
        grads = torch.autograd.grad(loss, list(params.values()))
        tx.step(params, dict(zip(params, grads)))
        losses.append(float(loss.detach()))
    ref = z["losses"]
    assert abs(losses[0] - ref[0]) < 2e-5, (losses[0], ref[0])
    np.testing.assert_allclose(losses[:15], ref[:15], rtol=5e-3, atol=2e-3)
    assert abs(losses[-1] - ref[-1]) < 0.25, (losses[-1], ref[-1])
    assert losses[-1] < losses[0] * 0.6


def _tree(rng, scale=1.0):
    return {"word_emb": rng.randn(10, 4).astype(np.float32) * scale,
            "a": rng.randn(3, 5).astype(np.float32) * scale,
            "b": rng.randn(7).astype(np.float32) * scale}


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("topn", [0, 4, 100])
@pytest.mark.parametrize("name", [c for c in CORES if c != "myadagrad"])
def test_optimizer_matches_optax(name, topn, clip):
    rng = np.random.RandomState(len(name) + topn)
    params = _tree(rng)
    max_norm = 1.0 if clip else 1e3
    tx = jax_build_optimizer(name, 0.3, max_grad_norm=max_norm, topn=topn,
                             lr_decay=0.1)
    state = tx.init(params)
    jparams = params
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = build_optimizer(name, 0.3, max_grad_norm=max_norm, topn=topn,
                          lr_decay=0.1)
    opt.init(tparams)
    for _ in range(5):
        grads = _tree(rng, scale=3.0)
        norm = np.sqrt(sum(np.square(g).sum() for g in grads.values()))
        assert (norm > max_norm) == clip
        updates, state = tx.update(grads, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.step(tparams, {k: torch.from_numpy(v) for k, v in
                           grads.items()})
    for k, v in jparams.items():
        np.testing.assert_allclose(tparams[k].numpy(), np.asarray(v),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    frozen = params["word_emb"][max(topn, 0):]
    np.testing.assert_array_equal(tparams["word_emb"][max(topn, 0):]
                                  .numpy(), frozen)


@pytest.mark.parametrize("name", ["sgd", "adagrad", "adam"])
def test_set_learning_rate_changes_the_next_step(name):
    rng = np.random.RandomState(0)
    params, grads = _tree(rng), _tree(rng)
    tx = jax_build_optimizer(name, 0.3)
    state = jax_set_lr(tx.init(params), 0.05)
    updates, _ = tx.update(grads, state, params)
    opt = build_optimizer(name, 0.3)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt.init(tparams)
    set_learning_rate(opt, 0.05)
    opt.step(tparams, {k: torch.from_numpy(v) for k, v in grads.items()})
    for k, u in updates.items():
        np.testing.assert_allclose(tparams[k].numpy() - params[k],
                                   np.asarray(u), rtol=1e-5, atol=1e-7)
    moved = float(np.abs(np.asarray(updates["a"])).max())
    if name == "adam":  # a fixed 1e-3, whatever the rate
        assert moved == pytest.approx(1e-3, rel=1e-3)
    else:
        assert moved < 0.3 * float(np.abs(grads["a"]).max()) / 2


@pytest.mark.parametrize("shared", [False, True])
def test_params_round_trip_through_the_port(shared):
    jcfg, _ = _configs(**{"model.deprel_shared_w": shared})
    tree = jax.device_get(JaxTrainer(jcfg).params)
    back = params_to_jax(params_from_jax(tree))
    flat = jax.tree_util.tree_leaves_with_path(tree)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        node = back
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, leaf)
    assert ("gcn_deprel_w" in tree["params"]) == shared


def test_cpu_trainer_learns_with_dropout():
    """Dropout, word dropout and pooling_l2 on: the training loss over the
    in-repo train split falls."""
    _, tcfg = _configs(**{"train.lr": 1.0, "train.effective_batch_size": 8})
    ds = RelationDataset(TRAIN, tcfg, Vocab.load(VOCAB))
    batcher = Batcher(ds, 8, seed=0)
    tt = Trainer(tcfg, device="cpu")
    epochs = [[float(tt.update(b)) for b in batcher] for _ in range(4)]
    assert np.mean(epochs[-1]) < np.mean(epochs[0]) - 0.1
    assert all(np.isfinite(epochs[-1]))
    preds, probs, loss = tt.predict_batch(next(iter(batcher)))
    assert len(preds) == len(probs) == 8 and np.isfinite(loss)
