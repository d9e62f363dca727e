"""The port's row-sparse word-embedding update (``train.sparse_emb``) on
the CPU, with the cases of gcn_tpu's ``tests/test_sparse_emb.py``.

* ``coalesce`` sums repeated ids as ``np.add.at`` does (within 1e-5),
  one nonzero row an id, the same bits twice, and gcn_tpu's ``coalesce``'s
  layout (sorted ids, each sum at its run's first position).
* Sparse against dense steps for {sgd, adagrad} × {every row, topn 40 with
  embedding dropout 0.3, a frozen table}: losses, parameters and the
  optimizer state within 1e-6; also through ``update_chunk``.
* ``auto``'s eligibility, the ``ValueError`` of ``true`` where it cannot
  run, and checkpoints that either mode resumes.
* The port's sparse ``Trainer`` against gcn_tpu's sparse ``Trainer`` from
  the same weights for 4 steps (dropout off: the frameworks' masks
  differ): losses and parameters within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_tpu.config import Config as JaxConfig
from gcn_tpu.train.sparse_emb import coalesce as jax_coalesce
from gcn_tpu.train.trainer import Trainer as JaxTrainer
from gcn_tpu_torch.convert import params_from_jax
from gcn_tpu_torch.train.sparse_emb import coalesce
from gcn_tpu_torch.train.trainer import SPARSE_EMB_AUTO_VOCAB, Trainer
from tests import dp_worker
from tests.test_torch_port_cuda import one_torch_thread  # noqa: F401


def _cfg(optim="sgd", mode="auto", topn=10**10, emb_dropout=0.0, **over):
    return dp_worker.tiny_cfg(**{
        "model.rnn": False, "train.optim": optim, "train.lr": 0.3,
        "train.sparse_emb_grad": mode, "model.topn": topn,
        "model.emb_dropout": emb_dropout, **over})


def _train(cfg, steps=4, chunk=False, state=None):
    tr = Trainer(cfg, state, rng_seed=0, device="cpu")
    batches = [dp_worker.synthetic_batch(cfg, i) for i in range(steps)]
    if chunk:
        losses = [float(x) for x in tr.update_chunk(batches)]
    else:
        losses = [float(tr.update(b)) for b in batches]
    return losses, tr


def _max_delta(a: Trainer, b: Trainer) -> float:
    ta = [*a.params.values(), *a.opt.state_tensors()]
    tb = [*b.params.values(), *b.opt.state_tensors()]
    return max(float((x.detach().float() - y.detach().float()).abs().max())
               for x, y in zip(ta, tb))


@pytest.mark.parametrize("t,v", [(40, 7), (4800, 300)])
def test_coalesce_matches_dense_scatter_add(t, v):
    rng = np.random.RandomState(0)
    ids = rng.randint(0, v, t)
    rows = rng.randn(t, 5).astype(np.float32)
    sids, crows = coalesce(torch.as_tensor(ids), torch.as_tensor(rows))
    dense = np.zeros((v, 5), np.float32)
    np.add.at(dense, ids, rows)
    recon = np.zeros((v, 5), np.float32)
    np.add.at(recon, sids.numpy(), crows.numpy())
    np.testing.assert_allclose(recon, dense, atol=1e-5)
    # repeats carry zeros: one position an id
    assert int(crows.numpy().any(axis=1).sum()) == len(np.unique(ids))
    again = coalesce(torch.as_tensor(ids), torch.as_tensor(rows))
    assert torch.equal(again[0], sids) and torch.equal(again[1], crows)
    # gcn_tpu's layout: its sorted ids, nonzero rows at the same places
    jsids, jrows = jax_coalesce(jnp.asarray(ids, jnp.int32),
                                jnp.asarray(rows))
    np.testing.assert_array_equal(np.asarray(jsids), sids.numpy())
    np.testing.assert_allclose(np.asarray(jrows), crows.numpy(), atol=1e-5)


@pytest.mark.parametrize("optim", ["sgd", "adagrad"])
@pytest.mark.parametrize("topn,emb_dropout", [
    (10**10, 0.0),  # every row finetuned
    (40, 0.3),      # partial freeze + word-type embedding dropout
    (0, 0.0),       # a frozen table
])
def test_sparse_matches_dense(optim, topn, emb_dropout):
    ls, trs = _train(_cfg(optim, "true", topn, emb_dropout))
    ld, trd = _train(_cfg(optim, "false", topn, emb_dropout))
    assert trs.sparse_emb and not trd.sparse_emb
    np.testing.assert_allclose(ls, ld, rtol=1e-6, atol=1e-6)
    assert _max_delta(trs, trd) < 1e-6


def test_sparse_chunked_dispatch_matches_dense():
    ls, trs = _train(_cfg("adagrad", "true",
                          **{"train.steps_per_dispatch": 4}), chunk=True)
    ld, trd = _train(_cfg("adagrad", "false"))
    np.testing.assert_allclose(ls, ld, rtol=1e-6, atol=1e-6)
    assert _max_delta(trs, trd) < 1e-6


def test_auto_eligibility():
    def sparse(optim="sgd", **over):
        cfg = _cfg(optim, "auto", **{"model.emb_dim": 4, **over})
        return Trainer(cfg, device="cpu").sparse_emb

    assert sparse(**{"model.vocab_size": SPARSE_EMB_AUTO_VOCAB})
    assert not sparse()  # a small table
    # adam's family stays dense (its state moves untouched rows)
    assert not sparse("adam", **{"model.vocab_size": SPARSE_EMB_AUTO_VOCAB})
    # accumulating configurations stay dense
    assert not sparse(**{"model.vocab_size": SPARSE_EMB_AUTO_VOCAB,
                         "train.effective_batch_size": 16})
    # forcing it where it cannot run is an error
    for over in ({"train.optim": "adam"},
                 {"train.effective_batch_size": 16}):
        with pytest.raises(ValueError, match="sparse_emb_grad true"):
            Trainer(_cfg(mode="true", **over), device="cpu")


def test_checkpoints_interchangeable_across_modes(tmp_path):
    """The optimizer state has one layout in both modes: a sparse run's
    checkpoint resumes a dense trainer and a sparse one alike."""
    _, trs = _train(_cfg("adagrad", "true"), steps=2)
    trs.save(str(tmp_path / "ck"), epoch=1)
    trd = Trainer(_cfg("adagrad", "false"), device="cpu")
    trd.load(str(tmp_path / "ck"))
    assert _max_delta(trs, trd) < 1e-7
    nxt = dp_worker.synthetic_batch(trd.cfg, 9)
    l_dense = float(trd.update(nxt))
    tr2 = Trainer(_cfg("adagrad", "true"), device="cpu")
    tr2.load(str(tmp_path / "ck"))
    l_sparse = float(tr2.update(nxt))
    assert abs(l_dense - l_sparse) < 1e-6
    assert _max_delta(tr2, trd) < 1e-6


@pytest.mark.parametrize("optim", ["sgd", "adagrad"])
def test_sparse_trainer_matches_gcn_tpus(optim):
    cfg = _cfg(optim, "true", **dp_worker.NO_DROPOUT)
    batches = [dp_worker.synthetic_batch(cfg, i) for i in range(4)]
    jt = JaxTrainer(JaxConfig.from_dict(cfg.to_dict()), rng_seed=0,
                    init_batch=batches[0])
    assert jt._sparse_emb
    state = params_from_jax(jax.device_get(jt.params))
    losses, tr = _train(cfg, state=state)
    want = [float(jt.update(b)) for b in batches]
    np.testing.assert_allclose(losses, want, rtol=1e-4)
    got = params_from_jax(jax.device_get(jt.params))
    for k, v in tr.model.state_dict().items():
        assert float((v - got[k]).abs().max()) <= 1e-4 * max(
            1.0, float(got[k].abs().max())), k
