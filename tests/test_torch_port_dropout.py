"""The port's stochastic regularizers and the model's stochastic forward.

Torch generators do not give JAX's bits, so these tests check what the
JAX package's functions promise: keep rates within 0.01 over 10^5 draws
(five standard deviations or more), the 1/(1-p) scale, the identity when
deterministic or the rate leaves nothing to drop, one shared draw per
(row, word type) for embedding dropout, and masks that are a function of
(seed, step) alone.
"""

import numpy as np
import pytest
import torch

from gcn_tpu_torch.models.gcn import GCNClassifier, init_params
from gcn_tpu_torch.ops import dropout as D
from gcn_tpu_torch.train.evaluator import batch_to_device
from gcn_tpu_torch.train.trainer import Trainer, step_seed
from tests.test_torch_port_cuda import (  # noqa: F401
    one_torch_thread,
    random_batch,
    small_cfg,
)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keeps_and_scales(rate):
    x = torch.ones(100_000)
    y = D.dropout(x, rate, False, _gen())
    kept = y != 0
    assert abs(float(kept.float().mean()) - (1 - rate)) < 0.01
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / (1 - rate)))
    v = D.variational_dropout(torch.ones(400, 5, 50), rate, False, _gen())
    assert torch.equal(v[:, :1].expand_as(v), v)  # one mask per sequence
    assert abs(float((v != 0).float().mean()) - (1 - rate)) < 0.01


def test_identity_when_deterministic_or_rate_zero():
    x = torch.randn(4, 6, 3)
    g = _gen()
    before = g.get_state()
    assert D.dropout(x, 0.5, True, g) is x
    assert D.dropout(x, 0.0, False, g) is x
    assert D.variational_dropout(x, 0.5, True, g) is x
    assert D.embedding_dropout_mask(torch.ones(4, 6, dtype=torch.long), 9,
                                    0.0, False, g) is None
    adj = torch.ones(2, 5, 5)
    assert D.drop_edges(adj, 1.0, False, g) is adj
    assert D.drop_edges(adj, 0.5, True, g) is adj
    assert D.forget_deprels(x, 1.0, False, g) is x
    ids = torch.arange(6).reshape(2, 3)
    assert D.forget_ids(ids, 99, 0.5, True, g) is ids
    assert torch.equal(g.get_state(), before)  # nothing was drawn


def test_embedding_dropout_shares_a_draw_per_word_type():
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, 20, (500, 40)))
    mask = D.embedding_dropout_mask(ids, 20, 0.3, False, _gen())
    assert mask.shape == (500, 40, 1) and mask.dtype == torch.float32
    m = mask[:, :, 0]
    assert set(torch.unique(m).tolist()) <= {0.0, np.float32(1 / 0.7)}
    for b in range(20):
        for w in torch.unique(ids[b]).tolist():
            vals = m[b][ids[b] == w]
            assert torch.all(vals == vals[0])
    first = torch.stack([m[b][ids[b] == ids[b, 0]][0] for b in range(500)])
    assert abs(float((first != 0).float().mean()) - 0.7) < 0.06


def test_edge_drop_and_deprel_forgetting_rates():
    adj = torch.ones(40, 50, 50)
    kept = D.drop_edges(adj, 0.8, False, _gen())
    assert set(torch.unique(kept).tolist()) == {0.0, 1.0}
    assert abs(float(kept.mean()) - 0.8) < 0.01
    e = torch.full((200, 500, 3), 2.0)
    f = D.forget_deprels(e, 0.7, False, _gen())
    forgot = (f == 1.0).all(-1)
    assert torch.equal(forgot, (f != 2.0).any(-1))
    assert abs(float(forgot.float().mean()) - 0.3) < 0.01
    ids = torch.full((200, 500), 5)
    out = D.forget_ids(ids, 99, 0.7, False, _gen())
    assert set(torch.unique(out).tolist()) == {5, 99}
    assert abs(float((out == 99).float().mean()) - 0.3) < 0.01


def _model_and_batch(**extra):
    cfg = small_cfg(**extra)
    model = GCNClassifier(cfg.model)
    init_params(model, _gen())
    batch = batch_to_device(random_batch(np.random.RandomState(2)),
                            torch.device("cpu"))
    return cfg, model, batch


def test_stochastic_forward_is_a_function_of_seed_and_step():
    cfg, model, batch = _model_and_batch(**{
        "model.emb_dropout": 0.1, "model.edge_keep_prob": 0.8,
        "model.deprel_keep_prop": 0.7, "model.rnn_layers": 2})
    tr = Trainer(cfg, model.state_dict(), device="cpu")
    with torch.no_grad():
        det, _ = tr.model(batch)
        a, _ = tr.model(batch, False, tr.step_generator(3))
        b, _ = tr.model(batch, False, tr.step_generator(3))
        c, _ = tr.model(batch, False, tr.step_generator(4))
        other = Trainer(cfg, model.state_dict(), rng_seed=cfg.train.seed + 1,
                        device="cpu")
        d, _ = other.model(batch, False, other.step_generator(3))
    assert torch.equal(a, b)
    assert not torch.allclose(a, c) and not torch.allclose(a, det)
    assert not torch.allclose(a, d)
    assert step_seed(0, 3) != step_seed(0, 4) != step_seed(1, 3)
    with pytest.raises(ValueError, match="generator"):
        tr.model(batch, deterministic=False)


def test_zero_rates_make_the_stochastic_forward_deterministic():
    cfg, model, batch = _model_and_batch(**{
        "model.input_dropout": 0.0, "model.rnn_dropout": 0.0,
        "model.gcn_dropout": 0.0})
    g = _gen(5)
    before = g.get_state()
    with torch.no_grad():
        a, ha = model(batch)
        b, hb = model(batch, False, g)
    assert torch.equal(a, b) and torch.equal(ha, hb)
    assert torch.equal(g.get_state(), before)


def test_forgetting_gives_each_layer_its_own_plan(monkeypatch):
    """With deprel forgetting on, the relation ids differ between layers,
    so the sort plan is not reused; the stochastic step still trains."""
    cfg, model, batch = _model_and_batch(**{"model.deprel_keep_prop": 0.5,
                                            "model.num_layers": 2,
                                            "model.deprel_max_depth": 2})
    plans = []
    real = GCNClassifier._group_plan

    def spy(self, plans_, key, ids, n, det):
        plan = real(self, plans_, key, ids, n, det)
        plans.append(plan)
        return plan

    monkeypatch.setattr(GCNClassifier, "_group_plan", spy)
    logits, _ = model(batch, False, _gen(1))
    model(batch)
    assert len(plans) == 4
    assert not torch.equal(plans[0].onehot, plans[1].onehot)
    assert plans[2] is plans[3]  # deterministic: one plan for both layers
    loss = logits.square().mean()
    grads = torch.autograd.grad(loss, list(model.parameters()),
                                allow_unused=True)
    assert all(torch.isfinite(g).all() for g in grads if g is not None)
