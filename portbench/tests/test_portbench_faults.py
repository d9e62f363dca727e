"""A run whose timed path is broken underneath comes out not correct: the
harness's whole run on the CPU (its look for a chip skipped), with each
fault a cell can have planted in the program.  The exchange between chips
is no fault of these one-chip cells."""

import time

import pytest

from portbench import run


def run_cpu(cell):
    result, _ = run.run_cell(cell, 2**31 + 91, 0.2, False, device="cpu",
                             t0=time.perf_counter(), sentences=150)
    return result


@pytest.mark.parametrize("cell", ["cgcn.train.tacred", "gcn.train.tacred"])
def test_step_that_leaves_the_state_unchanged(cell, monkeypatch):
    from gcn_tpu_torch.train import optim

    monkeypatch.setattr(optim.Optimizer, "step",
                        lambda self, params, grads: None)
    result = run_cpu(cell)
    assert not result["correct"]
    # every leaf reads 1 over its own norm; the median leaf's gap is over
    # the larger of its own and the median's
    assert result["checks"]["change"]["value"] > 0.5


@pytest.mark.parametrize("cell", ["cgcn.train.tacred", "gcn.train.tacred"])
def test_half_the_batch_left_out(cell, monkeypatch):
    from gcn_tpu_torch.train import trainer

    make = trainer.make_loss_fn

    def half(model, cfg, *a, **k):
        loss = make(model, cfg, *a, **k)

        def fn(batch, generator):
            em = batch["example_mask"].clone()
            em[em.shape[0] // 2:] = False
            return loss(dict(batch, example_mask=em), generator)

        return fn

    monkeypatch.setattr(trainer, "make_loss_fn", half)
    result = run_cpu(cell)
    assert not result["correct"]
    first = result["checks"]["loss_first"]
    assert first["value"] > 10 * first["limit"]


def test_tokens_altered_where_the_batch_is_made(monkeypatch):
    from gcn_tpu_torch.data import dataset

    materialize = dataset.Batcher.materialize

    def altered(self, chunk):  # the first sentence's words all UNK
        batch = materialize(self, chunk)
        batch["words"] = batch["words"].copy()
        n = int(batch["lengths"][0])
        batch["words"][0, :n] = 1
        return batch

    monkeypatch.setattr(dataset.Batcher, "materialize", altered)
    result = run_cpu("cgcn.train.tacred")
    assert not result["correct"]


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    from gcn_tpu_torch.train import evaluator

    core = evaluator.Evaluator._eval_core

    def altered(self, batch):
        probs, loss = core(self, batch)
        probs = probs.clone()
        probs[0] = probs[0].flip(0)
        return probs, loss

    monkeypatch.setattr(evaluator.Evaluator, "_eval_core", altered)
    result = run_cpu("cgcn.eval.tacred")
    assert not result["correct"]
    assert result["checks"]["prob"]["value"] > 1e-3
