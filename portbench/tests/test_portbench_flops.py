"""``flops.model_flops`` against ``torch``'s ``FlopCounterMode`` on the
program's plain path (``rnn_impl="scan"``, ``deprel_factored="ragged"``)
on a training batch whose sentences fill their bucket, so that no product
runs on padding.  Every difference is a term of its own below:

* the aggregation: counted by kept edges, 2·E·H a band; the plain path
  multiplies the dense [N, N] bands (the C-GCN's two bands, the GCN's one
  combined band), and only the messages take a gradient;
* the relation biases: a gather in the model, a one-hot product (rows ×
  87 × H) on the plain path, whose backward is the bias's gradient alone;
* the plain scan's backward recomputes each step's ``h W_hh`` product;
* the sgd update (5 a parameter), which the counter does not see."""

import json
import os

import pytest

from portbench import flops, generator, harness, jobs

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("config", ["cgcn", "gcn"])
def test_model_flops_match_the_counter_on_the_plain_path(config, tmp_path):
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from gcn_tpu_torch.data.dataset import Batcher, RelationDataset
    from gcn_tpu_torch.data.vocab import Vocab
    from gcn_tpu_torch.train.evaluator import batch_to_device
    from gcn_tpu_torch.train.trainer import Trainer

    cell = harness.find_cell(f"{config}.train.tacred")
    cell.config["model"].update(rnn_impl="scan", deprel_factored="ragged")
    with open(os.path.join(PB, "traffic", "tacred.train.json")) as f:
        mix = json.load(f)
    n, b = 16, 4
    mix["lengths"].update(min=n, cap=n)  # every sentence fills its bucket
    m = cell.config["model"]
    vocab = generator.vocabulary(m["vocab_size"])
    path = str(tmp_path / "split.json")
    generator.write_records(generator.make_records(mix, 3, len(vocab), b),
                            path)
    seeds = harness.seeds_of(3)
    cfg = jobs.program_config(cell, seeds)
    batch = next(iter(Batcher(RelationDataset(path, cfg, Vocab(vocab)), b,
                              seed=1)))
    assert batch["words"].shape == (b, n) and batch["lengths"].min() == n
    tr = Trainer(cfg, device="cpu")
    dev = batch_to_device(batch, tr.device)
    with FlopCounterMode(display=False) as counter:
        tr._grads(dev, tr.step_generator(0))
    counted = counter.get_total_flops()

    tok, e = b * n, int(batch["edge_mask"].sum())
    h = m["hidden_dim"]
    expect = flops.model_flops(m, tok, e, b, True) - 5 * flops.param_count(m)
    for t in flops.layer_widths(m):
        if m["adj_type"] == "full_deprel":
            expect += 2 * (2 * 2 * b * n * n * h - 2 * 2 * e * h)
            expect += 2 * (2 * (2 * tok) * flops.RELATION_ROWS * h)
        else:
            expect += 2 * (2 * b * n * n * t - 2 * 2 * e * t)
    if m["rnn"]:
        rh = m["rnn_hidden"]
        expect += 2 * 2 * tok * rh * 4 * rh
    assert counted == expect
