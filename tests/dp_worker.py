"""Data-parallel scenarios for the port, and a rank that runs them (no JAX).

Each scenario is a small C-GCN configuration, global batches made with
numpy from a seed (or the in-repo data), and some optimizer steps, then an
evaluation.  ``run`` drives one scenario through a trainer on batches it
is handed; the tests run it through ``Trainer`` on the global batches in
process, and start two ranks of this module as subprocesses, which run
every scenario through ``DistributedTrainer`` over gloo on their rows
(``ShardedBatcher``):

    GCN_TPU_COORDINATOR=localhost:PORT GCN_TPU_NUM_PROCS=2 \\
    GCN_TPU_PROC_ID=R python tests/dp_worker.py OUT_DIR [STATE_FILE \
    [NAME,...]]

Each rank saves its results to ``OUT_DIR/rank{R}.pt``: per scenario the
losses, the whole parameters after the steps (``full_state_dict``) and
the evaluation's output.
``STATE_FILE`` (a ``torch.save``d state dict, or empty) starts the ``jax``
scenario; ``NAME,...`` runs those scenarios (by default ``SCENARIOS``;
``accum`` only when named).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from gcn_tpu_torch.config import cgcn_preset  # noqa: E402
from gcn_tpu_torch.data.dataset import (  # noqa: E402
    PackedBatcher,
    RelationDataset,
)
from gcn_tpu_torch.data.sharding import ShardedBatcher  # noqa: E402
from gcn_tpu_torch.data.vocab import Vocab  # noqa: E402
from gcn_tpu_torch.train.trainer import SPARSE_EMB_AUTO_VOCAB  # noqa: E402

B, N = 8, 16
DATA = os.path.join(REPO, "dataset", "tacred")
VOCAB = os.path.join(REPO, "dataset", "vocab", "vocab.pkl")
NO_DROPOUT = {"model.input_dropout": 0.0, "model.rnn_dropout": 0.0,
              "model.gcn_dropout": 0.0}


def tiny_cfg(**overrides):
    """``cgcn_preset`` at small widths (its dropouts, sgd 0.3, B=8)."""
    cfg = cgcn_preset(**{
        "model.emb_dim": 32, "model.pos_dim": 8, "model.ner_dim": 8,
        "model.rnn_hidden": 16, "model.hidden_dim": 16,
        "model.deprel_emb_dim": 8, "model.vocab_size": 128,
        "train.batch_size": B, "train.effective_batch_size": B,
        **overrides})
    return cfg


def synthetic_batch(cfg, seed: int, padded: int = 0) -> dict:
    """A [B, N] batch of random sentences and trees; its last ``padded``
    rows are padding (``example_mask`` False), as a batcher pads."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(N // 2, N + 1, B).astype(np.int32)
    lengths[B - padded:] = 0
    batch = {
        "words": rng.randint(2, cfg.model.vocab_size, (B, N)).astype(
            np.int32),
        "pos": rng.randint(2, 47, (B, N)).astype(np.int32),
        "ner": rng.randint(2, 15, (B, N)).astype(np.int32),
        "deprel": rng.randint(2, 41, (B, N)).astype(np.int32),
        "subj_mask": np.zeros((B, N), bool),
        "obj_mask": np.zeros((B, N), bool),
        "pad_mask": np.ones((B, N), bool),
        "lengths": lengths,
        "labels": rng.randint(0, cfg.model.num_class, B).astype(np.int32),
        "example_mask": lengths > 0,
        "edge_parent": np.zeros((B, N), np.int32),
        "edge_child": np.zeros((B, N), np.int32),
        "edge_deprel": np.zeros((B, N), np.int32),
        "edge_mask": np.zeros((B, N), bool),
    }
    for i in range(B):
        li = int(lengths[i])
        for k in ("words", "pos", "ner", "deprel"):
            batch[k][i, li:] = 0
        if li == 0:
            continue
        batch["subj_mask"][i, rng.randint(li)] = True
        batch["obj_mask"][i, rng.randint(li)] = True
        batch["pad_mask"][i, :li] = False
        for t in range(1, li):  # a random tree over the first li tokens
            batch["edge_parent"][i, t - 1] = rng.randint(t)
            batch["edge_child"][i, t - 1] = t
            batch["edge_deprel"][i, t - 1] = rng.randint(2, 41)
            batch["edge_mask"][i, t - 1] = True
    return batch


class Batches:
    """A list of same-size global batches with a batcher's surface."""

    def __init__(self, batches: list, batch_size: int = B):
        self.batches = batches
        self.batch_size = batch_size

    def __iter__(self):
        return iter(self.batches)

    def __len__(self) -> int:
        return len(self.batches)


def _packed(cfg, split: str, evaluation: bool):
    ds = RelationDataset(os.path.join(DATA, f"{split}.json"), cfg,
                         Vocab.load(VOCAB), evaluation=evaluation)
    return PackedBatcher(ds, 4, pack_len=64, max_slots=4,
                         evaluation=evaluation, seed=3)


def scenario(name: str):
    """(config, train batches, evaluation batches) of a scenario."""
    if name == "packed":
        cfg = tiny_cfg(**{"model.vocab_size": Vocab.load(VOCAB).size,
                          "train.batch_size": 4,
                          "train.effective_batch_size": 4,
                          "data.pack_sentences": 4, "data.pack_len": 64})
        train = _packed(cfg, "train", False)
        batches = [train.materialize(c) for c in train.chunks[:3]]
        return cfg, Batches(batches, 4), Batches(
            list(_packed(cfg, "dev", True))[:2], 4)
    over = {
        # the preset's dropouts, and every other stochastic point: word
        # type, edge and deprel dropout, the BiLSTM's inter-layer dropout
        "dropout": {"model.emb_dropout": 0.2, "model.edge_keep_prob": 0.9,
                    "model.deprel_keep_prop": 0.9, "model.rnn_layers": 2},
        "jax": {**NO_DROPOUT, "model.rnn": False},
        "padded": {},
        "conv_l2": {"train.conv_l2": 0.01},
        "sparse": {"train.optim": "adagrad", "train.sparse_emb_grad": "true",
                   "model.emb_dropout": 0.2},
        # update_gap 2 over 5 batches: two applies, then a flush of one
        "accum": {"train.effective_batch_size": 2 * B},
    }[name]
    cfg = tiny_cfg(**over)
    padded = {"padded": (3, 1, 4), "accum": (0, 3, 0, 0, 5)}.get(
        name, (0, 0, 0))
    batches = [synthetic_batch(cfg, 10 + i, pad)
               for i, pad in enumerate(padded)]
    evals = [synthetic_batch(cfg, 20), synthetic_batch(cfg, 21, padded=3)]
    return cfg, Batches(batches), Batches(evals)


SCENARIOS = ("dropout", "jax", "padded", "conv_l2", "packed", "sparse")


def run(trainer, batches, evals) -> dict:
    """The scenario's steps (any pending accumulation flushed) and
    evaluation through ``trainer``."""
    losses = [float(trainer.update(b)) for b in batches]
    trainer.flush_gradients()
    preds, probs, loss = trainer.evaluate(evals)
    return {"losses": losses,
            "params": {k: v.detach().clone() for k, v in
                       trainer.full_state_dict().items()},
            "preds": preds, "probs": np.asarray(probs), "eval_loss": loss,
            "sparse_emb": trainer.sparse_emb}


def main(out_dir: str, state_file: str | None = None,
         names: str = ",".join(SCENARIOS)) -> None:
    from gcn_tpu_torch.parallel import distributed
    from gcn_tpu_torch.train.distributed_trainer import DistributedTrainer

    torch.set_num_threads(1)
    distributed.initialize(backend="gloo")
    rank, world = distributed.rank(), distributed.world_size()
    results = {}
    for name in names.split(","):
        cfg, batches, evals = scenario(name)
        state = (torch.load(state_file, weights_only=True)
                 if name == "jax" and state_file else None)
        tr = DistributedTrainer(cfg, state, rng_seed=0, device="cpu")
        results[name] = run(tr, ShardedBatcher(batches, rank, world),
                            ShardedBatcher(evals, rank, world))
    # "auto" stays dense under data parallelism, whatever the table
    big = tiny_cfg(**{"model.vocab_size": SPARSE_EMB_AUTO_VOCAB,
                      "model.emb_dim": 4})
    results["auto_sparse"] = DistributedTrainer(big, device="cpu").sparse_emb
    results["world"] = world
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    distributed.shutdown()


if __name__ == "__main__":
    main(*sys.argv[1:])
