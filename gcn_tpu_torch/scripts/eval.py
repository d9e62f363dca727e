"""Evaluate a trained checkpoint on a TACRED/SemEval split.

The port's counterpart of the root ``eval.py``, with its arguments: it
loads the config, the vocabulary snapshotted into the run directory and
the checkpoint (either package's), scores with the official micro-F1
scorer, dumps the misclassified examples into the run directory, and
prints one JSON line with the scores and sentences per second.  Batches
are ``eval_batch_size`` rows (``batch_size`` where that is 0).

    python -m gcn_tpu_torch.scripts.eval saved_models/00 --dataset test
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from gcn_tpu_torch.config import Config
from gcn_tpu_torch.convert import params_from_jax
from gcn_tpu_torch.data.dataset import Batcher, RelationDataset, constants_for
from gcn_tpu_torch.data.vocab import Vocab
from gcn_tpu_torch.train import scorer
from gcn_tpu_torch.train.checkpoint import load_checkpoint
from gcn_tpu_torch.train.evaluator import Evaluator, resolve_device


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("model_dir", help="Run directory, e.g. saved_models/00")
    p.add_argument("--model", default="best_model",
                   help="Checkpoint name inside the run directory.")
    p.add_argument("--data_dir", default=None,
                   help="Override the dataset directory from the config.")
    p.add_argument("--dataset", default="test",
                   help="Split to evaluate: train/dev/test.")
    p.add_argument("--out", default="",
                   help="Optional path to dump predicted labels, one per line.")
    p.add_argument("--cpu", action="store_true",
                   help="Run on the CPU (the kernels' plain versions).")
    args = p.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")

    cfg = Config.load(os.path.join(args.model_dir, "config.json"))
    if args.data_dir:
        cfg.data.data_dir = args.data_dir
    C = constants_for(cfg.model.dataset)

    vocab = Vocab.load(os.path.join(args.model_dir, "vocab.pkl"))
    if vocab.size != cfg.model.vocab_size:
        raise ValueError(f"Vocab size {vocab.size} != saved config "
                         f"{cfg.model.vocab_size}")

    params, _, blob = load_checkpoint(
        os.path.join(args.model_dir, args.model), load_opt_state=False)
    evaluator = Evaluator(cfg, params_from_jax(params), device=device)
    print(f"Loaded checkpoint (epoch {blob.get('meta', {}).get('epoch')}) "
          f"from {args.model_dir}/{args.model}")

    data_file = os.path.join(cfg.data.data_dir, f"{args.dataset}.json")
    ds = RelationDataset(data_file, cfg, vocab, evaluation=True)
    batcher = Batcher(ds, cfg.train.eval_batch_size or cfg.train.batch_size,
                      evaluation=True)

    t0 = time.perf_counter()
    preds, _, loss = evaluator.evaluate(batcher)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    id2label = {v: k for k, v in C.LABEL_TO_ID.items()}
    labels = [id2label[pr] for pr in preds]

    gold = np.array(batcher.gold())
    wrong = [ds.raw_data[batcher.order[i]]
             for i in np.nonzero(np.array(labels) != gold)[0]]
    wrong_path = os.path.join(args.model_dir,
                              f"{args.dataset}_incorrect_data.json")
    with open(wrong_path, "w") as f:
        json.dump(wrong, f)
    print(f"{len(wrong)} misclassified examples dumped to {wrong_path}")

    p_, r_, f1 = scorer.score(
        batcher.gold(), labels, verbose=True,
        negative_label=(cfg.train.scorer_negative_label
                        or C.NEGATIVE_LABEL))
    print(f"{args.dataset} set evaluate result: {p_:.2f}\t{r_:.2f}\t{f1:.2f}")

    if args.out:
        with open(args.out, "w") as f:
            for lab in labels:
                print(lab, file=f)
        print(f"Predictions saved to {args.out}")
    result = {"dataset": args.dataset, "precision": p_, "recall": r_,
              "f1": f1, "loss": loss, "sentences": len(labels),
              "batch_size": batcher.batch_size, "seconds": seconds,
              "sentences_per_s": len(labels) / seconds,
              "graphs_captured": len(evaluator.graphs),
              "device": str(device)}
    print(json.dumps(result))
    print("Evaluation ended.")
    return result


if __name__ == "__main__":
    main()
