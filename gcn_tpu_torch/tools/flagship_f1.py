#!/usr/bin/env python3
"""Train the round-5 flagship configuration to its F1 through the port's
train CLI, one seed after another, and print what each run reached.

    python3 gcn_tpu_torch/tools/flagship_f1.py [--seeds 11 17]
        [--epochs N] [--out DIR] [--cpu]

For each seed the flags are those of
``.campaign_r5/flagship/seed{S}/gcn_tpu_full_deprel_models/cmp/config.json``
(the C-GCN at hidden 64, BiLSTM 32, deprel 16, adam, ``batch_size`` 10 and
``effective_batch_size`` 50, so ``update_gap`` 5: the accumulating step,
on the card a micro-batch graph a batch signature and the apply graph),
on the seed's committed ``data/`` and ``vocab/``;
``gcn_tpu_torch.scripts.train`` runs in process, its run directory and
output under ``--out`` (default ``chiprun_out/flagship_f1``).  One JSON
line a seed: the best dev F1 and its epoch, the test F1 at that epoch,
the dev F1 of every epoch (``logs.txt``), the train loop's wall per epoch
(the driver's sustained walls: median, min, max), the whole run's wall
per epoch (evaluations of train, dev and test and the checkpoints
included), and the launches of kernels 1-4 over the run; then the card's
``nvidia-smi`` name and power limit.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
FLAGSHIP = os.path.join(REPO, ".campaign_r5", "flagship")
# round 5's best dev F1 on the same data (.campaign_r5/flagship/
# results.jsonl): gcn_tpu's full_deprel runs and the reference's
ROUND5 = {11: {"gcn_tpu": 0.6148, "reference": 0.6803},
          17: {"gcn_tpu": 0.717, "reference": 0.6643}}


def run_flags(seed: int) -> dict:
    """The CLI's defaults for ``seed``: every field of the run's
    ``config.json`` that is a flag of the port's train CLI."""
    from gcn_tpu_torch.train.cli import build_parser

    path = os.path.join(FLAGSHIP, f"seed{seed}",
                        "gcn_tpu_full_deprel_models", "cmp", "config.json")
    with open(path) as f:
        cfg = json.load(f)
    dests = {a.dest for a in build_parser(dataset="tacred")._actions}
    return {k: v for sec in ("model", "train", "data")
            for k, v in cfg[sec].items()
            if k in dests and k not in ("data_dir", "vocab_dir")}


def logged_rows(run_dir: str) -> list[list[str]]:
    """``logs.txt``'s epoch rows: epoch, train loss, dev loss, dev F1,
    best dev F1."""
    with open(os.path.join(run_dir, "logs.txt")) as f:
        return [line.split("\t") for line in f.read().splitlines()
                if line and line[0].isdigit()]


def train_seed(seed: int, out: str, epochs: int | None, cpu: bool) -> dict:
    from gcn_tpu_torch.ops import grouped_matmul, lstm_scan
    from gcn_tpu_torch.scripts import train

    kernels = {"lstm_scan_forward": lstm_scan.KERNEL,
               "lstm_scan_backward": lstm_scan.BACKWARD_KERNEL,
               "grouped_matmul_forward": grouped_matmul.KERNEL,
               "grouped_matmul_backward": grouped_matmul.BACKWARD_KERNEL}
    for k in kernels.values():
        k.reset()
    flags = run_flags(seed)
    if epochs is not None:
        flags["num_epoch"] = epochs
    data = os.path.join(FLAGSHIP, f"seed{seed}")
    argv = ["--id", f"seed{seed}", "--data_dir", os.path.join(data, "data"),
            "--vocab_dir", os.path.join(data, "vocab"),
            "--model_save_dir", out, *(["--cpu"] if cpu else [])]
    t0 = time.perf_counter()
    with open(os.path.join(out, f"seed{seed}_stdout.txt"), "w") as f, \
            contextlib.redirect_stdout(f):
        result = train.main(argv, **flags)
    wall = time.perf_counter() - t0
    rows = logged_rows(result["run_dir"])
    dev = [float(r[3]) for r in rows]
    best = max(dev)
    loop = [w for w, _ in result["epochs_timed"]]
    return {"seed": seed, "epochs": len(rows),
            "update_gap": flags["effective_batch_size"]
            // flags["batch_size"],
            "best_dev_f1": best, "best_epoch": dev.index(best) + 1,
            "test_f1_at_best_dev": result["test_at_best_dev"]["f1"],
            "dev_f1_by_epoch": dev,
            "train_loop_wall_s_per_epoch": {
                "median": statistics.median(loop), "min": min(loop),
                "max": max(loop)},
            "run_wall_s_per_epoch": wall / len(rows), "run_wall_s": wall,
            "launches": {n: k.launches for n, k in kernels.items()},
            "round5_best_dev_f1": ROUND5.get(seed)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[11, 17])
    ap.add_argument("--epochs", type=int, default=None,
                    help="cut the run (default: the config's 100)")
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "flagship_f1"))
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch

    if not args.cpu and not torch.cuda.is_available():
        print("flagship_f1: no CUDA device is available", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    if not args.cpu:
        from gcn_tpu_torch.ops import _cuda, grouped_matmul, lstm_scan

        _cuda.build_all([lstm_scan.KERNEL, lstm_scan.BACKWARD_KERNEL,
                         grouped_matmul.KERNEL,
                         grouped_matmul.BACKWARD_KERNEL])
    for seed in args.seeds:
        line = train_seed(seed, args.out, args.epochs, args.cpu)
        print(json.dumps(line), flush=True)
        with open(os.path.join(args.out, f"seed{seed}.json"), "w") as f:
            json.dump(line, f, indent=1)
    if not args.cpu:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
