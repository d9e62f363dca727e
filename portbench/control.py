#!/usr/bin/env python3
"""Readings that set a cell's limits, many seeds in one process (the
benchmark's own runs do not run this):

    python3 portbench/control.py --workload <cell> --seeds 1,2,...,12 \
        --variant-seeds 1,2,3

For each seed the cell's set-up runs (its traffic and weights at the
cell's own size, the program's checked steps or its first evaluation
pass) and the program's numbers are held to the reference's, as a run
holds them.  For the ``--variant-seeds`` the reference then stands in the
program's place, against itself in f32: in TF32 (the control) and, for a
training cell, with each step's loss over half the batch (a fault).  One
JSON line a seed.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness, jobs  # noqa: E402

VARIANTS = {"train": ("tf32", "half"), "eval": ("tf32",)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--variant-seeds", default="")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 3
    cell = harness.find_cell(args.workload)
    kind = cell.traffic["job"]
    variant_seeds = {int(s) for s in args.variant_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        job = jobs.JOBS[kind](cell, harness.seeds_of(seed),
                              torch.device("cuda"))
        job.setup(torch)
        job.free(torch)
        rec = {"workload": args.workload, "seed": seed,
               "program": job.reference(torch)}
        if seed in variant_seeds:
            for v in VARIANTS[kind]:
                rec[v] = job.reference(torch, variant=v)
        rec["seconds"] = time.perf_counter() - t0
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
