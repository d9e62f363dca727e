#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card it starts on.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (``BENCHMARK.json``) names a configuration (``configs/``) and a
traffic mix (``traffic/``), whose job is "train" or "eval" (``jobs.py``).
Set-up (``setup_s``, from the process's start to the first timed step)
generates the mix from the seed, loads it through the program, makes the
weights on the card and captures every graph the mix needs (the program
builds a kernel that has no library yet at its first launch, in the
eager call before the capture).  The window then measures for
``--seconds``.  With ``--trace 1`` a profiled sub-window follows it and
the result carries the per-layer metrics (``metrics/<name>.py``) instead
of the end-to-end ones.  Then the program is freed and its outputs are
held to the plain reference (``reference/``).

Stdout: a line of device facts, then the result as one JSON line.  The
last lines on stderr give each number compared beside its limit.  Exits
non-zero, printing no result, without a card (or without enough), without
the program, or when a JAX module was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# build caches at fixed paths inside the checkout (the program keeps its
# nvcc builds in gcn_tpu_torch/_build/)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, ".portbench_cache", sub)
os.environ["USE_FLAX"] = "0"

from portbench import harness, jobs, peaks, trace  # noqa: E402


def end_to_end(name: str, setup_s: float, win: dict):
    if name == "setup_s":
        return setup_s
    if name in ("train_sentences_per_s", "eval_sentences_per_s"):
        return win["sentences"] / win["seconds"]
    if name == "train_step_ms_p95":
        import numpy as np

        return float(np.percentile(win["step_ms"], 95))
    raise KeyError(f"no end-to-end metric {name!r}")


def run_cell(name: str, seed: int, seconds: float, traced: bool,
             device: str = "cuda", t0: float = T0,
             sentences: int | None = None) -> tuple[dict, dict]:
    """(result line, device facts) of one run of cell ``name``.  On the
    CPU (``device="cpu"``, for tests) the window and the check run on the
    plain versions, with no trace, facts or device metrics."""
    import torch

    cell = harness.find_cell(name)
    seeds = harness.seeds_of(seed)
    job = jobs.JOBS[cell.traffic["job"]](cell, seeds, torch.device(device),
                                         sentences)
    card = device == "cuda"
    facts: dict = {"start_s": time.perf_counter() - t0}
    job.setup(torch)
    if card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    before = jobs.launch_counts()
    win = job.window(torch, seconds, sync=card)
    after = jobs.launch_counts()
    dev = {"platform": "gpu" if card else "cpu",
           "kind": torch.cuda.get_device_name() if card else "cpu",
           "count": 1,
           "memory_peak_bytes": torch.cuda.max_memory_allocated()
           if card else 0}
    red = job.traced(torch) if traced and card else None
    job.free(torch)
    if traced:
        job.view["peak"] = peaks.peak_of(dev["kind"]) if card else None
        metrics = {}
        for m in cell.per_layer:
            v = harness.reader(m["name"])(job.view) if card else None
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": end_to_end(m["name"], setup_s, win),
                               "unit": m["unit"]} for m in cell.end_to_end}
    if card:
        facts.update(
            name=dev["kind"], count=torch.cuda.device_count(),
            smi=harness.smi("name", "power.limit", "power.draw", "clocks.sm",
                            "clocks.max.sm", "temperature.gpu"),
            calibrate_of_peak=harness.calibrate(
                torch, peaks.peak_of(dev["kind"])["flops"]),
            window_launches={k: after.get(k, 0) - before.get(k, 0)
                             for k in after
                             if after.get(k, 0) != before.get(k, 0)})
    checks = job.reference(torch)
    limits = cell.config["limits"][cell.traffic["job"]]
    compared = {k: {"value": checks[k], "limit": lim}
                for k, lim in limits.items()}
    result = {
        "correct": all(c["value"] <= c["limit"] for c in compared.values())
        and win["failed"] == 0,
        "attempted": win["steps"],
        "failed": win["failed"],
        "metrics": metrics,
        "device": dev,
    }
    if red is not None:
        dev.update(busy_s=red["busy_s"], window_s=red["window_s"])
        result["breakdown"] = trace.breakdown(red)
    facts["checked"] = {k: v for k, v in checks.items() if k not in limits}
    facts["setup_stages_s"] = job.stages
    if hasattr(job, "checked_widths"):
        facts["checked_widths"] = job.checked_widths
    if red is not None:
        facts["top_device_ops_s"] = [[n[:100], s] for n, s in red["top"]]
    result["checks"] = compared
    return result, facts


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = harness.find_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        print(f"portbench: the cell needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    try:
        import gcn_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the program is not here: {e}", file=sys.stderr)
        return 2
    result, facts = run_cell(args.workload, args.seed, args.seconds,
                             bool(args.trace))
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: JAX modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 4
    print(json.dumps({"facts": facts}), flush=True)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
