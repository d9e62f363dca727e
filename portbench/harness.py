"""What ``run.py`` finds by name and what it reports beside the result:
the cell's entry in ``BENCHMARK.json``, its configuration
(``configs/<name>.json``), its traffic mix (``traffic/<name>.json``), the
per-layer metrics' readers (``metrics/<name>.py``); the seeds a run's
seed gives; the device's facts; and the check that no JAX module was
loaded."""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "gcn_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list
    per_layer: list


def _reports(metric: dict, cell: str, end_to_end: set | None = None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return end_to_end is None or metric["moves"] in end_to_end


def find_cell(name: str) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``, with its files loaded and
    the metrics it reports."""
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name=name, config=load_json(os.path.join(ROOT, conf["file"])),
                traffic=load_json(os.path.join(HERE, "traffic",
                                               w["traffic"] + ".json")),
                chips=int(w["chips"]), end_to_end=e2e, per_layer=layer)


def reader(metric: str):
    """The ``read(run)`` function of ``metrics/<metric>.py``."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass(frozen=True)
class Seeds:
    data: int     # the mix's records
    weights: int  # the parameters
    train: int    # the trainer's dropout streams


def seeds_of(seed: int) -> Seeds:
    """Independent sub-seeds (each below 2**31) of any whole number."""
    state = np.random.SeedSequence(abs(int(seed))).generate_state(3)
    return Seeds(*(int(s) & 0x7FFFFFFF for s in state))


def smi(*fields: str) -> list[str]:
    """``nvidia-smi``'s readings of ``fields`` for each card, or the error
    it gave."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=" + ",".join(fields),
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return [line.strip() for line in out.stdout.splitlines()
                if line.strip()] or [out.stderr.strip()]
    except (OSError, subprocess.SubprocessError) as e:
        return [f"nvidia-smi: {e}"]


def calibrate(torch, peak: float, n: int = 4096) -> float:
    """A known-FLOPs bf16 matmul chain's rate as a fraction of ``peak``:
    per-iteration time as the slope between chains of 20 and 60 products,
    the least of three interleaved tries at each length (a copy of
    ``gcn_tpu_torch.utils.timing.calibrate``'s method)."""
    x = torch.full((n, n), 1e-3, dtype=torch.bfloat16, device="cuda")
    w = torch.full((n, n), 1e-3, dtype=torch.bfloat16, device="cuda")
    torch.matmul(x, w).float().sum().item()

    def chain(k):
        t0 = time.perf_counter()
        y = x
        for _ in range(k):
            y = torch.matmul(y, w)
        y.float().sum().item()
        return time.perf_counter() - t0

    t1, t2 = [], []
    for _ in range(3):
        t1.append(chain(20))
        t2.append(chain(60))
    dt = (min(t2) - min(t1)) / 40
    if dt <= 0:
        dt = min(t2) / 60
    return 2 * n ** 3 / dt / peak


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``gcn_tpu_torch`` is not ``gcn_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))
