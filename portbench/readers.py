"""What the per-layer readers (``metrics/<name>.py``) share.  A reader
takes the run's view (``jobs.Job.view`` with ``peak``) and returns a number,
or None where the run holds nothing for it to read."""

from __future__ import annotations

from portbench import flops


def mean_ms(run, job: str, span: str):
    """Mean host milliseconds of the harness span ``span`` in the
    window."""
    s = run["spans"].get(span) if run["job"] == job else None
    return 1e3 * sum(s) / len(s) if s else None


def idle_pct(run, job: str):
    """100 × (1 − the union of device activity ÷ the traced window)."""
    t = run["trace"]
    if run["job"] != job or not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def roofline_pct(run, job: str, names, launches):
    """Σ least time ÷ Σ profiled time of the kernels whose names hold one
    of ``names`` (case-insensitive); least time from ``launches(model,
    shape, train)`` of each profiled batch at the published peaks."""
    t = run["trace"]
    if run["job"] != job or not t:
        return None
    keys = [n.lower() for n in names]
    spent = sum(s for n, s in t["kernels"]
                if any(k in n.lower() for k in keys))
    if spent <= 0:
        return None
    peak = run["peak"]
    least = sum(flops.least_seconds(launches(run["model"], shape,
                                             job == "train"),
                                    peak["flops"], peak["bytes_per_s"])
                for shape in t["shapes"])
    return 100.0 * least / spent


def mfu_pct(run, job: str):
    """The window's model FLOPs on its real tokens, edges and sentences ÷
    its seconds ÷ the published peak."""
    w = run["window"]
    if run["job"] != job or not w.get("sums"):
        return None
    total = sum(flops.model_flops(run["model"], tok, e, n, job == "train")
                for tok, e, n in w["sums"])
    return 100.0 * total / w["seconds"] / run["peak"]["flops"]
