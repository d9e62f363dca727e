"""Reduce a ``torch.profiler`` trace of the profiled sub-window to what the
per-layer readers and the ``breakdown`` need: the window's length, the
union of device activity in it, each device operation's time, the idle
gaps named by the harness span the host was in, and device time by
category.

The categories are ``chip_smoke.py``'s ``KERNEL_GROUPS``, copied: kernel
names matched by substring, case-insensitive, first match wins."""

from __future__ import annotations

KERNEL_GROUPS = (
    ("scan forward kernel", ("lstm_scan_fwd_kernel",)),
    ("scan backward kernels", ("lstm_gates_", "lstm_chain_kernel",
                               "lstm_dw_kernel")),
    ("grouped matmul forward kernel", ("grouped_matmul_fwd_kernel",
                                       "grouped_matmul_fwd_bf16_kernel")),
    ("grouped matmul backward dx kernel", ("grouped_matmul_dx_kernel",
                                           "grouped_matmul_dx_bf16_kernel")),
    ("grouped matmul backward dS kernels", (
        "grouped_matmul_ds_kernel", "grouped_matmul_ds_bf16_kernel",
        "grouped_matmul_ds_sum_kernel", "grouped_matmul_ds_sum_bf16_kernel")),
    ("band aggregate forward kernel", ("band_aggregate_fwd_kernel",
                                       "band_aggregate_fwd_bf16_kernel")),
    ("band aggregate pair kernel", ("band_pair_kernel",)),
    ("fused GCN layer forward kernel", ("spmm_fused_fwd_kernel",
                                        "spmm_fused_fwd_bf16_kernel")),
    ("fused GCN layer sym pair kernel", ("spmm_sym_pair_kernel",
                                         "spmm_sym_pair_bf16_kernel")),
    ("sddmm forward kernel", ("sddmm_fwd_kernel",)),
    ("sddmm backward kernels", ("sddmm_lists_kernel",
                                "sddmm_gather_kernel",
                                "sddmm_bwd_bf16_kernel")),
    ("deprel bilinear kernels", ("deprel_bilinear_kernel",
                                 "deprel_bilinear_bf16_kernel",
                                 "deprel_bilinear_sum_kernel")),
    ("copies", ("Memcpy", "Memset")),
    ("library matmuls", ("gemm", "cublas", "cutlass", "xmma")),
)
OTHER = "other kernels (elementwise, reductions, optimizer)"
WINDOW = "portbench.window"
SPAN = "portbench."


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in KERNEL_GROUPS:
        if any(k.lower() in low for k in keys):
            return cat
    return OTHER


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def reduce_events(events) -> dict:
    """``events``: (kind, name, start_us, end_us) with kind "device" or
    "host"; the host's ``portbench.window`` event bounds the window and
    its other ``portbench.*`` events are the harness's spans."""
    windows = [(a, b) for k, n, a, b in events if k == "host" and n == WINDOW]
    if not windows:
        raise ValueError("the trace holds no portbench.window span")
    w0, w1 = windows[0]
    kernels, spans = [], []
    for kind, name, a, b in events:
        if kind == "device":
            a, b = max(a, w0), min(b, w1)
            if b > a:
                kernels.append((name, a, b))
        elif name.startswith(SPAN) and name != WINDOW:
            spans.append((name[len(SPAN):], a, b))
    busy = _union([(a, b) for _, a, b in kernels])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    spans.sort(key=lambda s: s[1])

    def host_at(t):
        inside = [s for s in spans if s[1] <= t < s[2]]
        return max(inside, key=lambda s: s[1])[0] if inside else "other"

    by_cat: dict = {}
    for name, a, b in kernels:
        c = category(name)
        by_cat[c] = by_cat.get(c, 0.0) + (b - a) / 1e6
    top: dict = {}
    for name, a, b in kernels:
        top[name] = top.get(name, 0.0) + (b - a) / 1e6
    return {
        "top": sorted(top.items(), key=lambda kv: -kv[1])[:15],
        "window_s": (w1 - w0) / 1e6,
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "kernels": [(n, (b - a) / 1e6) for n, a, b in kernels],
        "by_category": by_cat,
        "gaps": [(host_at(a), (b - a) / 1e6) for a, b in gaps],
    }


def profiler_events(prof, torch) -> list:
    """(kind, name, start_us, end_us) of a finished ``torch.profiler``
    run's events."""
    out = []
    cuda = torch.autograd.DeviceType.CUDA
    for evt in prof.events():
        kind = "device" if evt.device_type == cuda else "host"
        if kind == "host":
            keep = evt.name.startswith(SPAN)
        else:  # the device's copies of host ranges are no device work
            keep = not (evt.name.startswith(SPAN)
                        or getattr(evt, "is_user_annotation", False))
        if not keep:
            continue
        out.append((kind, evt.name, evt.time_range.start,
                    evt.time_range.end))
    return out


def breakdown(red: dict) -> dict:
    """The result line's ``breakdown``: the ten categories of device
    operations that took most time, and the idle gaps: their total by what
    the host was doing, then the longest single gaps."""
    ops = sorted(red["by_category"].items(), key=lambda kv: -kv[1])[:10]
    totals: dict = {}
    for name, s in red["gaps"]:
        totals[name] = totals.get(name, 0.0) + s
    gaps = sorted(totals.items(), key=lambda kv: -kv[1])
    longest = sorted(red["gaps"], key=lambda g: -g[1])
    gaps += [(f"longest single gap, host in {n}", s)
             for n, s in longest[:10 - len(gaps)]]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps[:10]]}
