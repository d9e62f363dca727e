#!/usr/bin/env python3
"""Drive the port's C-GCN, paper-GCN, attention, diagonal_deprel, BERT-input
and SemEval paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each:

1. device — the card's name, count and power limit;
2. build  — ``nvcc`` builds every kernel source of the paths from
   ``gcn_tpu_torch/csrc``, one process per source, in parallel;
3. kernel — each kernel (the scan and the grouped matmul, forward and
   backward; the band aggregation and its pair backward; the fused GCN
   layer and its sym-pair backward; the SDDMM and its backward; the
   deprel bilinear transform, v2 and v1) against its plain PyTorch version
   on the card at the main paths' shapes (the SDDMM also at N = E = 1200,
   where ``attention_impl="auto"`` takes the edge backend; its backward's
   list build also against a stable sort, bit for bit): max error and
   its tolerance, the same bits on a second call (scan, grouped matmul,
   band aggregation, SDDMM, bilinear), time by a replayed CUDA graph of 20 calls (and by
   one of a single call, and eagerly), the plain version's time, one
   PyTorch library call's time as a yardstick where one computes the
   same function (for the bilinear also one SGEMM on its prebuilt
   [M, D*T] operand), and the kernel's
   bound at the card's peak rates (3xTF32 for the kernels that run it,
   with the f32 FMA bound beside); for the scans also their cluster
   partition and how many of its clusters fit the card at once, and the
   backward's time by launch (gates, chain, dW; for the grouped matmul's,
   dx, dS and the partials' sum); then the floor of the graph timings
   (a one-element add, timed both ways);
4. slice  — for each path, ``Evaluator`` at full widths (random weights
   from a seeded ``torch.Generator``) over B=50 batches of the in-repo
   TACRED JSON and of synthetic sentences at the N=96 bucket (``cgcn_bert``:
   the same sentences as seeded [L, 1024] float rows; ``cgcn_semeval``: the
   in-repo SemEval JSON and synthetic SemEval sentences), all through the
   port's own loader.  The same forward with the plain versions on the
   card (``PLAIN``: for the edge-list layers the dense bands from
   ``build_adjacency`` and ``bmm``, which the fused layers' plain versions
   compute; for the attention edge backend the dense one; for the
   non-factored bilinear the einsum) and on the CPU must agree, on a fused
   path the same weights on the dense bands with the kernels too, and on
   ``cgcn_bilinear`` the factored ``cgcn`` on the same weights.  Every
   kernel's count is read: each kernel must have launched exactly as often
   per forward as ``EXPECTED`` says, which is 0 for a kernel off the
   path;
5. train  — for each path, ``Trainer.update`` at the same widths (sgd 0.3,
   clip 5, pooling_l2 0.003, the preset's dropouts) over the training
   batches of the in-repo train split and of the synthetic sentences.
   Every kernel must have launched exactly as often per step as
   ``EXPECTED`` says (0 off the path); a trainer on the plain versions on
   the card, from the same weights and seed, must follow it for 3 steps;
   with dropout off one step on the card must match one on the CPU; the
   loss on one fixed batch must fall over 20 steps; and ms per step,
   sentences/s, the device's busy time by kernel and the device memory
   one step adds are measured at N=96.

The paths: ``cgcn`` (``cgcn_preset``: BiLSTM, factored full_deprel on
dense bands), ``cgcn_fused`` (the same with ``use_pallas=True``: the band
aggregation kernels), ``gcn_fused`` (``gcn_preset`` with
``use_pallas=True``: the paper's GCN on the fused layer kernels),
``cgcn_attn`` (``cgcn_preset`` with ``adj_type="attention"`` and
``attention_impl="edge"``: the SDDMM kernels), ``cgcn_bilinear``
(``cgcn_preset`` with ``deprel_factored=False`` and ``use_pallas=True``:
the bilinear v2 kernel feeding the band aggregation), ``cdiag_fused``
(``cgcn_preset`` with ``adj_type="diagonal_deprel"`` and
``use_pallas=True``: the BiLSTM, the preprocessor, then the band
aggregation on the deprel gates), ``cgcn_bert`` (``cgcn_preset`` on
precomputed 1024-wide word vectors, no word table) and ``cgcn_semeval``
(``cgcn_preset`` on SemEval: no NER, 10 classes).

Then one line with every kernel's numbers, the ``nvidia-smi`` name and
power limit, and the last line ``{"ok": true, "device": {...}}``.  Any
failure raises and the script exits non-zero without that line; so does a
machine with no CUDA device, or a directory without the package.
"""

from __future__ import annotations

import functools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
B, N_BUCKET = 50, 96          # main-path batch and the 96-token bucket
SYNTH_BATCHES = 4             # synthetic batches at the N=96 bucket
PEAK_F32_FLOPS = 67e12        # H100 SXM f32 (no tensor cores), dense
PEAK_TF32X3_FLOPS = 495e12 / 3  # H100 SXM TF32 tensor cores, dense, three
                                # products per f32 product (3xTF32)
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
TOL_F32 = 1e-4                # kernel vs plain: f32, other summation order
TOL_BF16 = 1e-2               # bf16 storage, error over max(1, |ref|): one
                              # rounding flip is at most 2^-7 of |y|
TOL_SLICE = 1e-4              # logits and h_out per valid row, over
                              # max(1, |row|), kernels vs plain, f32
TOL_BWD = 1e-4                # backward kernels vs plain, f32, error over
                              # max(1, max |ref|): dW_hh and dS sum
                              # thousands of products in another order
TOL_TRAIN = 1e-4              # trainers: loss relative, every parameter
                              # over max(1, max |p|)
TRAIN_STEPS_FALL = 20         # steps on one fixed batch


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` by CUDA events, one pair per call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


GRAPH_CALLS = 20  # calls of fn in one CUDA graph: one replay then lasts
                  # well past the host's cost of a replay


def graph_ms(fn, reps: int = 10, calls: int = GRAPH_CALLS) -> float:
    """Milliseconds per call of ``fn`` on the device alone: ``calls`` calls
    captured in one CUDA graph and the graph replayed ``reps`` times
    between one pair of events, so no Python or launch overhead sits
    between the kernels; the time over ``calls * reps``.  For kernels of
    tens of microseconds, where one event pair around an eager call
    (``time_ms``) also times the host's wrapper.  A graph of one call
    replayed from Python (``calls=1``) reads no less than the host's cost
    of a replay, a few microseconds, whatever the kernel: the
    ``timing_floor`` line times that floor both ways."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the capture
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def kernel_ms(fn) -> dict:
    """A kernel row's times: ``ms`` by the ``graph_ms`` of ``GRAPH_CALLS``
    calls, ``ms_one_call_graph`` by a graph of one call replayed 50 times
    (the floor-bound way, kept beside it), ``eager_ms`` by ``time_ms``."""
    return {"ms": graph_ms(fn),
            "ms_one_call_graph": graph_ms(fn, reps=50, calls=1),
            "eager_ms": time_ms(fn, 20)}


def timing_floor(torch, dev) -> dict:
    """The floor under each graph timing: a one-element in-place add, by a
    graph of one call and by the graph of ``GRAPH_CALLS`` calls."""
    x = torch.zeros(1, device=dev)

    def fn():
        x.add_(1.0)

    return {"phase": "timing_floor",
            "op": "x.add_(1.0), x one f32 element on the card",
            "ms": graph_ms(fn),
            "ms_one_call_graph": graph_ms(fn, reps=50, calls=1),
            "graph_calls": GRAPH_CALLS}


def bound(n_bytes: float, flops: float, rate: float = PEAK_F32_FLOPS,
          ops: str = "operations") -> tuple[float, str]:
    """The least ms for ``n_bytes`` moved and ``flops`` done at ``rate``,
    and which of the two sets it (``ops`` names the operations)."""
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = flops / rate * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else ops)


def tf32x3_bound(n_bytes: float, flops: float) -> dict:
    """The bound keys of a kernel that runs 3xTF32: ``bound_ms`` at the
    3xTF32 rate and ``bound_f32_ms`` at the f32 FMA rate."""
    bound_ms, bound_by = bound(n_bytes, flops, PEAK_TF32X3_FLOPS,
                               "operations (3xTF32)")
    return {"bound_ms": bound_ms, "bound_by": bound_by,
            "bound_f32_ms": bound(n_bytes, flops)[0]}


def ptxas_by_function(log: str) -> dict:
    """Each kernel's ``ptxas -v`` line of registers and spills, keyed by
    the kernel's mangled name (the build log names it on the line before)."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function '" in line:
            name = line.split("'")[1]
        elif name and ("registers" in line or "spill" in line):
            out[name] = (out.get(name, "") + " " + line.split(":", 1)[-1]
                         .strip()).strip()
    return out


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def scaled_err(a, b) -> float:
    """max |a - b| over max(1, max |b|)."""
    return max_err(a, b) / max(1.0, float(b.float().abs().max()))


def row_err(a, b) -> float:
    """Largest per-row error of [rows, ...] tensors, each row's error over
    max(1, max|row of b|): a row whose sentence has no edge pools the -1e12
    fill and carries logits of that size."""
    a, b = a.float().flatten(1), b.float().flatten(1)
    scale = b.abs().amax(dim=1).clamp(min=1.0)
    return float(((a - b).abs().amax(dim=1) / scale).max())


# ------------------------------------------------------------------ data
def synthetic_records(rng, count: int, n_max: int, deprel_freq,
                      dataset: str = "tacred") -> list:
    """JSON records shaped as ``dataset``'s (TACRED: with NER tags;
    SemEval: none, its POS tags and labels): lengths uniform in [10, n_max]
    (one at n_max), random trees, deprels drawn from the in-repo corpus."""
    from gcn_tpu_torch import constants
    from gcn_tpu_torch.data.dataset import constants_for

    C = constants_for(dataset)
    words = [f"w{i}" for i in range(200)]
    pos_tags = [t for t in C.POS_TO_ID if not t.startswith("<")]
    ner_tags = [t for t in constants.NER_TO_ID if not t.startswith("<")]
    names, probs = zip(*deprel_freq.items())
    probs = np.asarray(probs, np.float64) / sum(probs)
    labels = list(C.LABEL_TO_ID)
    recs = []
    for i in range(count):
        L = n_max if i == 0 else int(rng.randint(10, n_max + 1))
        order = rng.permutation(L)
        head = np.zeros(L, np.int64)
        for k in range(1, L):          # each token hangs off an earlier one
            head[order[k]] = order[rng.randint(0, k)] + 1
        ss = int(rng.randint(0, L // 2 - 1))
        os_ = int(rng.randint(L // 2, L - 1))
        rec = {
            "id": f"synth{i}",
            "token": [words[j] for j in rng.randint(0, len(words), L)],
            "stanford_pos": [pos_tags[j]
                             for j in rng.randint(0, len(pos_tags), L)],
        }
        if dataset == "tacred":
            rec["stanford_ner"] = [ner_tags[j] for j in
                                   rng.randint(0, len(ner_tags), L)]
        recs.append({
            **rec,
            "stanford_deprel": [names[j]
                                for j in rng.choice(len(names), L, p=probs)],
            "stanford_head": [int(h) for h in head],
            "subj_start": ss, "subj_end": ss + 1,
            "obj_start": os_, "obj_end": os_,
            "subj_type": "PERSON", "obj_type": "ORGANIZATION",
            "relation": labels[int(rng.randint(0, len(labels)))],
        })
    return recs


def load_batches(cfg, vocab, rng, bert_rng=None):
    """B=50 batches through the port's loader: evaluation batches of the
    in-repo splits of ``cfg.model.dataset`` and of synthetic sentences at
    the N=96 bucket (drawn from ``rng``), and training batches (shuffled,
    the preset's word dropout) of the in-repo train split and of the same
    synthetic sentences.  With ``bert_rng`` each sentence's words are
    ``[L, emb_dim]`` float rows drawn from it (an id → rows dict a file,
    ``bert_embeddings``: the in-repo splits number their ids alike);
    returns the vocabulary's size last."""
    from gcn_tpu_torch.data.dataset import Batcher, RelationDataset

    dataset = cfg.model.dataset
    data_dir = os.path.join(HERE, "dataset", dataset)
    splits = {}
    for split in ("train", "dev", "test"):
        path = os.path.join(data_dir, f"{split}.json")
        if os.path.exists(path):
            with open(path) as f:
                splits[path] = json.load(f)
    freq = {}
    for recs in splits.values():
        for rec in recs:
            for d in rec["stanford_deprel"]:
                freq[d] = freq.get(d, 0) + 1
    synth_recs = synthetic_records(rng, B * SYNTH_BATCHES, N_BUCKET, freq,
                                   dataset)

    def rows(recs):
        if bert_rng is None:
            return None
        return {d["id"]: bert_rng.randn(len(d["token"]), cfg.model.emb_dim)
                .astype(np.float32) for d in recs}

    real = []
    for path, recs in splits.items():
        ds = RelationDataset(path, cfg, vocab, bert_embeddings=rows(recs))
        real.extend(Batcher(ds, B, evaluation=True))
        if path.endswith("train.json"):
            real_train = list(Batcher(ds, B, seed=SEED))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "synthetic.json")
        with open(path, "w") as f:
            json.dump(synth_recs, f)
        ds = RelationDataset(path, cfg, vocab,
                             bert_embeddings=rows(synth_recs))
        synth = list(Batcher(ds, B, evaluation=True))
        synth_train = list(Batcher(ds, B, seed=SEED))
    for batch in synth + synth_train:
        if batch["words"].shape[:2] != (B, N_BUCKET):
            fail(f"synthetic batch shape {batch['words'].shape}")
    return real, synth, real_train, synth_train, vocab.size


# --------------------------------------------------------------- kernels
def check_lstm(torch, rng, dev) -> dict:
    from gcn_tpu_torch.ops import lstm_scan as mod

    g, t, h = 2, N_BUCKET, 200
    lengths = rng.randint(1, t + 1, B)
    lengths[:2] = (1, t)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    xp = torch.tensor(rng.randn(t, g, B, 4 * h) * 0.5, dtype=torch.float32,
                      device=dev)
    bnd = 1.0 / np.sqrt(h)
    w_hh = torch.tensor(rng.uniform(-bnd, bnd, (g, h, 4 * h)),
                        dtype=torch.float32, device=dev)
    keep = torch.tensor((rng.rand(t, g, B) > 0.1).astype(np.float32),
                        device=dev)
    errs = {}
    for name, kp in (("f32", None), ("f32_keep", keep)):
        hk, ck = mod.lstm_scan_forward(xp, lengths, w_hh, kp)
        hp, cp = mod.lstm_scan_plain(xp, lengths, w_hh, kp)
        errs[name] = max(max_err(hk, hp), max_err(ck, cp))
    xb, wb = xp.bfloat16(), w_hh.bfloat16()
    hk, ck = mod.lstm_scan_forward(xb, lengths, wb)
    hp, cp = mod.lstm_scan_plain(xb, lengths, wb)
    errs["bf16"] = max(scaled_err(hk, hp), scaled_err(ck, cp))
    torch.cuda.synchronize()
    ok = (errs["f32"] <= TOL_F32 and errs["f32_keep"] <= TOL_F32
          and errs["bf16"] <= TOL_BF16)

    again = mod.lstm_scan_forward(xp, lengths, w_hh, keep)
    same = all(torch.equal(a, b) for a, b in
               zip(mod.lstm_scan_forward(xp, lengths, w_hh, keep), again))
    ok = ok and same

    fn = functools.partial(mod.lstm_scan_forward, xp, lengths, w_hh)
    times = kernel_ms(fn)
    plain_ms = graph_ms(functools.partial(mod.lstm_scan_plain, xp, lengths,
                                          w_hh), reps=5)
    # yardstick: cuDNN's bidirectional LSTM layer over the packed sequence
    # (it also does the input projection, from the 360-wide embeddings)
    lstm = torch.nn.LSTM(360, h, batch_first=True, bidirectional=True).to(dev)
    x = torch.randn(B, t, 360, device=dev)
    packed = torch.nn.utils.rnn.pack_padded_sequence(
        x, lengths.cpu(), batch_first=True, enforce_sorted=False)
    with torch.no_grad():
        library_ms = time_ms(lambda: lstm(packed), 20)
    steps = int(lengths.sum())
    n_bytes = 4 * (xp.numel() + 2 * t * g * B * h + w_hh.numel() + B)
    flops = 2.0 * g * steps * h * 4 * h
    bound_ms, bound_by = bound(n_bytes, flops)
    plan = mod.scan_plan(B, h)
    return {
        "name": "lstm_scan_forward", "route": "cuda",
        "source": "gcn_tpu_torch/csrc/lstm_scan.cu",
        "replaces": "gcn_tpu/ops/pallas/lstm_scan.py:128",
        "shape": {"T": t, "G": g, "B": B, "H": h},
        "plan": scan_plan_facts(mod, plan, g),
        "max_abs_err": errs["f32"], "errs": errs, "same_bits_twice": same,
        "tol": {"f32": TOL_F32, "bf16": TOL_BF16}, "ok": ok,
        **times, "ms_per_step": times["ms"] / t, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
        "library": "torch.nn.LSTM (cuDNN) bidirectional, packed, D=360 "
                   "(eager: median of event pairs)",
        "timing": TIMING_GRAPH,
    }


def scan_plan_facts(mod, plan, g: int) -> dict:
    """A scan plan's shape and how many of its clusters fit the card at
    once (``cudaOccupancyMaxActiveClusters``) against how many it launches."""
    return {"cluster": plan.cluster, "rows": plan.rows, "units": plan.units,
            "rows_per_thread": plan.rows_per_thread, "threads": plan.threads,
            "smem_bytes": plan.smem_bytes, "resident": plan.resident,
            "clusters": g * len(plan.row_tiles(B)),
            "max_active_clusters": mod.max_active_clusters(plan, g)}


def band_group_sizes(torch, synth_batch, dev):
    """Group sizes of the two stacked bands' relation ids, as the model
    builds them for a synthetic N=96 batch (R = 87 groups)."""
    from gcn_tpu_torch import constants as C
    from gcn_tpu_torch.ops.gcn_layers import make_group_plan

    deprel = torch.tensor(synth_batch["deprel"], dtype=torch.long)
    r = len(C.DEPREL_TO_ID) + 2
    ids_f = torch.where(deprel == 0, r - 1, deprel)
    ids_r = deprel + C.DEPREL_FORWARD_BOUND
    return make_group_plan(torch.cat([ids_f, ids_r]), r).group_sizes.to(dev)


TIMING_GMM = ("ms: 20 calls in one CUDA graph, replayed 10 times, per "
              "call, L2 warm; ms_one_call_graph: one call in a graph "
              "replayed 50 times; plain_ms, eager_ms and library_ms: median "
              "of one event pair around each eager call, the wrapper "
              "included (the plain version and torch._grouped_mm read the "
              "group sizes or offsets on the host, so no graph captures "
              "them)")


def check_gmm(torch, rng, dev, gs) -> list[dict]:
    from gcn_tpu_torch.ops import grouped_matmul as mod

    r = gs.shape[0]
    m, h = 2 * B * N_BUCKET, 200
    out = []
    for t in (400, 200):
        x = torch.tensor(rng.uniform(-1, 1, (m, t)), dtype=torch.float32,
                         device=dev)
        s = torch.tensor(rng.randn(r, t, h) / np.sqrt(t), dtype=torch.float32,
                         device=dev)
        got = mod.grouped_matmul(x, s, gs)
        err = max_err(got, mod.grouped_matmul_plain(x, s, gs))
        same = bool(torch.equal(got, mod.grouped_matmul(x, s, gs)))
        err_bf16 = scaled_err(mod.grouped_matmul(x.bfloat16(), s.bfloat16(), gs),
                           mod.grouped_matmul_plain(x.bfloat16(),
                                                    s.bfloat16(), gs))
        torch.cuda.synchronize()
        fn = functools.partial(mod.grouped_matmul, x, s, gs)
        plain_ms = time_ms(lambda: mod.grouped_matmul_plain(x, s, gs), 10)
        # yardstick only (the port never calls it); absent or refusing f32
        # in some PyTorch builds, and then not measured
        offs = torch.cumsum(gs, 0, dtype=torch.int32)
        grouped_mm = getattr(torch, "_grouped_mm", None)
        library_ms, library_note = None, "torch._grouped_mm is absent"
        if grouped_mm is not None:
            try:
                library_ms = time_ms(lambda: grouped_mm(x, s, offs=offs), 20)
                library_note = "torch._grouped_mm f32 (eager)"
            except RuntimeError as e:
                library_note = f"not measured: {str(e)[:200]}"
        used = int((gs > 0).sum())
        n_bytes = 4 * (x.numel() + used * t * h + m * h + r)
        out.append({
            "name": f"grouped_matmul_forward_T{t}", "route": "cuda",
            "source": "gcn_tpu_torch/csrc/grouped_matmul.cu",
            "replaces": "gcn_tpu/ops/pallas/grouped_matmul.py:153",
            "shape": {"M": m, "T": t, "H": h, "R": r, "groups_used": used},
            "max_abs_err": err, "errs": {"f32": err, "bf16": err_bf16},
            "same_bits_twice": same,
            "tol": {"f32": TOL_F32, "bf16": TOL_BF16},
            "ok": err <= TOL_F32 and err_bf16 <= TOL_BF16 and same,
            **kernel_ms(fn), "plain_ms": plain_ms,
            **tf32x3_bound(n_bytes, 2.0 * m * t * h),
            "library_ms": library_ms, "library": library_note,
            "timing": TIMING_GMM,
        })
    return out


def check_lstm_backward(torch, rng, dev) -> dict:
    from gcn_tpu_torch.ops import lstm_scan as mod

    g, t, h = 2, N_BUCKET, 200
    lengths = rng.randint(1, t + 1, B)
    lengths[:2] = (1, t)
    len_t = torch.tensor(lengths, dtype=torch.int32, device=dev)
    xp = torch.tensor(rng.randn(t, g, B, 4 * h) * 0.5, dtype=torch.float32,
                      device=dev)
    bnd = 1.0 / np.sqrt(h)
    w_hh = torch.tensor(rng.uniform(-bnd, bnd, (g, h, 4 * h)),
                        dtype=torch.float32, device=dev)
    keep = torch.tensor((rng.rand(t, g, B) > 0.1).astype(np.float32),
                        device=dev)
    ct = torch.tensor(rng.randn(t, g, B, h), dtype=torch.float32, device=dev)
    valid = (torch.arange(t, device=dev)[:, None, None, None]
             < len_t[None, None, :, None])

    def inputs(dtype, kp):
        """The forward's states and a cotangent that depends on them."""
        xq, wq = xp.to(dtype), w_hh.to(dtype)
        hs, cs = mod.lstm_scan_plain(xq, len_t, wq, kp)
        gy = torch.where(valid, hs.float() * ct, 0.0).contiguous()
        return gy, xq, len_t, wq, hs, cs, kp

    errs, abs_errs = {}, {}
    for name, dtype, kp in (("f32", torch.float32, None),
                            ("f32_keep", torch.float32, keep),
                            ("bf16", torch.bfloat16, None)):
        args = inputs(dtype, kp)
        got = mod.lstm_scan_backward(*args)
        want = mod.lstm_scan_backward_plain(*args)
        errs[name] = max(scaled_err(a, b) for a, b in zip(got, want))
        abs_errs[name] = max(max_err(a, b) for a, b in zip(got, want))
    torch.cuda.synchronize()
    ok = (errs["f32"] <= TOL_BWD and errs["f32_keep"] <= TOL_BWD
          and errs["bf16"] <= TOL_BF16)

    args = inputs(torch.float32, None)
    first, again = (mod.lstm_scan_backward(*args) for _ in range(2))
    same = all(torch.equal(a, b) for a, b in zip(first, again))
    ok = ok and same
    fn = functools.partial(mod.lstm_scan_backward, *args)
    times = kernel_ms(fn)
    plain_ms = graph_ms(functools.partial(mod.lstm_scan_backward_plain, *args),
                        reps=3)
    split = device_time(torch, lambda: [fn() for _ in range(5)])
    split_ms = None if split is None else {
        k: v / 5 for k, v in split["top_kernels_ms"].items() if "lstm_" in k}
    # yardstick: cuDNN's bidirectional LSTM layer over the packed sequence,
    # forward + backward minus forward (its backward also produces the
    # input projection's gradients)
    lstm = torch.nn.LSTM(360, h, batch_first=True, bidirectional=True).to(dev)
    x = torch.randn(B, t, 360, device=dev, requires_grad=True)
    len_cpu = torch.tensor(lengths, dtype=torch.int64)

    def lib_fwd():
        packed = torch.nn.utils.rnn.pack_padded_sequence(
            x, len_cpu, batch_first=True, enforce_sorted=False)
        return lstm(packed)[0].data

    grad_out = torch.randn_like(lib_fwd())
    leaves = [x] + list(lstm.parameters())
    fwd_ms = time_ms(lib_fwd, 20)
    fwd_bwd_ms = time_ms(
        lambda: torch.autograd.grad(lib_fwd(), leaves, grad_out), 20)
    steps = int(lengths.sum())
    flops = 6.0 * g * steps * h * 4 * h
    n_bytes = 4 * (3 * args[0].numel() + 2 * xp.numel() + 2 * w_hh.numel()
                   + B)
    bound_ms, bound_by = bound(n_bytes, flops)
    plan = mod.scan_plan(B, h, backward=True)
    return {
        "name": "lstm_scan_backward", "route": "cuda",
        "source": "gcn_tpu_torch/csrc/lstm_scan_backward.cu",
        "replaces": "gcn_tpu/ops/pallas/lstm_scan.py:262",
        "shape": {"T": t, "G": g, "B": B, "H": h, "sum_len": steps},
        "plan": scan_plan_facts(mod, plan, g),
        "dw_slices": mod.BACKWARD_KERNEL.load().lstm_scan_backward_dw_slices(
            g, h),
        "max_abs_err": abs_errs["f32"], "errs": errs, "same_bits_twice": same,
        "tol": {"f32": TOL_BWD, "bf16": TOL_BF16}, "ok": ok,
        **times, "ms_per_step": times["ms"] / t,
        "split_ms_profiler": split_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": fwd_bwd_ms - fwd_ms,
        "library": "torch.nn.LSTM (cuDNN) bidirectional, packed, D=360, "
                   "forward+backward minus forward (eager: median of event "
                   "pairs)",
        "library_fwd_ms": fwd_ms, "library_fwd_bwd_ms": fwd_bwd_ms,
        "timing": TIMING_GRAPH,
    }


def check_gmm_backward(torch, rng, dev, gs) -> list[dict]:
    from gcn_tpu_torch.ops import grouped_matmul as mod

    r = gs.shape[0]
    m, h = 2 * B * N_BUCKET, 200
    out = []
    for t in (400, 200):
        x = torch.tensor(rng.uniform(-1, 1, (m, t)), dtype=torch.float32,
                         device=dev)
        s = torch.tensor(rng.randn(r, t, h) / np.sqrt(t), dtype=torch.float32,
                         device=dev)
        g = torch.tensor(rng.randn(m, h) * 0.1, dtype=torch.float32,
                         device=dev)
        errs, abs_err = {}, 0.0
        for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            args = (x.to(dtype), g.to(dtype), s.to(dtype), gs)
            got = mod.grouped_matmul_backward(*args)
            want = mod.grouped_matmul_backward_plain(*args)
            errs[name] = max(scaled_err(a, b) for a, b in zip(got, want))
            if name == "f32":
                abs_err = max(max_err(a, b) for a, b in zip(got, want))
                again = mod.grouped_matmul_backward(*args)
                same = all(torch.equal(a, b) for a, b in zip(got, again))
            if bool(got[1][gs == 0].any()):
                fail("grouped_matmul_backward: dS of an empty group")
        torch.cuda.synchronize()
        fn = functools.partial(mod.grouped_matmul_backward, x, g, s, gs)
        plain_ms = time_ms(
            lambda: mod.grouped_matmul_backward_plain(x, g, s, gs), 10)
        split = device_time(torch, lambda: [fn() for _ in range(5)])
        split_ms = None if split is None else {
            k: v / 5 for k, v in split["top_kernels_ms"].items()
            if "grouped_matmul" in k}
        # yardstick only (the port never calls it): torch._grouped_mm's
        # autograd backward, forward+backward minus forward, where it runs
        # in f32
        offs = torch.cumsum(gs, 0, dtype=torch.int32)
        grouped_mm = getattr(torch, "_grouped_mm", None)
        library_ms, library_note = None, "torch._grouped_mm is absent"
        if grouped_mm is not None:
            xr = x.clone().requires_grad_()
            sr = s.clone().requires_grad_()
            try:
                fwd_ms = time_ms(lambda: grouped_mm(xr, sr, offs=offs), 20)
                fwd_bwd_ms = time_ms(
                    lambda: torch.autograd.grad(
                        grouped_mm(xr, sr, offs=offs), [xr, sr], g), 20)
                library_ms = fwd_bwd_ms - fwd_ms
                library_note = ("torch._grouped_mm f32 autograd, "
                                "forward+backward minus forward (eager)")
            except (RuntimeError, NotImplementedError) as e:
                library_note = f"not measured: {str(e)[:200]}"
        used = int((gs > 0).sum())
        # x, g and the used groups' S in; dx and every group's dS out (the
        # dS partials are scratch of this design, not of the function, and
        # stand apart in shape)
        n_bytes = 4 * (x.numel() + g.numel() + used * t * h + m * t
                       + r * t * h + r)
        slots = mod.BACKWARD_KERNEL.load().grouped_matmul_backward_partials(m)
        out.append({
            "name": f"grouped_matmul_backward_T{t}", "route": "cuda",
            "source": "gcn_tpu_torch/csrc/grouped_matmul_backward.cu",
            "replaces": "gcn_tpu/ops/pallas/grouped_matmul.py:208",
            "shape": {"M": m, "T": t, "H": h, "R": r, "groups_used": used,
                      "partial_scratch_bytes": 4 * slots * t * h},
            "max_abs_err": abs_err, "errs": errs, "same_bits_twice": same,
            "tol": {"f32": TOL_BWD, "bf16": TOL_BF16},
            "ok": errs["f32"] <= TOL_BWD and errs["bf16"] <= TOL_BF16 and same,
            **kernel_ms(fn), "split_ms_profiler": split_ms,
            "plain_ms": plain_ms, **tf32x3_bound(n_bytes, 4.0 * m * t * h),
            "library_ms": library_ms, "library": library_note,
            "timing": TIMING_GMM,
        })
    return out


def edge_lists(torch, batch, dev):
    """The edge-list kernels' operands of one batch: parent and child int32
    and the mask bool, [B, E] on the card."""
    return (torch.tensor(batch["edge_parent"], dtype=torch.int32, device=dev),
            torch.tensor(batch["edge_child"], dtype=torch.int32, device=dev),
            torch.tensor(batch["edge_mask"], dtype=torch.bool, device=dev))


def edge_facts(torch, edges, n: int) -> tuple[int, int]:
    """(bytes of the edge lists, edges that count: mask set, ends in
    [0, n))."""
    from gcn_tpu_torch.ops.spmm import valid_edges

    n_bytes = sum(t.numel() * t.element_size() for t in edges)
    return n_bytes, int(valid_edges(*edges, n).sum())


TIMING_GRAPH = ("ms, plain_ms, library_ms: 20 calls in one CUDA graph, "
                "replayed 10 times, per call, L2 warm; ms_one_call_graph: "
                "one call in a graph replayed 50 times, no less than the "
                "host's cost of a replay (the timing_floor line); eager_ms: "
                "median of one event pair around each of 20 eager calls, "
                "the wrapper included")


def check_band(torch, rng, dev, edges) -> list[dict]:
    """Kernels 5 and 6 at the C-GCN layer's shapes (x [B, 96, 200])."""
    from gcn_tpu_torch.ops import band_aggregate as mod
    from gcn_tpu_torch.ops.adjacency import build_adjacency

    b, n, h = edges[0].shape[0], N_BUCKET, 200
    x_f, x_r, x_s = (torch.tensor(rng.randn(b, n, h), dtype=torch.float32,
                                  device=dev) for _ in range(3))
    fwd_errs, fwd_abs, fwd_same = {}, 0.0, True
    for relu in (True, False):
        got = mod.band_aggregate_forward(*edges, x_f, x_r, x_s, relu)
        again = mod.band_aggregate_forward(*edges, x_f, x_r, x_s, relu)
        want = mod.band_aggregate_plain(*edges, x_f, x_r, x_s, relu)
        fwd_errs[f"relu={relu}"] = scaled_err(got, want)
        fwd_abs = max(fwd_abs, max_err(got, want))
        fwd_same = fwd_same and bool(torch.equal(got, again))
    got = mod.pair_aggregate(*edges, x_f)
    again = mod.pair_aggregate(*edges, x_f)
    want = mod.pair_aggregate_plain(*edges, x_f)
    pair_err = max(scaled_err(a, w) for a, w in zip(got, want))
    pair_abs = max(max_err(a, w) for a, w in zip(got, want))
    pair_same = all(bool(torch.equal(a, a2)) for a, a2 in zip(got, again))
    torch.cuda.synchronize()
    # yardstick only (the port never calls it): the dense path's product on
    # a band built beforehand; the build is timed apart
    build_ms = graph_ms(lambda: build_adjacency(*edges, n))
    adj = build_adjacency(*edges, n)
    band_fr = torch.cat([adj.forward, adj.reverse], dim=2)   # [B, N, 2N]
    x_fr = torch.cat([x_f, x_r], dim=1)                      # [B, 2N, H]
    band_tf = torch.cat([adj.reverse, adj.forward], dim=1)   # [B, 2N, N]
    e_bytes, valid = edge_facts(torch, edges, n)
    rows = []
    for name, line, fn, plain, lib, lib_note, err, abs_err, same, n_bytes, \
            flops in (
        ("band_aggregate_forward", 88,
         lambda: mod.band_aggregate_forward(*edges, x_f, x_r, x_s),
         lambda: mod.band_aggregate_plain(*edges, x_f, x_r, x_s),
         lambda: torch.bmm(band_fr, x_fr),
         "torch.bmm of the prebuilt [A_f | A_f^T] band [B, N, 2N] with "
         "[x_f; x_r] (no x_s, denom or ReLU)",
         max(fwd_errs.values()), fwd_abs, fwd_same,
         4 * 4 * x_f.numel() + e_bytes, 2.0 * valid * h + 3.0 * x_f.numel()),
        ("band_aggregate_pair", 149,
         lambda: mod.pair_aggregate(*edges, x_f),
         lambda: mod.pair_aggregate_plain(*edges, x_f),
         lambda: torch.bmm(band_tf, x_f),
         "torch.bmm of the prebuilt [A_f^T; A_f] band [B, 2N, N] with x",
         pair_err, pair_abs, pair_same, 3 * 4 * x_f.numel() + e_bytes,
         2.0 * valid * h),
    ):
        bound_ms, bound_by = bound(n_bytes, flops)
        rows.append({
            "name": name, "route": "cuda",
            "source": "gcn_tpu_torch/csrc/band_aggregate.cu",
            "replaces": f"gcn_tpu/ops/pallas/band_aggregate.py:{line}",
            "shape": {"B": b, "N": n, "E": edges[0].shape[1], "H": h,
                      "valid_edges": valid},
            "max_abs_err": abs_err,
            "errs": fwd_errs if name.endswith("forward") else {"f32": err},
            "same_bits_twice": same,
            "tol": {"f32": TOL_F32}, "ok": err <= TOL_F32 and same,
            **kernel_ms(fn), "plain_ms": graph_ms(plain),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": graph_ms(lib), "library": lib_note,
            "library_band_build_ms": build_ms, "timing": TIMING_GRAPH,
        })
    return rows


def check_spmm(torch, rng, dev, edges) -> list[dict]:
    """Kernels 7 and 8 at the paper GCN's two layers' shapes (h [B, 96, T]
    with T = 360 and 200, W [T, 200])."""
    from gcn_tpu_torch.ops import spmm_fused as mod
    from gcn_tpu_torch.ops.adjacency import build_adjacency

    b, n, hd = edges[0].shape[0], N_BUCKET, 200
    build_ms = graph_ms(lambda: build_adjacency(*edges, n))
    adj = build_adjacency(*edges, n)
    s_full = adj.combined + torch.eye(n, device=dev)  # A_f + A_f^T + diag
    e_bytes, valid = edge_facts(torch, edges, n)
    rows = []
    for t in (360, 200):
        h = torch.tensor(rng.randn(b, n, t), dtype=torch.float32, device=dev)
        g = torch.tensor(rng.randn(b, n, t), dtype=torch.float32, device=dev)
        w = torch.tensor(rng.uniform(-1, 1, (t, hd)) / np.sqrt(t),
                         dtype=torch.float32, device=dev)
        bias = torch.tensor(rng.uniform(-0.1, 0.1, hd), dtype=torch.float32,
                            device=dev)
        got = mod.gcn_spmm_forward(*edges, h, w, bias)
        want = mod.gcn_spmm_plain(*edges, h, w, bias)
        fwd_err, fwd_abs = scaled_err(got, want), max_err(got, want)
        got = mod.sym_pair(*edges, g, h)
        want = mod.sym_pair_plain(*edges, g, h)
        pair_err = max(scaled_err(a, w_) for a, w_ in zip(got, want))
        pair_abs = max(max_err(a, w_) for a, w_ in zip(got, want))
        torch.cuda.synchronize()
        gh = torch.cat([g, h], dim=2)
        gather = 2.0 * valid * t + 2.0 * b * n * t   # S·x of one operand
        for name, line, fn, plain, lib, lib_note, err, abs_err, n_bytes, \
                flops in (
            (f"spmm_fused_forward_T{t}", 88,
             lambda: mod.gcn_spmm_forward(*edges, h, w, bias),
             lambda: mod.gcn_spmm_plain(*edges, h, w, bias),
             lambda: torch.bmm(s_full, h) @ w,
             "torch.bmm of the prebuilt S = A_f + A_f^T + diag(incident+1) "
             "band with h, then @ W (two calls; no 2b, denom or ReLU)",
             fwd_err, fwd_abs,
             4 * (h.numel() + w.numel() + hd + b * n * hd) + e_bytes,
             2.0 * b * n * t * hd + gather + 3.0 * b * n * hd),
            (f"spmm_fused_sym_pair_T{t}", 174,
             lambda: mod.sym_pair(*edges, g, h),
             lambda: mod.sym_pair_plain(*edges, g, h),
             lambda: torch.bmm(s_full, gh),
             "torch.bmm of the prebuilt S band with [x1 | x2] [B, N, 2T]",
             pair_err, pair_abs, 4 * 4 * h.numel() + e_bytes, 2 * gather),
        ):
            if "forward" in name:  # the W product runs 3xTF32
                bounds = tf32x3_bound(n_bytes, flops)
            else:
                bounds = dict(zip(("bound_ms", "bound_by"),
                                  bound(n_bytes, flops)))
            rows.append({
                "name": name, "route": "cuda",
                "source": "gcn_tpu_torch/csrc/spmm_fused.cu",
                "replaces": f"gcn_tpu/ops/pallas/spmm_fused.py:{line}",
                "shape": {"B": b, "N": n, "E": edges[0].shape[1], "T": t,
                          "H": hd, "valid_edges": valid},
                "max_abs_err": abs_err, "errs": {"f32": err},
                "tol": {"f32": TOL_F32}, "ok": err <= TOL_F32,
                **kernel_ms(fn), "plain_ms": graph_ms(plain), **bounds,
                "library_ms": graph_ms(lib), "library": lib_note,
                "library_band_build_ms": build_ms, "timing": TIMING_GRAPH,
            })
    return rows


def forest_edges(torch, rng, dev, n: int):
    """[B, n] edge lists of B seeded random trees with lengths in
    [n/2, n] (one at n), the padded slots masked: the giant-forest regime
    where ``attention_impl="auto"`` takes the edge backend."""
    parent = np.zeros((B, n), np.int32)
    child = np.zeros((B, n), np.int32)
    mask = np.zeros((B, n), bool)
    for i in range(B):
        length = n if i == 0 else int(rng.randint(n // 2, n + 1))
        order = rng.permutation(length)
        for k in range(1, length):     # each node hangs off an earlier one
            parent[i, k - 1] = order[rng.randint(0, k)]
            child[i, k - 1] = order[k]
        mask[i, :length - 1] = True
    return (torch.tensor(parent, device=dev), torch.tensor(child, device=dev),
            torch.tensor(mask, device=dev))


def touched_rows(torch, edges, n: int) -> tuple[int, int]:
    """Distinct (sentence, node) rows that counted edges read as parents
    and as children."""
    from gcn_tpu_torch.ops.spmm import valid_edges

    parent, child, mask = edges
    ok = valid_edges(parent, child, mask, n)
    base = torch.arange(parent.shape[0], device=parent.device)[:, None] * n
    return tuple(int(torch.unique((base + idx.long())[ok]).numel())
                 for idx in (parent, child))


def edge_csr(torch, edges, n: int, values, transpose: bool = False):
    """A library yardstick's prebuilt operand: the counted edges of [B, E]
    lists as one block-diagonal [B·n, B·n] CSR matrix with ``values``
    [B, E] at (parent, child), at (child, parent) if ``transpose``.
    Returns it and ``pick``, which takes a [B, E] tensor to its entries'
    order (by row, then column)."""
    from gcn_tpu_torch.ops.spmm import valid_edges

    parent, child, mask = edges
    ok = valid_edges(parent, child, mask, n)
    size = parent.shape[0] * n
    base = torch.arange(parent.shape[0], device=parent.device)[:, None] * n
    rows, cols = (base + parent.long())[ok], (base + child.long())[ok]
    if transpose:
        rows, cols = cols, rows
    order = torch.argsort(rows * size + cols)
    crow = torch.zeros(size + 1, dtype=torch.long, device=parent.device)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=size), 0)

    def pick(t):
        return t[ok][order]

    return (torch.sparse_csr_tensor(crow, cols[order], pick(values),
                                    (size, size), check_invariants=False),
            pick)


def check_sddmm(torch, rng, dev, edges) -> list[dict]:
    """Kernels 9 and 10 at the attention layer's shapes (q, k [B, 96, 200],
    the synthetic batch's edges) and on a forest at N = E = 1200."""
    from gcn_tpu_torch.ops import sddmm as mod

    h = 200
    rows = []
    for tag, case in (("N96", edges),
                      ("N1200", forest_edges(torch, rng, dev, 1200))):
        b, e = case[0].shape
        n = N_BUCKET if tag == "N96" else 1200
        u, v = (torch.tensor(rng.randn(b, n, h) / np.sqrt(h),
                             dtype=torch.float32, device=dev)
                for _ in range(2))
        g = torch.tensor(rng.randn(b, e), dtype=torch.float32, device=dev)
        got = mod.sddmm_forward(*case, u, v)
        again = mod.sddmm_forward(*case, u, v)
        want = mod.sddmm_plain(*case, u, v)
        fwd_err, fwd_abs = scaled_err(got, want), max_err(got, want)
        got_b = mod.sddmm_backward(*case, g, u, v)
        again_b = mod.sddmm_backward(*case, g, u, v)
        want_b = mod.sddmm_backward_plain(*case, g, u, v)
        bwd_err = max(scaled_err(a, w) for a, w in zip(got_b, want_b))
        bwd_abs = max(max_err(a, w) for a, w in zip(got_b, want_b))
        # the backward's list build alone against a stable sort
        lists_ok = bool(torch.equal(mod.edge_lists(*case, n),
                                    mod.edge_lists_plain(*case, n)))
        torch.cuda.synchronize()
        same = {"forward": bool(torch.equal(got, again)),
                "backward": all(torch.equal(a, w)
                                for a, w in zip(got_b, again_b))}
        e_bytes, valid = edge_facts(torch, case, n)
        rows_p, rows_c = touched_rows(torch, case, n)
        gathered = 4 * h * (rows_p + rows_c)
        # yardsticks only (the port never calls them): cuSPARSE's SDDMM
        # and two sparse-dense products on block-diagonal CSR patterns of
        # the counted edges, built beforehand and not timed, as the band
        # rows' prebuilt bands; each is held against the plain version
        u2, v2 = u.reshape(b * n, h), v.reshape(b * n, h)
        pattern, pick = edge_csr(torch, case, n, torch.zeros_like(g))
        a_g, _ = edge_csr(torch, case, n, g)
        a_gt, _ = edge_csr(torch, case, n, g, transpose=True)

        def lib_fwd():
            return torch.sparse.sampled_addmm(pattern, u2, v2.t())

        def lib_bwd():
            return a_g @ v2, a_gt @ u2

        lib_fwd_err = scaled_err(lib_fwd().values(), pick(want))
        lib_bwd_err = max(scaled_err(a.reshape(b, n, h), w)
                          for a, w in zip(lib_bwd(), want_b))
        for name, line, fn, plain, lib, lib_note, lib_err, err, abs_err, \
                tol, n_bytes, flops in (
            (f"sddmm_forward_{tag}", 64,
             lambda: mod.sddmm_forward(*case, u, v),
             lambda: mod.sddmm_plain(*case, u, v), lib_fwd,
             "torch.sparse.sampled_addmm of the prebuilt CSR edge pattern "
             "[B·N, B·N] with u and v^T (counted edges only, in CSR order)",
             lib_fwd_err, fwd_err, fwd_abs,
             TOL_F32, e_bytes + gathered + 4 * b * e, 2.0 * valid * h),
            (f"sddmm_backward_{tag}", 132,
             lambda: mod.sddmm_backward(*case, g, u, v),
             lambda: mod.sddmm_backward_plain(*case, g, u, v), lib_bwd,
             "two calls, one an output: the prebuilt CSR pattern with "
             "values g @ v, and its prebuilt transpose @ u",
             lib_bwd_err, bwd_err, bwd_abs, TOL_BWD,
             e_bytes + 4 * b * e + gathered + 2 * 4 * b * n * h,
             4.0 * valid * h),
        ):
            bound_ms, bound_by = bound(n_bytes, flops)
            kind = name.split("_")[1]
            rows.append({
                "name": name, "route": "cuda",
                "source": "gcn_tpu_torch/csrc/sddmm.cu",
                "replaces": f"gcn_tpu/ops/pallas/sddmm.py:{line}",
                "shape": {"B": b, "N": n, "E": e, "H": h,
                          "valid_edges": valid, "parent_rows": rows_p,
                          "child_rows": rows_c},
                "max_abs_err": abs_err, "errs": {"f32": err},
                "same_bits_twice": same[kind],
                "library_err": lib_err,
                "tol": {"f32": tol},
                **({"lists_equal_plain": lists_ok}
                   if kind == "backward" else {}),
                "ok": (err <= tol and same[kind] and lib_err <= tol
                       and (lists_ok or kind != "backward")),
                **kernel_ms(fn), "plain_ms": graph_ms(plain),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": graph_ms(lib), "library": lib_note,
                "timing": TIMING_GRAPH,
            })
    return rows


def check_bilinear(torch, rng, dev) -> tuple[list[dict], int]:
    """Kernels 11 and 12 at the non-factored C-GCN layer's shapes (M =
    B·N = 4800 tokens, D = 50, H = 200, T = 400 and 200); returns the rows
    and the launches of v1 in this phase (its only caller here)."""
    from gcn_tpu_torch.ops import deprel_bilinear as mod

    m, d, h = B * N_BUCKET, 50, 200
    rows, v1_launches = [], 0
    for t in (400, 200):
        x = torch.tensor(rng.randn(m, t), dtype=torch.float32, device=dev)
        e = torch.tensor(rng.randn(m, d), dtype=torch.float32, device=dev)
        w = torch.tensor(rng.uniform(-1, 1, (d, t, h)) / np.sqrt(t),
                         dtype=torch.float32, device=dev)
        # yardsticks only (the port never calls them): the einsum, which may
        # form [M, D, T] (384 MB at T = 400), and one SGEMM of the same
        # product on its operand z = e ⊗ x [M, D·T], built beforehand and
        # not timed, as the band rows prebuild their bands
        library_ms = graph_ms(
            lambda: torch.einsum("md,mt,dth->mh", e, x, w))
        z = (e[:, :, None] * x[:, None, :]).reshape(m, d * t)
        w2 = w.reshape(d * t, h)
        library_sgemm_ms = graph_ms(lambda: torch.mm(z, w2))
        del z
        n_bytes = 4 * (x.numel() + e.numel() + w.numel() + m * h)
        flops = 2.0 * m * d * t * h
        for version, line in (("v2", 143), ("v1", 57)):
            plain = getattr(mod, f"bilinear_{version}_plain")
            (got, again), counts = counted(lambda: [
                mod.bilinear_forward(x, e, w, version) for _ in range(2)])
            v1_launches += counts["deprel_bilinear_v1"]
            want = plain(x, e, w)
            err, abs_err = scaled_err(got, want), max_err(got, want)
            same = bool(torch.equal(got, again))
            bounds = tf32x3_bound(n_bytes, flops)  # both on the mainloop
            fn = functools.partial(mod.bilinear_forward, x, e, w, version)
            rows.append({
                "name": f"deprel_bilinear_{version}_T{t}", "route": "cuda",
                "source": "gcn_tpu_torch/csrc/deprel_bilinear.cu",
                "replaces": f"gcn_tpu/ops/pallas/deprel_bilinear.py:{line}",
                "shape": {"M": m, "T": t, "D": d, "H": h},
                "max_abs_err": abs_err, "errs": {"f32": err},
                "same_bits_twice": same, "tol": {"f32": TOL_F32},
                "ok": err <= TOL_F32 and same,
                **kernel_ms(fn),
                "plain_ms": graph_ms(functools.partial(plain, x, e, w)),
                **bounds, "library_ms": library_ms,
                "library": 'torch.einsum("md,mt,dth->mh", e, x, w)',
                "library_sgemm_ms": library_sgemm_ms,
                "library_sgemm": "torch.mm of the prebuilt z = e ⊗ x "
                                 "[M, D·T] with W [D·T, H], f32",
                "timing": TIMING_GRAPH,
            })
    return rows, v1_launches


# ----------------------------------------------------------------- paths
# The counted main paths: each configuration's preset and overrides.
PATHS = {
    "cgcn": ("cgcn_preset", {}),
    "cgcn_fused": ("cgcn_preset", {"model.use_pallas": True}),
    "gcn_fused": ("gcn_preset", {"model.use_pallas": True}),
    "cgcn_attn": ("cgcn_preset", {"model.adj_type": "attention",
                                  "model.attention_impl": "edge"}),
    "cgcn_bilinear": ("cgcn_preset", {"model.deprel_factored": False,
                                      "model.use_pallas": True}),
    "cdiag_fused": ("cgcn_preset", {"model.adj_type": "diagonal_deprel",
                                    "model.use_pallas": True}),
    # 1024: BERT-large's width, which gcn_tpu's run_training sets
    "cgcn_bert": ("cgcn_preset", {"model.use_bert_embeddings": True,
                                  "model.emb_dim": 1024}),
    # as train_cgcn_semeval.sh sets it
    "cgcn_semeval": ("cgcn_preset", {"model.dataset": "semeval",
                                     "model.num_class": 10,
                                     "train.word_dropout": 0.0}),
}
# the inputs each path reads (``load_batches``): the in-repo TACRED and
# synthetic N=96 sentences by word ids, the same sentences as seeded
# [L, 1024] float rows, or the in-repo SemEval and synthetic SemEval
# sentences
INPUTS = {"cgcn_bert": "bert", "cgcn_semeval": "semeval"}
# Each kernel's launches per evaluation forward and per train step (the
# step's forward included) on each path, at 2 GCN layers: the scans once,
# the grouped matmul once a layer (both bands stacked), an edge-list
# layer kernel once a layer, the SDDMM and the bilinear once a band and
# layer.  Every kernel not named launches 0 times.
_CGCN = {"lstm_scan_forward": 1, "grouped_matmul_forward": 2}
_CGCN_BWD = {"lstm_scan_backward": 1, "grouped_matmul_backward": 2}
EXPECTED = {
    "cgcn": (_CGCN, {**_CGCN, **_CGCN_BWD}),
    "cgcn_fused": ({**_CGCN, "band_aggregate_forward": 2},
                   {**_CGCN, **_CGCN_BWD, "band_aggregate_forward": 2,
                    "band_aggregate_pair": 2}),
    "gcn_fused": ({"spmm_fused_forward": 2},
                  {"spmm_fused_forward": 2, "spmm_fused_sym_pair": 2}),
    "cgcn_attn": ({"lstm_scan_forward": 1, "sddmm_forward": 4},
                  {"lstm_scan_forward": 1, "sddmm_forward": 4,
                   "lstm_scan_backward": 1, "sddmm_backward": 4}),
    "cgcn_bilinear": ({"lstm_scan_forward": 1, "deprel_bilinear_v2": 4,
                       "band_aggregate_forward": 2},
                      {"lstm_scan_forward": 1, "deprel_bilinear_v2": 4,
                       "band_aggregate_forward": 2, "lstm_scan_backward": 1,
                       "band_aggregate_pair": 2}),
    "cdiag_fused": ({"lstm_scan_forward": 1, "band_aggregate_forward": 2},
                    {"lstm_scan_forward": 1, "band_aggregate_forward": 2,
                     "lstm_scan_backward": 1, "band_aggregate_pair": 2}),
    "cgcn_bert": (_CGCN, {**_CGCN, **_CGCN_BWD}),
    "cgcn_semeval": (_CGCN, {**_CGCN, **_CGCN_BWD}),
}
# Each path's card-side reference, the plain versions: the scan's and the
# grouped matmul's; for the edge-list layers the dense bands
# (``build_adjacency`` + ``bmm``, what their plain versions compute); for
# the attention edge backend the dense backend; for the non-factored
# bilinear on the fused path the einsum on the dense bands; for the fused
# diagonal_deprel layers the dense bands' two ``bmm``.
_PLAIN = {"model.rnn_impl": "scan", "model.deprel_factored": "ragged",
          "model.use_pallas": False}
PLAIN = {
    "cgcn": _PLAIN, "cgcn_fused": _PLAIN, "gcn_fused": _PLAIN,
    "cgcn_attn": {"model.rnn_impl": "scan", "model.attention_impl": "dense"},
    "cgcn_bilinear": {"model.rnn_impl": "scan", "model.use_pallas": False},
    "cdiag_fused": _PLAIN, "cgcn_bert": _PLAIN, "cgcn_semeval": _PLAIN,
}
# a path whose logits must also equal another path's on the same weights:
# the non-factored full_deprel against the factored one (both exact)
CROSS = {"cgcn_bilinear": "cgcn"}


def kernel_table() -> dict:
    """Every kernel of the port by the name its row carries."""
    from gcn_tpu_torch.ops import band_aggregate, grouped_matmul, lstm_scan
    from gcn_tpu_torch.ops import deprel_bilinear, sddmm, spmm_fused

    return {"lstm_scan_forward": lstm_scan.KERNEL,
            "lstm_scan_backward": lstm_scan.BACKWARD_KERNEL,
            "grouped_matmul_forward": grouped_matmul.KERNEL,
            "grouped_matmul_backward": grouped_matmul.BACKWARD_KERNEL,
            "band_aggregate_forward": band_aggregate.KERNEL,
            "band_aggregate_pair": band_aggregate.PAIR_KERNEL,
            "spmm_fused_forward": spmm_fused.KERNEL,
            "spmm_fused_sym_pair": spmm_fused.SYM_PAIR_KERNEL,
            "sddmm_forward": sddmm.KERNEL,
            "sddmm_backward": sddmm.BACKWARD_KERNEL,
            "deprel_bilinear_v2": deprel_bilinear.KERNEL_V2,
            "deprel_bilinear_v1": deprel_bilinear.KERNEL_V1}


def path_config(path: str, **extra):
    from gcn_tpu_torch import config

    preset, overrides = PATHS[path]
    return getattr(config, preset)(**{**overrides, **extra})


def counted(fn):
    """Run ``fn`` with every kernel's count set to 0 just before; returns
    (its result, every count just after)."""
    import torch

    kernels = kernel_table()
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    out = fn()
    torch.cuda.synchronize()
    return out, {name: k.launches for name, k in kernels.items()}


def check_launches(path: str, what: str, launches: dict, expected: dict,
                   runs: int) -> dict:
    """Fail unless every kernel launched exactly ``expected`` times per
    run (0 for a kernel not named) over ``runs`` forwards or steps;
    returns the launches per run."""
    per_run = {k: v / runs for k, v in launches.items()}
    for name, count in per_run.items():
        if count != expected.get(name, 0):
            fail(f"{path}: kernel {name} launched {count} times per {what}, "
                 f"not {expected.get(name, 0)}")
    return per_run


# ----------------------------------------------------------------- slice
def run_slice(torch, dev, real, synth, vocab_size: int, path: str) -> dict:
    from gcn_tpu_torch.models.gcn import GCNClassifier, init_params
    from gcn_tpu_torch.train.evaluator import Evaluator, batch_to_device
    from gcn_tpu_torch.train.scorer import score

    base = {"model.vocab_size": vocab_size, "train.batch_size": B}
    cfg = path_config(path, **base)
    plain_cfg = path_config(path, **base, **PLAIN[path])
    model = GCNClassifier(cfg.model)
    init_params(model, torch.Generator().manual_seed(SEED))
    state = model.state_dict()
    ev = Evaluator(cfg, state, device=dev)
    ev_plain = Evaluator(plain_cfg, state, device=dev)
    # on the CPU every kernel's wrapper runs its plain version
    ev_cpu = Evaluator(cfg, state, device="cpu")
    fused = cfg.model.use_pallas is True
    if fused:  # the same weights on the dense bands (use_pallas=False)
        ev_dense = Evaluator(path_config(path, **base,
                                         **{"model.use_pallas": False}),
                             state, device=dev)
    cross = CROSS.get(path)
    if cross:  # the same weights on another path
        ev_cross = Evaluator(path_config(cross, **base), state, device=dev)

    # the main path, counted
    t0 = time.perf_counter()
    (preds, probs, loss), launches = counted(
        lambda: ev.evaluate(real + synth))
    first_s = time.perf_counter() - t0
    per_forward = check_launches(path, "evaluation forward", launches,
                                 EXPECTED[path][0], len(real + synth))
    n_sent = sum(int(b["example_mask"].sum()) for b in real + synth)
    if len(preds) != n_sent or not np.isfinite(loss):
        fail(f"{path}: evaluate gave {len(preds)} predictions for {n_sent}, "
             f"loss {loss}")

    # the same forward with the plain versions, on the card and the CPU,
    # on the dense bands and on the cross path, over the batches' valid
    # rows (padded rows pool -1e12 fills)
    err, err_cpu, err_dense, err_cross = 0.0, 0.0, 0.0, 0.0
    with torch.no_grad():
        for i, b in enumerate(real + synth):
            lk, hk = ev.model(batch_to_device(b, dev))
            lp, hp = ev_plain.model(batch_to_device(b, dev))
            if lk.shape != (B, cfg.model.num_class) or not bool(
                    torch.isfinite(lk).all()):
                fail(f"{path}: logits shape {tuple(lk.shape)} or "
                     "non-finite")
            valid = torch.from_numpy(b["example_mask"]).to(dev)
            err = max(err, row_err(lk[valid], lp[valid]),
                      row_err(hk[valid], hp[valid]))
            if fused:
                ld, hd = ev_dense.model(batch_to_device(b, dev))
                err_dense = max(err_dense, row_err(lk[valid], ld[valid]),
                                row_err(hk[valid], hd[valid]))
            if cross:
                lx, hx = ev_cross.model(batch_to_device(b, dev))
                err_cross = max(err_cross, row_err(lk[valid], lx[valid]),
                                row_err(hk[valid], hx[valid]))
            if i == 0:
                lc, _ = ev_cpu.model(batch_to_device(b, "cpu"))
                err_cpu = row_err(lk[valid].cpu(), lc[valid.cpu()])
    if max(err, err_cpu, err_dense, err_cross) > TOL_SLICE:
        fail(f"{path}: slice logits differ: card plain {err}, cpu "
             f"{err_cpu}, dense bands {err_dense}, {cross} {err_cross}")

    gold = [l for b in real + synth for l in
            (b["labels"][b["example_mask"]]).tolist()]
    with open(os.devnull, "w") as sink:
        _, _, f1 = score([str(g) for g in gold], [str(p) for p in preds],
                         negative_label="0", out=sink)

    def rate(batches, reps=3):
        n = sum(int(b["example_mask"].sum()) for b in batches)
        best = float("inf")
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            ev.evaluate(batches)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t)
        return n / best

    return {
        "phase": "slice", "path": path, "sentences": n_sent,
        "batches": {"real": len(real), "synthetic_n96": len(synth)},
        "launches": launches, "launches_per_forward": per_forward,
        "first_pass_s": first_s,
        "row_err_plain_card": err, "row_err_plain_cpu": err_cpu,
        "row_err_dense_bands": err_dense if fused else None,
        "row_err_cross": {cross: err_cross} if cross else None,
        "tol": TOL_SLICE, "loss": loss, "f1_random_weights": f1,
        "sentences_per_s_real": rate(real),
        "sentences_per_s_n96": rate(synth),
    }


# ----------------------------------------------------------------- train
KERNEL_GROUPS = (  # device time by category, matched on kernel names
    ("scan forward kernel", ("lstm_scan_fwd_kernel",)),
    ("scan backward kernels", ("lstm_gates_kernel", "lstm_chain_kernel",
                               "lstm_dw_kernel")),
    ("grouped matmul forward kernel", ("grouped_matmul_fwd_kernel",)),
    ("grouped matmul backward dx kernel", ("grouped_matmul_dx_kernel",)),
    ("grouped matmul backward dS kernels", ("grouped_matmul_ds_kernel",
                                            "grouped_matmul_ds_sum_kernel")),
    ("band aggregate forward kernel", ("band_aggregate_fwd_kernel",)),
    ("band aggregate pair kernel", ("band_pair_kernel",)),
    ("fused GCN layer forward kernel", ("spmm_fused_fwd_kernel",)),
    ("fused GCN layer sym pair kernel", ("spmm_sym_pair_kernel",)),
    ("sddmm forward kernel", ("sddmm_fwd_kernel",)),
    ("sddmm backward kernels", ("sddmm_lists_kernel",
                                "sddmm_gather_kernel")),
    ("deprel bilinear kernels", ("deprel_bilinear_kernel",
                                 "deprel_bilinear_sum_kernel")),
    ("copies", ("Memcpy", "Memset")),
    ("library matmuls", ("gemm", "cublas", "cutlass", "xmma")),
)


def device_time(torch, fn) -> dict:
    """Run ``fn`` under ``torch.profiler``: the device's busy ms by
    category and its ten longest kernels, or ``None`` where the trace
    holds no device events."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_cat = {name: 0.0 for name, _ in KERNEL_GROUPS}
    by_cat["other kernels (elementwise, reductions, optimizer)"] = 0.0
    by_name: dict = {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = evt.time_range.elapsed_us() / 1e3
        by_name[evt.name] = by_name.get(evt.name, 0.0) + ms
        for cat, keys in KERNEL_GROUPS:
            if any(k.lower() in evt.name.lower() for k in keys):
                by_cat[cat] += ms
                break
        else:
            by_cat["other kernels (elementwise, reductions, optimizer)"] += ms
    if not by_name:
        return None
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_ms": sum(by_name.values()), "by_category_ms": by_cat,
            "top_kernels_ms": {k[:90]: v for k, v in top}}


def params_err(a, b) -> float:
    """Largest parameter difference of two trainers, each over
    max(1, max |p|)."""
    sa, sb = a.model.state_dict(), b.model.state_dict()
    return max(max_err(sa[k].cpu(), sb[k].cpu())
               / max(1.0, float(sb[k].abs().max())) for k in sb)


def run_train(torch, dev, real_train, synth_train, vocab_size,
              path: str) -> dict:
    from gcn_tpu_torch.models.gcn import GCNClassifier, init_params
    from gcn_tpu_torch.train.trainer import Trainer

    base = {"model.vocab_size": vocab_size, "train.batch_size": B,
            "train.effective_batch_size": B}
    cfg = path_config(path, **base)
    plain_cfg = path_config(path, **base, **PLAIN[path])
    nodrop_cfg = path_config(path, **base, **{"model.input_dropout": 0.0,
                                              "model.rnn_dropout": 0.0,
                                              "model.gcn_dropout": 0.0})
    if cfg.train.update_gap != 1 or cfg.train.optim != "sgd":
        fail("the train slice expects one sgd step per batch")
    model = GCNClassifier(cfg.model)
    init_params(model, torch.Generator().manual_seed(SEED))
    state = model.state_dict()
    batches = real_train + synth_train
    tr = Trainer(cfg, state, device=dev)

    # the main path, counted
    t0 = time.perf_counter()
    losses, launches = counted(lambda: [tr.update(b) for b in batches])
    first_s = time.perf_counter() - t0
    per_step = check_launches(path, "train step", launches,
                              EXPECTED[path][1], len(batches))
    losses = [float(l) for l in losses]
    if not all(np.isfinite(losses)):
        fail(f"{path}: non-finite training loss: {losses}")

    # kernels against the plain versions on the card: same weights, seed
    # and batches, so the same dropout masks
    a = Trainer(cfg, state, device=dev)
    p = Trainer(plain_cfg, state, device=dev)
    loss_err = 0.0
    for b in batches[:3]:
        la, lp = float(a.update(b)), float(p.update(b))
        loss_err = max(loss_err, abs(la - lp) / abs(lp))
    param_err = params_err(a, p)
    # dropout off: one step on the card against one on the CPU
    c = Trainer(nodrop_cfg, state, device=dev)
    cpu = Trainer(nodrop_cfg, state, device="cpu")
    lc, lcpu = float(c.update(real_train[0])), float(cpu.update(real_train[0]))
    cpu_loss_err = abs(lc - lcpu) / abs(lcpu)
    cpu_param_err = params_err(c, cpu)
    if max(loss_err, param_err, cpu_loss_err, cpu_param_err) > TOL_TRAIN:
        fail(f"{path}: trainers disagree: plain on the card loss {loss_err} "
             f"params {param_err}; cpu loss {cpu_loss_err} params "
             f"{cpu_param_err}")

    # the loss falls on one fixed batch
    f = Trainer(cfg, state, device=dev)
    fall = [float(f.update(real_train[0])) for _ in range(TRAIN_STEPS_FALL)]
    if not np.mean(fall[-5:]) < np.mean(fall[:5]):
        fail(f"{path}: the loss did not fall on a fixed batch: {fall}")

    # speed at N=96: host wall time per step, the device's timeline span
    # (CUDA events around the epoch) and its busy time (profiler)
    def epoch():
        for b in synth_train:
            tr.update(b)

    epoch()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        epoch()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    span_ms = time_ms(epoch, 3, warmup=0)
    busy = device_time(torch, epoch)
    # device memory one step adds above what is allocated before it
    # (activations, saved tensors, gradients): the fused paths keep no
    # [B, N, N] band
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    tr.update(synth_train[0])
    torch.cuda.synchronize()
    peak_mib = (torch.cuda.max_memory_allocated() - before) / 2**20
    steps = len(synth_train)
    n_sent = sum(int(b["example_mask"].sum()) for b in synth_train)
    wall = min(walls)
    return {
        "phase": "train", "path": path, "steps": len(batches),
        "batches": {"real": len(real_train), "synthetic_n96": steps},
        "launches": launches, "launches_per_step": per_step,
        "first_pass_s": first_s, "losses": losses,
        "plain_card": {"loss_rel_err": loss_err, "param_err": param_err,
                       "steps": 3},
        "cpu_no_dropout": {"loss_rel_err": cpu_loss_err,
                           "param_err": cpu_param_err, "steps": 1},
        "tol": TOL_TRAIN, "fixed_batch_losses": fall,
        "ms_per_step_n96": wall / steps * 1e3,
        "walls_s": walls,
        "sentences_per_s_n96": n_sent / wall,
        "device_span_ms_per_step_n96": span_ms / steps,
        "step_peak_mib_n96": peak_mib,
        "device_busy_ms_per_step_n96": (
            None if busy is None else busy["busy_ms"] / steps),
        "device_time_per_step_n96": None if busy is None else {
            "by_category_ms": {k: v / steps for k, v in
                               busy["by_category_ms"].items()},
            "top_kernels_ms": {k: v / steps for k, v in
                               busy["top_kernels_ms"].items()}},
    }


# the path whose train run gives each kernel's "launches" in the kernels
# line: the one that brought the kernel in; v1 is on no path, and its
# launches are those of the kernel phase
HOME_PATH = {"lstm_scan_forward": "cgcn", "lstm_scan_backward": "cgcn",
             "grouped_matmul_forward": "cgcn",
             "grouped_matmul_backward": "cgcn",
             "band_aggregate_forward": "cgcn_fused",
             "band_aggregate_pair": "cgcn_fused",
             "spmm_fused_forward": "gcn_fused",
             "spmm_fused_sym_pair": "gcn_fused",
             "sddmm_forward": "cgcn_attn", "sddmm_backward": "cgcn_attn",
             "deprel_bilinear_v2": "cgcn_bilinear",
             "deprel_bilinear_v1": None}


def kernel_of(row_name: str) -> str:
    """The kernel a kernel-phase row measures (rows carry a shape suffix)."""
    return next(k for k in HOME_PATH if row_name.startswith(k))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from gcn_tpu_torch.data.vocab import Vocab
    from gcn_tpu_torch.ops import _cuda

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": name,
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    report = _cuda.build_all(list(kernel_table().values()))
    build_s = time.perf_counter() - t0
    emit({"phase": "build", "seconds": build_s,
          "per_source_s": {k: v["seconds"] for k, v in report.items()},
          "ptxas": {k: ptxas_by_function(v["log"])
                    for k, v in report.items()}})

    rng = np.random.RandomState(SEED)
    vocab = Vocab.load(os.path.join(HERE, "dataset", "vocab", "vocab.pkl"))
    from gcn_tpu_torch.config import cgcn_preset

    # cgcn_preset and gcn_preset prune alike (prune_k 1), so the TACRED
    # paths read the same batches
    inputs = {"tacred": load_batches(cgcn_preset(), vocab, rng)}
    real, synth, real_train, synth_train, _ = inputs["tacred"]
    gs = band_group_sizes(torch, synth[0], dev)
    edges = edge_lists(torch, synth[0], dev)
    # in row order from one generator, so no row's inputs depend on the
    # rows after it
    rows = ([check_lstm(torch, rng, dev)] + check_gmm(torch, rng, dev, gs)
            + [check_lstm_backward(torch, rng, dev)]
            + check_gmm_backward(torch, rng, dev, gs)
            + check_band(torch, rng, dev, edges)
            + check_spmm(torch, rng, dev, edges)
            + check_sddmm(torch, rng, dev, edges))
    bilinear_rows, v1_launches = check_bilinear(torch, rng, dev)
    rows += bilinear_rows
    for row in rows:
        emit({"phase": "kernel", **row})
    emit(timing_floor(torch, dev))
    emit({"phase": "kernels_done", "at_s": time.perf_counter() - t_start})
    bad = [r["name"] for r in rows if not r["ok"]]
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")

    # the other inputs from generators of their own: the BERT path's
    # sentences are the TACRED paths' (the same seed draws the synthetic
    # ones), their float rows drawn apart
    inputs["bert"] = load_batches(path_config("cgcn_bert"), vocab,
                                  np.random.RandomState(SEED),
                                  bert_rng=np.random.RandomState(SEED + 1))
    inputs["semeval"] = load_batches(
        path_config("cgcn_semeval"),
        Vocab.load(os.path.join(HERE, "dataset", "vocab_semeval",
                                "vocab.pkl")),
        np.random.RandomState(SEED + 2))
    slices, trains = {}, {}
    for path in PATHS:
        real, synth, real_train, synth_train, vocab_size = inputs[
            INPUTS.get(path, "tacred")]
        slices[path] = run_slice(torch, dev, real, synth, vocab_size, path)
        emit({**slices[path], "at_s": time.perf_counter() - t_start})
        trains[path] = run_train(torch, dev, real_train, synth_train,
                                 vocab_size, path)
        emit({**trains[path], "at_s": time.perf_counter() - t_start})
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    line = []
    for row in rows:
        kernel = kernel_of(row["name"])
        home = HOME_PATH[kernel]
        row["launches"] = (v1_launches if home is None
                           else trains[home]["launches"][kernel])
        by_path = {
            path: {"eval_forward":
                   slices[path]["launches_per_forward"][kernel],
                   "train_step": trains[path]["launches_per_step"][kernel]}
            for path in PATHS}
        line.append({**{k: row[k] for k in keys},
                     **{k: row[k] for k in ("bound_f32_ms", "library_sgemm_ms")
                        if k in row},
                     "launches_path": home or "kernel phase",
                     "launches_by_path": by_path})
    emit({"kernels": line})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
