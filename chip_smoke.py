#!/usr/bin/env python3
"""Drive the port's C-GCN, paper-GCN, attention, diagonal_deprel, BERT-input,
SemEval, bf16 and cross-sentence-packed paths on one NVIDIA GPU, score
the reference's trained checkpoints, and drive the row-sparse word-table
update, data-parallel training and the partitioned graph (edges and
halo).

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
   [M, D*T] operand; torch._grouped_mm by the same graph where the build
   lets it be captured, eagerly beside it), and the kernel's
   bound at the card's peak rates (3xTF32 for the kernels that run it,
   with the f32 FMA bound beside); every kernel also in its bf16
   instance, on the same inputs rounded to bf16, each a row of its own
   (``..._bf16``): within TOL_BF16 of the plain version in bf16, the same
   bits twice, timed alike, its bound on bf16 bytes (and the bf16 tensor
   cores' peak where a product counts), its library call in bf16 (where
   the build takes a sparse bf16 product; else ``None`` and the reason);
   the bf16 kernels on the tensor cores (grouped matmul forward and
   backward, fused layer forward, bilinear) with their TFLOP/s and
   ``ptxas`` registers and spills, and a spill fails the first three;
   the bf16 band forward and sym pair (5b, 8b: kernels of their own) with
   their ``ptxas`` lines, a spill failing them too, and their blocks in a
   wave; the bf16 scans (1b, 2b) with their ``ptxas`` lines, a spill in
   an instance the paths launch failing them too, and their outputs'
   SHA-256; the bf16 SDDMM backward (10b, one kernel) with its ``ptxas``
   lines, a spill failing it, and both SDDMM backwards' ms by launch;
   the edge-list kernels
   (5-8) with GB/s and their outputs' SHA-256; for the
   scans also their cluster
   partition and how many of its clusters fit the card at once, and the
   backward's time by launch, f32 and bf16 (gates, chain, dW; for the
   grouped matmul's,
   in f32 and in bf16, dx, dS and the partials' sum); then the floor of
   the graph timings
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
   path.  The forwards replay CUDA graphs (a graph's launches count at
   each replay; the eager call before a capture is not counted); the
   sentences/s are read through graphs and eagerly (``eager_dispatch``);
5. train  — for each path, ``Trainer.update`` at the same widths (sgd 0.3,
   clip 5, pooling_l2 0.003, the preset's dropouts) over the training
   batches of the in-repo train split and of the synthetic sentences.
   Every kernel must have launched exactly as often per step as
   ``EXPECTED`` says (0 off the path); a trainer on the plain versions on
   the card, from the same weights and seed, must follow it for 3 steps;
   with dropout off one step on the card must match one on the CPU; the
   loss on one fixed batch must fall over 20 steps; 3 steps through
   graphs must give the eager steps' losses and parameters in bits (on
   ``NONDETERMINISTIC``'s path, whose eager steps differ run to run,
   within 1e-6 of each tensor's max |value|); and
   ms per step (graphs and eager), sentences/s, the device's busy time by
   kernel, the memory the graphs reserve and the device memory one eager
   step adds are measured at N=96;
6. dispatch — on ``cgcn`` at B=50 over the four synthetic N=96 batches
   (twice) and the real bucket-48 one: 8 steps at ``steps_per_dispatch``
   1 and 4 and a 7-batch ``update_chunk`` (pieces 4 + 2 + 1) give the
   eager steps' bits; ``evaluate`` through graphs with the window and in
   chunks of 4 gives the eager one's predictions, probabilities and loss;
   a run after ``Trainer.warmup`` gives the unwarmed run's bits and the
   warm-up leaves the trainer as it was; a packed batch crosses in one
   copy; a trainer on ``deprel_factored="ragged"`` (which a graph cannot
   hold) takes steps and a chunk and evaluates, eagerly, capturing
   nothing; a capture that cannot succeed raises (in a process of its
   own).
   Host ms a step eager against graphs at spd 1, 4 and 8 with the busy
   time and idle share, evaluation sentences/s eager and synced against
   graphs, copies and bytes a step packed and unpacked, and the warm-up's
   graphs, seconds and pool MiB;
   On a bf16 path (``F32_TWIN``) every kernel runs its bf16 instance
   only (a launch of an f32 instance fails the run), the plain versions
   and the CPU are held within TOL_BF16, and the logits' gap to the f32
   twin on the same weights is printed (gated in the reference phase).
   On the packed path (``UNPACKED``) every sentence's logits and h_out are
   held within 1e-4 to its own row of the unpacked path on the same
   weights, and the unpacked path's train and evaluation sentences/s over
   the same sentences are read beside the packed ones;
7. cli    — the run's entry points at ``train_cgcn.sh``'s flags
   (``cgcn_preset`` at its widths, sgd 0.3, B=50) on the committed
   2400/1200/1200-sentence data of ``.campaign_r5/flagship/seed11``:
   ``gcn_tpu_torch.scripts.train`` in process for 3 epochs, its launches
   exactly ``EXPECTED["cgcn"]`` per step and per evaluation batch, its
   run directory complete and its train loss falling; one epoch with
   dropout off on the card and with ``--cpu`` (on ``CPU_THREADS``
   threads), ``logs.txt``'s train and dev loss within 1e-4 relative; the same run as 2 epochs, then
   ``--resume`` to
   3, its ``best_model`` and ``checkpoint_epoch_3`` within 1e-6 of each
   tensor's max |value| of the whole run's; the eval CLI as a subprocess
   on the run (the test F1, dev loss and dev F1 that ``logs.txt``
   recorded at the best epoch)
   and on copies of gcn_tpu's committed seed-11 and seed-17 checkpoints
   at B=100 (dev F1 0.612559 and 0.717025; the card's dev probabilities
   and the CLI's dev loss within 1e-4 of the CPU's; a label unlike the
   CPU's only where it is the CPU's second at a top-two gap under 1e-4).
   The whole run again at ``--steps_per_dispatch 4 --warmup_compile
   true``: its ``logs.txt`` and ``best_model`` the spd=1 run's bits.
   Again with ``--pack_sentences 10``: its launches exactly
   ``EXPECTED["cgcn"]`` per step and evaluation batch of its packed
   batchers, the loss falling, and 2 epochs ``--resume``d to 3 the whole
   packed run's bits; gcn_tpu's seed-11 checkpoint on its dev sentences
   packed (50 rows of up to 10) at dev F1 0.612559.
   Epoch walls, sustained examples/s and the eval CLI's sentences/s;
8. reference — the reference's trained checkpoints (the original PyTorch
   C-GCN's ``best_model.pt`` of ``.campaign_r5/flagship/seed{11,17}/
   reference_full_deprel_models/cmp``, loaded with ``weights_only``, its
   config built here from the run's ``config.json``), carried in by
   ``gcn_tpu_torch.compat.torch_import``, score their seed's 1200 dev
   sentences through ``Evaluator`` at B=50: on the CPU at the runs' own
   best dev F1 (0.680328, 0.664319); on the card in f32 on the dense bands
   and on kernels 5-6, the CPU's labels but at near-ties; in bf16 on both,
   against the same run in f32, at most 6 predictions apart, the F1
   within 0.005 and the largest logit gap within twice gcn_tpu's own
   (0.66, 0.49).  Exported by ``compat.torch_export`` and imported again,
   the parameters keep their bits.
9. sparse — row-sparse word-table updates (``train.sparse_emb``) on
   ``cgcn`` at B=50 over the synthetic N=96 train batches, their words
   drawn uniformly over a table of random f32 rows from the seed: at
   300,000 rows (``SPARSE_EMB_AUTO_VOCAB``) "auto" takes the sparse
   update, its steps launch exactly ``EXPECTED["cgcn"]``, a dense trainer
   (``sparse_emb_grad`` false) on the same weights follows it within
   TOL_TRAIN for 3 steps (and one adagrad step each way), and 3 steps
   through graphs give the eager steps' bits, as two eager runs do; at
   53,954 rows (TACRED's GloVe vocabulary), 10,000 and 1,000 "auto" stays
   dense.  At each size the ms a step through graphs, sparse against
   dense, and the device memory one eager step adds (at 300,000 the busy
   ms and the top kernels too);
10. parallel — ``DistributedTrainer`` on ``cgcn`` at B=50: a world of one
   over NCCL (its all-reduces inside the step's CUDA graph) gives
   ``Trainer``'s losses and parameters in bits over 3 steps and launches
   exactly ``EXPECTED["cgcn"]``; a world of two on the one card over
   gloo (two processes of this script, ``--parallel-rank``; gloo's
   collectives cannot be captured, so their steps run eagerly), each rank
   on its 25 rows of the same global batches, follows ``Trainer`` within
   TOL_TRAIN for 3 steps, and its evaluation (gathered from both ranks)
   gives ``Trainer``'s predictions but at near-ties.  ms a step of each
   beside ``Trainer``'s (graphs, and eager for the gloo world);
11. partition — ``graph_partition`` "edges" and "halo" on a 1 × 2 mesh:
   two gloo ranks on the one card (``--partition-rank``), each on all 50
   rows of the synthetic N=96 batches, with half of their edges
   (``edges``) or half of their nodes (``halo``: slabs of 48, the
   batches' ``hplan_*`` exchange plans, one boundary ``all_to_all`` a
   layer), on ``cgcn`` (the preset's dropouts on; ``edge_keep_prob``
   1.0, so the masks are the dense path's) and on ``cgcn_attn``'s
   configuration (the cross-shard or the slab-local edge softmax): 3
   steps within TOL_TRAIN of ``Trainer`` unpartitioned in loss and every
   parameter, the two ranks' parameters equal in bits, rank 0's launches
   a step exactly ``PARTITION_EXPECTED`` / ``HALO_EXPECTED`` (``cgcn``:
   ``EXPECTED["cgcn"]``, kernels 1-4, under halo 3-4 on the slab's rows;
   ``cgcn_attn``: the scans only), under halo exactly one exchange a
   layer forward and one backward, and the evaluation ``Trainer``'s
   predictions but at near-ties.  Rank 0 also holds one slab-shaped
   grouped-matmul call (M = 50·48, the slab's ragged groups, empty ones
   included) against its plain version.  ms a step of each world,
   eagerly, beside ``Trainer``'s eager ms and the gloo data-parallel
   world's, the exchange's bytes a step and each rank's
   ``max_memory_allocated``: both ranks share one card, so this shows no
   speed-up.

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
precomputed 1024-wide word vectors, no word table), ``cgcn_semeval``
(``cgcn_preset`` on SemEval: no NER, 10 classes), ``cgcn_bf16``,
``cgcn_fused_bf16``, ``gcn_fused_bf16``, ``cgcn_attn_bf16`` and
``cgcn_bilinear_bf16`` (``compute_dtype="bfloat16"`` on ``cgcn``,
``cgcn_fused``, ``gcn_fused``, ``cgcn_attn`` and ``cgcn_bilinear``: every
kernel of the path in its bf16 instance), and ``cgcn_packed``
(``cgcn_preset`` with ``data.pack_sentences=10``: B=50 rows of up to 10
sentences and 128 tokens over the seed-11 split's dev and train
sentences; kernels 1-4, the scans with the rows' carry resets).

Then one line with every kernel's numbers, the ``nvidia-smi`` name and
power limit, and the last line ``{"ok": true, "device": {...}}``.  Any
failure raises and the script exits non-zero without that line; so does a
machine with no CUDA device, or a directory without the package.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import io
import json
import os
import shutil
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
PEAK_BF16_FLOPS = 989e12      # H100 SXM bf16 tensor cores, dense
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


def out_sha256(torch, out) -> str:
    """SHA-256 of a call's output tensors' bytes, in order: two trees'
    kernels told apart on the same inputs (``tools/edge_timing.py``)."""
    h = hashlib.sha256()
    for t in out if isinstance(out, (tuple, list)) else (out,):
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def wave_facts(torch, blocks) -> dict:
    """A launch's (blocks an SM, grid blocks) with the blocks in one wave
    (SMs x blocks an SM) and the waves it takes."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    wave = blocks[0] * sms
    return {"blocks_per_sm": blocks[0], "grid_blocks": blocks[1],
            "wave_blocks": wave, "waves": blocks[1] / max(wave, 1)}


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


# the packed path's batchers and the same sentences unpacked (load_packed)
PACKED: dict = {}


def load_packed():
    """The ``cgcn_packed`` path's batches, as ``load_batches`` returns them
    (no synthetic ones): the seed-11 split's 1200 dev sentences for
    evaluation and its 2400 train sentences (the preset's word dropout)
    packed by ``PackedBatcher`` at the path's config (B = 50 rows of up to
    10 sentences and 128 tokens).  ``PACKED`` keeps the batchers and the
    same sentences unpacked (B = 50, bucketed) for the unpacked twin."""
    from gcn_tpu_torch.data.dataset import (
        Batcher,
        PackedBatcher,
        RelationDataset,
    )
    from gcn_tpu_torch.data.vocab import Vocab

    cfg = path_config("cgcn_packed")
    vocab = Vocab.load(os.path.join(FLAGSHIP, "seed11", "vocab",
                                    "vocab.pkl"))
    cfg.model.vocab_size = vocab.size
    data = os.path.join(FLAGSHIP, "seed11", "data")
    dev_ds = RelationDataset(os.path.join(data, "dev.json"), cfg, vocab,
                             evaluation=True)
    train_ds = RelationDataset(os.path.join(data, "train.json"), cfg, vocab)
    kw = {"pack_len": cfg.data.pack_len or None,
          "max_slots": cfg.data.pack_sentences}
    dev = PackedBatcher(dev_ds, B, evaluation=True, **kw)
    train = PackedBatcher(train_ds, B, seed=SEED, **kw)
    PACKED.update(dev=dev, train=train,
                  dev_unpacked=list(Batcher(dev_ds, B, evaluation=True)),
                  train_unpacked=list(Batcher(train_ds, B, seed=SEED)))
    return list(dev), [], list(train), [], vocab.size


# --------------------------------------------------------------- kernels
def bf16_bound(n_bytes: float, flops: float) -> dict:
    """The bound keys of a bf16 row whose products count at the bf16 tensor
    cores' peak."""
    return dict(zip(("bound_ms", "bound_by"),
                    bound(n_bytes, flops, PEAK_BF16_FLOPS,
                          "operations (bf16)")))


def library_or_none(torch, fn, note: str, timer=None):
    """(ms of ``fn`` by ``timer``, ``time_ms`` over 20 calls by default,
    note) where the library call runs, else (None, why not): a yardstick
    the PyTorch build may refuse in bf16."""
    try:
        return (timer or functools.partial(time_ms, reps=20))(fn), note
    except (RuntimeError, NotImplementedError) as e:
        return None, f"not measured: {str(e)[:200]}"


def bf16_scan_ptxas(ptxas: dict, plan) -> tuple[dict, bool | None]:
    """The ``ptxas`` lines of a scan source's bf16 kernels (their mangled
    names carry ``__nv_bfloat16``) and whether the ones the plan launches
    spill none (``spill_free``): its (rows per thread, resident) instance
    of the cluster kernel, and the backward's gates pass and dW.  (The
    streaming chain at two rows a thread, which no path launches, spills
    20 bytes.)"""
    lines = {k: v for k, v in ptxas.items() if "bfloat16" in k}
    tag = f"Li{plan.rows_per_thread}ELb{int(plan.resident)}E"
    return lines, spill_free({k: v for k, v in lines.items()
                              if tag in k or "lstm_gates" in k
                              or "lstm_dw" in k})


def check_lstm(torch, rng, dev, ptxas: dict) -> list[dict]:
    """Kernel 1 at the C-GCN's BiLSTM (f32, with and without keep) and
    its bf16 instance (1b) with its ``ptxas`` lines (a spill fails it)."""
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
    # the bf16 instance (bf16 xp, w_hh, h and c; f32 gates), timed alike
    first, again = (mod.lstm_scan_forward(xb, lengths, wb) for _ in range(2))
    same_b = all(torch.equal(a, b) for a, b in zip(first, again))
    fn_b = functools.partial(mod.lstm_scan_forward, xb, lengths, wb)
    lstm_b = lstm.to(torch.bfloat16)
    packed_b = torch.nn.utils.rnn.pack_padded_sequence(
        x.bfloat16(), lengths.cpu(), batch_first=True, enforce_sorted=False)
    with torch.no_grad():
        lib_b, lib_b_note = library_or_none(
            torch, lambda: lstm_b(packed_b),
            "torch.nn.LSTM (cuDNN) bidirectional, packed, D=360, bf16 (eager: "
            "median of event pairs)")
    lines_b, spills_ok = bf16_scan_ptxas(ptxas, plan)
    row_b = {
        "name": "lstm_scan_forward_bf16", "route": "cuda",
        "source": "gcn_tpu_torch/csrc/lstm_scan.cu",
        "replaces": "gcn_tpu/ops/pallas/lstm_scan.py:128",
        "dtype": "bfloat16", "shape": {"T": t, "G": g, "B": B, "H": h},
        "max_abs_err": max(max_err(hk, hp), max_err(ck, cp)),
        "errs": {"bf16": errs["bf16"]}, "same_bits_twice": same_b,
        "tol": {"bf16": TOL_BF16},
        "ok": errs["bf16"] <= TOL_BF16 and same_b and spills_ok is not False,
        "ptxas": lines_b, "sha256": out_sha256(torch, first),
        **kernel_ms(fn_b), "plain_ms": graph_ms(functools.partial(
            mod.lstm_scan_plain, xb, lengths, wb), reps=5),
        **bf16_bound(2 * (xp.numel() + 2 * t * g * B * h + w_hh.numel())
                     + 4 * B, flops),
        "library_ms": lib_b, "library": lib_b_note, "timing": TIMING_GRAPH,
    }
    return [{
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
    }, row_b]


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


TIMING_GMM = ("ms and library_ms: 20 calls in one CUDA graph, replayed 10 "
              "times, per call, L2 warm; ms_one_call_graph: one call in a "
              "graph replayed 50 times; eager_ms, library_eager_ms and "
              "plain_ms: median of one event pair around each eager call, "
              "the wrapper included (the plain version reads the group "
              "sizes on the host, so no graph captures it)")


def grouped_mm_yardstick(torch, fn, dtype: str, what: str):
    """(library_ms by ``graph_ms``, library_eager_ms by ``time_ms``, note)
    of a ``torch._grouped_mm`` call ``fn``: yardstick only (the port never
    calls it).  A build without it, or one that refuses the dtype or the
    capture, gives None and says why."""
    if getattr(torch, "_grouped_mm", None) is None:
        return None, None, "torch._grouped_mm is absent"
    eager, note = library_or_none(torch, fn, "")
    if eager is None:
        return None, None, note
    graph, note = library_or_none(
        torch, fn, f"torch._grouped_mm {dtype} {what}", timer=graph_ms)
    if graph is None:
        note = f"the graph capture was refused ({note}); eager only"
    return graph, eager, note


def ptxas_of(ptxas: dict, tag: str) -> dict:
    """The ``ptxas`` lines of the kernels whose mangled names hold tag."""
    return {k: v for k, v in ptxas.items() if tag in k}


def spill_free(lines: dict):
    """Whether ``ptxas`` reported no spill for any of these kernels; None
    where the build left no report (a library built by an earlier run)."""
    if not lines:
        return None
    return all("0 bytes spill stores, 0 bytes spill loads" in v
               for v in lines.values())


def check_gmm(torch, rng, dev, gs, ptxas: dict) -> list[dict]:
    """Kernel 3 at the C-GCN layer's shapes (M = 9600 stacked band rows,
    R = 87 groups, H = 200, T = 400 and 200), in its f32 and its bf16
    instance (the same inputs, rounded), each against torch._grouped_mm in
    the row's dtype; the bf16 row with its TFLOP/s and ``ptxas`` lines."""
    from gcn_tpu_torch.ops import grouped_matmul as mod

    r = gs.shape[0]
    m, h = 2 * B * N_BUCKET, 200
    offs = torch.cumsum(gs, 0, dtype=torch.int32)
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
        library_ms, library_eager_ms, library_note = grouped_mm_yardstick(
            torch, lambda: torch._grouped_mm(x, s, offs=offs), "f32",
            "(offs = cumsum of the group sizes)")
        used = int((gs > 0).sum())
        n_bytes = 4 * (x.numel() + used * t * h + m * h + r)
        flops = 2.0 * m * t * h
        # the bf16 instance, timed alike
        xb, sb = x.bfloat16(), s.bfloat16()
        got_b = mod.grouped_matmul(xb, sb, gs)
        same_b = bool(torch.equal(got_b, mod.grouped_matmul(xb, sb, gs)))
        lib_b, lib_b_eager, lib_b_note = grouped_mm_yardstick(
            torch, lambda: torch._grouped_mm(xb, sb, offs=offs), "bf16",
            "(offs = cumsum of the group sizes)")
        times_b = kernel_ms(functools.partial(mod.grouped_matmul, xb, sb, gs))
        lines_b = ptxas_of(ptxas, "grouped_matmul_fwd_bf16_kernel")
        row_b = {
            "name": f"grouped_matmul_forward_bf16_T{t}", "route": "cuda",
            "source": "gcn_tpu_torch/csrc/grouped_matmul.cu",
            "replaces": "gcn_tpu/ops/pallas/grouped_matmul.py:153",
            "dtype": "bfloat16",
            "shape": {"M": m, "T": t, "H": h, "R": r, "groups_used": used},
            "max_abs_err": max_err(got_b, mod.grouped_matmul_plain(xb, sb, gs)),
            "errs": {"bf16": err_bf16}, "same_bits_twice": same_b,
            "tol": {"bf16": TOL_BF16},
            "ok": (err_bf16 <= TOL_BF16 and same_b
                   and spill_free(lines_b) is not False),
            **times_b, "tflops": flops / (times_b["ms"] * 1e-3) / 1e12,
            "ptxas": lines_b,
            "plain_ms": time_ms(lambda: mod.grouped_matmul_plain(xb, sb, gs),
                                10),
            **bf16_bound(2 * (x.numel() + used * t * h + m * h) + 4 * r,
                         flops),
            "library_ms": lib_b, "library_eager_ms": lib_b_eager,
            "library": lib_b_note, "timing": TIMING_GMM,
        }
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
            **tf32x3_bound(n_bytes, flops),
            "library_ms": library_ms, "library_eager_ms": library_eager_ms,
            "library": library_note, "timing": TIMING_GMM,
        })
        out.append(row_b)
    return out


def check_lstm_backward(torch, rng, dev, ptxas: dict) -> list[dict]:
    """Kernel 2 at the C-GCN's BiLSTM (f32, with and without keep) and
    its bf16 instance (2b), each with its time by launch (gates, chain,
    dW); 2b with its ``ptxas`` lines (a spill fails it)."""
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
    # the bf16 instance (bf16 xp, w_hh, states and dxp; f32 gy and dW),
    # timed alike; the yardstick is cuDNN's layer in bf16
    args_b = inputs(torch.bfloat16, None)
    first, again = (mod.lstm_scan_backward(*args_b) for _ in range(2))
    same_b = all(torch.equal(a, b) for a, b in zip(first, again))
    lstm_b = lstm.to(torch.bfloat16)
    x_b = x.detach().bfloat16().requires_grad_()
    leaves_b = [x_b] + list(lstm_b.parameters())

    def lib_fwd_b():
        packed = torch.nn.utils.rnn.pack_padded_sequence(
            x_b, len_cpu, batch_first=True, enforce_sorted=False)
        return lstm_b(packed)[0].data

    lib_b = None
    fwd_b, lib_b_note = library_or_none(torch, lib_fwd_b, "")
    if fwd_b is not None:
        grad_b = grad_out.bfloat16()
        fwd_bwd_b, lib_b_note = library_or_none(
            torch, lambda: torch.autograd.grad(lib_fwd_b(), leaves_b, grad_b),
            "torch.nn.LSTM (cuDNN) bidirectional, packed, D=360, bf16, "
            "forward+backward minus forward (eager)")
        if fwd_bwd_b is not None:
            lib_b = fwd_bwd_b - fwd_b
    gy_n = args_b[0].numel()
    fn_b = functools.partial(mod.lstm_scan_backward, *args_b)
    split_b = device_time(torch, lambda: [fn_b() for _ in range(5)])
    lines_b, spills_ok = bf16_scan_ptxas(ptxas, plan)
    row_b = {
        "name": "lstm_scan_backward_bf16", "route": "cuda",
        "source": "gcn_tpu_torch/csrc/lstm_scan_backward.cu",
        "replaces": "gcn_tpu/ops/pallas/lstm_scan.py:262",
        "dtype": "bfloat16",
        "shape": {"T": t, "G": g, "B": B, "H": h, "sum_len": steps},
        "max_abs_err": abs_errs["bf16"], "errs": {"bf16": errs["bf16"]},
        "same_bits_twice": same_b, "tol": {"bf16": TOL_BF16},
        "ok": errs["bf16"] <= TOL_BF16 and same_b and spills_ok is not False,
        "ptxas": lines_b, "sha256": out_sha256(torch, first),
        **kernel_ms(fn_b),
        "split_ms_profiler": None if split_b is None else {
            k: v / 5 for k, v in split_b["top_kernels_ms"].items()
            if "lstm_" in k},
        "plain_ms": graph_ms(functools.partial(mod.lstm_scan_backward_plain,
                                               *args_b), reps=3),
        # gy and dW f32; xp, w_hh, h, c and dxp bf16
        **bf16_bound(4 * gy_n + 2 * 2 * gy_n + 2 * 2 * xp.numel()
                     + 2 * w_hh.numel() + 4 * w_hh.numel() + 4 * B, flops),
        "library_ms": lib_b, "library": lib_b_note, "timing": TIMING_GRAPH,
    }
    return [{
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
    }, row_b]


def backward_yardstick(torch, x, s, g, offs, dtype: str):
    """(library_ms, library_eager_ms, note) of torch._grouped_mm's autograd
    backward on x, s with cotangent g: forward+backward minus forward, both
    by ``graph_ms`` and by ``time_ms``."""
    xr, sr = x.clone().requires_grad_(), s.clone().requires_grad_()
    what = "(offs = cumsum of the group sizes)"
    fwd = grouped_mm_yardstick(
        torch, lambda: torch._grouped_mm(xr, sr, offs=offs), dtype, what)
    both = grouped_mm_yardstick(
        torch, lambda: torch.autograd.grad(
            torch._grouped_mm(xr, sr, offs=offs), [xr, sr], g), dtype, what)
    if fwd[1] is None or both[1] is None:
        return None, None, (fwd if fwd[1] is None else both)[2]
    graph = None if fwd[0] is None or both[0] is None else both[0] - fwd[0]
    return graph, both[1] - fwd[1], (
        f"torch._grouped_mm {dtype} autograd, forward+backward minus "
        f"forward" + ("" if graph is not None else f"; {both[2]}"))


def split_by_launch(torch, fn, tag: str = "grouped_matmul") -> dict | None:
    """ms a call of each kernel whose name holds ``tag`` that ``fn``
    launches, by the profiler over five eager calls (None where it saw no
    device time)."""
    split = device_time(torch, lambda: [fn() for _ in range(5)])
    return None if split is None else {
        k: v / 5 for k, v in split["top_kernels_ms"].items() if tag in k}


def check_gmm_backward(torch, rng, dev, gs, ptxas: dict) -> list[dict]:
    """Kernel 4 at kernel 3's shapes, f32 and bf16 (the same inputs,
    rounded), each with its time by launch (dx, dS, the partials' sum)
    and against torch._grouped_mm's autograd backward in the row's dtype;
    the bf16 row with its TFLOP/s and ``ptxas`` lines (a spill fails it)."""
    from gcn_tpu_torch.ops import grouped_matmul as mod

    r = gs.shape[0]
    m, h = 2 * B * N_BUCKET, 200
    offs = torch.cumsum(gs, 0, dtype=torch.int32)
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
        split_ms = split_by_launch(torch, fn)
        # yardstick only (the port never calls it): torch._grouped_mm's
        # autograd backward, forward+backward minus forward, each timed as
        # the forward rows time theirs
        library_ms, library_eager_ms, library_note = backward_yardstick(
            torch, x, s, g, offs, "f32")
        used = int((gs > 0).sum())
        # x, g and the used groups' S in; dx and every group's dS out (the
        # dS partials are scratch of this design, not of the function, and
        # stand apart in shape)
        n_bytes = 4 * (x.numel() + g.numel() + used * t * h + m * t
                       + r * t * h + r)
        slots = mod.BACKWARD_KERNEL.load().grouped_matmul_backward_partials(m)
        # the bf16 instance (bf16 x, g, s and dx; f32 dS), timed alike
        args_b = (x.bfloat16(), g.bfloat16(), s.bfloat16(), gs)
        first, again = (mod.grouped_matmul_backward(*args_b)
                        for _ in range(2))
        same_b = all(torch.equal(a, b) for a, b in zip(first, again))
        want_b = mod.grouped_matmul_backward_plain(*args_b)
        lib_b, lib_b_eager, lib_b_note = backward_yardstick(
            torch, args_b[0], args_b[2], args_b[1], offs, "bf16")
        fn_b = functools.partial(mod.grouped_matmul_backward, *args_b)
        times_b = kernel_ms(fn_b)
        lines_b = ptxas_of(ptxas, "_bf16_kernel")
        row_b = {
            "name": f"grouped_matmul_backward_bf16_T{t}", "route": "cuda",
            "source": "gcn_tpu_torch/csrc/grouped_matmul_backward.cu",
            "replaces": "gcn_tpu/ops/pallas/grouped_matmul.py:208",
            "dtype": "bfloat16",
            "shape": {"M": m, "T": t, "H": h, "R": r, "groups_used": used},
            "max_abs_err": max(max_err(a, b) for a, b in zip(first, want_b)),
            "errs": {"bf16": errs["bf16"]}, "same_bits_twice": same_b,
            "tol": {"bf16": TOL_BF16},
            "ok": (errs["bf16"] <= TOL_BF16 and same_b
                   and spill_free(lines_b) is not False),
            **times_b, "tflops": 4.0 * m * t * h / (times_b["ms"] * 1e-3)
            / 1e12,
            "ptxas": lines_b,
            "split_ms_profiler": split_by_launch(torch, fn_b),
            "plain_ms": time_ms(
                lambda: mod.grouped_matmul_backward_plain(*args_b), 10),
            # x, g, the used groups' S and dx bf16; every group's dS f32
            **bf16_bound(2 * (x.numel() + g.numel() + used * t * h + m * t)
                         + 4 * (r * t * h + r), 4.0 * m * t * h),
            "library_ms": lib_b, "library_eager_ms": lib_b_eager,
            "library": lib_b_note, "timing": TIMING_GMM,
        }
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
            "library_ms": library_ms, "library_eager_ms": library_eager_ms,
            "library": library_note, "timing": TIMING_GMM,
        })
        out.append(row_b)
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


DTYPE_TAG = {"float32": "", "bfloat16": "_bf16"}  # a bf16 row's name tag


def check_band(torch, rng, dev, edges, ptxas: dict) -> list[dict]:
    """Kernels 5 and 6 at the C-GCN layer's shapes (x [B, 96, 200]), each
    in its f32 and its bf16 instance (the same inputs, rounded), with
    GB/s and the outputs' SHA-256; the bf16 forward (5b, a kernel of its
    own) with its ``ptxas`` lines (a spill fails it) and its blocks in a
    wave."""
    from gcn_tpu_torch.ops import band_aggregate as mod
    from gcn_tpu_torch.ops.adjacency import build_adjacency

    b, n, h = edges[0].shape[0], N_BUCKET, 200
    x32 = [torch.tensor(rng.randn(b, n, h), dtype=torch.float32, device=dev)
           for _ in range(3)]
    # yardstick only (the port never calls it): the dense path's product on
    # a band built beforehand; the build is timed apart
    build_ms = graph_ms(lambda: build_adjacency(*edges, n))
    adj = build_adjacency(*edges, n)
    e_bytes, valid = edge_facts(torch, edges, n)
    rows = []
    for dtype, tol in (("float32", TOL_F32), ("bfloat16", TOL_BF16)):
        tdt = getattr(torch, dtype)
        x_f, x_r, x_s = (x.to(tdt) for x in x32)
        esize = x_f.element_size()
        key = "f32" if dtype == "float32" else "bf16"
        fwd_errs, fwd_abs, fwd_same = {}, 0.0, True
        for relu in (True, False):
            got = mod.band_aggregate_forward(*edges, x_f, x_r, x_s, relu)
            again = mod.band_aggregate_forward(*edges, x_f, x_r, x_s, relu)
            want = mod.band_aggregate_plain(*edges, x_f, x_r, x_s, relu)
            fwd_errs[f"{key} relu={relu}"] = scaled_err(got, want)
            fwd_abs = max(fwd_abs, max_err(got, want))
            fwd_same = fwd_same and bool(torch.equal(got, again))
        got = mod.pair_aggregate(*edges, x_f)
        again = mod.pair_aggregate(*edges, x_f)
        want = mod.pair_aggregate_plain(*edges, x_f)
        pair_err = max(scaled_err(a, w) for a, w in zip(got, want))
        pair_abs = max(max_err(a, w) for a, w in zip(got, want))
        pair_same = all(bool(torch.equal(a, a2)) for a, a2 in zip(got, again))
        torch.cuda.synchronize()
        band_fr = torch.cat([adj.forward, adj.reverse], dim=2).to(tdt)
        x_fr = torch.cat([x_f, x_r], dim=1)                      # [B, 2N, H]
        band_tf = torch.cat([adj.reverse, adj.forward], dim=1).to(tdt)
        tag = DTYPE_TAG[dtype]
        for name, line, fn, plain, lib, lib_note, err, abs_err, same, \
                n_bytes, flops in (
            ("band_aggregate_forward", 88,
             lambda: mod.band_aggregate_forward(*edges, x_f, x_r, x_s),
             lambda: mod.band_aggregate_plain(*edges, x_f, x_r, x_s),
             lambda: torch.bmm(band_fr, x_fr),
             f"torch.bmm of the prebuilt [A_f | A_f^T] band [B, N, 2N] with "
             f"[x_f; x_r], {dtype} (no x_s, denom or ReLU)",
             max(fwd_errs.values()), fwd_abs, fwd_same,
             4 * esize * x_f.numel() + e_bytes,
             2.0 * valid * h + 3.0 * x_f.numel()),
            ("band_aggregate_pair", 149,
             lambda: mod.pair_aggregate(*edges, x_f),
             lambda: mod.pair_aggregate_plain(*edges, x_f),
             lambda: torch.bmm(band_tf, x_f),
             f"torch.bmm of the prebuilt [A_f^T; A_f] band [B, 2N, N] with "
             f"x, {dtype}",
             pair_err, pair_abs, pair_same, 3 * esize * x_f.numel() + e_bytes,
             2.0 * valid * h),
        ):
            # sums of neighbour rows in f32 on the CUDA cores, either type
            bound_ms, bound_by = bound(n_bytes, flops)
            times = kernel_ms(fn)
            extra, spill_ok = {}, True
            if name + tag == "band_aggregate_forward_bf16":
                extra = {"ptxas": ptxas_of(ptxas,
                                           "band_aggregate_fwd_bf16_kernel"),
                         **wave_facts(torch, mod.forward_blocks(
                             *edges, x_f, x_r, x_s))}
                spill_ok = spill_free(extra["ptxas"]) is not False
            rows.append({
                "name": name + tag, "route": "cuda",
                "source": "gcn_tpu_torch/csrc/band_aggregate.cu",
                "replaces": f"gcn_tpu/ops/pallas/band_aggregate.py:{line}",
                "dtype": dtype,
                "shape": {"B": b, "N": n, "E": edges[0].shape[1], "H": h,
                          "valid_edges": valid},
                "max_abs_err": abs_err,
                "errs": fwd_errs if name.endswith("forward") else {key: err},
                "same_bits_twice": same,
                "tol": {key: tol}, "ok": err <= tol and same and spill_ok,
                **times, **extra, "plain_ms": graph_ms(plain),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "gb_per_s": n_bytes / (times["ms"] * 1e-3) / 1e9,
                "library_ms": graph_ms(lib), "library": lib_note,
                "library_band_build_ms": build_ms,
                "out_sha256": out_sha256(torch, fn()), "timing": TIMING_GRAPH,
            })
    return rows


def check_spmm(torch, rng, dev, edges, ptxas: dict) -> list[dict]:
    """Kernels 7 and 8 at the paper GCN's two layers' shapes (h [B, 96, T]
    with T = 360 and 200, W [T, 200]), each in its f32 and its bf16
    instance (the same inputs, rounded), with GB/s and the outputs'
    SHA-256; the bf16 forward with its TFLOP/s and ``ptxas`` lines, the
    bf16 sym pair (8b) with its ``ptxas`` lines and blocks in a wave (a
    spill fails either)."""
    from gcn_tpu_torch.ops import spmm_fused as mod
    from gcn_tpu_torch.ops.adjacency import build_adjacency

    b, n, hd = edges[0].shape[0], N_BUCKET, 200
    build_ms = graph_ms(lambda: build_adjacency(*edges, n))
    adj = build_adjacency(*edges, n)
    s_full = adj.combined + torch.eye(n, device=dev)  # A_f + A_f^T + diag
    e_bytes, valid = edge_facts(torch, edges, n)
    rows = []
    for t in (360, 200):
        h32 = torch.tensor(rng.randn(b, n, t), dtype=torch.float32,
                           device=dev)
        g32 = torch.tensor(rng.randn(b, n, t), dtype=torch.float32,
                           device=dev)
        w32 = torch.tensor(rng.uniform(-1, 1, (t, hd)) / np.sqrt(t),
                           dtype=torch.float32, device=dev)
        bias32 = torch.tensor(rng.uniform(-0.1, 0.1, hd), dtype=torch.float32,
                              device=dev)
        for dtype, tol in (("float32", TOL_F32), ("bfloat16", TOL_BF16)):
            tdt = getattr(torch, dtype)
            h, g, w, bias = (a.to(tdt) for a in (h32, g32, w32, bias32))
            esize = h.element_size()
            key = "f32" if dtype == "float32" else "bf16"
            got = mod.gcn_spmm_forward(*edges, h, w, bias)
            want = mod.gcn_spmm_plain(*edges, h, w, bias)
            fwd_err, fwd_abs = scaled_err(got, want), max_err(got, want)
            fwd_same = bool(torch.equal(
                got, mod.gcn_spmm_forward(*edges, h, w, bias)))
            got = mod.sym_pair(*edges, g, h)
            want = mod.sym_pair_plain(*edges, g, h)
            pair_err = max(scaled_err(a, w_) for a, w_ in zip(got, want))
            pair_abs = max(max_err(a, w_) for a, w_ in zip(got, want))
            pair_same = all(bool(torch.equal(a, a2)) for a, a2 in zip(
                got, mod.sym_pair(*edges, g, h)))
            torch.cuda.synchronize()
            s_t = s_full.to(tdt)
            gh = torch.cat([g, h], dim=2)
            gather = 2.0 * valid * t + 2.0 * b * n * t   # S·x of one operand
            tag = DTYPE_TAG[dtype]
            for name, line, fn, plain, lib, lib_note, err, abs_err, same, \
                    n_bytes, flops in (
                (f"spmm_fused_forward{tag}_T{t}", 88,
                 lambda: mod.gcn_spmm_forward(*edges, h, w, bias),
                 lambda: mod.gcn_spmm_plain(*edges, h, w, bias),
                 lambda: torch.bmm(s_t, h) @ w,
                 "torch.bmm of the prebuilt S = A_f + A_f^T + "
                 f"diag(incident+1) band with h, then @ W, {dtype} (two "
                 "calls; no 2b, denom or ReLU)",
                 fwd_err, fwd_abs, fwd_same,
                 esize * (h.numel() + w.numel() + hd + b * n * hd) + e_bytes,
                 2.0 * b * n * t * hd + gather + 3.0 * b * n * hd),
                (f"spmm_fused_sym_pair{tag}_T{t}", 174,
                 lambda: mod.sym_pair(*edges, g, h),
                 lambda: mod.sym_pair_plain(*edges, g, h),
                 lambda: torch.bmm(s_t, gh),
                 f"torch.bmm of the prebuilt S band with [x1 | x2] "
                 f"[B, N, 2T], {dtype}",
                 pair_err, pair_abs, pair_same,
                 4 * esize * h.numel() + e_bytes, 2 * gather),
            ):
                if "forward" not in name:  # a gather alone
                    bounds = dict(zip(("bound_ms", "bound_by"),
                                      bound(n_bytes, flops)))
                elif dtype == "float32":  # the W product runs 3xTF32
                    bounds = tf32x3_bound(n_bytes, flops)
                else:  # the W product of bf16 values
                    bounds = bf16_bound(n_bytes, flops)
                times = kernel_ms(fn)
                extra, spill_ok = {}, True
                if "forward_bf16" in name:  # the bf16 kernel of its own
                    extra = {"tflops": 2.0 * b * n * t * hd
                             / (times["ms"] * 1e-3) / 1e12,
                             "ptxas": ptxas_of(ptxas,
                                               "spmm_fused_fwd_bf16_kernel")}
                    spill_ok = spill_free(extra["ptxas"]) is not False
                elif "sym_pair_bf16" in name:  # 8b, a kernel of its own
                    extra = {"ptxas": ptxas_of(ptxas,
                                               "spmm_sym_pair_bf16_kernel"),
                             **wave_facts(torch, mod.sym_pair_blocks(
                                 *edges, g, h))}
                    spill_ok = spill_free(extra["ptxas"]) is not False
                rows.append({
                    "name": name, "route": "cuda",
                    "source": "gcn_tpu_torch/csrc/spmm_fused.cu",
                    "replaces": f"gcn_tpu/ops/pallas/spmm_fused.py:{line}",
                    "dtype": dtype,
                    "shape": {"B": b, "N": n, "E": edges[0].shape[1],
                              "T": t, "H": hd, "valid_edges": valid},
                    "max_abs_err": abs_err, "errs": {key: err},
                    "same_bits_twice": same,
                    "tol": {key: tol}, "ok": err <= tol and same and spill_ok,
                    **times, **extra, "plain_ms": graph_ms(plain), **bounds,
                    "gb_per_s": n_bytes / (times["ms"] * 1e-3) / 1e9,
                    "library_ms": graph_ms(lib), "library": lib_note,
                    "library_band_build_ms": build_ms,
                    "out_sha256": out_sha256(torch, fn()),
                    "timing": TIMING_GRAPH,
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


def check_sddmm(torch, rng, dev, edges, ptxas: dict) -> list[dict]:
    """Kernels 9 and 10 at the attention layer's shapes (q, k [B, 96, 200],
    the synthetic batch's edges) and on a forest at N = E = 1200, each in
    its f32 and its bf16 instance (the same inputs, rounded; the scores
    and g f32 in both); the bf16 backward (10b, one kernel of its own)
    with its ``ptxas`` lines (a spill fails it) and, as the f32 one, its
    ms by launch."""
    from gcn_tpu_torch.ops import sddmm as mod

    h = 200
    rows = []
    for tag, case in (("N96", edges),
                      ("N1200", forest_edges(torch, rng, dev, 1200))):
        b, e = case[0].shape
        n = N_BUCKET if tag == "N96" else 1200
        u32, v32 = (torch.tensor(rng.randn(b, n, h) / np.sqrt(h),
                                 dtype=torch.float32, device=dev)
                    for _ in range(2))
        g = torch.tensor(rng.randn(b, e), dtype=torch.float32, device=dev)
        # the backward's list build alone against a stable sort
        lists_ok = bool(torch.equal(mod.edge_lists(*case, n),
                                    mod.edge_lists_plain(*case, n)))
        e_bytes, valid = edge_facts(torch, case, n)
        rows_p, rows_c = touched_rows(torch, case, n)
        for dtype, tol_fwd, tol_bwd in (("float32", TOL_F32, TOL_BWD),
                                        ("bfloat16", TOL_F32, TOL_BF16)):
            tdt = getattr(torch, dtype)
            u, v = u32.to(tdt), v32.to(tdt)
            esize = u.element_size()
            key = "f32" if dtype == "float32" else "bf16"
            got = mod.sddmm_forward(*case, u, v)
            again = mod.sddmm_forward(*case, u, v)
            want = mod.sddmm_plain(*case, u, v)
            fwd_err, fwd_abs = scaled_err(got, want), max_err(got, want)
            got_b = mod.sddmm_backward(*case, g, u, v)
            again_b = mod.sddmm_backward(*case, g, u, v)
            want_b = mod.sddmm_backward_plain(*case, g, u, v)
            bwd_err = max(scaled_err(a, w) for a, w in zip(got_b, want_b))
            bwd_abs = max(max_err(a, w) for a, w in zip(got_b, want_b))
            torch.cuda.synchronize()
            same = {"forward": bool(torch.equal(got, again)),
                    "backward": all(torch.equal(a, w)
                                    for a, w in zip(got_b, again_b))}
            gathered = esize * h * (rows_p + rows_c)
            # yardsticks only (the port never calls them): cuSPARSE's SDDMM
            # and two sparse-dense products on block-diagonal CSR patterns
            # of the counted edges, in the row's dtype, built beforehand and
            # not timed, as the band rows' prebuilt bands; each is held
            # against the plain version
            u2, v2 = u.reshape(b * n, h), v.reshape(b * n, h)
            pattern, pick = edge_csr(torch, case, n,
                                     torch.zeros_like(g).to(tdt))
            a_g, _ = edge_csr(torch, case, n, g.to(tdt))
            a_gt, _ = edge_csr(torch, case, n, g.to(tdt), transpose=True)

            def lib_fwd():
                return torch.sparse.sampled_addmm(pattern, u2, v2.t())

            def lib_bwd():
                return a_g @ v2, a_gt @ u2

            lib_notes = (
                "torch.sparse.sampled_addmm of the prebuilt CSR edge "
                f"pattern [B·N, B·N] with u and v^T, {dtype} (counted edges "
                "only, in CSR order)",
                "two calls, one an output: the prebuilt CSR pattern with "
                f"values g @ v, and its prebuilt transpose @ u, {dtype}")
            lib_ms, lib_errs = [], []
            for fn, note, check in (
                    (lib_fwd, lib_notes[0],
                     lambda: scaled_err(lib_fwd().values(), pick(want))),
                    (lib_bwd, lib_notes[1],
                     lambda: max(scaled_err(a.reshape(b, n, h), w)
                                 for a, w in zip(lib_bwd(), want_b)))):
                ms, note = library_or_none(torch, fn, note, graph_ms)
                lib_ms.append((ms, note))
                lib_errs.append(check() if ms is not None else None)
            tag_d = DTYPE_TAG[dtype]
            for k, (name, line, fn, plain, err, abs_err, tol, n_bytes,
                    flops) in enumerate((
                (f"sddmm_forward{tag_d}_{tag}", 64,
                 lambda: mod.sddmm_forward(*case, u, v),
                 lambda: mod.sddmm_plain(*case, u, v), fwd_err, fwd_abs,
                 tol_fwd, e_bytes + gathered + 4 * b * e, 2.0 * valid * h),
                (f"sddmm_backward{tag_d}_{tag}", 132,
                 lambda: mod.sddmm_backward(*case, g, u, v),
                 lambda: mod.sddmm_backward_plain(*case, g, u, v), bwd_err,
                 bwd_abs, tol_bwd,
                 e_bytes + 4 * b * e + gathered + 2 * esize * b * n * h,
                 4.0 * valid * h),
            )):
                # products and sums in f32 on the CUDA cores, either type
                bound_ms, bound_by = bound(n_bytes, flops)
                kind = name.split("_")[1]
                lib_err = lib_errs[k]
                # the library's bf16 sums round at other points: its error
                # is printed, and gated in f32 only
                lib_ok = (lib_err is None or dtype != "float32"
                          or lib_err <= tol)
                extra, spill_ok = {}, True
                if kind == "backward":
                    extra["split_ms_profiler"] = split_by_launch(torch, fn,
                                                                 "sddmm")
                    if dtype == "bfloat16":
                        extra["ptxas"] = ptxas_of(ptxas,
                                                  "sddmm_bwd_bf16_kernel")
                        spill_ok = spill_free(extra["ptxas"]) is not False
                rows.append({
                    "name": name, "route": "cuda",
                    "source": "gcn_tpu_torch/csrc/sddmm.cu",
                    "replaces": f"gcn_tpu/ops/pallas/sddmm.py:{line}",
                    "dtype": dtype,
                    "shape": {"B": b, "N": n, "E": e, "H": h,
                              "valid_edges": valid, "parent_rows": rows_p,
                              "child_rows": rows_c},
                    "max_abs_err": abs_err, "errs": {key: err},
                    "same_bits_twice": same[kind],
                    "library_err": lib_err,
                    "tol": {key: tol},
                    **({"lists_equal_plain": lists_ok}
                       if kind == "backward" else {}),
                    "ok": (err <= tol and same[kind] and lib_ok and spill_ok
                           and (lists_ok or kind != "backward")),
                    **kernel_ms(fn), **extra, "plain_ms": graph_ms(plain),
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": lib_ms[k][0], "library": lib_ms[k][1],
                    "timing": TIMING_GRAPH,
                })
    return rows


def check_bilinear(torch, rng, dev, ptxas: dict) -> tuple[list[dict], dict]:
    """Kernels 11 and 12 at the non-factored C-GCN layer's shapes (M =
    B·N = 4800 tokens, D = 50, H = 200, T = 400 and 200), each in its f32
    and its bf16 instance (the same inputs, rounded), with the achieved
    TFLOP/s and the instance's ``ptxas`` lines (``ptxas``: the build's, by
    mangled kernel name); returns the rows and the launches of v1 in this
    phase (its only caller here) by dtype."""
    from gcn_tpu_torch.ops import deprel_bilinear as mod

    m, d, h = B * N_BUCKET, 50, 200
    rows, v1_launches = [], {"float32": 0, "bfloat16": 0}
    for t in (400, 200):
        x32 = torch.tensor(rng.randn(m, t), dtype=torch.float32, device=dev)
        e32 = torch.tensor(rng.randn(m, d), dtype=torch.float32, device=dev)
        w32 = torch.tensor(rng.uniform(-1, 1, (d, t, h)) / np.sqrt(t),
                           dtype=torch.float32, device=dev)
        for dtype, tol in (("float32", TOL_F32), ("bfloat16", TOL_BF16)):
            tdt = getattr(torch, dtype)
            x, e, w = x32.to(tdt), e32.to(tdt), w32.to(tdt)
            esize = x.element_size()
            key = "f32" if dtype == "float32" else "bf16"
            # yardsticks only (the port never calls them): the einsum, which
            # may form [M, D, T] (384 MB at T = 400 in f32), and one GEMM of
            # the same product on its operand z = e ⊗ x [M, D·T], built
            # beforehand and not timed, as the band rows prebuild their
            # bands; both in the row's dtype
            library_ms = graph_ms(
                lambda: torch.einsum("md,mt,dth->mh", e, x, w))
            z = (e[:, :, None] * x[:, None, :]).reshape(m, d * t)
            w2 = w.reshape(d * t, h)
            library_sgemm_ms = graph_ms(lambda: torch.mm(z, w2))
            del z
            n_bytes = esize * (x.numel() + e.numel() + w.numel() + m * h)
            flops = 2.0 * m * d * t * h
            for version, line in (("v2", 143), ("v1", 57)):
                plain = getattr(mod, f"bilinear_{version}_plain")
                (got, again), counts = counted(lambda: [
                    mod.bilinear_forward(x, e, w, version)
                    for _ in range(2)], dtype)
                v1_launches[dtype] += counts["deprel_bilinear_v1"]
                want = plain(x, e, w)
                err, abs_err = scaled_err(got, want), max_err(got, want)
                same = bool(torch.equal(got, again))
                # 3xTF32 in f32 (the mainloop); in bf16 one wgmma kernel for
                # both versions, against the bf16 tensor cores' peak
                bounds = (tf32x3_bound(n_bytes, flops) if dtype == "float32"
                          else bf16_bound(n_bytes, flops))
                fn = functools.partial(mod.bilinear_forward, x, e, w,
                                       version)
                ms = kernel_ms(fn)
                # the instance's kernel: the template's for this version in
                # f32, the one bf16 kernel in bf16
                tag = (f"deprel_bilinear_kernelILb{int(version == 'v1')}"
                       if dtype == "float32" else
                       "deprel_bilinear_bf16_kernel")
                rows.append({
                    "name": f"deprel_bilinear_{version}"
                            f"{DTYPE_TAG[dtype]}_T{t}",
                    "route": "cuda",
                    "source": "gcn_tpu_torch/csrc/deprel_bilinear.cu",
                    "replaces": "gcn_tpu/ops/pallas/deprel_bilinear.py:"
                                f"{line}",
                    "dtype": dtype,
                    "shape": {"M": m, "T": t, "D": d, "H": h},
                    "max_abs_err": abs_err, "errs": {key: err},
                    "same_bits_twice": same, "tol": {key: tol},
                    "ok": err <= tol and same,
                    **ms, "tflops": flops / (ms["ms"] * 1e-3) / 1e12,
                    "ptxas": ptxas_of(ptxas, tag),
                    **({"registers_note": "ptxas counts a thread's "
                        "registers at launch (384 threads); setmaxnreg "
                        "gives the two consumer warpgroups 232 and the "
                        "producer 40"}
                       if dtype == "bfloat16" else {}),
                    "plain_ms": graph_ms(functools.partial(plain, x, e, w)),
                    **bounds, "library_ms": library_ms,
                    "library": f'torch.einsum("md,mt,dth->mh", e, x, w), '
                               f"{dtype}",
                    "library_sgemm_ms": library_sgemm_ms,
                    "library_sgemm": "torch.mm of the prebuilt z = e ⊗ x "
                                     f"[M, D·T] with W [D·T, H], {dtype}",
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
    # compute_dtype="bfloat16": kernels 1-4, 5-6 and 7-8 in their bf16
    # instances
    "cgcn_bf16": ("cgcn_preset", {"model.compute_dtype": "bfloat16"}),
    "cgcn_fused_bf16": ("cgcn_preset", {"model.use_pallas": True,
                                        "model.compute_dtype": "bfloat16"}),
    "gcn_fused_bf16": ("gcn_preset", {"model.use_pallas": True,
                                      "model.compute_dtype": "bfloat16"}),
    # and kernels 9-10, 11 in theirs
    "cgcn_attn_bf16": ("cgcn_preset", {"model.adj_type": "attention",
                                       "model.attention_impl": "edge",
                                       "model.compute_dtype": "bfloat16"}),
    "cgcn_bilinear_bf16": ("cgcn_preset", {
        "model.deprel_factored": False, "model.use_pallas": True,
        "model.compute_dtype": "bfloat16"}),
    # cross-sentence packing: up to 10 sentences a row of the default
    # pack_len (the largest bucket, 128), B = 50 rows, on the seed-11 data
    "cgcn_packed": ("cgcn_preset", {"data.pack_sentences": 10}),
}
# each bf16 path's f32 twin: the same configuration and weights in f32
F32_TWIN = {"cgcn_bf16": "cgcn", "cgcn_fused_bf16": "cgcn_fused",
            "gcn_fused_bf16": "gcn_fused", "cgcn_attn_bf16": "cgcn_attn",
            "cgcn_bilinear_bf16": "cgcn_bilinear"}
# the inputs each path reads (``load_batches``): the in-repo TACRED and
# synthetic N=96 sentences by word ids, the same sentences as seeded
# [L, 1024] float rows, or the in-repo SemEval and synthetic SemEval
# sentences; ``load_packed``: the seed-11 sentences packed
INPUTS = {"cgcn_bert": "bert", "cgcn_semeval": "semeval",
          "cgcn_packed": "packed"}
# a packed path and the unpacked path its sentences are held to, each
# sentence's logits on the same weights
UNPACKED = {"cgcn_packed": "cgcn"}
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
    "cgcn_packed": (_CGCN, {**_CGCN, **_CGCN_BWD}),
}
# a bf16 path launches its twin's kernels, each in its bf16 instance only
EXPECTED.update({p: EXPECTED[twin] for p, twin in F32_TWIN.items()})
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
    # the same in bf16 (the path's own compute dtype) where the card runs
    # the plain versions (kernels 1-4); None: the plain versions of the
    # edge-list kernels in bf16 run on the CPU only (the card's dense bands
    # round each band's product, at other points: they are held apart,
    # ``run_slice``), so the path is held against the CPU, every batch
    "cgcn_bf16": _PLAIN, "cgcn_fused_bf16": None, "gcn_fused_bf16": None,
    "cgcn_attn_bf16": None, "cgcn_bilinear_bf16": None,
    "cgcn_packed": _PLAIN,
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


def path_dtype(path: str) -> str:
    """The compute dtype of a path ("float32" or "bfloat16")."""
    return path_config(path).model.compute_dtype


# a bf16 path's tolerances in place of the f32 ones: logits and h_out per
# row against the plain versions (which round at other points: the dense
# bands round each band's product) and against the CPU; the trainers'
TOL_PATH = {"float32": (TOL_SLICE, TOL_TRAIN), "bfloat16": (TOL_BF16,
                                                            TOL_BF16)}


def eager_dispatch():
    """The port's ``eager_dispatch()``: the card runs its steps and
    forwards eagerly inside it."""
    from gcn_tpu_torch.train.dispatch import eager_dispatch as eager

    return eager()


def counted(fn, dtype: str = "float32"):
    """Run ``fn`` with every kernel's counts set to 0 just before; returns
    (its result, each kernel's launches of its ``dtype`` instance just
    after).  A launch of a kernel's other instance (bf16 on an f32 path,
    f32 on a bf16 one) fails the run."""
    import torch

    kernels = kernel_table()
    for k in kernels.values():
        k.reset()
    torch.cuda.synchronize()
    out = fn()
    torch.cuda.synchronize()
    counts = {}
    for name, k in kernels.items():
        bf16 = k.launches_of("_bf16")
        mine, other = ((bf16, k.launches - bf16) if dtype == "bfloat16"
                       else (k.launches - bf16, bf16))
        if other:
            fail(f"kernel {name} launched {other} times outside its "
                 f"{dtype} instance: {k.by_function}")
        counts[name] = mine
    return out, counts


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
    dtype = cfg.model.compute_dtype
    tol = TOL_PATH[dtype][0]
    model = GCNClassifier(cfg.model)
    init_params(model, torch.Generator().manual_seed(SEED))
    state = model.state_dict()
    ev = Evaluator(cfg, state, device=dev)
    # on the CPU every kernel's wrapper runs its plain version
    ev_cpu = Evaluator(cfg, state, device="cpu")
    ev_plain = ev_cpu if PLAIN[path] is None else Evaluator(
        path_config(path, **base, **PLAIN[path]), state, device=dev)
    fused = cfg.model.use_pallas is True
    if fused:  # the same weights on the dense bands (use_pallas=False)
        ev_dense = Evaluator(path_config(path, **base,
                                         **{"model.use_pallas": False}),
                             state, device=dev)
    cross = CROSS.get(path)
    if cross:  # the same weights on another path
        ev_cross = Evaluator(path_config(cross, **base), state, device=dev)
    twin = F32_TWIN.get(path)
    if twin:  # the same weights in f32: the gap bf16 costs, printed
        ev_twin = Evaluator(path_config(twin, **base), state, device=dev)

    # the main path, counted
    t0 = time.perf_counter()
    (preds, probs, loss), launches = counted(
        lambda: ev.evaluate(real + synth), dtype)
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
    gap = {"row_err": 0.0, "logits_row_err": 0.0, "logits_max_abs_err": 0.0,
           "largest_logit": 0.0, "predictions_differ": 0, "rows": 0}
    with torch.no_grad():
        for i, b in enumerate(real + synth):
            lk, hk = ev.model(batch_to_device(b, dev))
            lp, hp = (t.to(dev) for t in ev_plain.model(
                batch_to_device(b, ev_plain.device)))
            rows_b = len(b["example_mask"])  # B·S for a packed batch
            if lk.shape != (rows_b, cfg.model.num_class) or not bool(
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
            if twin:
                lt, ht = ev_twin.model(batch_to_device(b, dev))
                gap["row_err"] = max(gap["row_err"],
                                     row_err(lk[valid], lt[valid]),
                                     row_err(hk[valid], ht[valid]))
                gap["logits_row_err"] = max(gap["logits_row_err"],
                                            row_err(lk[valid], lt[valid]))
                gap["logits_max_abs_err"] = max(gap["logits_max_abs_err"],
                                                max_err(lk[valid], lt[valid]))
                gap["largest_logit"] = max(gap["largest_logit"],
                                           float(lt[valid].abs().max()))
                gap["predictions_differ"] += int(
                    (lk[valid].argmax(1) != lt[valid].argmax(1)).sum())
                gap["rows"] += int(valid.sum())
            if i == 0:
                lc, _ = ev_cpu.model(batch_to_device(b, "cpu"))
                err_cpu = row_err(lk[valid].cpu(), lc[valid.cpu()])
    # in bf16 the dense bands round at other points than the edge-list
    # kernels (each band's product): held within twice the gap that bf16
    # itself costs against f32 on these rows (logits and h_out), as the
    # CPU tests hold the port to gcn_tpu
    tol_dense = tol if dtype == "float32" else 2 * gap["row_err"]
    if (max(err, err_cpu, err_cross) > tol or err_dense > tol_dense):
        fail(f"{path}: slice logits differ: card plain {err}, cpu "
             f"{err_cpu}, dense bands {err_dense} (tolerance {tol_dense}), "
             f"{cross} {err_cross}; tolerance {tol}")

    gold = [l for b in real + synth for l in
            (b["labels"][b["example_mask"]]).tolist()]
    with open(os.devnull, "w") as sink:
        _, _, f1 = score([str(g) for g in gold], [str(p) for p in preds],
                         negative_label="0", out=sink)

    def rate(batches, evaluator=ev, reps=3):
        n = sum(int(b["example_mask"].sum()) for b in batches)
        best = float("inf")
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            evaluator.evaluate(batches)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t)
        return n / best

    def eager_rate(batches):
        with eager_dispatch():
            return rate(batches)

    unpacked = None
    if path in UNPACKED:  # each packed sentence against its own row
        ev_unp = Evaluator(path_config(UNPACKED[path], **base), state,
                           device=dev)
        unp_batches = PACKED["dev_unpacked"]
        rows_of = {}
        with torch.no_grad():
            for bi, b in enumerate(unp_batches):
                lu, hu = ev_unp.model(batch_to_device(b, dev))
                for r in range(int(b["example_mask"].sum())):
                    rows_of[bi * B + r] = (lu[r], hu[r])
            packed_err, checked = 0.0, 0
            slots = PACKED["dev"].max_slots
            for ci, b in enumerate(real):
                lk, hk = ev.model(batch_to_device(b, dev))
                for r, row in enumerate(PACKED["dev"].chunks[ci]):
                    for si, i in enumerate(row):
                        lu, hu = rows_of[i]
                        at = r * slots + si
                        packed_err = max(packed_err,
                                         row_err(lk[at:at + 1], lu[None]),
                                         row_err(hk[at:at + 1], hu[None]))
                        checked += 1
        if checked != len(rows_of) or packed_err > tol:
            fail(f"{path}: {checked} packed sentences of {len(rows_of)}, "
                 f"{packed_err} from their unpacked rows; tolerance {tol}")
        unpacked = {"path": UNPACKED[path], "sentences": checked,
                    "row_err": packed_err, "tol": tol,
                    "batches": len(unp_batches),
                    "sentences_per_s": rate(unp_batches, ev_unp)}
    return {
        "phase": "slice", "path": path, "dtype": dtype, "sentences": n_sent,
        "batches": {"real": len(real), "synthetic_n96": len(synth)},
        "launches": launches, "launches_per_forward": per_forward,
        "first_pass_s": first_s,
        "row_err_plain_card": err, "row_err_plain_cpu": err_cpu,
        "row_err_dense_bands": err_dense if fused else None,
        "tol_dense_bands": tol_dense if fused else None,
        "plain_on": str(ev_plain.device),
        "row_err_cross": {cross: err_cross} if cross else None,
        "bf16_gap_to_f32": {twin: gap} if twin else None,
        "tol": tol, "loss": loss, "f1_random_weights": f1,
        "unpacked_twin": unpacked,
        "sentences_per_s_real": rate(real),
        "sentences_per_s_n96": rate(synth) if synth else None,
        "sentences_per_s_real_eager": eager_rate(real),
        "sentences_per_s_n96_eager": eager_rate(synth) if synth else None,
    }


# ----------------------------------------------------------------- train
KERNEL_GROUPS = (  # device time by category, matched on kernel names
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


def epoch_walls(torch, epoch, reps: int = 3) -> list[float]:
    """Host seconds of ``reps`` calls of ``epoch``, each ending in a
    synchronisation of the card."""
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        epoch()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    return walls


def same_bits(torch, got: list, want: list, a, b) -> dict:
    """Losses and every parameter of trainers ``a`` and ``b``: equal in
    bits, and the largest difference over each tensor's max |value|."""
    sa, sb = a.model.state_dict(), b.model.state_dict()
    equal = [float(x) for x in got] == [float(x) for x in want] and all(
        torch.equal(sa[k], sb[k]) for k in sb)
    err = max(float((sa[k] - sb[k]).abs().max())
              / max(float(sb[k].abs().max()), 1e-30) for k in sb)
    loss_err = max(abs(float(x) - float(y)) / max(abs(float(y)), 1e-30)
                   for x, y in zip(got, want))
    return {"same_bits": equal, "max_err": max(err, loss_err)}


# The paths whose eager steps differ from run to run, so that graphs
# cannot equal them in bits: the attention edge backend sums with
# ``scatter_add``, which adds with float atomics on the card
# (``ops/spmm.py`` ``scatter_rows``, ``ops/sddmm.py`` ``edge_softmax``).
# Their graphs are held within (tolerance, spread) of each tensor's max
# |value|: the larger of the tolerance and ``spread`` times the distance
# between two eager runs of the same steps.  In f32 the atomics move a sum
# by an f32 rounding (1e-6, spread 0: fixed); in bf16 by a bf16 rounding
# of a message sum, which three sgd steps carry into the parameters as
# far as the eager runs' own spread (my chip runs 2-3 of PR 18: eager
# 1.05e-2 and 1.15e-2 from eager), so there graphs may lie twice as far.
# Every other path in bits.
NONDETERMINISTIC = {"cgcn_attn": (1e-6, 0.0),
                    "cgcn_attn_bf16": (TOL_BF16, 2.0)}


def graphs_against_eager(torch, cfg, state, dev, batches, path) -> dict:
    """Steps through graphs against the same steps run eagerly on the card
    (``eager_dispatch``), from one state: losses and parameters must be
    equal in bits, or on a path of ``NONDETERMINISTIC`` within its
    tolerance (or its multiple of the eager runs' own distance).  Two
    eager runs are compared too, and the reading printed."""
    from gcn_tpu_torch.train.trainer import Trainer

    g, e, e2 = (Trainer(cfg, state, device=dev) for _ in range(3))
    got = [g.update(b) for b in batches]
    with eager_dispatch():
        want = [e.update(b) for b in batches]
        again = [e2.update(b) for b in batches]
    out = {"steps": len(batches), **same_bits(torch, got, want, g, e),
           "eager_against_eager": same_bits(torch, again, want, e2, e)}
    out["held_in"] = ("tolerance" if path in NONDETERMINISTIC else "bits")
    if path in NONDETERMINISTIC:
        tol, spread = NONDETERMINISTIC[path]
        out["tol"] = max(tol, spread * out["eager_against_eager"]["max_err"])
    if not (out["max_err"] <= out["tol"]
            if path in NONDETERMINISTIC else out["same_bits"]):
        fail(f"{path}: {len(batches)} steps through graphs differ from the "
             f"eager steps: {out}")
    return out


def run_train(torch, dev, real_train, synth_train, vocab_size,
              path: str) -> dict:
    from gcn_tpu_torch.models.gcn import GCNClassifier, init_params
    from gcn_tpu_torch.train.trainer import Trainer

    base = {"model.vocab_size": vocab_size, "train.batch_size": B,
            "train.effective_batch_size": B}
    cfg = path_config(path, **base)
    dtype = cfg.model.compute_dtype
    tol = TOL_PATH[dtype][1]
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

    # the main path, counted: a graph captured per batch shape, then
    # replayed (the launches of the capture's eager warm-up count apart)
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    losses, launches = counted(lambda: [tr.update(b) for b in batches],
                               dtype)
    first_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    graph_mib = (torch.cuda.memory_reserved() - reserved) / 2**20
    per_step = check_launches(path, "train step", launches,
                              EXPECTED[path][1], len(batches))
    losses = [float(l) for l in losses]
    if not all(np.isfinite(losses)):
        fail(f"{path}: non-finite training loss: {losses}")
    dispatch = graphs_against_eager(torch, cfg, state, dev, batches[:3],
                                    path)

    # kernels against the plain versions on the card: same weights, seed
    # and batches, so the same dropout masks (the references run eagerly;
    # the plain grouped matmul would anyway: a graph cannot hold it); where
    # the plain versions run on the CPU only (PLAIN None), against the CPU
    # with dropout off (the card's and the CPU's generators differ)
    if PLAIN[path] is None:
        a = Trainer(nodrop_cfg, state, device=dev)
        p = Trainer(nodrop_cfg, state, device="cpu")
    else:
        a = Trainer(cfg, state, device=dev)
        p = Trainer(path_config(path, **base, **PLAIN[path]), state,
                    device=dev)
    loss_err = 0.0
    for b in batches[:3]:
        la = float(a.update(b))
        with eager_dispatch():
            lp = float(p.update(b))
        loss_err = max(loss_err, abs(la - lp) / abs(lp))
    param_err = params_err(a, p)
    # dropout off: one step on the card against one on the CPU
    c = Trainer(nodrop_cfg, state, device=dev)
    cpu = Trainer(nodrop_cfg, state, device="cpu")
    lc, lcpu = float(c.update(real_train[0])), float(cpu.update(real_train[0]))
    cpu_loss_err = abs(lc - lcpu) / abs(lcpu)
    cpu_param_err = params_err(c, cpu)
    if max(loss_err, param_err, cpu_loss_err, cpu_param_err) > tol:
        fail(f"{path}: trainers disagree: plain on the card loss {loss_err} "
             f"params {param_err}; cpu loss {cpu_loss_err} params "
             f"{cpu_param_err}; tolerance {tol}")

    # the loss falls on one fixed batch
    f = Trainer(cfg, state, device=dev)
    fall = [float(f.update(real_train[0])) for _ in range(TRAIN_STEPS_FALL)]
    if not np.mean(fall[-5:]) < np.mean(fall[:5]):
        fail(f"{path}: the loss did not fall on a fixed batch: {fall}")

    # speed at N=96 (the packed path: its own train batches): host wall
    # time per step, the device's timeline span (CUDA events around the
    # epoch) and its busy time (profiler)
    speed = synth_train or real_train

    def epoch():
        for b in speed:
            tr.update(b)

    epoch()
    walls = epoch_walls(torch, epoch)
    with eager_dispatch():
        eager_walls = epoch_walls(torch, epoch)
    span_ms = time_ms(epoch, 3, warmup=0)
    # the profiler traces graph replays, but on the bf16 paths its trace
    # of them crashed the process (a segmentation fault inside a replay,
    # from the fourth bf16 path of one process on; never without the
    # profiler, never eagerly): there it traces the same steps eagerly,
    # the same kernels
    profiled = "graph replays" if dtype == "float32" else "eager steps"
    with (contextlib.nullcontext() if dtype == "float32"
          else eager_dispatch()):
        busy = device_time(torch, epoch)
    # device memory one eager step adds above what is allocated before it
    # (activations, saved tensors, gradients): the fused paths keep no
    # [B, N, N] band.  A graph holds its own in its pool (graph_mib).
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    with eager_dispatch():
        tr.update(speed[0])
    torch.cuda.synchronize()
    peak_mib = (torch.cuda.max_memory_allocated() - before) / 2**20
    steps = len(speed)
    n_sent = sum(int(b["example_mask"].sum()) for b in speed)
    wall = min(walls)
    unpacked = None
    if path in UNPACKED:  # the same sentences unpacked, on the same weights
        twin = Trainer(path_config(UNPACKED[path], **base), state,
                       device=dev)
        unp = PACKED["train_unpacked"]

        def unp_epoch():
            for b in unp:
                twin.update(b)

        unp_epoch()
        unp_walls = epoch_walls(torch, unp_epoch)
        unpacked = {
            "path": UNPACKED[path], "steps": len(unp),
            "ms_per_step": min(unp_walls) / len(unp) * 1e3,
            "walls_s": unp_walls,
            "sentences_per_s": sum(int(b["example_mask"].sum())
                                   for b in unp) / min(unp_walls)}
    return {
        "phase": "train", "path": path, "dtype": dtype, "steps": len(batches),
        "batches": {"real": len(real_train), "synthetic_n96": steps},
        "launches": launches, "launches_per_step": per_step,
        "first_pass_s": first_s, "losses": losses,
        "plain_card": {"loss_rel_err": loss_err, "param_err": param_err,
                       "steps": 3, "plain_on": str(p.device)},
        "cpu_no_dropout": {"loss_rel_err": cpu_loss_err,
                           "param_err": cpu_param_err, "steps": 1},
        "tol": tol, "fixed_batch_losses": fall,
        "ms_per_step_n96": wall / steps * 1e3,
        "walls_s": walls,
        "ms_per_step_n96_eager": min(eager_walls) / steps * 1e3,
        "walls_s_eager": eager_walls,
        "graphs_against_eager": dispatch,
        "graph_memory_mib": graph_mib,
        "speed_batches": "synthetic N=96" if synth_train else "own train",
        "sentences_per_s_n96": n_sent / wall,
        "unpacked_twin": unpacked,
        "device_span_ms_per_step_n96": span_ms / steps,
        "step_peak_mib_n96_eager": peak_mib,
        "device_busy_ms_per_step_n96": (
            None if busy is None else busy["busy_ms"] / steps),
        "device_busy_profiled": profiled,
        "device_time_per_step_n96": None if busy is None else {
            "by_category_ms": {k: v / steps for k, v in
                               busy["by_category_ms"].items()},
            "top_kernels_ms": {k: v / steps for k, v in
                               busy["top_kernels_ms"].items()}},
    }


# -------------------------------------------------------------- dispatch
FAIL_CAPTURE = """
import sys
sys.path.insert(0, {here!r})
import numpy as np
import torch
from gcn_tpu_torch.config import cgcn_preset
from gcn_tpu_torch.models.gcn import GCNClassifier
from gcn_tpu_torch.train.trainer import Trainer
GCNClassifier.capturable = property(lambda self: True)
batch = {{k: np.asarray(v) for k, v in np.load({batch!r}).items()}}
cfg = cgcn_preset(**{{"model.vocab_size": {vocab}, "train.batch_size": 50,
                     "model.deprel_factored": "ragged"}})
tr = Trainer(cfg, device="cuda")
try:
    tr.update(batch)
except RuntimeError as e:
    print("raised:", str(e).splitlines()[0][:200])
else:
    print("no error")
"""


def capture_fails(tmp: str, batch: dict, vocab_size: int) -> str:
    """A trainer on the plain grouped matmul (it reads the group sizes on
    the host, which a capture cannot do) whose model is made to claim that
    a graph can hold it, in a process of its own: its first step must
    raise.  Returns the error's first line."""
    path = os.path.join(tmp, "batch.npz")
    np.savez(path, **batch)
    out = subprocess.run(
        [sys.executable, "-c", FAIL_CAPTURE.format(
            here=HERE, batch=path, vocab=vocab_size)],
        cwd=HERE, capture_output=True, text=True, timeout=300)
    said = [ln for ln in out.stdout.splitlines() if ln.startswith("raised:")]
    if not said:
        fail(f"dispatch: a capture that cannot succeed did not raise: "
             f"{out.stdout[-1000:]} {out.stderr[-2000:]}")
    return said[0]


def run_dispatch(torch, dev, real, synth, real_train, synth_train,
                 vocab_size) -> dict:
    """The dispatch phase (module docstring, 6) on ``cgcn``; fails on any
    miss."""
    from gcn_tpu_torch.models.gcn import GCNClassifier, init_params
    from gcn_tpu_torch.train.trainer import Trainer

    base = {"model.vocab_size": vocab_size, "train.batch_size": B,
            "train.effective_batch_size": B}

    def cfg_of(**extra):
        return path_config("cgcn", **base, **extra)

    model = GCNClassifier(cfg_of().model)
    init_params(model, torch.Generator().manual_seed(SEED))
    state = model.state_dict()

    def trainer(**extra):
        return Trainer(cfg_of(**extra), state, device=dev)

    eight = synth_train * 2  # 8 steps at N=96
    # the reference: 8 eager steps, the losses and parameters after 7 and 8
    eager = trainer()
    with eager_dispatch():
        want = [eager.update(b) for b in eight[:7]]
        after7 = {k: v.clone() for k, v in eager.model.state_dict().items()}
        want.append(eager.update(eight[7]))
    gates = {}
    runs = {"spd1": trainer(), "spd4": trainer(**{
        "train.steps_per_dispatch": 4})}
    got = {"spd1": [runs["spd1"].update(b) for b in eight],
           "spd4": runs["spd4"].update_chunk(eight)}
    for name in ("spd1", "spd4"):
        gates[f"8_steps_{name}"] = same_bits(torch, got[name], want,
                                             runs[name], eager)
    seven = trainer(**{"train.steps_per_dispatch": 4})
    got7 = seven.update_chunk(eight[:7])
    pieces = sorted((k[2] for k in seven.graphs), reverse=True)
    s7 = seven.model.state_dict()
    gates["7_steps_4_2_1"] = {
        "pieces": pieces,
        "same_bits": [float(x) for x in got7] == [float(x) for x in
                                                  want[:7]]
        and all(torch.equal(s7[k], after7[k]) for k in after7)}
    if pieces != [4, 2, 1]:
        fail(f"dispatch: a 7-batch update_chunk went out as {pieces}")

    # evaluation: eager and synced, through graphs with the window, and in
    # chunks of 4; preds, probs and the average loss
    eval_batches = real + synth
    with eager_dispatch():
        ev_want = eager.evaluate(eval_batches)
    ev_runs = {"window": runs["spd1"], "chunks_of_4": runs["spd4"]}
    for name, tr in ev_runs.items():
        got_ev = tr.evaluate(eval_batches)
        gates[f"evaluate_{name}"] = {"same_bits": got_ev == ev_want}

    # warm-up: every graph of the shapes captured first; then the spd=4
    # run and its evaluation give the unwarmed run's bits
    warm = trainer(**{"train.steps_per_dispatch": 4})
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    stats = warm.warmup([real_train[0], synth_train[0]],
                        eval_batches=[real[0], synth[0]])
    torch.cuda.empty_cache()
    pool_mib = (torch.cuda.memory_reserved() - reserved) / 2**20
    if warm.global_step != 0 or int(warm.opt.count) != 0 or any(
            not torch.equal(v, state[k].to(dev))
            for k, v in warm.model.state_dict().items()):
        fail("dispatch: warm-up changed the trainer's state")
    got_w = warm.update_chunk(eight)
    gates["warmed_run"] = same_bits(torch, got_w, got["spd4"], warm,
                                    runs["spd4"])
    gates["warmed_run"]["evaluate_same_bits"] = (
        warm.evaluate(eval_batches) == ev_want)
    for name, g in gates.items():
        if not (g["same_bits"] and g.get("evaluate_same_bits", True)):
            fail(f"dispatch: {name} differs from the eager run: {g}")

    # a model that a graph cannot hold (deprel_factored ragged: the plain
    # grouped matmul reads the group sizes on the host) trains, in steps
    # and a chunk, and evaluates on the card through the same entry
    # points, eagerly: nothing captured, its losses within TOL_TRAIN of
    # the kernels' eager steps
    ragged = trainer(**{"model.deprel_factored": "ragged",
                        "train.steps_per_dispatch": 4})
    got_r = [ragged.update(b) for b in eight[:2]] + ragged.update_chunk(
        eight[2:6])
    preds_r, _, loss_r = ragged.evaluate(eval_batches)
    ragged_err = max(abs(float(x) - float(y)) / abs(float(y))
                     for x, y in zip(got_r, want))
    ragged_gate = {"steps": len(got_r), "loss_rel_err": ragged_err,
                   "graphs": len(ragged.graphs)
                   + len(ragged._evaluator.graphs),
                   "eval_loss": loss_r, "tol": TOL_TRAIN}
    if (ragged_gate["graphs"] or ragged_err > TOL_TRAIN
            or not np.isfinite(loss_r) or len(preds_r) != sum(
                int(b["example_mask"].sum()) for b in eval_batches)):
        fail(f"dispatch: the ragged trainer on the card: {ragged_gate}")

    # copies: one per packed dispatch, counted where they start
    copies = {}
    for name, extra in (("compact", {}),
                        ("int32", {"train.pack_format": "int32"}),
                        ("unpacked", {"train.pack_transfers": False})):
        tr = trainer(**extra)
        tr.update(eight[0])  # capture first
        tr.staging.copies = tr.staging.bytes = 0
        for b in eight:
            tr.update(b)
        copies[name] = {"copies_per_step": tr.staging.copies / len(eight),
                        "bytes_per_step": tr.staging.bytes / len(eight)}
    if copies["compact"]["copies_per_step"] != 1:
        fail(f"dispatch: {copies['compact']} copies a packed batch")
    chunk = runs["spd4"].staging
    chunk.copies = 0
    runs["spd4"].update_chunk(eight)
    copies["compact_spd4"] = {"copies_per_step": chunk.copies / len(eight)}
    if chunk.copies != 2:
        fail(f"dispatch: 8 steps at spd 4 made {chunk.copies} copies")

    # host wall a step at N=96: eager against graphs at spd 1, 4 and 8,
    # each beside the device's busy time (profiler) and idle share
    runs["spd8"] = trainer(**{"train.steps_per_dispatch": 8})
    runs["spd8"].update_chunk(eight)  # capture first
    modes = {"eager": lambda: [eager.update(b) for b in eight],
             "graphs_spd1": lambda: [runs["spd1"].update(b) for b in eight],
             "graphs_spd4": lambda: runs["spd4"].update_chunk(eight),
             "graphs_spd8": lambda: runs["spd8"].update_chunk(eight)}
    walls = {}
    for name, fn in modes.items():
        ctx = eager_dispatch() if name == "eager" else contextlib.nullcontext()
        with ctx:
            fn()
            w = epoch_walls(torch, fn)
            busy = device_time(torch, fn)
        ms = min(w) / len(eight) * 1e3
        busy_ms = None if busy is None else busy["busy_ms"] / len(eight)
        walls[name] = {"ms_per_step": ms, "walls_s": w,
                       "busy_ms_per_step": busy_ms,
                       "idle_share": None if busy_ms is None
                       else 1 - busy_ms / ms}

    # evaluation sentences/s: eager and synced, graphs with the window,
    # graphs in chunks of 4
    n_sent = sum(int(b["example_mask"].sum()) for b in eval_batches)
    rates = {}
    for name, tr, ctx in (
            ("eager_synced", eager, eager_dispatch),
            ("graphs_window", runs["spd1"], contextlib.nullcontext),
            ("graphs_chunks_of_4", runs["spd4"], contextlib.nullcontext)):
        with ctx():
            w = epoch_walls(torch, lambda: tr.evaluate(eval_batches))
        rates[name] = n_sent / min(w)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_dispatch_")
    try:
        raised = capture_fails(tmp, real_train[0], vocab_size)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {
        "phase": "dispatch", "path": "cgcn",
        "batches": {"train_n96": len(eight), "eval": len(eval_batches)},
        "gates": gates, "copies": copies,
        "host_ms_per_step_n96": walls,
        "eval_sentences_per_s": rates,
        "warmup": {"programs": stats["programs"],
                   "seconds": stats["seconds"], "pool_mib": pool_mib},
        "failed_capture": raised, "ragged_eager": ragged_gate,
    }


# ------------------------------------------------------------------ cli
FLAGSHIP = os.path.join(HERE, ".campaign_r5", "flagship")
# train_cgcn.sh's flags (its --num_epoch apart)
CGCN_SH = ["--seed", "0", "--prune_k", "1", "--lr", "0.3", "--rnn_hidden",
           "200", "--pooling", "max", "--mlp_layers", "2", "--pooling_l2",
           "0.003", "--word_dropout", "0.04", "--emb_dropout", "0.0",
           "--deprel_emb_dim", "50", "--adj_type", "full_deprel",
           "--batch_size", "50"]
CLI_EPOCHS = 3
TOL_RESUME = 1e-6             # resumed vs whole run, of each tensor's max
SEED_DEV_F1 = {11: 0.612559, 17: 0.717025}  # gcn_tpu's checkpoints, port
NO_DROPOUT = ["--input_dropout", "0", "--gcn_dropout", "0", "--rnn_dropout",
              "0", "--deprel_dropout", "0"]  # the card's and the CPU's
                                             # generators differ
CPU_THREADS = 8  # the --cpu epoch's threads: its sums split by thread
                 # count, so a host of another size would move its bits
NEAR_TIE = 1e-4               # a row may flip only where its top two CPU
                              # probabilities lie this close


def logged_rows(run_dir: str) -> tuple[list[str], list[list[str]]]:
    """(logs.txt's lines, its epoch rows split at tabs)."""
    with open(os.path.join(run_dir, "logs.txt")) as f:
        lines = f.read().splitlines()
    return lines, [ln.split("\t") for ln in lines[1:]
                   if not ln.startswith("new best")]


def run_eval_cli(run_dir: str, *args: str) -> dict:
    """``python -m gcn_tpu_torch.scripts.eval`` on the card; its JSON line.
    A non-zero exit fails the run."""
    out = subprocess.run(
        [sys.executable, "-m", "gcn_tpu_torch.scripts.eval", run_dir, *args],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        fail(f"eval CLI on {run_dir} exited {out.returncode}: "
             f"{out.stderr[-2000:]}")
    lines = out.stdout.splitlines()
    return json.loads(lines[lines.index("Evaluation ended.") - 1])


def split_sizes(data_dir: str, batch: int) -> tuple[int, int]:
    """(train steps, evaluation batches) of one epoch of the driver:
    train, train-eval, dev and test at ``batch`` rows."""
    n = {}
    for split in ("train", "dev", "test"):
        with open(os.path.join(data_dir, f"{split}.json")) as f:
            n[split] = -(-len(json.load(f)) // batch)
    return n["train"], n["train"] + n["dev"] + n["test"]


def dev_probs(run_dir: str, data_dir: str) -> tuple[list, dict]:
    """(gold labels, {device: (probabilities, loss)}) of a run directory's
    best model on dev, in process on the CPU and on the card, over the
    eval CLI's batches."""
    from gcn_tpu_torch.config import Config
    from gcn_tpu_torch.convert import params_from_jax
    from gcn_tpu_torch.data.dataset import Batcher, RelationDataset
    from gcn_tpu_torch.data.vocab import Vocab
    from gcn_tpu_torch.train.checkpoint import load_checkpoint
    from gcn_tpu_torch.train.evaluator import Evaluator

    cfg = Config.load(os.path.join(run_dir, "config.json"))
    params, _, _ = load_checkpoint(os.path.join(run_dir, "best_model"),
                                   load_opt_state=False)
    ds = RelationDataset(os.path.join(data_dir, "dev.json"), cfg,
                         Vocab.load(os.path.join(run_dir, "vocab.pkl")),
                         evaluation=True)
    batcher = Batcher(ds, cfg.train.eval_batch_size or cfg.train.batch_size,
                      evaluation=True)
    out = {}
    for device in ("cpu", "cuda"):
        ev = Evaluator(cfg, params_from_jax(params), device=device)
        _, probs, loss = ev.evaluate(batcher)
        out[device] = (np.asarray(probs), loss)
    return batcher.gold(), out


def check_seed_checkpoint(tmp: str, seed: int) -> dict:
    """The eval CLI on the card on a copy of gcn_tpu's committed run, its
    dev F1 against the target.  At these shapes (B=100, H=32, D=64) the
    card's probabilities are held to the CPU's, and the CLI's loss to the
    CPU's; a row whose label differs from the CPU's must have taken the
    CPU's second label at a near-tie there."""
    from gcn_tpu_torch import constants
    from gcn_tpu_torch.train.scorer import score

    src = os.path.join(FLAGSHIP, f"seed{seed}", "gcn_tpu_full_deprel_models",
                       "cmp")
    data_dir = os.path.join(FLAGSHIP, f"seed{seed}", "data")
    run = os.path.join(tmp, f"seed{seed}")
    os.makedirs(run)
    for name in ("config.json", "vocab.pkl"):
        shutil.copy(os.path.join(src, name), run)
    shutil.copytree(os.path.join(src, "best_model"),
                    os.path.join(run, "best_model"))
    pred_file = os.path.join(tmp, f"seed{seed}_dev.txt")
    out = run_eval_cli(run, "--data_dir", data_dir, "--dataset", "dev",
                       "--out", pred_file)
    with open(pred_file) as f:
        card = f.read().split()
    gold, evals = dev_probs(run, data_dir)
    (probs, cpu_loss), (card_probs, card_loss) = evals["cpu"], evals["cuda"]
    probs_err = float(np.abs(card_probs - probs).max())
    loss_err = max(abs(out["loss"] - cpu_loss), abs(card_loss - cpu_loss)
                   ) / max(1.0, abs(cpu_loss))
    if probs_err > TOL_SLICE or loss_err > TOL_SLICE:
        fail(f"seed {seed}: card against CPU at B=100: dev probabilities "
             f"{probs_err}, loss {loss_err} (CLI {out['loss']}, in process "
             f"{card_loss}, CPU {cpu_loss}); tolerance {TOL_SLICE}")
    id2label = {v: k for k, v in constants.LABEL_TO_ID.items()}
    cpu = [id2label[i] for i in probs.argmax(1)]
    top2 = np.argsort(probs, axis=1)[:, -2:]
    flipped = [i for i, (a, b) in enumerate(zip(card, cpu)) if a != b]
    ties = [i for i in flipped
            if card[i] == id2label[top2[i, 0]]
            and probs[i, top2[i, 1]] - probs[i, top2[i, 0]] < NEAR_TIE]
    cpu_f1 = score(gold, cpu, out=io.StringIO())[2]
    if round(cpu_f1, 6) != SEED_DEV_F1[seed]:
        fail(f"seed {seed}: CPU dev F1 {cpu_f1}, not {SEED_DEV_F1[seed]}")
    # the card's F1 may then differ from the target through near-ties only
    if len(ties) < len(flipped):
        fail(f"seed {seed}: {len(flipped) - len(ties)} rows differ from the "
             f"CPU's labels other than by its second label at a near-tie")
    return {"dev_f1": out["f1"], "target": SEED_DEV_F1[seed],
            "cpu_dev_f1": cpu_f1, "rows_unlike_cpu": len(flipped),
            "probs_max_abs_err": probs_err, "loss_rel_err": loss_err,
            "dev_loss": {"cli": out["loss"], "card": card_loss,
                         "cpu": cpu_loss}, "tol": TOL_SLICE,
            "sentences_per_s": out["sentences_per_s"],
            "eval_seconds": out["seconds"], "batch_size": out["batch_size"]}


PACK_SENTENCES = ["--pack_sentences", "10"]  # the cli phase's packed runs


def packed_sizes(argv: list) -> tuple[int, int]:
    """(train steps, evaluation batches) of one epoch of the driver on the
    train CLI's ``argv`` with ``--pack_sentences``: its ``PackedBatcher``s'
    lengths (the train rows follow the seeded shuffle)."""
    from gcn_tpu_torch.data.dataset import PackedBatcher, RelationDataset
    from gcn_tpu_torch.data.vocab import Vocab
    from gcn_tpu_torch.train import cli as port_cli

    cfg = port_cli.args_to_config(
        port_cli.build_parser("tacred").parse_args(argv))
    vocab = Vocab.load(os.path.join(cfg.data.vocab_dir, "vocab.pkl"))
    cfg.model.vocab_size = vocab.size

    def batches(split, evaluation):
        ds = RelationDataset(os.path.join(cfg.data.data_dir,
                                          f"{split}.json"),
                             cfg, vocab, evaluation=evaluation)
        rows = cfg.train.batch_size
        if evaluation:
            rows = cfg.train.eval_batch_size or rows
        return len(PackedBatcher(
            ds, rows, pack_len=cfg.data.pack_len or None,
            max_slots=cfg.data.pack_sentences, evaluation=evaluation,
            seed=cfg.train.seed))

    return batches("train", False), sum(
        batches(split, True) for split in ("train", "dev", "test"))


def check_seed_packed(seed: int) -> dict:
    """gcn_tpu's committed checkpoint of ``seed`` on the card over its dev
    sentences packed (50 rows of up to 10 sentences): the dev F1 its
    unpacked evaluation reaches."""
    from gcn_tpu_torch import constants
    from gcn_tpu_torch.config import Config
    from gcn_tpu_torch.convert import params_from_jax
    from gcn_tpu_torch.data.dataset import PackedBatcher, RelationDataset
    from gcn_tpu_torch.data.vocab import Vocab
    from gcn_tpu_torch.train.checkpoint import load_checkpoint
    from gcn_tpu_torch.train.evaluator import Evaluator
    from gcn_tpu_torch.train.scorer import score

    src = os.path.join(FLAGSHIP, f"seed{seed}", "gcn_tpu_full_deprel_models",
                       "cmp")
    cfg = Config.load(os.path.join(src, "config.json"))
    params, _, _ = load_checkpoint(os.path.join(src, "best_model"),
                                   load_opt_state=False)
    ds = RelationDataset(os.path.join(FLAGSHIP, f"seed{seed}", "data",
                                      "dev.json"),
                         cfg, Vocab.load(os.path.join(src, "vocab.pkl")),
                         evaluation=True)
    batcher = PackedBatcher(ds, B, max_slots=10, evaluation=True)
    ev = Evaluator(cfg, params_from_jax(params), device="cuda")
    t0 = time.perf_counter()
    preds, _, loss = ev.evaluate(batcher)
    seconds = time.perf_counter() - t0
    id2label = {v: k for k, v in constants.LABEL_TO_ID.items()}
    f1 = score(batcher.gold(), [id2label[p] for p in preds],
               out=io.StringIO())[2]
    if round(f1, 6) != SEED_DEV_F1[seed]:
        fail(f"seed {seed}: dev F1 on packed batches {f1}, not "
             f"{SEED_DEV_F1[seed]}")
    return {"dev_f1": f1, "target": SEED_DEV_F1[seed], "dev_loss": loss,
            "rows": B, "batches": len(batcher),
            "sentences": len(preds), "first_pass_s": seconds,
            "pack_len": batcher.pack_len}


def run_cli(torch) -> dict:
    """The cli phase (module docstring, 7); fails on any miss."""
    from gcn_tpu_torch.convert import params_from_jax
    from gcn_tpu_torch.scripts import train
    from gcn_tpu_torch.train.checkpoint import load_checkpoint

    data_dir = os.path.join(FLAGSHIP, "seed11", "data")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    log = os.path.join(tmp, "train_stdout.txt")
    try:
        base = [*CGCN_SH, "--data_dir", data_dir, "--vocab_dir",
                os.path.join(FLAGSHIP, "seed11", "vocab"),
                "--model_save_dir", tmp]

        def train_cli(*args):
            with open(log, "a") as f, contextlib.redirect_stdout(f):
                return train.main([*base, *args])

        # 1. the whole run, counted
        t0 = time.perf_counter()
        result, launches = counted(lambda: train_cli(
            "--id", "whole", "--num_epoch", str(CLI_EPOCHS)))
        whole_s = time.perf_counter() - t0
        steps, evals = split_sizes(data_dir, 50)
        per_forward, per_step = EXPECTED["cgcn"]
        for name, count in launches.items():
            want = CLI_EPOCHS * (steps * per_step.get(name, 0)
                                 + evals * per_forward.get(name, 0))
            if count != want:
                fail(f"cli: kernel {name} launched {count} times over "
                     f"{CLI_EPOCHS} epochs, not {want}")
        run = result["run_dir"]
        for name in ("config.json", "vocab.pkl", "logs.txt",
                     "deprel_embs.pkl", "dev_confusion_matrix.pkl",
                     "test_confusion_matrix.pkl", "dev_incorrect_data.json",
                     "test_incorrect_data.json"):
            if not os.path.isfile(os.path.join(run, name)):
                fail(f"cli: the run directory has no {name}")
        for ck in ("best_model", f"checkpoint_epoch_{CLI_EPOCHS}"):
            for name in ("params.msgpack", "opt_state.msgpack", "meta.json"):
                if not os.path.isfile(os.path.join(run, ck, name)):
                    fail(f"cli: the run directory has no {ck}/{name}")
        lines, rows = logged_rows(run)
        if len(rows) != CLI_EPOCHS:
            fail(f"cli: logs.txt has {len(rows)} epoch lines: {lines}")
        train_losses = [float(r[1]) for r in rows]
        if not train_losses[-1] < train_losses[0]:
            fail(f"cli: the train loss did not fall over {CLI_EPOCHS} "
                 f"epochs: {train_losses}")

        # 1b. dropout off (word dropout, drawn on the host, stays), one
        # epoch on the card against one with --cpu: logs.txt's train and
        # dev loss
        nodrop_s = {}
        threads = torch.get_num_threads()
        for where in ("card", "cpu"):
            torch.set_num_threads(CPU_THREADS if where == "cpu" else threads)
            t0 = time.perf_counter()
            try:
                train_cli("--id", f"nodrop_{where}", "--num_epoch", "1",
                          *NO_DROPOUT, *(["--cpu"] if where == "cpu" else []))
            finally:
                torch.set_num_threads(threads)
            nodrop_s[where] = time.perf_counter() - t0
        (card_row,), (cpu_row,) = (logged_rows(os.path.join(
            tmp, f"nodrop_{w}"))[1] for w in ("card", "cpu"))
        epoch1_err = max(abs(float(card_row[c]) - float(cpu_row[c]))
                         / abs(float(cpu_row[c])) for c in (1, 2))
        if epoch1_err > TOL_TRAIN:
            fail(f"cli: epoch 1 without dropout, card {card_row} against "
                 f"--cpu {cpu_row}: {epoch1_err} relative")

        # 2. 2 epochs, then --resume to 3
        train_cli("--id", "split", "--num_epoch", "2")
        train_cli("--id", "split", "--num_epoch", str(CLI_EPOCHS), "--resume")
        resume_err, same_bits = 0.0, True
        for ck in ("best_model", f"checkpoint_epoch_{CLI_EPOCHS}"):
            want = params_from_jax(load_checkpoint(os.path.join(run, ck))[0])
            got = params_from_jax(load_checkpoint(os.path.join(
                tmp, "split", ck))[0])
            for k, v in want.items():
                err = float((got[k] - v).abs().max()) / max(
                    float(v.abs().max()), 1e-30)
                resume_err = max(resume_err, err)
                same_bits &= torch.equal(got[k], v)
        if resume_err > TOL_RESUME:
            fail(f"cli: the resumed run is {resume_err} of a tensor's max "
                 f"from the whole run")
        print(f"cli: resumed run, the same bits as the whole run: "
              f"{same_bits}", flush=True)

        # 2b. the same run at --steps_per_dispatch 4 with its graphs
        # captured first: logs.txt and best_model the spd=1 run's bits
        spd4 = train_cli("--id", "spd4", "--num_epoch", str(CLI_EPOCHS),
                         "--steps_per_dispatch", "4",
                         "--warmup_compile", "true")
        spd4_same = logged_rows(spd4["run_dir"])[0] == lines
        want = params_from_jax(load_checkpoint(os.path.join(
            run, "best_model"))[0])
        got = params_from_jax(load_checkpoint(os.path.join(
            spd4["run_dir"], "best_model"))[0])
        spd4_same &= all(torch.equal(got[k], v) for k, v in want.items())
        if not spd4_same:
            fail("cli: the --steps_per_dispatch 4 run's logs.txt or "
                 "best_model differs from the spd=1 run's")
        spd4_eval = run_eval_cli(spd4["run_dir"], "--dataset", "test")

        # 2c. the same flags with --pack_sentences 10 (batch_size counts
        # rows): its launches, the loss falling, and a resume
        t0 = time.perf_counter()
        packed, p_launches = counted(lambda: train_cli(
            "--id", "packed", "--num_epoch", str(CLI_EPOCHS),
            *PACK_SENTENCES))
        packed_s = time.perf_counter() - t0
        p_steps, p_evals = packed_sizes([*base, *PACK_SENTENCES])
        for name, count in p_launches.items():
            want = CLI_EPOCHS * (p_steps * per_step.get(name, 0)
                                 + p_evals * per_forward.get(name, 0))
            if count != want:
                fail(f"cli: packed, kernel {name} launched {count} times "
                     f"over {CLI_EPOCHS} epochs, not {want}")
        p_lines, p_rows = logged_rows(packed["run_dir"])
        p_losses = [float(r[1]) for r in p_rows]
        if len(p_rows) != CLI_EPOCHS or not p_losses[-1] < p_losses[0]:
            fail(f"cli: the packed run's logs.txt: {p_lines}")
        train_cli("--id", "packed_split", "--num_epoch", "2",
                  *PACK_SENTENCES)
        train_cli("--id", "packed_split", "--num_epoch", str(CLI_EPOCHS),
                  "--resume", *PACK_SENTENCES)
        p_same = logged_rows(os.path.join(tmp, "packed_split"))[0] == p_lines
        for ck in ("best_model", f"checkpoint_epoch_{CLI_EPOCHS}"):
            want = params_from_jax(load_checkpoint(os.path.join(
                packed["run_dir"], ck))[0])
            got = params_from_jax(load_checkpoint(os.path.join(
                tmp, "packed_split", ck))[0])
            p_same &= all(torch.equal(got[k], v) for k, v in want.items())
        if not p_same:
            fail("cli: the resumed packed run's logs.txt or checkpoints "
                 "differ from the whole packed run's")
        print(f"cli: packed run, {p_steps} steps an epoch, resumed the "
              f"same bits; epoch walls "
              f"{[round(w, 3) for w, _ in packed['epochs_timed']]} s",
              flush=True)
        print(f"cli: spd 4 run, the spd=1 run's bits; epoch walls "
              f"{[round(w, 3) for w, _ in spd4['epochs_timed']]} s; eval "
              f"CLI {spd4_eval['sentences_per_s']:.1f} sentences/s",
              flush=True)

        # 3. the eval CLI on the run: the test F1 and the dev loss that
        # logs.txt recorded at the best epoch
        on_run = run_eval_cli(run, "--dataset", "test")
        best = [ln for ln in lines if ln.startswith("new best")][-1]
        logged = float(best.split("\t")[-1])
        if (on_run["f1"] != result["test_at_best_dev"]["f1"]
                or round(on_run["f1"] * 100, 2) != logged):
            fail(f"cli: eval CLI test F1 {on_run['f1']}, logs.txt {logged}, "
                 f"run {result['test_at_best_dev']['f1']}")
        best_epoch = best.split(":")[0].split()[-1]
        logged_dev = next(r for r in rows if r[0] == best_epoch)
        on_dev = run_eval_cli(run, "--dataset", "dev")
        if (f"{on_dev['loss']:.6f}" != logged_dev[2]
                or f"{on_dev['f1']:.4f}" != logged_dev[3]):
            fail(f"cli: eval CLI dev loss {on_dev['loss']} and F1 "
                 f"{on_dev['f1']}, logs.txt at epoch {best_epoch}: "
                 f"{logged_dev}")

        # 4. the eval CLI on gcn_tpu's checkpoints
        seeds = {seed: check_seed_checkpoint(tmp, seed)
                 for seed in sorted(SEED_DEV_F1)}
        for seed, r in seeds.items():
            print(f"cli: seed {seed} dev F1 {r['dev_f1']:.6f}, "
                  f"{r['sentences_per_s']:.1f} sentences/s", flush=True)
        seed_packed = check_seed_packed(11)
        print(f"cli: seed 11 on packed dev batches, dev F1 "
              f"{seed_packed['dev_f1']:.6f}", flush=True)
    except BaseException:
        if os.path.exists(log):
            with open(log) as f:
                sys.stderr.write(f.read()[-4000:])
        raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {
        "phase": "cli", "flags": "train_cgcn.sh", "epochs": CLI_EPOCHS,
        "train_steps_per_epoch": steps, "eval_batches_per_epoch": evals,
        "whole_run_s": whole_s,
        "epoch_wall_s": [w for w, _ in result["epochs_timed"]],
        "sustained_examples_per_s": [x for _, x in result["epochs_timed"]],
        "launches": launches,
        "train_loss_sums": train_losses,
        "epoch1_no_dropout": {"card": card_row[1:3], "cpu": cpu_row[1:3],
                              "max_rel_err": epoch1_err, "tol": TOL_TRAIN,
                              "run_s": nodrop_s,
                              "cpu_threads": CPU_THREADS,
                              "host_cpus": os.cpu_count()},
        "resume": {"max_err": resume_err, "tol": TOL_RESUME,
                   "same_bits": same_bits},
        "spd4_warmed": {"same_bits_as_spd1": spd4_same,
                        "epoch_wall_s": [w for w, _ in
                                         spd4["epochs_timed"]],
                        "sustained_examples_per_s": [
                            x for _, x in spd4["epochs_timed"]],
                        "eval_cli_test_sentences_per_s":
                            spd4_eval["sentences_per_s"],
                        "eval_cli_graphs_captured":
                            spd4_eval["graphs_captured"]},
        "best_dev_f1": result["best_dev"]["f1"],
        "test_f1_at_best": result["test_at_best_dev"]["f1"],
        "eval_cli_on_run": {"test_f1": on_run["f1"], "dev_f1": on_dev["f1"],
                            "dev_loss": on_dev["loss"],
                            "best_epoch": int(best_epoch),
                            "sentences_per_s": {
                                "test": on_run["sentences_per_s"],
                                "dev": on_dev["sentences_per_s"]},
                            "graphs_captured": on_run["graphs_captured"]},
        "eval_cli_on_gcn_tpu": seeds,
        "packed": {"flags": PACK_SENTENCES,
                   "train_steps_per_epoch": p_steps,
                   "eval_batches_per_epoch": p_evals,
                   "whole_run_s": packed_s, "launches": p_launches,
                   "train_loss_sums": p_losses,
                   "epoch_wall_s": [w for w, _ in packed["epochs_timed"]],
                   "sustained_examples_per_s": [
                       x for _, x in packed["epochs_timed"]],
                   "resume_same_bits": p_same,
                   "best_dev_f1": packed["best_dev"]["f1"],
                   "seed11_packed_dev": seed_packed},
    }


# ------------------------------------------------------------- reference
# the reference's trained C-GCN checkpoints (the original PyTorch code's
# best_model.pt, committed with their run's config.json and vocab.pkl):
# their best dev F1 (logs.txt: 68.03 and 66.43), as the port scores them
REFERENCE_DEV_F1 = {11: 0.680328, 17: 0.664319}
# gcn_tpu's own bf16 against its f32 on these checkpoints (the CPU, the
# non-factored path, 1200 dev sentences): the largest logit gap; the
# port's bf16 may take twice it
JAX_BF16_LOGIT_GAP = {11: 0.331, 17: 0.243}
E2E_MAX_FLIPS = 6             # of 1200 predictions, bf16 against f32
E2E_F1 = 0.005                # dev F1, bf16 against f32
# the model fields of a reference run's config.json (the options its
# train.py saved under the same names)
REFERENCE_FIELDS = ("emb_dim", "ner_dim", "pos_dim", "vocab_size",
                    "hidden_dim", "num_layers", "rnn", "rnn_hidden",
                    "rnn_layers", "prune_k", "adj_type", "deprel_emb_dim",
                    "deprel_self_loop", "deprel_directed", "deprel_max_depth",
                    "no_adj", "pooling", "mlp_layers", "num_class", "dataset")


def reference_config(opt: dict, **extra):
    """The port's Config of a reference run's config.json, for evaluation
    at B=50: its model fields, the reference's one shared full_deprel W
    (``deprel_shared_w``), and ``extra`` model fields."""
    from gcn_tpu_torch.config import Config

    cfg = Config()
    for k in REFERENCE_FIELDS:
        setattr(cfg.model, k, opt[k])
    cfg.model.deprel_shared_w = opt["adj_type"] == "full_deprel"
    for k, v in extra.items():
        setattr(cfg.model, k, v)
    cfg.train.batch_size = B
    return cfg


def reference_run(torch, cfg, state, batcher, device, dtype="float32"):
    """One scoring of a reference checkpoint: ``Evaluator.evaluate`` on
    ``device`` (counted on the card), then every valid row's logits by the
    same model, and the dev F1."""
    from gcn_tpu_torch import constants
    from gcn_tpu_torch.train.evaluator import Evaluator, batch_to_device
    from gcn_tpu_torch.train.scorer import score

    ev = Evaluator(cfg, state, device=device)
    t0 = time.perf_counter()
    if device == "cpu":
        (preds, probs, loss), launches = ev.evaluate(batcher), None
    else:
        (preds, probs, loss), launches = counted(
            lambda: ev.evaluate(batcher), dtype)
    seconds = time.perf_counter() - t0
    logits = []
    with torch.no_grad():
        for b in batcher:
            lg, _ = ev.model(batch_to_device(b, device))
            logits.append(lg[torch.from_numpy(b["example_mask"]).to(
                lg.device)].float().cpu())
    id2label = {v: k for k, v in constants.LABEL_TO_ID.items()}
    labels = [id2label[p] for p in preds]
    f1 = score(batcher.gold(), labels, out=io.StringIO())[2]
    return {"labels": labels, "probs": np.asarray(probs), "loss": loss,
            "logits": torch.cat(logits).numpy(), "f1": f1,
            "seconds": seconds, "launches": launches, "model": ev.model}


def run_reference(torch, dev) -> dict:
    """The reference phase (module docstring, 8); fails on any miss."""
    from gcn_tpu_torch import constants
    from gcn_tpu_torch.compat.torch_export import (params_to_torch_state,
                                                   state_dict_to_torch_state)
    from gcn_tpu_torch.compat.torch_import import torch_state_to_params
    from gcn_tpu_torch.convert import params_from_jax
    from gcn_tpu_torch.data.dataset import Batcher, RelationDataset
    from gcn_tpu_torch.data.vocab import Vocab

    id2label = {v: k for k, v in constants.LABEL_TO_ID.items()}

    out = {}
    for seed, target in sorted(REFERENCE_DEV_F1.items()):
        run = os.path.join(FLAGSHIP, f"seed{seed}",
                           "reference_full_deprel_models", "cmp")
        ckpt = torch.load(os.path.join(run, "best_model.pt"),
                          map_location="cpu", weights_only=True)
        with open(os.path.join(run, "config.json")) as f:
            opt = json.load(f)
        state = {k: v.numpy() for k, v in ckpt["model"].items()}
        cfg = reference_config(opt)
        params = torch_state_to_params(state, cfg.model)
        weights = params_from_jax(params)
        ds = RelationDataset(
            os.path.join(FLAGSHIP, f"seed{seed}", "data", "dev.json"), cfg,
            Vocab.load(os.path.join(run, "vocab.pkl")), evaluation=True)
        batcher = Batcher(ds, B, evaluation=True)
        runs = {"cpu_f32_dense": reference_run(torch, cfg, weights, batcher,
                                               "cpu")}
        for name, extra in (
                ("f32_dense", {}), ("f32_fused", {"use_pallas": True}),
                ("bf16_dense", {"compute_dtype": "bfloat16"}),
                ("bf16_fused", {"use_pallas": True,
                                "compute_dtype": "bfloat16"})):
            runs[name] = reference_run(
                torch, reference_config(opt, **extra), weights, batcher, dev,
                extra.get("compute_dtype", "float32"))
        cpu = runs["cpu_f32_dense"]
        if round(cpu["f1"], 6) != target:
            fail(f"reference seed {seed}: CPU dev F1 {cpu['f1']}, not "
                 f"{target}")
        res = {"target_dev_f1": target, "cpu_dev_f1": cpu["f1"],
               "sentences": len(cpu["labels"]), "runs": {}}
        # f32 on the card: the CPU's labels, or its second label at a
        # near-tie (check_seed_checkpoint's rule)
        top2 = np.argsort(cpu["probs"], axis=1)[:, -2:]
        for name in ("f32_dense", "f32_fused"):
            r = runs[name]
            flipped = [i for i, (a, c) in enumerate(zip(r["labels"],
                                                         cpu["labels"]))
                       if a != c]
            ties = [i for i in flipped
                    if r["labels"][i] == id2label[top2[i, 0]]
                    and cpu["probs"][i, top2[i, 1]]
                    - cpu["probs"][i, top2[i, 0]] < NEAR_TIE]
            if len(ties) < len(flipped) or (
                    not flipped and round(r["f1"], 6) != target):
                fail(f"reference seed {seed} {name}: dev F1 {r['f1']}, "
                     f"{len(flipped) - len(ties)} rows unlike the CPU's "
                     "other than at a near-tie")
            res["runs"][name] = {
                "dev_f1": r["f1"], "rows_unlike_cpu": len(flipped),
                "probs_max_abs_err_cpu": float(np.abs(
                    r["probs"] - cpu["probs"]).max()),
                "dev_loss": r["loss"], "seconds": r["seconds"],
                "sentences_per_s": len(r["labels"]) / r["seconds"],
                "launches": r["launches"]}
        # bf16 against the same path in f32 (the E2E gate)
        for name, twin in (("bf16_dense", "f32_dense"),
                           ("bf16_fused", "f32_fused")):
            r, t = runs[name], runs[twin]
            flips = sum(a != c for a, c in zip(r["labels"], t["labels"]))
            gap = float(np.abs(r["logits"] - t["logits"]).max())
            gate = {"flips_max": E2E_MAX_FLIPS, "f1_max": E2E_F1,
                    "logit_gap_max": 2 * JAX_BF16_LOGIT_GAP[seed]}
            res["runs"][name] = {
                "dev_f1": r["f1"], "predictions_unlike_f32": flips,
                "f1_gap": abs(r["f1"] - t["f1"]), "max_logit_gap": gap,
                "largest_logit_f32": float(np.abs(t["logits"]).max()),
                "gate": gate, "dev_loss": r["loss"],
                "seconds": r["seconds"],
                "sentences_per_s": len(r["labels"]) / r["seconds"],
                "launches": r["launches"]}
            if (flips > E2E_MAX_FLIPS or abs(r["f1"] - t["f1"]) > E2E_F1
                    or gap > gate["logit_gap_max"]):
                fail(f"reference seed {seed} {name}: {res['runs'][name]}")
        # export, re-import: the same bits; and from the model's state_dict
        back = torch_state_to_params(params_to_torch_state(params,
                                                           cfg.model),
                                     cfg.model)
        flat, flat_back = params_from_jax(params), params_from_jax(back)
        again = state_dict_to_torch_state(
            runs["f32_dense"]["model"].state_dict(), cfg.model)
        same = (flat.keys() == flat_back.keys()
                and all(torch.equal(flat[k], flat_back[k]) for k in flat)
                and again.keys() == state.keys()
                and all(np.array_equal(again[k], state[k]) for k in state))
        if not same:
            fail(f"reference seed {seed}: export and re-import changed the "
                 "parameters")
        res["export_round_trip_same_bits"] = same
        out[seed] = res
        print(f"reference: seed {seed} dev F1 "
              + ", ".join(f"{k} {v['dev_f1']:.6f}"
                          for k, v in res["runs"].items()), flush=True)
    return {"phase": "reference", "seeds": out}


# ---------------------------------------------------------------- sparse
# word tables the sparse phase times, sparse against dense: two small
# ones for the crossover, TACRED's GloVe vocabulary and gcn_tpu's auto
# threshold (SPARSE_EMB_AUTO_VOCAB), where the phase's gates run
SPARSE_ROWS = (1_000, 10_000, 53_954, 300_000)


def wide_batches(batches, rows: int, rng) -> list:
    """``batches`` with every word drawn uniformly over a table of
    ``rows`` rows (padding stays 0)."""
    out = []
    for b in batches:
        words = b["words"]
        out.append({**b, "words": np.where(
            words > 0, rng.randint(2, rows, words.shape), 0).astype(
                words.dtype)})
    return out


def step_peak_mib(torch, tr, batch) -> float:
    """Device memory one eager step adds above what is allocated before
    it (activations, saved tensors, gradients)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    with eager_dispatch():
        tr.update(batch)
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - before) / 2**20


def trainer_speed(torch, tr, batches, busy: bool = False) -> dict:
    """ms a step through graphs (the best of 3 passes over ``batches``),
    the memory one eager step adds and, with ``busy``, the device's busy
    ms a step (profiler)."""
    def epoch():
        for b in batches:
            tr.update(b)

    epoch()
    walls = epoch_walls(torch, epoch)
    out = {"ms_per_step": min(walls) / len(batches) * 1e3, "walls_s": walls,
           "step_peak_mib_eager": step_peak_mib(torch, tr, batches[0])}
    if busy:
        dt = device_time(torch, epoch)
        out["device_busy_ms_per_step"] = (None if dt is None
                                          else dt["busy_ms"] / len(batches))
        out["device_top_kernels_ms_per_step"] = None if dt is None else {
            k: v / len(batches) for k, v in dt["top_kernels_ms"].items()}
    return out


def run_sparse(torch, dev, synth_train) -> dict:
    """The sparse phase (row-sparse word-table updates on ``cgcn`` at
    B=50, N=96, sgd 0.3, word ids drawn over the whole table); fails on
    any miss."""
    from gcn_tpu_torch.models.gcn import GCNClassifier, init_params
    from gcn_tpu_torch.train.trainer import SPARSE_EMB_AUTO_VOCAB, Trainer

    rng = np.random.RandomState(SEED + 3)
    out = {"phase": "sparse", "path": "cgcn", "optim": "sgd",
           "by_rows": {}}
    for rows in SPARSE_ROWS:
        base = {"model.vocab_size": rows, "train.batch_size": B,
                "train.effective_batch_size": B}
        cfg = {mode: path_config("cgcn", **base,
                                 **{"train.sparse_emb_grad": mode})
               for mode in ("auto", "true", "false")}
        model = GCNClassifier(cfg["auto"].model)
        init_params(model, torch.Generator().manual_seed(SEED))
        state = model.state_dict()
        del model
        batches = wide_batches(synth_train, rows, rng)
        ids = np.concatenate([b["words"][b["words"] > 0] for b in batches])
        row = {"ids_per_step": len(ids) / len(batches),
               "distinct_ids_per_step": float(np.mean([
                   len(np.unique(b["words"][b["words"] > 0]))
                   for b in batches])),
               "auto_sparse": Trainer(cfg["auto"], state,
                                      device=dev).sparse_emb}
        if row["auto_sparse"] != (rows >= SPARSE_EMB_AUTO_VOCAB):
            fail(f"sparse: auto chose sparse={row['auto_sparse']} at "
                 f"{rows} rows")
        if rows >= SPARSE_EMB_AUTO_VOCAB:
            # the main path: auto's sparse steps, counted
            tr = Trainer(cfg["auto"], state, device=dev)
            losses, launches = counted(
                lambda: [tr.update(b) for b in batches])
            row["launches_per_step"] = check_launches(
                "cgcn sparse", "train step", launches, EXPECTED["cgcn"][1],
                len(batches))
            losses = [float(x) for x in losses]
            if not all(np.isfinite(losses)):
                fail(f"sparse: non-finite loss {losses}")
            # the dense update on the same weights follows it (and one
            # adagrad step each way)
            a = Trainer(cfg["auto"], state, device=dev)
            d = Trainer(cfg["false"], state, device=dev)
            la = [float(a.update(b)) for b in batches[:3]]
            ld = [float(d.update(b)) for b in batches[:3]]
            loss_err = max(abs(x - y) / abs(y) for x, y in zip(la, ld))
            param_err = params_err(a, d)
            ada = {m: path_config("cgcn", **base, **{
                "train.sparse_emb_grad": m, "train.optim": "adagrad"})
                for m in ("true", "false")}
            sa, sd = (Trainer(ada[m], state, device=dev)
                      for m in ("true", "false"))
            lsa, lsd = float(sa.update(batches[0])), float(sd.update(
                batches[0]))
            ada_err = max(abs(lsa - lsd) / abs(lsd), params_err(sa, sd))
            row.update({"losses": losses, "against_dense": {
                "steps": 3, "loss_rel_err": loss_err,
                "param_err": param_err, "adagrad_one_step_err": ada_err,
                "tol": TOL_TRAIN}})
            if max(loss_err, param_err, ada_err) > TOL_TRAIN:
                fail(f"sparse: the dense update disagrees: {row}")
            # graphs against eager steps, and eager twice: the same bits
            row["graphs_against_eager"] = graphs_against_eager(
                torch, cfg["true"], state, dev, batches[:3], "cgcn")
            if not row["graphs_against_eager"]["eager_against_eager"][
                    "same_bits"]:
                fail(f"sparse: two eager runs differ: {row}")
        for mode, label in (("true", "sparse"), ("false", "dense")):
            tr = Trainer(cfg[mode], state, device=dev)
            row[label] = trainer_speed(torch, tr, batches,
                                       busy=rows >= SPARSE_EMB_AUTO_VOCAB)
            del tr
            torch.cuda.empty_cache()
        row["sparse_over_dense_ms"] = (row["sparse"]["ms_per_step"]
                                       / row["dense"]["ms_per_step"])
        out["by_rows"][rows] = row
    return out


# -------------------------------------------------------------- parallel
class GlobalBatches:
    """A list of global batches with a batcher's ``batch_size``, for
    ``ShardedBatcher``."""

    def __init__(self, batches: list, batch_size: int):
        self.batches, self.batch_size = batches, batch_size

    def __iter__(self):
        return iter(self.batches)

    def __len__(self) -> int:
        return len(self.batches)


DP_STEPS = 3  # steps held to Trainer's


def spawn_ranks(flag: str, tmp: str) -> None:
    """Run two processes of this script (``chip_smoke.py FLAG R DIR
    PORT``), a gloo world on the one card; fail if either exits
    non-zero."""
    from gcn_tpu_torch.parallel.distributed import free_port

    port = str(free_port())
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), flag, str(r), tmp, port],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (o, e) in zip(procs, logs):
        if p.returncode != 0:
            fail(f"{flag}: a gloo rank exited {p.returncode}: {e[-3000:]}")


def flips(preds: list, ref_preds: list, ref_probs) -> tuple[list, list]:
    """The rows whose prediction differs from the reference's, and those
    of them at a near-tie (the reference's second label, its top two
    within NEAR_TIE)."""
    top2 = np.argsort(ref_probs, axis=1)[:, -2:]
    flipped = [i for i, (a, b) in enumerate(zip(preds, ref_preds)) if a != b]
    ties = [i for i in flipped if preds[i] == top2[i, 0]
            and ref_probs[i, top2[i, 1]] - ref_probs[i, top2[i, 0]]
            < NEAR_TIE]
    return flipped, ties


def parallel_rank(rank: int, tmp: str, port: int) -> int:
    """One rank of the world of two over gloo on the one card (``python3
    chip_smoke.py --parallel-rank R DIR PORT``, started by
    ``run_parallel``): ``DP_STEPS`` steps on its rows of the inputs in
    ``DIR``, timed steps, the evaluation; rank 0 writes the results."""
    import pickle

    import torch

    sys.path.insert(0, HERE)
    from gcn_tpu_torch.config import Config
    from gcn_tpu_torch.data.sharding import ShardedBatcher
    from gcn_tpu_torch.parallel import distributed
    from gcn_tpu_torch.train.distributed_trainer import DistributedTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.initialize(f"localhost:{port}", 2, rank, backend="gloo")
    with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
        cfg, batches, evals = pickle.load(f)
    cfg = Config.from_dict(cfg)
    state = torch.load(os.path.join(tmp, "state.pt"), weights_only=True)
    dev = torch.device("cuda", 0)
    tr = DistributedTrainer(cfg, state, device=dev, backend="gloo")
    local = list(ShardedBatcher(GlobalBatches(batches, B), rank, 2))
    losses, launches = counted(
        lambda: [float(tr.update(b)) for b in local[:DP_STEPS]])
    params = {k: v.cpu() for k, v in tr.model.state_dict().items()}
    preds, probs, eval_loss = tr.evaluate(
        ShardedBatcher(GlobalBatches(evals, B), rank, 2))

    def epoch():
        for b in local:
            tr.update(b)

    epoch()
    walls = epoch_walls(torch, epoch)
    if rank == 0:
        torch.save({"losses": losses, "launches": launches, "params": params,
                    "preds": preds, "probs": np.asarray(probs),
                    "eval_loss": eval_loss, "graphs_on": tr._graphs_on(),
                    "backend": tr.backend, "world": tr.world,
                    "ms_per_step": min(walls) / len(local) * 1e3,
                    "walls_s": walls}, os.path.join(tmp, "rank0.pt"))
    distributed.shutdown()
    return 0


def run_parallel(torch, dev, synth_train, synth, vocab_size) -> dict:
    """The parallel phase (data parallelism on ``cgcn`` at B=50, N=96);
    fails on any miss."""
    import pickle

    from gcn_tpu_torch.models.gcn import GCNClassifier, init_params
    from gcn_tpu_torch.parallel import distributed
    from gcn_tpu_torch.train.distributed_trainer import DistributedTrainer
    from gcn_tpu_torch.train.trainer import Trainer

    cfg = path_config("cgcn", **{"model.vocab_size": vocab_size,
                                 "train.batch_size": B,
                                 "train.effective_batch_size": B})
    model = GCNClassifier(cfg.model)
    init_params(model, torch.Generator().manual_seed(SEED))
    state = model.state_dict()
    batches = synth_train
    out = {"phase": "parallel", "path": "cgcn", "batches": len(batches)}

    # a world of one over NCCL: its all-reduces inside the step's graph
    one = Trainer(cfg, state, device=dev)
    dp = DistributedTrainer(cfg, state, device=dev)
    if dp.backend != "nccl" or dp.world != 1 or not dp._graphs_on():
        fail(f"parallel: a world of {dp.world} over {dp.backend}, graphs "
             f"{dp._graphs_on()}")
    want = [one.update(b) for b in batches[:DP_STEPS]]
    got, launches = counted(lambda: [dp.update(b)
                                     for b in batches[:DP_STEPS]])
    nccl = {"backend": dp.backend, "world": dp.world, "graphs": True,
            "launches_per_step": check_launches(
                "cgcn parallel", "train step", launches,
                EXPECTED["cgcn"][1], DP_STEPS),
            **same_bits(torch, got, want, dp, one)}
    if not nccl["same_bits"]:
        fail(f"parallel: the NCCL world of one differs from Trainer: {nccl}")
    nccl["ms_per_step"] = trainer_speed(torch, dp, batches)["ms_per_step"]
    nccl["trainer_ms_per_step"] = trainer_speed(torch, one,
                                                batches)["ms_per_step"]
    out["nccl_world_1"] = nccl
    del dp, one
    distributed.shutdown()

    # a world of two on the one card over gloo, stepping eagerly
    ref = Trainer(cfg, state, device=dev)
    ref_losses = [float(ref.update(b)) for b in batches[:DP_STEPS]]
    ref_preds, ref_probs, ref_loss = ref.evaluate(synth)
    ref_probs = np.asarray(ref_probs)
    with eager_dispatch():
        eager_ms = trainer_speed(torch, Trainer(cfg, state, device=dev),
                                 batches)["ms_per_step"]
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(state, os.path.join(tmp, "state.pt"))
        with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
            pickle.dump((cfg.to_dict(), batches, synth), f)
        spawn_ranks("--parallel-rank", tmp)
        res = torch.load(os.path.join(tmp, "rank0.pt"), weights_only=False)
    ref_params = ref.model.state_dict()
    loss_err = max(abs(x - y) / abs(y)
                   for x, y in zip(res["losses"], ref_losses))
    param_err = max(max_err(res["params"][k], ref_params[k].cpu())
                    / max(1.0, float(ref_params[k].abs().max()))
                    for k in ref_params)
    flipped, ties = flips(res["preds"], ref_preds, ref_probs)
    gloo = {"backend": res["backend"], "world": res["world"],
            "graphs": res["graphs_on"], "steps": DP_STEPS,
            "launches_per_step_rank0": check_launches(
                "cgcn parallel gloo", "train step", res["launches"],
                EXPECTED["cgcn"][1], DP_STEPS),
            "loss_rel_err": loss_err, "param_err": param_err,
            "tol": TOL_TRAIN, "eval_rows": len(ref_preds),
            "eval_predictions_unlike": len(flipped),
            "eval_near_ties": len(ties),
            "eval_probs_err": float(np.abs(res["probs"] - ref_probs).max()),
            "eval_loss_rel_err": abs(res["eval_loss"] - ref_loss)
            / abs(ref_loss),
            "ms_per_step": res["ms_per_step"], "walls_s": res["walls_s"],
            "trainer_eager_ms_per_step": eager_ms}
    out["gloo_world_2_one_card"] = gloo
    if (res["world"] != 2 or res["backend"] != "gloo" or res["graphs_on"]
            or max(loss_err, param_err) > TOL_TRAIN
            or len(ties) < len(flipped) or len(res["preds"]) != len(ref_preds)):
        fail(f"parallel: the gloo world of two disagrees with Trainer: "
             f"{gloo}")
    return out


# ------------------------------------------------------------- partition
PARTITION_PATHS = ("cgcn", "cgcn_attn")  # configurations the world trains
PARTITION_MODES = ("edges", "halo")
# launches a step of a partitioned world's rank: the scans and the grouped
# matmul where the configuration runs them; the aggregation is gathers,
# scatters and the model group's collectives (``parallel.edge_partition``,
# ``parallel.halo``)
PARTITION_EXPECTED = {"cgcn": EXPECTED["cgcn"][1],
                      "cgcn_attn": {"lstm_scan_forward": 1,
                                    "lstm_scan_backward": 1}}
# under halo the same kernels, the grouped matmul on the slab's rows
HALO_EXPECTED = PARTITION_EXPECTED


def partition_cfg(path: str, vocab_size: int, graph_partition: str):
    """``path``'s configuration at B=50 with ``graph_partition`` over a
    model axis of 2."""
    return path_config(path, **{"model.vocab_size": vocab_size,
                                "model.graph_partition": graph_partition,
                                "mesh.graph_axis": 2, "train.batch_size": B,
                                "train.effective_batch_size": B})


def slab_gmm(torch, batch: dict, dev, k: int) -> dict:
    """Kernel 3 at rank 0's slab of ``batch`` under halo: M = B·S rows of
    the forward band's relation ids (the all-zeros row for padding), R =
    87 groups, some empty, T = 400, H = 200, against its plain version."""
    from gcn_tpu_torch import constants as C
    from gcn_tpu_torch.ops import grouped_matmul as mod
    from gcn_tpu_torch.ops.gcn_layers import make_group_plan

    deprel = torch.tensor(batch["deprel"], dtype=torch.long)
    r = len(C.DEPREL_TO_ID) + 2
    s = -(-deprel.shape[1] // k)
    ids = torch.where(deprel == 0, r - 1, deprel)[:, :s]
    gs = make_group_plan(ids, r).group_sizes.to(dev)
    m, t, h = ids.numel(), 400, 200
    rng = np.random.RandomState(SEED)
    x = torch.tensor(rng.uniform(-1, 1, (m, t)), dtype=torch.float32,
                     device=dev)
    w = torch.tensor(rng.randn(r, t, h) / np.sqrt(t), dtype=torch.float32,
                     device=dev)
    err = max_err(mod.grouped_matmul(x, w, gs),
                  mod.grouped_matmul_plain(x, w, gs))
    empty = int((gs == 0).sum())
    return {"shape": {"M": m, "T": t, "H": h, "R": r,
                      "groups_used": r - empty, "groups_empty": empty},
            "max_abs_err": err, "tol": TOL_F32,
            "ms": time_ms(lambda: mod.grouped_matmul(x, w, gs), 10),
            "ok": err <= TOL_F32 and empty > 0}


def partition_rank(rank: int, tmp: str, port: int) -> int:
    """One rank of the 1 × 2 world over gloo on the one card (``python3
    chip_smoke.py --partition-rank R DIR PORT``, started by
    ``run_partition``): for each mode and path, ``DP_STEPS`` steps on all
    rows of the inputs in ``DIR`` (with their halo plans under halo), the
    evaluation, timed steps, the exchanges and the peak memory; rank 0
    also ``slab_gmm``.  Each rank writes its results."""
    import gc
    import pickle

    import torch

    sys.path.insert(0, HERE)
    from gcn_tpu_torch.config import Config
    from gcn_tpu_torch.data.sharding import ShardedBatcher
    from gcn_tpu_torch.parallel import distributed
    from gcn_tpu_torch.parallel.halo import EXCHANGES, attach_halo_plans
    from gcn_tpu_torch.train.distributed_trainer import DistributedTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.initialize(f"localhost:{port}", 2, rank, backend="gloo")
    with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
        cfgs, batches, evals, dev = pickle.load(f)
    dev = torch.device(dev)
    out = {}
    for (mode, path), cfg in cfgs.items():
        state = torch.load(os.path.join(tmp, f"{path}.pt"),
                           weights_only=True)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tr = DistributedTrainer(Config.from_dict(cfg), state, device=dev,
                                backend="gloo")
        d, size, k = tr.groups.data_index, tr.mesh.data, tr.mesh.model

        def planned(bs):
            if mode != "halo":
                return bs
            return [attach_halo_plans(b, b["words"].shape[1], k) for b in bs]

        local = list(ShardedBatcher(GlobalBatches(planned(batches), B), d,
                                    size))
        EXCHANGES.reset()
        losses, launches = counted(
            lambda: [float(tr.update(b)) for b in local[:DP_STEPS]])
        exchanges = {"calls_per_step": EXCHANGES.calls / DP_STEPS,
                     "bytes_per_step": EXCHANGES.bytes / DP_STEPS}
        params = {k: v.cpu().clone() for k, v in
                  tr.model.state_dict().items()}
        preds, probs, eval_loss = tr.evaluate(
            ShardedBatcher(GlobalBatches(planned(evals), B), d, size))

        def epoch():
            for b in local:
                tr.update(b)

        epoch()
        walls = epoch_walls(torch, epoch)
        torch.cuda.synchronize()
        out[mode, path] = {
            "losses": losses, "launches": launches, "params": params,
            "preds": preds, "probs": np.asarray(probs),
            "eval_loss": eval_loss, "mesh": tr.mesh.shape,
            "graphs_on": tr._graphs_on(), "backend": tr.backend,
            "ms_per_step": min(walls) / len(local) * 1e3, "walls_s": walls,
            "exchange": exchanges,
            "max_memory_allocated_mib":
            torch.cuda.max_memory_allocated() / 2**20}
        if mode == "halo" and path == "cgcn" and rank == 0:
            out["slab_gmm"] = slab_gmm(torch, batches[0], dev, k)
        del tr
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    distributed.shutdown()
    return 0


def run_partition(torch, dev, synth_train, synth, vocab_size,
                  parallel: dict) -> dict:
    """The partition phase (``graph_partition`` "edges" and "halo" on a
    1 × 2 mesh of two gloo ranks sharing the card, ``cgcn`` and
    ``cgcn_attn`` at B=50, N=96) against ``Trainer`` unpartitioned; fails
    on any miss.  Both ranks share one card, so its ms show no speed-up:
    a correctness gate."""
    import pickle

    from gcn_tpu_torch.models.gcn import GCNClassifier, init_params
    from gcn_tpu_torch.train.trainer import Trainer

    batches = synth_train
    out = {"phase": "partition", "mesh": {"data": 1, "model": 2},
           "backend": "gloo", "batches": len(batches),
           "gloo_data_parallel_ms_per_step":
           parallel["gloo_world_2_one_card"]["ms_per_step"]}
    cfgs, states, refs = {}, {}, {}
    for path in PARTITION_PATHS:
        cfg = partition_cfg(path, vocab_size, "edges")
        model = GCNClassifier(cfg.model)
        init_params(model, torch.Generator().manual_seed(SEED))
        states[path] = model.state_dict()
        for mode in PARTITION_MODES:
            cfgs[mode, path] = partition_cfg(path, vocab_size,
                                             mode).to_dict()
        # Trainer never partitions: the dense path, whatever the config
        ref = Trainer(cfg, states[path], device=dev)
        losses = [float(ref.update(b)) for b in batches[:DP_STEPS]]
        preds, probs, loss = ref.evaluate(synth)
        with eager_dispatch():
            eager_ms = trainer_speed(torch, Trainer(cfg, states[path],
                                                    device=dev),
                                     batches)["ms_per_step"]
        refs[path] = (losses, {k: v.cpu().clone() for k, v in
                               ref.model.state_dict().items()},
                      preds, np.asarray(probs), loss, eager_ms)
        del ref
    with tempfile.TemporaryDirectory() as tmp:
        for path, state in states.items():
            torch.save(state, os.path.join(tmp, f"{path}.pt"))
        with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
            pickle.dump((cfgs, batches, synth, str(dev)), f)
        spawn_ranks("--partition-rank", tmp)
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False) for r in range(2)]
    bad = []
    n_layers = cfgs["halo", "cgcn"]["model"]["num_layers"]
    for mode in PARTITION_MODES:
        out[mode] = {}
        expected = PARTITION_EXPECTED if mode == "edges" else HALO_EXPECTED
        for path in PARTITION_PATHS:
            (ref_losses, ref_params, ref_preds, ref_probs, ref_loss,
             eager_ms) = refs[path]
            res = ranks[0][mode, path]
            loss_err = max(abs(x - y) / abs(y)
                           for x, y in zip(res["losses"], ref_losses))
            param_err = max(max_err(res["params"][k], ref_params[k])
                            / max(1.0, float(ref_params[k].abs().max()))
                            for k in ref_params)
            same = all(torch.equal(v, ranks[1][mode, path]["params"][k])
                       for k, v in res["params"].items())
            flipped, ties = flips(res["preds"], ref_preds, ref_probs)
            calls = res["exchange"]["calls_per_step"]
            row = {"mesh": res["mesh"], "backend": res["backend"],
                   "graphs": res["graphs_on"], "steps": DP_STEPS,
                   "launches_per_step_rank0": check_launches(
                       f"{path} {mode} partition", "train step",
                       res["launches"], expected[path], DP_STEPS),
                   "loss_rel_err": loss_err, "param_err": param_err,
                   "tol": TOL_TRAIN, "ranks_same_bits": same,
                   "eval_rows": len(ref_preds),
                   "eval_predictions_unlike": len(flipped),
                   "eval_near_ties": len(ties),
                   "eval_probs_err": float(np.abs(res["probs"]
                                                  - ref_probs).max()),
                   "eval_loss_rel_err": abs(res["eval_loss"] - ref_loss)
                   / abs(ref_loss),
                   "ms_per_step": res["ms_per_step"],
                   "walls_s": res["walls_s"],
                   "trainer_eager_ms_per_step": eager_ms,
                   "exchanges_per_step": calls,
                   "exchange_bytes_per_step_rank0":
                   res["exchange"]["bytes_per_step"],
                   "max_memory_allocated_mib": [
                       r[mode, path]["max_memory_allocated_mib"]
                       for r in ranks]}
            out[mode][path] = row
            if (res["mesh"] != out["mesh"] or res["backend"] != "gloo"
                    or res["graphs_on"]
                    or max(loss_err, param_err) > TOL_TRAIN or not same
                    or len(ties) < len(flipped)
                    or len(res["preds"]) != len(ref_preds)
                    or calls != (2 * n_layers if mode == "halo" else 0)):
                bad.append((mode, path))
    out["halo_slab_gmm_rank0"] = ranks[0]["slab_gmm"]
    if not ranks[0]["slab_gmm"]["ok"]:
        bad.append(("halo", "slab_gmm"))
    out["summary"] = {path: {
        "trainer_eager_ms_per_step": out["edges"][path][
            "trainer_eager_ms_per_step"],
        **{f"{mode}_ms_per_step": out[mode][path]["ms_per_step"]
           for mode in PARTITION_MODES},
        "halo_exchange_bytes_per_step":
        out["halo"][path]["exchange_bytes_per_step_rank0"],
        **{f"{mode}_max_memory_allocated_mib":
           out[mode][path]["max_memory_allocated_mib"]
           for mode in PARTITION_MODES}} for path in PARTITION_PATHS}
    if bad:
        fail(f"partition: the 1 x 2 world disagrees with Trainer on {bad}: "
             f"{out}")
    return out


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
# and each bf16 instance's
HOME_PATH_BF16 = {**{k: "cgcn_bf16" for k in (
    "lstm_scan_forward", "lstm_scan_backward", "grouped_matmul_forward",
    "grouped_matmul_backward")},
    "band_aggregate_forward": "cgcn_fused_bf16",
    "band_aggregate_pair": "cgcn_fused_bf16",
    "spmm_fused_forward": "gcn_fused_bf16",
    "spmm_fused_sym_pair": "gcn_fused_bf16",
    "sddmm_forward": "cgcn_attn_bf16", "sddmm_backward": "cgcn_attn_bf16",
    "deprel_bilinear_v2": "cgcn_bilinear_bf16",
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
    ptxas = {k: ptxas_by_function(v["log"]) for k, v in report.items()}
    emit({"phase": "build", "seconds": build_s,
          "per_source_s": {k: v["seconds"] for k, v in report.items()},
          "ptxas": ptxas})

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
    rows = (check_lstm(torch, rng, dev, ptxas["lstm_scan"])
            + check_gmm(torch, rng, dev, gs, ptxas["grouped_matmul"])
            + check_lstm_backward(torch, rng, dev,
                                  ptxas["lstm_scan_backward"])
            + check_gmm_backward(torch, rng, dev, gs,
                                 ptxas["grouped_matmul_backward"])
            + check_band(torch, rng, dev, edges, ptxas["band_aggregate"])
            + check_spmm(torch, rng, dev, edges, ptxas["spmm_fused"])
            + check_sddmm(torch, rng, dev, edges, ptxas["sddmm"]))
    bilinear_rows, v1_launches = check_bilinear(
        torch, rng, dev, ptxas["deprel_bilinear"])
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
    inputs["packed"] = load_packed()
    slices, trains = {}, {}
    for path in PATHS:
        real, synth, real_train, synth_train, vocab_size = inputs[
            INPUTS.get(path, "tacred")]
        slices[path] = run_slice(torch, dev, real, synth, vocab_size, path)
        emit({**slices[path], "at_s": time.perf_counter() - t_start})
        trains[path] = run_train(torch, dev, real_train, synth_train,
                                 vocab_size, path)
        emit({**trains[path], "at_s": time.perf_counter() - t_start})
    real, synth, real_train, synth_train, vocab_size = inputs["tacred"]
    emit({**run_dispatch(torch, dev, real, synth, real_train, synth_train,
                         vocab_size), "nvidia_smi": smi,
          "at_s": time.perf_counter() - t_start})
    cli = run_cli(torch)
    emit({**cli, "nvidia_smi": smi, "at_s": time.perf_counter() - t_start})
    emit({**run_reference(torch, dev), "nvidia_smi": smi,
          "at_s": time.perf_counter() - t_start})
    emit({**run_sparse(torch, dev, synth_train), "nvidia_smi": smi,
          "at_s": time.perf_counter() - t_start})
    parallel = run_parallel(torch, dev, synth_train, synth, vocab_size)
    emit({**parallel, "nvidia_smi": smi,
          "at_s": time.perf_counter() - t_start})
    emit({**run_partition(torch, dev, synth_train, synth, vocab_size,
                          parallel),
          "nvidia_smi": smi, "at_s": time.perf_counter() - t_start})
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    line = []
    for row in rows:
        kernel = kernel_of(row["name"])
        dtype = row.get("dtype", "float32")
        home = (HOME_PATH if dtype == "float32" else HOME_PATH_BF16)[kernel]
        row["launches"] = (v1_launches[dtype] if home is None
                           else trains[home]["launches"][kernel])
        # the launches of this row's instance: on the paths of its dtype
        by_path = {
            path: {"eval_forward":
                   slices[path]["launches_per_forward"][kernel],
                   "train_step": trains[path]["launches_per_step"][kernel]}
            for path in PATHS if path_dtype(path) == dtype}
        line.append({**{k: row[k] for k in keys}, "dtype": dtype,
                     **{k: row[k] for k in ("bound_f32_ms", "library_sgemm_ms")
                        if k in row},
                     "launches_path": home or "kernel phase",
                     "launches_by_path": by_path,
                     **({"launches_cli": cli["launches"][kernel]}
                        if dtype == "float32" else {})})
    emit({"kernels": line})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:
        sys.exit(parallel_rank(int(sys.argv[2]), sys.argv[3],
                               int(sys.argv[4])))
    if sys.argv[1:2] == ["--partition-rank"]:
        sys.exit(partition_rank(int(sys.argv[2]), sys.argv[3],
                                int(sys.argv[4])))
    sys.exit(main())
