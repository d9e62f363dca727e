"""The two jobs a cell runs, each in four stages: set-up, the measured
window, the traced sub-window (``--trace 1``), and the check against the
plain reference once the program's state is freed.

Train (``traffic`` job "train"): the records are loaded through the
program's ``RelationDataset`` and ``Batcher`` (shuffled, word dropout per
batch), the weights handed to a ``Trainer``, every batch shape's graphs
captured (``Trainer.warmup``); then the first ``CHECKED_STEPS`` batches go
through ``Trainer.update_chunk`` with the parameters copied to the host
after the first and the last of them (a training mix's ``shuffle_seed``
puts a batch of each of its length buckets among them, so every graph the
window replays is held to the reference).  The window carries on with the same
trainer and batch stream, a step at a time as ``train/driver.py``'s epoch loop
drives it, batches built inside the window; a CUDA event after each
update, read once the window has closed.  The reference then follows the
checked steps from the same weights and records.

Eval (job "eval"): an ``Evaluator`` over the split in file order, its
graphs captured, one pass in set-up (it builds and caches the batches, as
the training driver's first epoch does); the window repeats whole passes of
``Evaluator.evaluate``; the reference scores the whole split once and
every pass's every answer is held to it.
"""

from __future__ import annotations

import gc
import os
import tempfile
import time

import numpy as np

from portbench import flops, generator, trace
from portbench.reference import data as rdata
from portbench.reference import model as rmodel
from portbench.reference import tacred_ids as ids

CHECKED_STEPS = 3
PROFILED_STEPS = 64     # train steps in the traced sub-window
PROFILED_BATCHES = 64   # evaluation batches in the traced sub-window
REF_EVAL_ROWS = 500     # rows of a reference evaluation block


def step_seed(seed: int, step: int) -> int:
    """The 64-bit seed of training step ``step``'s dropout stream (the
    program's documented derivation, from the run's training seed)."""
    return int(np.random.SeedSequence([seed % 2**63, step]).generate_state(
        1, np.uint64)[0])


def program_config(cell, seeds):
    """The program's ``Config``: the file's preset with every stated
    value; raises where a stated value does not take."""
    from gcn_tpu_torch import config as pconfig

    c = cell.config
    over = {f"model.{k}": v for k, v in c["model"].items()}
    over.update({f"train.{k}": v for k, v in c["train"].items()})
    over["train.seed"] = seeds.train
    cfg = getattr(pconfig, c["preset"])(**over)
    for k, v in over.items():
        sect, name = k.split(".")
        if getattr(getattr(cfg, sect), name) != v:
            raise ValueError(f"{k} does not take: {v!r}")
    return cfg


def _kernels() -> list:
    """Every CUDA kernel object of the program."""
    from gcn_tpu_torch.ops import (_cuda, band_aggregate, deprel_bilinear,
                                   grouped_matmul, lstm_scan, sddmm,
                                   spmm_fused)

    return [v for mod in (lstm_scan, grouped_matmul, band_aggregate,
                          spmm_fused, sddmm, deprel_bilinear)
            for v in vars(mod).values() if isinstance(v, _cuda.CudaKernel)]


def launch_counts() -> dict:
    """Each kernel function's launches so far, graph replays included."""
    out: dict = {}
    for k in _kernels():
        for f, n in k.by_function.items():
            out[f] = out.get(f, 0) + n
    return out


def shape_sums(batch: dict) -> tuple[int, int, int]:
    """(real tokens, kept edges, real sentences) of a program batch."""
    return (int(batch["lengths"].sum()), int(batch["edge_mask"].sum()),
            int(batch["example_mask"].sum()))


def batch_shape(batch: dict) -> flops.BatchShape:
    """A program batch's real sentences' lengths and the relation groups
    its real tokens use in the two bands."""
    real = batch["example_mask"].astype(bool)
    lengths = batch["lengths"][real]
    mask = ~batch["pad_mask"][real]
    dep = batch["deprel"][real][mask]
    groups = np.unique(np.concatenate([
        np.where(dep == 0, ids.DEPREL_ROWS + 1, dep),   # padding: zero row
        dep + ids.DEPREL_FORWARD_BOUND]))
    return flops.BatchShape(lengths=[int(x) for x in lengths],
                            groups=int(len(groups)))


class Job:
    """State shared by the stages; ``view`` is what the metric readers
    get."""

    def __init__(self, cell, seeds, device, sentences=None):
        self.cell, self.seeds, self.device = cell, seeds, device
        self.m, self.t = cell.config["model"], cell.config["train"]
        self.rows = int(cell.traffic["batch_size"])
        self.sentences = sentences
        self.vocab = generator.vocabulary(int(self.m["vocab_size"]))
        self.view = {"job": cell.traffic["job"], "model": self.m,
                     "spans": {}, "window": {}, "trace": None}
        self.stages: dict = {}
        self._at = time.perf_counter()

    def stage(self, name: str) -> None:
        """Close the set-up stage ``name`` (host seconds since the last)."""
        now = time.perf_counter()
        self.stages[name] = now - self._at
        self._at = now

    def load(self, evaluation: bool):
        """The mix's records (kept for the reference), written to a file
        under ``TMPDIR`` and loaded by the program's ``RelationDataset``,
        as ``train.py`` loads a split; (program config, dataset)."""
        from gcn_tpu_torch.data.dataset import RelationDataset
        from gcn_tpu_torch.data.vocab import Vocab

        self._at = time.perf_counter()
        self.recs = generator.make_records(self.cell.traffic, self.seeds.data,
                                           len(self.vocab), self.sentences)
        self.stage("generate")
        cfg = program_config(self.cell, self.seeds)
        with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
            path = os.path.join(tmp, "split.json")
            generator.write_records(self.recs, path)
            ds = RelationDataset(path, cfg, Vocab(self.vocab),
                                 evaluation=evaluation)
        return cfg, ds

    def profile(self, torch, body):
        """``body(span)`` under the profiler inside ``portbench.window``
        (``span(name)`` a harness span), synchronised at both ends; the
        reduced trace."""
        from torch.profiler import ProfilerActivity, profile, record_function

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(trace.WINDOW):
                body(lambda name: record_function(trace.SPAN + name))
                torch.cuda.synchronize()
        return trace.reduce_events(trace.profiler_events(prof, torch))


class TrainJob(Job):
    def setup(self, torch):
        from gcn_tpu_torch.data.dataset import Batcher
        from gcn_tpu_torch.train.trainer import Trainer

        cfg, ds = self.load(evaluation=False)
        # the mix's shuffle (and word-dropout stream), not the run's: every
        # seed trains the same sequence of batch shapes
        self.batcher = Batcher(ds, self.rows,
                               seed=int(self.cell.traffic["shuffle_seed"]))
        self.stage("load")
        self.p0 = rmodel.make_weights(self.m, self.seeds.weights, self.device)
        self.trainer = Trainer(cfg, state_dict=self.p0, device=self.device)
        self.stage("weights")
        self.trainer.warmup(self.batcher.warmup_batches(), eval_batches=[])
        self.stage("capture")
        self.p0 = {k: v.cpu() for k, v in self.p0.items()}
        self.stream = self._batches()
        losses, self.checked_widths = [], []
        for i in range(CHECKED_STEPS):
            batch = next(self.stream)
            self.checked_widths.append(int(batch["words"].shape[1]))
            losses.append(self.trainer.update_chunk([batch])[0])
            if i == 0:
                self.p1 = self._snapshot()
        self.p3 = self._snapshot()
        self.losses = [float(x) for x in losses]
        self.stage("checked steps")

    def _batches(self):
        while True:
            yield from self.batcher

    def _snapshot(self):
        return {k: v.detach().to("cpu", copy=True)
                for k, v in self.trainer.params.items()}

    def window(self, torch, seconds, sync):
        ev = [torch.cuda.Event(enable_timing=True)] if sync else []
        if sync:
            ev[0].record()
        data_s, upd_s, sums, losses = [], [], [], []
        trainer, stream = self.trainer, self.stream
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            a = time.perf_counter()
            if a >= deadline:
                break
            batch = next(stream)
            b = time.perf_counter()
            losses.append(trainer.update_chunk([batch])[0])
            c = time.perf_counter()
            if sync:
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                ev.append(e)
            data_s.append(b - a)
            upd_s.append(c - b)
            sums.append(shape_sums(batch))
        if sync:
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        # on the CPU (tests) every call is synchronous: the host's times
        step_ms = ([ev[i - 1].elapsed_time(ev[i]) for i in range(1, len(ev))]
                   if sync else [1e3 * (a + b) for a, b in zip(data_s, upd_s)])
        sent = sum(s[2] for s in sums)
        bad = sum(1 for x in torch.stack(losses).tolist()
                  if not np.isfinite(x)) if losses else 0
        self.view["spans"] = {"data": data_s, "update": upd_s}
        self.view["window"] = {"seconds": elapsed, "sums": sums,
                               "sentences": sent}
        return {"steps": len(sums), "failed": bad, "seconds": elapsed,
                "sentences": sent, "step_ms": step_ms}

    def traced(self, torch):
        kept = []

        def body(span):
            for _ in range(PROFILED_STEPS):
                with span("data"):
                    batch = next(self.stream)
                with span("update"):
                    self.trainer.update_chunk([batch])
                kept.append(batch)

        red = self.profile(torch, body)
        red["shapes"] = [batch_shape(b) for b in kept]
        self.view["trace"] = red
        return red

    def free(self, torch):
        del self.trainer, self.batcher, self.stream
        gc.collect()
        torch.cuda.empty_cache()

    def reference(self, torch, variant=None):
        """The reference's checked steps from the same weights and
        records; the numbers compared.  ``variant`` puts the reference in
        the program's place, against itself in f32: "tf32" (the control:
        its products in TF32) or "half" (a fault: each step's loss over
        the first half of the batch's rows)."""
        ref = self._reference_steps(torch)
        if variant is None:
            prog = (self.losses, self.p1, self.p3)
        else:
            prog = self._reference_steps(torch, tf32=variant == "tf32",
                                         half=variant == "half")
        return compare_steps(self.p0, prog, ref, float(self.t["lr"]))

    def _reference_steps(self, torch, tf32=False, half=False):
        with tf32_mode(torch, tf32):
            word2id = {w: i for i, w in enumerate(self.vocab)}
            shuffle = int(self.cell.traffic["shuffle_seed"])
            chunks = rdata.train_chunks(len(self.recs), self.rows, shuffle)
            # epochs wrap round the chunks, each with its own word dropout
            chunks = [chunks[i % len(chunks)] for i in range(CHECKED_STEPS)]
            rng = np.random.RandomState(shuffle)
            params = {k: v.to(self.device) for k, v in self.p0.items()}
            losses, p1 = [], None
            for step, chunk in enumerate(chunks):
                sents = [rdata.sentence(self.recs[i], word2id,
                                        int(self.m["prune_k"]))
                         for i in chunk]
                words = rdata.word_dropout(sents, float(
                    self.t["word_dropout"]), rng)
                batch = rdata.batch(sents, words, self.rows, self.device)
                if half:
                    batch["valid"][self.rows // 2:] = False
                gen = torch.Generator(device=self.device).manual_seed(
                    step_seed(self.seeds.train, step))
                losses.append(rmodel.sgd_step(params, self.m, self.t, batch,
                                              gen))
                if step == 0:
                    p1 = {k: v.cpu() for k, v in params.items()}
            return losses, p1, {k: v.cpu() for k, v in params.items()}


def _norm(t) -> float:
    return float(np.linalg.norm(t.double().numpy().ravel()))


def compare_steps(p0, prog, ref, lr):
    """The numbers the training check compares, each a gap between the
    program's reading and the reference's over the reference's:

    * ``loss_first`` and ``loss``: the first checked step's loss, and the
      widest of the checked steps';
    * ``grad``: the gap between the norms of each leaf's first gradient as
      the optimizer applied it ((p0 - p1) / lr), over the reference's
      norm of that leaf or of the median leaf, whichever is larger: the
      median leaf's gap; ``grad_worst``: the worst leaf's;
    * ``change`` and ``change_worst``: the same of each leaf's change over
      the checked steps.

    Leaves whose reference gradient is under a thousandth of the median
    leaf's are left out.  The worst leaf's gaps swing with a ReLU or a
    max-pooling choice that rounding flips (one flip moves a small leaf's
    gradient by a few per cent), so the check compares the median's."""
    (lp, p1, p3), (lr_, r1, r3) = prog, ref
    gaps = [abs(a - b) / abs(b) for a, b in zip(lp, lr_)]
    g_ref = {k: _norm((p0[k] - r1[k]) / lr) for k in p0}
    g_prog = {k: _norm((p0[k] - p1[k]) / lr) for k in p0}
    med = float(np.median(list(g_ref.values())))
    leaves = [k for k in p0 if g_ref[k] >= 1e-3 * med]
    d_ref = {k: _norm(r3[k] - p0[k]) for k in leaves}
    d_prog = {k: _norm(p3[k] - p0[k]) for k in leaves}
    d_med = float(np.median(list(d_ref.values())))

    def per_leaf(a, b, m):
        return {k: abs(a[k] - b[k]) / max(b[k], m) for k in leaves}

    g_gap = per_leaf(g_prog, g_ref, med)
    c_gap = per_leaf(d_prog, d_ref, d_med)
    g_worst = max(g_gap, key=g_gap.get)
    c_worst = max(c_gap, key=c_gap.get)
    return {"loss_first": gaps[0], "loss": max(gaps),
            "grad": float(np.median(list(g_gap.values()))),
            "change": float(np.median(list(c_gap.values()))),
            "grad_worst": g_gap[g_worst], "grad_worst_leaf": g_worst,
            "change_worst": c_gap[c_worst], "change_worst_leaf": c_worst,
            "left_out": sorted(set(p0) - set(leaves))}


class tf32_mode:
    """Matrix products in f32 (``tf32=False``) or TF32 inside the block."""

    def __init__(self, torch, tf32: bool):
        self.torch, self.tf32 = torch, tf32

    def __enter__(self):
        b = self.torch.backends
        self.saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32)
        b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = self.tf32

    def __exit__(self, *exc):
        b = self.torch.backends
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = self.saved


class EvalJob(Job):
    def setup(self, torch):
        from gcn_tpu_torch.data.dataset import Batcher
        from gcn_tpu_torch.train.evaluator import Evaluator

        cfg, ds = self.load(evaluation=True)
        self.batcher = Batcher(ds, self.rows, evaluation=True)
        self.stage("load")
        self.p0 = rmodel.make_weights(self.m, self.seeds.weights, self.device)
        self.evaluator = Evaluator(cfg, self.p0, device=self.device)
        self.stage("weights")
        if self.device.type == "cuda":
            for b in self.batcher.warmup_batches():
                self.evaluator.warmup(b)
        self.stage("capture")
        self.p0 = {k: v.cpu() for k, v in self.p0.items()}
        self.passes = [self.evaluator.evaluate(self.batcher)]
        self.stage("first pass")
        sums = [shape_sums(b) for b in self.batcher]
        self.pass_sums = sums
        self.n = sum(s[2] for s in sums)

    def window(self, torch, seconds, sync):
        passes = []
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while time.perf_counter() < deadline:
            a = time.perf_counter()
            passes.append(self.evaluator.evaluate(self.batcher))
            self.view["spans"].setdefault("evaluate", []).append(
                time.perf_counter() - a)
        elapsed = time.perf_counter() - t0
        self.passes += passes
        sent = self.n * len(passes)
        bad = sum(int(not np.all(np.isfinite(np.asarray(p[1]))))
                  for p in passes)
        self.view["window"] = {"seconds": elapsed,
                               "sums": self.pass_sums * len(passes),
                               "sentences": sent}
        return {"steps": len(passes), "failed": bad, "seconds": elapsed,
                "sentences": sent, "step_ms": []}

    def traced(self, torch):
        batches = list(self.batcher)[:PROFILED_BATCHES]

        def body(span):
            with span("evaluate"):
                self.evaluator.evaluate(batches)

        red = self.profile(torch, body)
        red["shapes"] = [batch_shape(b) for b in batches]
        self.view["trace"] = red
        return red

    def free(self, torch):
        del self.evaluator, self.batcher
        gc.collect()
        torch.cuda.empty_cache()

    def reference(self, torch, variant=None):
        """Every pass's answers against the reference's on the whole
        split: ``prob``, the widest gap of a probability; ``loss``, the
        widest relative gap of a pass's mean loss.  ``variant`` "tf32":
        the reference in TF32 in the program's place (the control)."""
        probs, loss = self._reference_scores(torch, tf32=False)
        if variant == "tf32":
            passes = [self._reference_scores(torch, tf32=True)]
        else:
            passes = [(np.asarray(p[1], np.float64), p[2])
                      for p in self.passes]
        prob = max(float(np.abs(p - probs).max()) for p, _ in passes)
        lgap = max(abs(l - loss) / abs(loss) for _, l in passes)
        return {"prob": prob, "loss": lgap, "passes": len(passes)}

    def _reference_scores(self, torch, tf32: bool):
        """(probabilities [n, C], the mean loss as ``Evaluator.evaluate``
        weighs it: each file-order batch's mean × its rows over n)."""
        with tf32_mode(torch, tf32):
            word2id = {w: i for i, w in enumerate(self.vocab)}
            params = {k: v.to(self.device) for k, v in self.p0.items()}
            probs, ce = [], []
            n = len(self.recs)
            for a in range(0, n, REF_EVAL_ROWS):
                sents = [rdata.sentence(r, word2id, int(self.m["prune_k"]))
                         for r in self.recs[a:a + REF_EVAL_ROWS]]
                batch = rdata.batch(sents, [s.words for s in sents],
                                    len(sents), self.device)
                p, loss = rmodel.scores(params, self.m, batch)
                probs.append(p.cpu().numpy())
                ce.append(loss.cpu().numpy())
            probs, ce = np.concatenate(probs), np.concatenate(ce)
            means = [ce[a:a + self.rows].mean()
                     for a in range(0, n, self.rows)]
            return probs, float(sum(means)) / n * self.rows


JOBS = {"train": TrainJob, "eval": EvalJob}
