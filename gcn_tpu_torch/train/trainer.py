"""Training entry point: one optimizer step per batch, or accumulated.

Counterpart of the training half of ``gcn_tpu.train.trainer.Trainer``:

* the loss is the f32 cross-entropy over the batch's valid rows
  (``example_mask``), plus ``conv_l2`` times the squared GCN transform
  weights and ``pooling_l2`` times the squared sentence pooling output of
  the valid rows (``parallel.train_step.make_loss_fn``);
* ``update`` runs the stochastic forward and its backward (the CUDA
  backward kernels on the card) and, when ``update_gap <= 1``, one
  freeze → clip → optimizer step; otherwise it sums the gradients and
  steps in ``flush_gradients`` after ``update_gap`` batches;
* row-sparse word-table updates (``train.sparse_emb``), as gcn_tpu's
  ``sparse_emb_grad``: "true" (sgd or adagrad/myadagrad, word ids,
  ``update_gap <= 1``; else ``ValueError``), "false", or "auto" = on for
  those configurations from ``SPARSE_EMB_AUTO_VOCAB`` rows.  A fused step
  then gathers the batch's rows outside the differentiated loss, the
  table gets no gradient, and only its touched rows are updated;
* ``update_chunk`` takes k same-shape batches as k fused steps in
  ``chunk_plan`` pieces of at most ``steps_per_dispatch`` (gcn_tpu's
  ``_chunk_step``): the same steps as k ``update`` calls;
* on the card a fused step (``update_gap <= 1``) is a replay of a CUDA
  graph captured per batch signature and dispatch size
  (``train.dispatch``), its batch moved in by ``train.transfer`` (one
  pinned copy where it packs, a cross-sentence-packed batch in the
  sentence format, one step a replay); a piece of k is one replay of a
  k-step graph.  Accumulating steps, the CPU, ``eager_dispatch()`` and a model
  that a graph cannot hold (``GCNClassifier.capturable``) run step by
  step;
* the dropout stream of step s is a ``torch.Generator`` seeded from
  ``(seed, s)``, as JAX folds the step into its key, so a run restarted at
  step s draws the same masks (a graph's step slot is reseeded so);
* ``warmup`` captures the graphs a run will need before it starts and
  leaves the trainer's state as it was;
* ``predict_batch`` and ``evaluate`` run the ``Evaluator`` code on the same
  module;
* ``save`` and ``load`` write and read checkpoints in gcn_tpu's format
  (``train.checkpoint``), so a run of either package resumes in the other.
  A checkpoint holds the parameters before any pending accumulated
  gradients: its ``global_step`` counts only the batches applied, so a
  resumed run replays the pending ones with the same dropout streams.

``update`` returns the loss as a device tensor of its own (a graph's output
is copied out before the next replay) and does not synchronise.
"""

from __future__ import annotations

import time
from typing import Iterable, Optional

import numpy as np
import torch

from gcn_tpu_torch.config import Config
from gcn_tpu_torch.convert import params_from_jax, params_to_jax
from gcn_tpu_torch.models.gcn import GCNClassifier, init_params
from gcn_tpu_torch.parallel.train_step import (  # noqa: F401 (re-exported)
    conv_l2_penalty,
    make_loss_fn,
)
from gcn_tpu_torch.train import checkpoint as ckpt
from gcn_tpu_torch.train import sparse_emb
from gcn_tpu_torch.train.dispatch import (
    GraphCache,
    allowed_chunk_sizes,
    chunk_plan,
    graphs_on,
)
from gcn_tpu_torch.train.evaluator import (
    Evaluator,
    batch_to_device,
    resolve_device,
)
from gcn_tpu_torch.train.optim import build_optimizer, set_learning_rate
from gcn_tpu_torch.train.transfer import Staging

RING_SLOTS = 4  # pinned batch buffers: the host runs up to 4 steps ahead
# gcn_tpu's vocabulary size from which "auto" takes the row-sparse update
# (its crossover measured on a TPU; the card's is in PERF.md)
SPARSE_EMB_AUTO_VOCAB = 300_000


def step_seed(seed: int, step: int) -> int:
    """The 64-bit seed of step ``step``'s dropout stream."""
    return int(np.random.SeedSequence([seed % 2**63, step]).generate_state(
        1, np.uint64)[0])


def _signature(batch: dict) -> tuple:
    """Every field's name, shape and dtype: one representative a
    signature is enough for a warm-up."""
    return tuple(sorted((k, np.shape(v), np.asarray(v).dtype.str)
                        for k, v in batch.items()))


class Trainer:
    """Holds the model and optimizer state on ``device`` (the card by
    default; ``device="cpu"`` runs the kernels' plain versions).
    ``state_dict`` (e.g. ``convert.params_from_jax`` of a flax tree)
    replaces the seeded initialization; ``emb_matrix`` replaces the word
    table (a model on precomputed word vectors has none, and refuses
    it)."""

    def __init__(self, cfg: Config, state_dict: Optional[dict] = None,
                 emb_matrix: Optional[np.ndarray] = None,
                 rng_seed: Optional[int] = None, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.seed = cfg.train.seed if rng_seed is None else rng_seed
        model = GCNClassifier(cfg.model)
        if state_dict is None:
            init_params(model, torch.Generator().manual_seed(self.seed))
        else:
            model.load_state_dict(state_dict)
        if emb_matrix is not None:
            if cfg.model.use_bert_embeddings:
                raise ValueError("use_bert_embeddings: the model has no "
                                 "word table for emb_matrix to replace")
            emb = torch.as_tensor(np.asarray(emb_matrix), dtype=torch.float32)
            if emb.shape != model.word_emb.shape:
                raise ValueError(f"embedding matrix {tuple(emb.shape)} vs "
                                 f"vocab {tuple(model.word_emb.shape)}")
            with torch.no_grad():
                model.word_emb.copy_(emb)
        self.model = model.to(self.device)
        self.params = dict(self.model.named_parameters())
        self._loss_fn = make_loss_fn(self.model, cfg)
        mode = str(cfg.train.sparse_emb_grad).lower()
        eligible = (sparse_emb.supported(cfg.train.optim)
                    and not cfg.model.use_bert_embeddings
                    and cfg.train.update_gap <= 1)
        if mode == "true" and not eligible:
            raise ValueError(
                "--sparse_emb_grad true requires a row-local optimizer "
                "(sgd/adagrad), integer word inputs (not BERT) and "
                f"update_gap == 1; got optim={cfg.train.optim}, "
                f"bert={cfg.model.use_bert_embeddings}, "
                f"update_gap={cfg.train.update_gap}")
        self._sparse_emb = mode == "true" or (
            mode == "auto" and eligible
            and cfg.model.vocab_size >= SPARSE_EMB_AUTO_VOCAB)
        self.opt = build_optimizer(cfg.train.optim, cfg.train.lr,
                                   max_grad_norm=cfg.train.max_grad_norm,
                                   topn=cfg.model.topn,
                                   external_clip=self._sparse_emb)
        self.opt.init(self.params)
        self.current_lr = cfg.train.lr
        self.global_step = 0
        self._accum: Optional[dict] = None
        self._accum_count = 0
        self._evaluator = Evaluator.for_model(cfg, self.model)
        self.staging = Staging(self.device, cfg.train.pack_transfers
                               and not cfg.model.use_bert_embeddings,
                               cfg.train.pack_format, RING_SLOTS)
        self._graphs = GraphCache(self.staging, self.device)
        self.graphs = self._graphs.graphs  # batch signature → StepGraph

    @property
    def sparse_emb(self) -> bool:
        """Whether fused steps update the word table row-sparsely."""
        return self._sparse_emb

    def _set_sparse_emb(self, flag: bool) -> None:
        """Turn the row-sparse update on or off before any step is
        captured (the optimizer's state keeps its layout)."""
        if flag == self._sparse_emb:
            return
        if self.graphs:
            raise RuntimeError("the sparse mode changes after a capture")
        self._sparse_emb = flag
        self.opt.external_clip = flag

    def _graphs_on(self) -> bool:
        """Whether fused steps replay CUDA graphs (``dispatch.graphs_on``)."""
        return graphs_on(self.device, self.model)

    def step_generator(self, step: int) -> torch.Generator:
        """The dropout stream of ``step``, on the trainer's device."""
        return torch.Generator(device=self.device).manual_seed(
            step_seed(self.seed, step))

    def _loss(self, batch: dict, generator):
        """CE over the valid rows + conv and pooling L2 penalties."""
        return self._loss_fn(batch, generator)

    def _grads(self, batch: dict, generator, rows=None):
        """(loss, gradients by parameter name) of one device batch; with
        ``rows`` (the word table's rows at the batch's words, a leaf that
        requires grad) the model takes them for its lookup, and the
        gradients leave out ``word_emb`` and add ``rows``' under
        ``"rows"``."""
        if rows is not None:
            batch = dict(batch, word_vecs=rows)
        loss = self._loss(batch, generator)
        # every parameter but those the model names unused must reach the
        # loss (autograd raises otherwise); those get a zero gradient, as
        # under jax.grad
        skip = set(self.model.unused_params)
        if rows is not None:
            skip.add("word_emb")
        used = [k for k in self.params if k not in skip]
        inputs = [self.params[k] for k in used]
        if rows is not None:
            used.append("rows")
            inputs.append(rows)
        grads = dict(zip(used, torch.autograd.grad(loss, inputs)))
        out = {k: grads[k] if k in grads else torch.zeros_like(p)
               for k, p in self.params.items()
               if rows is None or k != "word_emb"}
        if rows is not None:
            out["rows"] = grads["rows"]
        return loss.detach(), out

    def _reduce(self, loss, grads: dict, ids=None):
        """The step's loss and gradients over every rank's rows (one
        process: as they are), and the word ids of the rows' gradient."""
        return loss, grads, ids

    def _loss_and_grads(self, batch: dict):
        step = self.global_step
        self.global_step += 1
        loss, grads, _ = self._reduce(*self._grads(
            batch_to_device(batch, self.device), self.step_generator(step)))
        return loss, grads

    def _step(self, batch: dict, generator) -> torch.Tensor:
        """One fused optimizer step on a device batch; its loss."""
        if not self._sparse_emb:
            loss, grads, _ = self._reduce(*self._grads(batch, generator))
            self.opt.step(self.params, grads)
            return loss
        words = batch["words"]
        rows = self.params["word_emb"].detach().index_select(
            0, words.reshape(-1)).view(*words.shape, -1).requires_grad_()
        loss, grads, words = self._reduce(
            *self._grads(batch, generator, rows), words)
        g_rows = grads.pop("rows")
        sparse_emb.sparse_step(self.opt, self.params, grads, words, g_rows,
                               topn=self.cfg.model.topn,
                               max_grad_norm=self.cfg.train.max_grad_norm)
        return loss

    def _fused(self) -> bool:
        """Whether the next batch is one whole optimizer step."""
        return self.cfg.train.update_gap <= 1 and self._accum is None

    def _steps(self, static, generators) -> torch.Tensor:
        """Fused steps over a graph's static batches, one a generator (the
        function a train graph captures): their losses [k]."""
        return torch.stack([self._step(self.staging.device_batch(static, i),
                                       gen)
                            for i, gen in enumerate(generators)])

    def _state(self) -> list[torch.Tensor]:
        """Every tensor a fused step changes."""
        return [*self.params.values(), *self.opt.state_tensors()]

    def _replay(self, batches: list) -> list:
        """``len(batches)`` fused steps as one replay; each step's loss."""
        k = len(batches)
        losses = self._graphs.replay(
            batches, self._steps,
            seeds=[step_seed(self.seed, self.global_step + i)
                   for i in range(k)],
            state=self._state())
        self.global_step += k
        return list(losses.clone().unbind(0))

    def update(self, batch: dict) -> torch.Tensor:
        """Forward + backward on one numpy batch; steps the optimizer every
        ``update_gap`` batches.  Returns the loss as a device scalar."""
        if self._fused() and self._graphs_on():
            return self._replay([batch])[0]
        if self._fused():
            step = self.global_step
            self.global_step += 1
            return self._step(batch_to_device(batch, self.device),
                              self.step_generator(step))
        loss, grads = self._loss_and_grads(batch)
        if self._accum is None:
            self._accum = grads
        else:
            self._accum = {k: self._accum[k] + g for k, g in grads.items()}
        self._accum_count += 1
        if self._accum_count >= self.cfg.train.update_gap:
            self.flush_gradients()
        return loss

    def update_chunk(self, batches: list) -> list:
        """``len(batches)`` fused optimizer steps, as gcn_tpu's
        ``update_chunk``: same-shape packable batches go out in
        ``chunk_plan`` pieces of at most ``steps_per_dispatch`` (all at
        once where that is 1 or less), a piece of k as one replay of a
        k-step graph on the card; otherwise one ``update`` a batch.  The
        same steps as ``update`` on each batch; returns their losses."""
        if (len(batches) < 2 or self.cfg.train.update_gap > 1
                or self._accum is not None
                or not all(self.staging.packs(b) for b in batches)
                or len({b["words"].shape for b in batches}) != 1):
            return [self.update(b) for b in batches]
        spd = int(self.cfg.train.steps_per_dispatch)
        cap = spd if spd > 1 else len(batches)
        losses: list = []
        i = 0
        for size in chunk_plan(len(batches), cap):
            sub = batches[i:i + size]
            i += size
            if size > 1 and self._graphs_on():
                losses.extend(self._replay(sub))
            else:
                losses.extend(self.update(b) for b in sub)
        return losses

    def warmup(self, batches: Iterable[dict], *,
               eval_batches: Optional[Iterable[dict]] = None) -> dict:
        """Capture the graphs a run will need before it starts (gcn_tpu's
        ``warmup``).  ``batches``: one representative a train batch shape
        (``Batcher.warmup_batches``), each given the fused step's graph
        and, when ``steps_per_dispatch`` > 1 and it packs, the chunk
        graphs of ``allowed_chunk_sizes``; ``eval_batches``: those of
        shapes only evaluation sees, each given the evaluation graphs
        (with ``eval_batches=None`` the train shapes get them too).
        Parameters, optimizer state, ``global_step``
        and the dropout streams stay as they were.  Nothing is captured
        on the CPU, inside ``eager_dispatch()`` or for a model that a
        graph cannot hold.  Returns
        ``{"programs": graphs captured, "seconds"}``."""
        t0 = time.perf_counter()
        reps: dict = {}
        for b in batches:
            ent = reps.setdefault(_signature(b),
                                  {"batch": b, "train": False, "eval": False})
            ent["train"] = True
            ent["eval"] |= eval_batches is None
        for b in (eval_batches or ()):
            reps.setdefault(_signature(b), {"batch": b, "train": False,
                                            "eval": False})["eval"] = True
        before = len(self.graphs) + len(self._evaluator.graphs)
        if self._graphs_on():
            cap = max(1, int(self.cfg.train.steps_per_dispatch))
            fused = self.cfg.train.update_gap <= 1
            for ent in reps.values():
                b = ent["batch"]
                sizes = (allowed_chunk_sizes(cap)
                         if self.staging.packs(b) else [1])
                if ent["train"] and fused:
                    for k in sizes:
                        self._graphs.get([b] * k, self._steps, k,
                                         self._state())
                if ent["eval"]:
                    self._evaluator.warmup(b)
            torch.cuda.synchronize(self.device)
        return {"programs": len(self.graphs) + len(self._evaluator.graphs)
                - before, "seconds": time.perf_counter() - t0}

    @property
    def pending_batches(self) -> int:
        """Batches whose gradients are accumulated but not yet applied."""
        return self._accum_count

    def flush_gradients(self) -> None:
        """Apply any pending accumulated gradients."""
        if self._accum is None or self._accum_count == 0:
            return
        self.opt.step(self.params, self._accum)
        self._accum = None
        self._accum_count = 0

    def update_lr(self, new_lr: float) -> None:
        set_learning_rate(self.opt, new_lr)
        self.current_lr = new_lr

    def predict_batch(self, batch: dict):
        """Eval-mode predictions for the valid rows of one padded batch:
        (predictions, probs, loss)."""
        return self._evaluator.predict_batch(batch)

    def evaluate(self, batches: Iterable[dict]):
        """(preds, probs, avg_loss) over the batches, as
        ``Evaluator.evaluate``."""
        return self._evaluator.evaluate(batches)

    def save(self, directory: str, epoch: Optional[int] = None,
             extra_meta: Optional[dict] = None) -> None:
        """Write a checkpoint: meta ``epoch``, ``global_step`` (batches
        applied to the parameters), ``current_lr`` and ``extra_meta``."""
        meta = {"epoch": epoch,
                "global_step": self.global_step - self.pending_batches,
                "current_lr": self.current_lr}
        if extra_meta:
            meta.update(extra_meta)
        ckpt.save_checkpoint(
            directory,
            params_to_jax(self.model.state_dict()),
            self.opt.state_tree(),
            config=self.cfg.to_dict(),
            meta=meta,
            async_save=self.cfg.train.async_save,
        )

    def load(self, directory: str, load_opt_state: bool = True) -> dict:
        """Restore parameters, optimizer state, the rate and the step
        counter from a checkpoint of either package; returns its meta."""
        ckpt.wait_for_async_saves()
        params, opt_state, blob = ckpt.load_checkpoint(directory,
                                                       load_opt_state)
        self.model.load_state_dict(params_from_jax(params))
        if opt_state is not None:
            self.opt.load_state_tree(opt_state, self.params)
        self._accum = None
        self._accum_count = 0
        meta = blob.get("meta", {})
        if meta.get("current_lr") is not None:
            self.update_lr(float(meta["current_lr"]))
        # step s's dropout stream is seeded from (seed, s): the counter
        # carries on where the checkpoint's run stopped
        if meta.get("global_step") is not None:
            self.global_step = int(meta["global_step"])
        return meta
