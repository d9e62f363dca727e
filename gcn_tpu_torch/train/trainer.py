"""Training entry point: one optimizer step per batch, or accumulated.

Counterpart of the training half of ``gcn_tpu.train.trainer.Trainer``:

* the loss is the f32 cross-entropy over the batch's valid rows
  (``example_mask``), plus ``conv_l2`` times the squared GCN transform
  weights and ``pooling_l2`` times the squared sentence pooling output of
  the valid rows (``_loss``);
* ``update`` runs the stochastic forward and its backward (the CUDA
  backward kernels on the card) and, when ``update_gap <= 1``, one
  freeze → clip → optimizer step; otherwise it sums the gradients and
  steps in ``flush_gradients`` after ``update_gap`` batches;
* the dropout stream of step s is a ``torch.Generator`` seeded from
  ``(seed, s)``, as JAX folds the step into its key, so a run restarted at
  step s draws the same masks;
* ``predict_batch`` and ``evaluate`` run the ``Evaluator`` code on the same
  module.

``update`` returns the loss as a device tensor and does not synchronise.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from gcn_tpu_torch.config import Config
from gcn_tpu_torch.models.gcn import GCNClassifier, init_params
from gcn_tpu_torch.train.evaluator import (
    Evaluator,
    batch_to_device,
    resolve_device,
)
from gcn_tpu_torch.train.optim import build_optimizer, set_learning_rate


def conv_l2_penalty(model: torch.nn.Module) -> torch.Tensor:
    """Σ‖W‖² over the GCN layer transforms (``gcn_w*``, ``gcn_deprel_*``),
    as ``gcn_tpu.train.trainer.conv_l2_penalty`` scopes it."""
    return sum(p.square().sum()
               for name, p in model.named_parameters()
               if name.startswith(("gcn_w", "gcn_deprel_")))


def step_seed(seed: int, step: int) -> int:
    """The 64-bit seed of step ``step``'s dropout stream."""
    return int(np.random.SeedSequence([seed % 2**63, step]).generate_state(
        1, np.uint64)[0])


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
        self.opt = build_optimizer(cfg.train.optim, cfg.train.lr,
                                   max_grad_norm=cfg.train.max_grad_norm,
                                   topn=cfg.model.topn)
        self.opt.init(self.params)
        self.current_lr = cfg.train.lr
        self.global_step = 0
        self._accum: Optional[dict] = None
        self._accum_count = 0
        self._evaluator = Evaluator.for_model(cfg, self.model)

    def step_generator(self, step: int) -> torch.Generator:
        """The dropout stream of ``step``, on the trainer's device."""
        return torch.Generator(device=self.device).manual_seed(
            step_seed(self.seed, step))

    def _loss(self, batch: dict, generator: torch.Generator):
        """CE over the valid rows + conv and pooling L2 penalties."""
        cfg = self.cfg.train
        logits, pooled = self.model(batch, deterministic=False,
                                    generator=generator)
        em = batch["example_mask"].float()
        denom = em.sum().clamp(min=1.0)
        ce = F.cross_entropy(logits.float(), batch["labels"],
                             reduction="none")
        loss = (ce * em).sum() / denom
        if cfg.conv_l2 > 0:
            loss = loss + cfg.conv_l2 * conv_l2_penalty(self.model)
        if cfg.pooling_l2 > 0:
            pen = (pooled.float().square().sum(1) * em).sum() / denom
            loss = loss + cfg.pooling_l2 * pen
        return loss

    def _loss_and_grads(self, batch: dict):
        step = self.global_step
        self.global_step += 1
        loss = self._loss(batch_to_device(batch, self.device),
                          self.step_generator(step))
        # every parameter but those the model names unused must reach the
        # loss (autograd raises otherwise); those get a zero gradient, as
        # under jax.grad
        unused = self.model.unused_params
        used = [k for k in self.params if k not in unused]
        grads = dict(zip(used, torch.autograd.grad(
            loss, [self.params[k] for k in used])))
        return loss.detach(), {
            k: grads[k] if k in grads else torch.zeros_like(p)
            for k, p in self.params.items()}

    def update(self, batch: dict) -> torch.Tensor:
        """Forward + backward on one numpy batch; steps the optimizer every
        ``update_gap`` batches.  Returns the loss as a device scalar."""
        loss, grads = self._loss_and_grads(batch)
        if self.cfg.train.update_gap <= 1 and self._accum is None:
            self.opt.step(self.params, grads)
            return loss
        if self._accum is None:
            self._accum = grads
        else:
            self._accum = {k: self._accum[k] + g for k, g in grads.items()}
        self._accum_count += 1
        if self._accum_count >= self.cfg.train.update_gap:
            self.flush_gradients()
        return loss

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
