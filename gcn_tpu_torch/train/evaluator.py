"""Evaluation entry point: predictions, probabilities and loss.

Counterpart of the evaluation half of ``gcn_tpu.train.trainer.Trainer``
(``_eval_core``, ``predict_batch``, ``evaluate``): an f32 cross-entropy
averaged over the batch's valid rows (``example_mask``), a softmax, and
the same loss weighting across batches.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch
import torch.nn.functional as F

from gcn_tpu_torch.config import Config
from gcn_tpu_torch.models.gcn import GCNClassifier


def resolve_device(device) -> torch.device:
    """The card unless the caller asks for the CPU; asking for a card that
    is not there raises instead of falling back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: expected cuda or cpu")
    return dev


def batch_to_device(batch: dict, device: torch.device) -> dict:
    """numpy batch dict → tensors on ``device`` (integers as int64)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.asarray(v))
        if not t.is_floating_point() and t.dtype != torch.bool:
            t = t.long()
        out[k] = t.to(device, non_blocking=True)
    return out


class Evaluator:
    """Holds a ``GCNClassifier`` with the given ``state_dict`` on ``device``
    (the card by default; ``device="cpu"`` runs the kernels' plain
    versions)."""

    def __init__(self, cfg: Config, state_dict: dict, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        model = GCNClassifier(cfg.model)
        model.load_state_dict(state_dict)
        self.model = model.to(self.device).eval()

    @classmethod
    def for_model(cls, cfg: Config, model: GCNClassifier) -> "Evaluator":
        """An evaluator over an existing model (the trainer's), sharing its
        parameters and device."""
        ev = cls.__new__(cls)
        ev.cfg = cfg
        ev.device = next(model.parameters()).device
        ev.model = model
        return ev

    @torch.no_grad()
    def _eval_core(self, batch: dict):
        """(probs [B, C], loss) for one device batch."""
        logits, _ = self.model(batch)
        logits = logits.float()
        em = batch["example_mask"].float()
        ce = F.cross_entropy(logits, batch["labels"], reduction="none")
        loss = (ce * em).sum() / em.sum().clamp(min=1.0)
        return torch.softmax(logits, dim=-1), loss

    def predict_batch(self, batch: dict):
        """Predictions for the VALID rows of one padded numpy batch:
        (predictions list[int], probs list[list[float]], loss)."""
        probs, loss = self._eval_core(batch_to_device(batch, self.device))
        probs = probs.cpu().numpy()
        mask = np.asarray(batch["example_mask"])
        return (probs.argmax(axis=1)[mask].tolist(), probs[mask].tolist(),
                float(loss))

    def evaluate(self, batches: Iterable[dict]):
        """(preds, probs, avg_loss) over the batches.  avg_loss follows the
        reference normalization (Σ batch_loss / num_examples × batch_size)
        when every batch has ``cfg.train.batch_size`` rows, else the
        per-example mean weighted by each batch's valid rows."""
        all_preds: list[int] = []
        all_probs: list[list[float]] = []
        losses: list[float] = []
        weights: list[int] = []
        offsize = False
        for batch in batches:
            preds, probs, loss = self.predict_batch(batch)
            all_preds.extend(preds)
            all_probs.extend(probs)
            losses.append(loss)
            weights.append(len(preds))
            offsize |= len(batch["example_mask"]) != self.cfg.train.batch_size
        n = sum(weights)
        if offsize:
            avg = sum(l * w for l, w in zip(losses, weights)) / max(n, 1)
        else:
            avg = sum(losses) / max(n, 1) * self.cfg.train.batch_size
        return all_preds, all_probs, avg
