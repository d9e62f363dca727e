"""Evaluation entry point: predictions, probabilities and loss.

Counterpart of the evaluation half of ``gcn_tpu.train.trainer.Trainer``
(``_eval_core``, ``predict_batch``, ``evaluate``): an f32 cross-entropy
averaged over the batch's valid rows (``example_mask``), a softmax, and
the same loss weighting across batches.

On the card each evaluation forward is a replay of a CUDA graph captured
per batch signature (``train.dispatch``), and with ``steps_per_dispatch``
k > 1 a run of k same-shape packable batches is one replay of a graph of
k forwards (gcn_tpu's ``_forward_eval_chunk``), in ``chunk_plan`` pieces.
The batches cross packed in one pinned copy where they pack
(``train.transfer``).  ``evaluate`` keeps a window of forwards in flight,
as gcn_tpu does: each replay's probabilities leave the card by a
``non_blocking`` copy before the next replay, the host reads them a window
later, and the losses are summed on the card and fetched once.  The CPU,
``eager_dispatch()`` and a model that a graph cannot hold
(``GCNClassifier.capturable``) run the same loop a forward at a time, the
card then reading each batch's probabilities at once.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch
import torch.nn.functional as F

from gcn_tpu_torch.config import Config
from gcn_tpu_torch.models.gcn import GCNClassifier
from gcn_tpu_torch.train.dispatch import (
    GraphCache,
    allowed_chunk_sizes,
    chunk_plan,
    graphs_on,
)
from gcn_tpu_torch.train.transfer import Staging

WINDOW = 8  # evaluation forwards in flight (gcn_tpu's window)


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
        model = GCNClassifier(cfg.model)
        model.load_state_dict(state_dict)
        self._setup(cfg, model.to(resolve_device(device)).eval())

    @classmethod
    def for_model(cls, cfg: Config, model: GCNClassifier) -> "Evaluator":
        """An evaluator over an existing model (the trainer's), sharing its
        parameters and device."""
        ev = cls.__new__(cls)
        ev._setup(cfg, model)
        return ev

    def _setup(self, cfg: Config, model: GCNClassifier) -> None:
        self.cfg = cfg
        self.model = model
        self.device = next(model.parameters()).device
        self.staging = Staging(self.device, cfg.train.pack_transfers
                               and not cfg.model.use_bert_embeddings,
                               cfg.train.pack_format, WINDOW + 2)
        self._graphs = GraphCache(self.staging, self.device)
        self.graphs = self._graphs.graphs  # batch signature → StepGraph
        # the backend of collectives inside the forward (a partitioned
        # model's), None for none: a graph holds NCCL's, not gloo's
        self.backend = None

    @torch.no_grad()
    def _eval_core(self, batch: dict):
        """(probs [B, C], loss) for one device batch."""
        logits, _ = self.model(batch)
        logits = logits.float()
        em = batch["example_mask"].float()
        ce = F.cross_entropy(logits, batch["labels"], reduction="none")
        loss = (ce * em).sum() / em.sum().clamp(min=1.0)
        return torch.softmax(logits, dim=-1), loss

    def _forwards(self, static, generators=()):
        """The forwards over a graph's static batches (what an evaluation
        graph captures): (probs [k, B, C], losses [k])."""
        out = [self._eval_core(self.staging.device_batch(static, i))
               for i in range(static.count)]
        return (torch.stack([p for p, _ in out]),
                torch.stack([l for _, l in out]))

    def warmup(self, batch: dict) -> None:
        """Capture the evaluation graphs of ``batch``'s shape: one forward
        and, when ``steps_per_dispatch`` > 1 and it packs, the chunks of
        ``allowed_chunk_sizes``."""
        cap = max(1, int(self.cfg.train.steps_per_dispatch))
        for k in (allowed_chunk_sizes(cap) if self.staging.packs(batch)
                  else [1]):
            self._graphs.get([batch] * k, self._forwards)

    def _dispatch(self, batches: list):
        """Start the forwards of ``batches`` (one shape; several only
        where they pack): (probs [k, B, C] on the host, an event to wait
        on before reading them or None, losses [k] on the device)."""
        if not graphs_on(self.device, self.model, self.backend):
            out = [self._eval_core(batch_to_device(b, self.device))
                   for b in batches]
            probs = torch.stack([p for p, _ in out]).cpu()
            return probs, None, torch.stack([l for _, l in out])
        probs, losses = self._graphs.replay(batches, self._forwards)
        host = probs.to("cpu", non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done, losses.clone()

    def predict_batch(self, batch: dict):
        """Predictions for the VALID rows of one padded numpy batch:
        (predictions list[int], probs list[list[float]], loss)."""
        probs, done, loss = self._dispatch([batch])
        if done is not None:
            done.synchronize()
        probs = probs[0].numpy()
        mask = np.asarray(batch["example_mask"])
        return (probs.argmax(axis=1)[mask].tolist(), probs[mask].tolist(),
                float(loss[0]))

    def evaluate(self, batches: Iterable[dict]):
        """(preds, probs, avg_loss) over the batches.  avg_loss follows the
        reference normalization (Σ batch_loss / num_examples × batch_size)
        when every batch has ``cfg.train.batch_size`` rows and none is
        cross-sentence-packed, else it is the per-example mean: each
        batch's mean loss weighted by its valid examples (gcn_tpu's, for a
        packed batch, whose ``batch_size`` counts rows, not examples).  With
        ``steps_per_dispatch`` k > 1, runs of same-shape packable batches
        go out k at a time (gcn_tpu's ``evaluate``)."""
        bs = self.cfg.train.batch_size
        spd = max(1, int(self.cfg.train.steps_per_dispatch))
        pending: list = []  # (host probs, event, masks), oldest first
        all_preds: list[int] = []
        all_probs: list[list[float]] = []
        losses: list = []  # device [k] tensors, fetched once at the end
        weights: list[int] = []
        offsize = False

        def drain(item):
            probs, done, masks = item
            if done is not None:
                done.synchronize()
            for p, mask in zip(probs.numpy(), masks):
                all_preds.extend(p.argmax(axis=1)[mask].tolist())
                all_probs.extend(p[mask].tolist())

        def dispatch(sub):
            nonlocal offsize
            probs, done, loss = self._dispatch(sub)
            masks = [np.asarray(b["example_mask"]) for b in sub]
            pending.append((probs, done, masks))
            losses.append(loss)
            weights.extend(int(m.sum()) for m in masks)
            offsize |= any(len(m) != bs or "slot_mask" in b
                           for m, b in zip(masks, sub))

        buf: list[dict] = []
        depth = max(WINDOW // spd, 2) if spd > 1 else WINDOW

        def flush():
            i = 0
            for size in chunk_plan(len(buf), spd):
                dispatch(buf[i:i + size])
                i += size
            buf.clear()

        for batch in batches:
            if spd > 1 and self.staging.packs(batch):
                if buf and batch["words"].shape != buf[0]["words"].shape:
                    flush()
                buf.append(batch)
                if len(buf) >= spd:
                    flush()
            else:
                flush()
                dispatch([batch])
            while len(pending) >= depth:
                drain(pending.pop(0))
        flush()
        for item in pending:
            drain(item)
        n = sum(weights)
        if not losses:
            return all_preds, all_probs, 0.0
        stacked = torch.cat(losses)
        if offsize:
            w = torch.tensor(weights, dtype=torch.float32,
                             device=stacked.device)
            avg = float(torch.dot(stacked, w)) / max(n, 1)
        else:
            avg = float(stacked.sum()) / max(n, 1) * bs
        return all_preds, all_probs, avg
