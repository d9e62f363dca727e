"""Epoch-loop driver shared by the TACRED and SemEval CLIs (counterpart of
``gcn_tpu.train.driver``).

The same training policy and run directory as gcn_tpu's: per-epoch
train/dev/test evaluation with the official scorer; best-model tracking on
dev F1, or on train F1 where there is no dev split (SemEval); per-epoch
checkpoints with ``save_epoch`` retention plus the newest
``keep_latest_checkpoints``; ``save_steps`` step checkpoints that
``--resume`` continues mid-epoch; plateau decay of the rate for
sgd/adagrad/adadelta; ``logs.txt``, ``config.json``, ``vocab.pkl``,
``deprel_embs.pkl`` (a pickled numpy array), and at each new best the
confusion matrices and misclassified examples.  Checkpoints are
gcn_tpu's format, so either package resumes or evaluates the other's run.

``--pack_sentences S`` builds every batcher as a ``PackedBatcher`` (rows
of up to ``pack_len`` tokens and S sentences, ``batch_size`` rows a
batch), as gcn_tpu's driver does; BERT inputs with it raise
``ValueError``.

A resumed run is the uninterrupted one: the step counter seeds the
dropout streams (``Trainer.load``), the train batcher draws the word
dropout of the batches before the resume point (``advance``), and
the checkpoint's meta carries the selection history that the plateau
decay reads and, in a step checkpoint, the losses of the epoch's batches
before it.  The epoch's losses are summed on the device and fetched once.

Data parallelism, as gcn_tpu's driver: a job that
``parallel.distributed.initialize`` finds in the environment
(``GCN_TPU_COORDINATOR`` / ``GCN_TPU_NUM_PROCS`` / ``GCN_TPU_PROC_ID``, or
``torchrun``'s) with more than one process trains a ``DistributedTrainer``
on ``ShardedBatcher``s over a (data × ``graph_axis``) mesh: every data
index its rows of each batch, and with ``--graph_partition edges`` the
ranks of a data index split its edge lists, with ``--graph_partition
halo`` its nodes, every batcher then adding the halo exchange plans for
the model axis (``halo_devices``); NCCL on the card, one card a rank,
gloo with ``--cpu``.  Only rank 0 (the chief)
writes the run directory, ``logs.txt`` and the artifacts; every rank
scores the whole split.

Dispatch, as gcn_tpu's driver: with ``steps_per_dispatch`` k > 1 (fused
steps, packed batches) the train batches go to ``Trainer.update_chunk``
k at a time, a chunk flushed at a change of bucket and cut at
``save_steps`` boundaries, and each step's bookkeeping replayed from the
returned losses; ``warmup_compile`` ("true", or "auto" with k > 1)
captures the run's graphs before epoch 1 (``Trainer.warmup``).
"""

from __future__ import annotations

import json
import os
import pickle
import time
from datetime import datetime
from shutil import rmtree

import numpy as np
import torch

from gcn_tpu_torch.config import Config
from gcn_tpu_torch.data.dataset import (
    Batcher,
    PackedBatcher,
    RelationDataset,
    constants_for,
)
from gcn_tpu_torch.data.sharding import ShardedBatcher
from gcn_tpu_torch.data.vocab import Vocab
from gcn_tpu_torch.parallel import distributed
from gcn_tpu_torch.train import checkpoint as ckpt
from gcn_tpu_torch.train import scorer
from gcn_tpu_torch.train.distributed_trainer import DistributedTrainer
from gcn_tpu_torch.train.logger import FileLogger, ensure_dir, print_config
from gcn_tpu_torch.train.profiling import ThroughputMeter, trace
from gcn_tpu_torch.train.trainer import Trainer


def load_word_embeddings(cfg: Config, vocab: Vocab):
    if cfg.model.use_bert_embeddings:
        return None
    emb_file = os.path.join(cfg.data.vocab_dir, "embedding.npy")
    if not os.path.exists(emb_file):
        print(f"[warn] no embedding matrix at {emb_file}; using random init")
        return None
    emb = np.load(emb_file)
    if emb.shape != (vocab.size, cfg.model.emb_dim):
        raise ValueError(f"embedding matrix {emb.shape} vs vocab "
                         f"{vocab.size} x emb_dim {cfg.model.emb_dim}")
    return emb


def find_latest_checkpoint(run_dir: str) -> str | None:
    """Most recent checkpoint in a run directory (step checkpoints beat
    their epoch's checkpoint by global step), else best_model."""
    if not os.path.isdir(run_dir):
        return None
    best_key, best_name = None, None
    for name in os.listdir(run_dir):
        for prefix, kind in (("checkpoint_epoch_", 0),
                             ("checkpoint_step_", 1)):
            if not name.startswith(prefix) or name.endswith(".tmp"):
                continue
            try:
                num = int(name.rsplit("_", 1)[1])
            except ValueError:
                continue
            try:
                with open(os.path.join(run_dir, name, "meta.json")) as f:
                    meta = json.load(f).get("meta", {})
            except OSError:
                continue
            step = int(meta.get("global_step") or 0)
            epoch = int(meta.get("epoch") or num)
            key = (step, epoch, kind)
            if best_key is None or key > best_key:
                best_key, best_name = key, name
    if best_name:
        return os.path.join(run_dir, best_name)
    best = os.path.join(run_dir, "best_model")
    return best if os.path.isdir(best) else None


def prune_checkpoints(run_dir: str, epoch: int, save_epoch: int,
                      keep_latest: int = 1) -> None:
    """Reference retention (keep ``save_epoch`` multiples) plus the newest
    ``keep_latest`` epoch checkpoints; a finished epoch supersedes its
    step checkpoints."""
    epochs = []
    for name in os.listdir(run_dir):
        if name.startswith("checkpoint_epoch_") and not name.endswith(".tmp"):
            try:
                epochs.append(int(name.rsplit("_", 1)[1]))
            except ValueError:
                continue
    keep = set(sorted(epochs)[-max(keep_latest, 0):]) if keep_latest else set()
    for e in epochs:
        if e % save_epoch != 0 and e not in keep:
            rmtree(os.path.join(run_dir, f"checkpoint_epoch_{e}"))
    for name in list(os.listdir(run_dir)):
        if name.startswith("checkpoint_step_") and not name.endswith(".tmp"):
            rmtree(os.path.join(run_dir, name))


def write_artifacts(art_dir: str, split: str, labels, batcher, ds,
                    confusion_file: str = "") -> None:
    """``{split}_confusion_matrix.pkl`` and ``{split}_incorrect_data.json``
    (the raw records of the misclassified examples)."""
    gold = np.array(batcher.gold())
    pred = np.array(labels)
    cm = scorer.compute_confusion_matrices(gold, pred)
    with open(confusion_file or os.path.join(
            art_dir, f"{split}_confusion_matrix.pkl"), "wb") as f:
        pickle.dump(cm, f)
    wrong = [ds.raw_data[batcher.order[i]] for i in np.nonzero(pred != gold)[0]]
    with open(os.path.join(art_dir, f"{split}_incorrect_data.json"), "w") as f:
        json.dump(wrong, f)


def run_training(
    cfg: Config,
    bert_embeddings: dict | None = None,
    load_from: str | None = None,
    profile_dir: str | None = None,
    resume: bool = False,
    device="cuda",
) -> dict:
    """Train ``cfg`` for ``cfg.train.num_epoch`` epochs into
    ``<model_save_dir>/<id>``; returns the best dev (or train) metrics, the
    test metrics at that epoch, the run directory and each epoch's
    ``(wall s, sustained examples/s)``."""
    C = constants_for(cfg.model.dataset)
    np.random.seed(cfg.train.seed)
    distributed.initialize(device=device)
    is_chief = distributed.rank() == 0

    vocab = Vocab.load(os.path.join(cfg.data.vocab_dir, "vocab.pkl"))
    cfg.model.vocab_size = vocab.size
    cfg.model.num_class = len(C.LABEL_TO_ID)
    emb_matrix = load_word_embeddings(cfg, vocab)
    if cfg.model.use_bert_embeddings:
        cfg.model.emb_dim = 1024  # reference train.py:143-144

    data_dir = cfg.data.data_dir
    print(f"Loading data from {data_dir} with batch size "
          f"{cfg.train.batch_size}...")
    train_ds = RelationDataset(
        os.path.join(data_dir, cfg.data.train_file), cfg, vocab,
        bert_embeddings=bert_embeddings,
    )
    dev_path = os.path.join(data_dir, cfg.data.dev_file)
    dev_ds = (
        RelationDataset(dev_path, cfg, vocab, evaluation=True,
                        bert_embeddings=bert_embeddings)
        if os.path.exists(dev_path)
        else None
    )
    test_ds = RelationDataset(
        os.path.join(data_dir, cfg.data.test_file), cfg, vocab,
        evaluation=True, bert_embeddings=bert_embeddings,
    )

    bs = cfg.train.batch_size
    ebs = cfg.train.eval_batch_size or bs
    if cfg.data.pack_sentences > 0:
        if cfg.model.use_bert_embeddings:
            raise ValueError(
                "--pack_sentences does not support BERT embedding inputs"
                " (float [L,D] word vectors; PackedBatcher packs integer"
                " token ids) — use --pack_sentences 0 with"
                " --use_bert_embeddings"
            )
        # cross-sentence packing: several sentences a row, the same
        # per-sentence math; batch_size counts ROWS here

        def packed(ds, evaluation):
            return PackedBatcher(
                ds, ebs if evaluation else bs,
                pack_len=cfg.data.pack_len or None,
                max_slots=cfg.data.pack_sentences,
                evaluation=evaluation, seed=cfg.train.seed)

        train_batcher = packed(train_ds, False)
        train_eval_batcher = packed(train_ds, True)
        dev_batcher = packed(dev_ds, True) if dev_ds else None
        test_batcher = packed(test_ds, True)
    else:
        train_batcher = Batcher(train_ds, bs, seed=cfg.train.seed,
                                group_by_length=cfg.data.group_by_length)
        train_eval_batcher = Batcher(train_ds, ebs, evaluation=True)
        dev_batcher = (Batcher(dev_ds, ebs, evaluation=True)
                       if dev_ds else None)
        test_batcher = Batcher(test_ds, ebs, evaluation=True)

    model_id = cfg.id if len(cfg.id) > 1 else "0" + cfg.id
    run_dir = os.path.join(cfg.model_save_dir, model_id)
    if is_chief:
        ensure_dir(run_dir)
        cfg.save(os.path.join(run_dir, "config.json"))
        vocab.save(os.path.join(run_dir, "vocab.pkl"))
        print_config(cfg.to_dict())
        file_logger = FileLogger(
            os.path.join(run_dir, cfg.log),
            header="# epoch\ttrain_loss\tdev_loss\tdev_score\t"
                   "best_dev_score",
            append=resume,
        )
    log = file_logger.log if is_chief else (lambda line: None)

    if distributed.world_size() > 1:
        # a (data × graph_axis) mesh: every data index its rows of each
        # batch, shared by the ranks of its model group
        print(f"Distributed training: {distributed.runtime_info()}")
        trainer = DistributedTrainer(cfg, emb_matrix=emb_matrix,
                                     device=device)
        print(f"Mesh: {trainer.mesh.shape}, graph_partition "
              f"{cfg.model.graph_partition}")

        def shard(b):
            return ShardedBatcher(b, trainer.groups.data_index,
                                  trainer.mesh.data)

        train_batcher, train_eval_batcher, test_batcher = (
            shard(b) for b in (train_batcher, train_eval_batcher,
                               test_batcher))
        if dev_batcher is not None:
            dev_batcher = shard(dev_batcher)
        if (cfg.model.graph_partition == "halo"
                and trainer.mesh.model > 1):
            # every batch carries static-shape exchange plans for the
            # mesh's model axis (parallel.halo.attach_halo_plans)
            for b in (train_batcher, train_eval_batcher, dev_batcher,
                      test_batcher):
                if b is not None:
                    b.halo_devices = trainer.mesh.model
    else:
        trainer = Trainer(cfg, emb_matrix=emb_matrix, device=device)
    start_epoch = 1
    skip_batches = 0
    resumed: dict = {}
    if resume:
        # the newest checkpoint in the run dir: params, optimizer state,
        # rate, step counter, epoch, best metrics; a step checkpoint
        # (save_steps > 0) resumes mid-epoch, its applied batches skipped
        latest = find_latest_checkpoint(run_dir)
        if latest:
            resumed = trainer.load(latest)
            if resumed.get("step_in_epoch") is not None:
                start_epoch = max(int(resumed.get("epoch") or 1), 1)
                skip_batches = int(resumed["step_in_epoch"])
            else:
                start_epoch = int(resumed.get("epoch") or 0) + 1
            # the word dropout of the batches before the resume point
            train_batcher.advance((start_epoch - 1) * len(train_batcher)
                                  + skip_batches)
            print(f"Resumed from {latest}; continuing at epoch "
                  f"{start_epoch}"
                  + (f" batch {skip_batches}" if skip_batches else ""))
        else:
            print(f"No checkpoint found in {run_dir}; starting fresh")
    if load_from:
        # warm start (reference train.py:186-195), optimizer state too
        meta = trainer.load(load_from)
        print(f"Loaded pretrained model from {load_from} "
              f"(epoch {meta.get('epoch')})")
    id2label = {v: k for k, v in C.LABEL_TO_ID.items()}
    neg = cfg.train.scorer_negative_label or C.NEGATIVE_LABEL

    selection_history: list[float] = list(
        resumed.get("selection_history") or [])
    best_metrics = resumed.get("best_metrics") or {
        "f1": -np.inf, "precision": -np.inf, "recall": -np.inf}
    test_at_best = resumed.get("test_at_best") or dict(best_metrics)
    current_lr = trainer.current_lr
    global_step = trainer.global_step
    max_steps = len(train_batcher) * cfg.train.num_epoch
    fmt = ("{}: step {}/{} (epoch {}/{}), loss = {:.6f} "
           "({:.3f} sec/batch), lr: {:.6f}")
    epochs_timed = []

    def run_eval(batcher):
        preds, _, loss = trainer.evaluate(batcher)
        labels = [id2label[p] for p in preds]
        p, r, f1 = scorer.score(batcher.gold(), labels, negative_label=neg)
        return labels, loss, {"f1": f1, "precision": p, "recall": r}

    def run_meta():  # copies: an async save writes them later
        return {"best_metrics": dict(best_metrics),
                "test_at_best": dict(test_at_best),
                "selection_history": list(selection_history)}

    meter = ThroughputMeter(device=trainer.device)
    profiled = False

    spd = max(1, int(cfg.train.steps_per_dispatch))
    use_chunks = (spd > 1 and cfg.train.update_gap <= 1
                  and trainer.staging.pack)
    wm = str(cfg.train.warmup_compile).lower()
    if wm in ("true", "1", "yes") or (wm == "auto" and spd > 1):
        # the train batcher's shapes get the train graphs; those of the
        # evaluation batchers only the evaluation graphs
        reps = train_batcher.warmup_batches()
        eval_reps = []
        for b in (dev_batcher, test_batcher, train_eval_batcher):
            if b is not None:
                eval_reps += b.warmup_batches()
        t0 = time.time()
        stats = trainer.warmup(reps, eval_batches=eval_reps)
        print(f"warmup: compiled {stats['programs']} programs in "
              f"{time.time() - t0:.1f}s ({len(reps)} batch shapes)")

    for epoch in range(start_epoch, cfg.train.num_epoch + 1):
        # device scalars, summed and fetched once; after a mid-epoch resume
        # the losses of the batches before it lead
        epoch_losses = [torch.tensor(x, dtype=torch.float32,
                                     device=trainer.device)
                        for x in (resumed.get("epoch_losses") or [])
                        if epoch == start_epoch]
        meter.start()

        def step_bookkeeping(i, batch, loss, sec, epoch=epoch,
                             epoch_losses=epoch_losses):
            epoch_losses.append(loss)
            meter.step(int(batch["edge_mask"].sum()),
                       int(batch["example_mask"].sum()))
            if global_step % cfg.train.log_step == 0:
                print(fmt.format(
                    datetime.now(), global_step, max_steps, epoch,
                    cfg.train.num_epoch, float(loss), sec, current_lr,
                ) + f" [{meter.summary()}]")
            if (cfg.train.save_steps
                    and global_step % cfg.train.save_steps == 0):
                # the parameters before any pending accumulation: the
                # resume replays those batches (Trainer.save)
                step_dir = os.path.join(
                    run_dir, f"checkpoint_step_{global_step}")
                applied = i + 1 - trainer.pending_batches
                trainer.save(step_dir, epoch=epoch, extra_meta={
                    **run_meta(), "step_in_epoch": applied,
                    "epoch_losses": (torch.stack(
                        epoch_losses[:applied]).tolist() if applied else []),
                })
                ckpt.wait_for_async_saves()
                for name in os.listdir(run_dir) if is_chief else ():
                    if (name.startswith("checkpoint_step_")
                            and not name.endswith(".tmp")
                            and name != f"checkpoint_step_{global_step}"):
                        rmtree(os.path.join(run_dir, name))

        buf: list = []
        buf_t0 = 0.0

        def flush_buf():
            # one replay a piece (Trainer.update_chunk); the bookkeeping
            # replays per step from the returned losses
            nonlocal buf, global_step, profiled
            if not buf:
                return
            if profile_dir and not profiled:
                with trace(profile_dir):
                    losses = trainer.update_chunk([b for _, b in buf])
                profiled = True
                print(f"profiler trace written to {profile_dir}")
            else:
                losses = trainer.update_chunk([b for _, b in buf])
            sec = (time.time() - buf_t0) / len(buf)
            for (bi, bb), loss in zip(buf, losses):
                global_step += 1
                step_bookkeeping(bi, bb, loss, sec)
            buf = []

        # after a mid-epoch resume, the batches from the resume point on
        first = skip_batches if epoch == start_epoch else 0
        batches = (map(train_batcher.materialize,
                       train_batcher.chunks[first:])
                   if first else train_batcher)
        for i, batch in enumerate(batches, start=first):
            if use_chunks:
                if buf and batch["words"].shape != buf[0][1]["words"].shape:
                    flush_buf()
                if not buf:
                    buf_t0 = time.time()
                buf.append((i, batch))
                # a chunk ends at a save_steps boundary, so that a step
                # checkpoint holds exactly that step's state
                cap = spd
                if cfg.train.save_steps:
                    cap = min(cap, cfg.train.save_steps
                              - global_step % cfg.train.save_steps)
                if len(buf) >= cap:
                    flush_buf()
                continue
            start = time.time()
            global_step += 1
            if profile_dir and not profiled and global_step == 3:
                with trace(profile_dir):  # a warm step
                    loss = trainer.update(batch)
                profiled = True
                print(f"profiler trace written to {profile_dir}")
            else:
                loss = trainer.update(batch)
            step_bookkeeping(i, batch, loss, time.time() - start)
        flush_buf()
        trainer.flush_gradients()
        train_loss = (float(torch.stack(epoch_losses).sum())
                      if epoch_losses else 0.0)
        eps, xps, wall = meter.sustained()
        if epoch_losses:
            epochs_timed.append((wall, xps))
            print(f"epoch {epoch} sustained: {eps:,.0f} edges/s, "
                  f"{xps:,.1f} ex/s over {wall:.2f}s wall")

        # deprel embedding snapshot (reference train.py:239-241)
        if is_chief:
            with open(os.path.join(run_dir, "deprel_embs.pkl"), "wb") as f:
                pickle.dump(trainer.model.deprel_emb.detach().cpu().numpy(),
                            f)

        print("Evaluating on train set...")
        train_labels, train_eval_loss, train_m = run_eval(train_eval_batcher)
        print(f"epoch {epoch}: train_loss = {train_loss:.6f}, "
              f"train_eval_loss = {train_eval_loss:.6f}, "
              f"train_f1 = {train_m['f1']:.4f}")

        if dev_batcher is not None:
            print("Evaluating on dev set...")
            dev_labels, dev_loss, dev_m = run_eval(dev_batcher)
            print(f"epoch {epoch}: dev_loss = {dev_loss:.6f}, "
                  f"dev_f1 = {dev_m['f1']:.4f}")
        else:
            # SemEval: select on train F1 (train_semeval.py:256-262)
            dev_labels, dev_loss, dev_m = train_labels, train_eval_loss, train_m

        selection_score = dev_m["f1"]
        log(
            f"{epoch}\t{train_loss:.6f}\t{dev_loss:.6f}\t"
            f"{selection_score:.4f}\t"
            f"{max([selection_score] + selection_history):.4f}"
        )

        print("Evaluating on test set...")
        test_labels, _, test_m = run_eval(test_batcher)

        if dev_m["f1"] > best_metrics["f1"]:
            best_metrics = dev_m
            test_at_best = test_m
            trainer.save(os.path.join(run_dir, "best_model"), epoch=epoch,
                         extra_meta=run_meta())
            print("new best model saved.")
            log(
                "new best model saved at epoch {}: {:.2f}\t{:.2f}\t{:.2f}"
                .format(epoch, test_m["precision"] * 100,
                        test_m["recall"] * 100, test_m["f1"] * 100)
            )
            # confusion matrices + misclassified dumps, into the run dir
            # unless --test_save_dir / --test_confusion_save_file redirect
            if is_chief:
                art_dir = run_dir
                if cfg.test_save_dir:
                    art_dir = os.path.join(cfg.test_save_dir, cfg.id)
                    os.makedirs(art_dir, exist_ok=True)
                write_artifacts(art_dir, "test", test_labels, test_batcher,
                                test_ds, cfg.test_confusion_save_file)
                if dev_batcher is not None:
                    write_artifacts(art_dir, "dev", dev_labels, dev_batcher,
                                    dev_ds)

        print("Best Dev Metrics | F1: {} | Precision: {} | Recall: {}".format(
            best_metrics["f1"], best_metrics["precision"],
            best_metrics["recall"]))
        print("Test Metrics at Best Dev | F1: {} | Precision: {} | "
              "Recall: {}".format(test_at_best["f1"],
                                  test_at_best["precision"],
                                  test_at_best["recall"]))

        # plateau decay of the rate (train.py:340-343)
        if (
            len(selection_history) > cfg.train.decay_epoch
            and selection_score <= selection_history[-1]
            and cfg.train.optim in ("sgd", "adagrad", "adadelta")
        ):
            current_lr *= cfg.train.lr_decay
            trainer.update_lr(current_lr)
        selection_history.append(selection_score)

        # epoch checkpoint + retention (train.py:329-337)
        trainer.save(os.path.join(run_dir, f"checkpoint_epoch_{epoch}"),
                     epoch=epoch, extra_meta=run_meta())
        ckpt.wait_for_async_saves()
        if is_chief:
            prune_checkpoints(run_dir, epoch, cfg.train.save_epoch,
                              keep_latest=cfg.train.keep_latest_checkpoints)
        print("")

    print(f"Training ended with {cfg.train.num_epoch} epochs.")
    return {
        "best_dev": best_metrics,
        "test_at_best_dev": test_at_best,
        "run_dir": run_dir,
        "epochs_timed": epochs_timed,
    }
