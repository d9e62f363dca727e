"""Row-sparse word-embedding gradients: update only the vocabulary rows a
batch touches (counterpart of ``gcn_tpu.train.sparse_emb``).

The word table is the largest parameter (a GloVe vocabulary of 53,954 rows
× 300 is 65 MB in f32), and a dense step passes over all of it several
times: the lookup's backward writes a dense [V, E] gradient, the freeze
and the clip read it, and the optimizer reads and writes the table (and
adagrad its accumulator), for a batch that touches at most B·N rows.  The
sparse step:

1. the trainer gathers the batch's rows outside the differentiated loss
   and passes them to the model as ``batch["word_vecs"]``
   (``models.gcn``), so autograd returns a [B, N, E] row gradient and
   ``word_emb`` none at all: the optimizer's freeze, clip and update loops
   never see the table (``Optimizer.step`` walks the gradients it is
   given);
2. ``coalesce`` sums the rows of repeated ids (the dense lookup's backward
   sums them too): a stable sort, each run's sum by a segmented scan over
   the sorted rows in a fixed order (``ceil(log2(B·N))`` shifted adds, no
   atomics, no host sync, so a CUDA graph holds it and it gives the same
   bits every run), the sum at the run's first position and zeros at its
   repeats;
3. the global-norm clip runs over the dense gradients and the coalesced
   rows (``optim.clip_by_global_norm``);
4. the row rule (sgd, or adagrad/myadagrad with its accumulator) runs on
   the B·N coalesced rows, and ``index_add_`` adds them into the table and
   their squares into the accumulator: each id has one nonzero row, so
   the sums are the same whatever order the adds land in.

Only the row-local optimizers are supported (``supported``): adam's
family moves every row every step.  The optimizer is built with
``external_clip=True`` (its clip stage skipped); its state keeps the dense
layout, so checkpoints are the same in both modes.
"""

from __future__ import annotations

import torch

from gcn_tpu_torch.train.optim import Optimizer, clip_by_global_norm

_EPS = 1e-10  # MyAdagrad's denominator eps


def supported(optim_name: str) -> bool:
    """Optimizers whose dense update leaves a row of zero gradient as it
    was."""
    return optim_name in ("sgd", "adagrad", "myadagrad")


def coalesce(ids: torch.Tensor, rows: torch.Tensor):
    """Sum the rows of repeated ids.  Returns ``(sorted_ids, rows)``:
    ``rows[i]`` holds the whole sum of its id's rows at each run's first
    position and zeros at the repeats, so one ``index_add_`` over
    ``sorted_ids`` adds each id's sum once."""
    ids = ids.reshape(-1)
    rows = rows.reshape(ids.shape[0], -1)
    t = ids.shape[0]
    sids, order = torch.sort(ids, stable=True)
    acc = rows.index_select(0, order)
    # suffix sums within runs, by doubling: after the step of shift d,
    # acc[i] holds the rows [i, i + 2d) of its run
    d = 1
    while d < t:
        same = torch.zeros(t, dtype=torch.bool, device=ids.device)
        same[:t - d] = sids[d:] == sids[:t - d]
        shifted = torch.zeros_like(acc)
        shifted[:t - d] = acc[d:]
        acc = acc + torch.where(same[:, None], shifted, 0.0)
        d *= 2
    first = torch.ones(t, dtype=torch.bool, device=ids.device)
    first[1:] = sids[1:] != sids[:-1]
    return sids, torch.where(first[:, None], acc, 0.0)


@torch.no_grad()
def sparse_step(opt: Optimizer, params: dict, grads: dict,
                word_ids: torch.Tensor, g_rows: torch.Tensor, *,
                topn: int, max_grad_norm: float) -> None:
    """One optimizer step with a row-sparse word-table update, in place.

    ``grads`` holds every other parameter's gradient (none for
    ``word_emb``); ``g_rows`` [..., E] is the gradient of the rows
    gathered at ``word_ids`` [...].  ``opt`` is built with
    ``external_clip=True``: the clip is here, so that its norm counts the
    rows."""
    emb = params["word_emb"]
    # 1. the partial-finetune freeze, before the clip (as the dense chain)
    if topn <= 0:
        g_rows = torch.zeros_like(g_rows)
    elif topn < emb.shape[0]:
        g_rows = torch.where((word_ids < topn)[..., None], g_rows, 0.0)
    # 2. repeated ids summed (the dense lookup backward's sums)
    sids, crows = coalesce(word_ids, g_rows)
    # 3. the global-norm clip over the dense gradients and the rows
    grads = clip_by_global_norm({**grads, "rows": crows}, max_grad_norm)
    crows = grads.pop("rows")
    # 4. the dense chain on every other parameter (it counts the step),
    #    then the row rule on the touched rows
    opt.step(params, grads)
    lr = opt.learning_rate
    if opt.name == "sgd":
        upd = crows * -lr
    else:
        accum = opt.state["word_emb"]["accum"]
        decay = 1.0 / (1.0 + (opt.count.float() - 1.0) * opt.lr_decay)
        sq = crows * crows
        acc_rows = accum.index_select(0, sids) + sq
        upd = decay * crows / (acc_rows.sqrt() + _EPS) * -lr
        accum.index_add_(0, sids, sq)
    emb.index_add_(0, sids, upd.to(emb.dtype))
