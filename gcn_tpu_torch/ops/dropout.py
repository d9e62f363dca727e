"""Stochastic regularizers, each drawn from an explicit ``torch.Generator``.

Counterpart of ``gcn_tpu.ops.dropout``:

* inverted dropout (input, rnn, gcn and inter-layer LSTM dropout),
* variational dropout (one mask per sequence, shared over time),
* type-level embedding dropout (one draw per (row, word type)),
* edge dropout on a 0/1 adjacency band,
* deprel forgetting (a token's deprel embedding → the all-ones vector).

Every function is the identity when ``deterministic`` is set or its rate
leaves nothing to drop, and then draws nothing.  ``generator`` lives on the
tensor's device.  The draws are not JAX's bits: the two frameworks' streams
differ, so the tests compare distributions and hand both sides the same
masks where they compare values.
"""

from __future__ import annotations

import torch


def bernoulli(shape, p: float, generator: torch.Generator, device):
    """Bool keep mask, True with probability ``p``."""
    return torch.rand(shape, generator=generator, device=device) < p


def dropout(x, rate: float, deterministic: bool, generator=None):
    """Inverted dropout (``nn.Dropout`` semantics)."""
    if deterministic or rate <= 0.0:
        return x
    keep = bernoulli(x.shape, 1.0 - rate, generator, x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


def variational_dropout(x, rate: float, deterministic: bool, generator=None):
    """One mask per sequence: [B, 1, D] shared over the time axis."""
    if deterministic or rate <= 0.0:
        return x
    b, _, d = x.shape
    keep = bernoulli((b, 1, d), 1.0 - rate, generator, x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


def embedding_dropout_mask(token_ids, vocab_size: int, rate: float,
                           deterministic: bool, generator=None):
    """[B, L, 1] f32 multiplier (already scaled by 1/(1-p)) from one draw
    per (batch row, word type), gathered back to the token positions: every
    occurrence of an id within a row shares its draw.  None when
    inactive."""
    if deterministic or rate <= 0.0:
        return None
    b = token_ids.shape[0]
    type_keep = bernoulli((b, vocab_size), 1.0 - rate, generator,
                          token_ids.device)
    tok_keep = torch.take_along_dim(type_keep, token_ids.long(), dim=1)
    return tok_keep[:, :, None].float() / (1.0 - rate)


def drop_edges(adj_band, keep_prob: float, deterministic: bool,
               generator=None):
    """Bernoulli-mask a 0/1 adjacency band [B, N, N]."""
    if deterministic or keep_prob >= 1.0:
        return adj_band
    keep = bernoulli(adj_band.shape, keep_prob, generator, adj_band.device)
    return adj_band * keep.to(adj_band.dtype)


def forget_deprels(deprel_embs, keep_prop: float, deterministic: bool,
                   generator=None):
    """Replace a token's deprel embedding [B, N, D] with the all-ones vector
    with probability 1 - keep_prop."""
    if deterministic or keep_prop >= 1.0:
        return deprel_embs
    b, n, _ = deprel_embs.shape
    keep = bernoulli((b, n, 1), keep_prop, generator, deprel_embs.device)
    return torch.where(keep, deprel_embs, torch.ones(
        (), dtype=deprel_embs.dtype, device=deprel_embs.device))


def forget_ids(ids, ones_id: int, keep_prop: float, deterministic: bool,
               generator=None):
    """The factored path's form of ``forget_deprels``: a token's relation id
    becomes ``ones_id`` (the all-ones table row) with probability
    1 - keep_prop, one draw per token, as ``forget_deprels`` draws."""
    if deterministic or keep_prop >= 1.0:
        return ids
    keep = bernoulli(ids.shape, keep_prop, generator, ids.device)
    return torch.where(keep, ids, torch.full_like(ids, ones_id))
