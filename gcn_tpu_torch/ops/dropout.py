"""Stochastic regularizers, each drawn from an explicit ``torch.Generator``.

Counterpart of ``gcn_tpu.ops.dropout``:

* inverted dropout (input, rnn, gcn and inter-layer LSTM dropout),
* variational dropout (one mask per sequence, shared over time),
* type-level embedding dropout (one draw per (row, word type)),
* edge dropout on a 0/1 adjacency band or an edge mask,
* deprel forgetting (a token's deprel embedding → the all-ones vector).

Every function is the identity when ``deterministic`` is set or its rate
leaves nothing to drop, and then draws nothing.  ``generator`` lives on the
tensor's device.  The draws are not JAX's bits: the two frameworks' streams
differ, so the tests compare distributions and hand both sides the same
masks where they compare values.

Every mask's leading axis is the batch's rows.  A data-parallel rank
passes a ``RowShard`` for ``generator``: it draws the whole global batch's
mask from the wrapped generator and keeps its own rows, so that rank r's
masks are the rows of the single-device step's.
"""

from __future__ import annotations

import torch


class RowShard:
    """A generator for rows ``[lo, hi)`` of a batch of ``rows`` rows: each
    mask is drawn at the whole batch's shape from ``generator`` and cut to
    those rows."""

    def __init__(self, generator: torch.Generator, lo: int, hi: int,
                 rows: int):
        if not 0 <= lo <= hi <= rows:
            raise ValueError(f"rows [{lo}, {hi}) of {rows}")
        self.generator = generator
        self.lo, self.hi, self.rows = lo, hi, rows


def bernoulli(shape, p: float, generator, device):
    """Bool keep mask, True with probability ``p``."""
    if isinstance(generator, RowShard):
        if shape[0] != generator.hi - generator.lo:
            raise ValueError(f"a mask of {shape[0]} rows from a RowShard of "
                             f"{generator.hi - generator.lo}")
        full = torch.rand((generator.rows, *shape[1:]),
                          generator=generator.generator, device=device)
        return full[generator.lo:generator.hi] < p
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
    """Bernoulli-mask a 0/1 adjacency band [B, N, N], or a bool edge mask
    [B, E] (the partitioned full_deprel layer's)."""
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
