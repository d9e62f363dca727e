"""The C-GCN and the paper's GCN relation classifier.

Counterpart of ``gcn_tpu.models.gcn.GCNClassifier`` for its four modes:
``full_deprel`` (``cgcn_preset``: embeddings → BiLSTM → full_deprel GCN
layers → pooling → MLP → logits), ``regular`` (``gcn_preset``, with or
without the BiLSTM), ``attention`` (edge-attention aggregation) and
``diagonal_deprel`` (element-wise deprel gates after a ``preprocessor``
dense layer), differentiable end to end, on TACRED or SemEval, with word
ids or precomputed float word vectors (``use_bert_embeddings``: the
batch's ``words`` is [B, N, D] and the model has no word table).
full_deprel runs factored (the grouped
matmul, ``deprel_factored`` "auto"/"ragged"/"pallas"/True) or not
(``deprel_factored=False``: the per-token bilinear transform, an einsum on
the dense bands, the ``deprel_bilinear`` kernel on the fused path).  With
``use_pallas=True`` the GCN layers run on the fused edge-list path as in
JAX, with no [B, N, N] band: a ``full_deprel`` layer is one
``fused_band_aggregate`` call (while edge dropout is inactive), a
``regular`` layer one ``fused_gcn_spmm`` call (unless ``no_adj``);
``"auto"`` is off, the dense bands.  The attention mode picks its backend
from ``attention_impl`` instead: dense masked-softmax bands, or edge lists
(``sddmm`` → ``edge_softmax`` → weighted SpMM), ``"auto"`` by the size of
the [B, N, N] score buffer.  ``deterministic=False`` applies the JAX
model's stochastic points in its order, each drawn from the caller's
``torch.Generator``: embedding dropout (word ids only), input dropout, the
BiLSTM's inter-layer dropout, rnn dropout, then per GCN layer edge dropout
and deprel forgetting on the forward band, the same on the reverse band
(full_deprel only), and gcn dropout between layers.  Unpacked batches,
f32.  Other settings raise ``NotImplementedError``.

Parameters keep the flax names and layouts (``word_emb``,
``rnn.l0_fwd_w_ih [D, 4H]``, ``gcn_deprel_w0 [D, T, H]``,
``gcn_w0_kernel [T, H]``, ``attn_q0 [T, H]``, ``preprocessor.kernel
[T, H]``, ``mlp0.kernel [in, out]``, ...), so ``convert.params_from_jax``
carries a flax tree across name for name.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from gcn_tpu_torch import constants
from gcn_tpu_torch.config import ModelConfig
from gcn_tpu_torch.data.dataset import constants_for
from gcn_tpu_torch.ops.adjacency import build_adjacency
from gcn_tpu_torch.ops.band_aggregate import fused_band_aggregate
from gcn_tpu_torch.ops.deprel_bilinear import deprel_bilinear_batched
from gcn_tpu_torch.ops.dropout import (
    drop_edges,
    dropout,
    embedding_dropout_mask,
    forget_ids,
)
from gcn_tpu_torch.ops.gcn_layers import (
    compose_relation_transforms,
    diagonal_deprel_layer,
    full_deprel_layer,
    grouped_bilinear,
    make_group_plan,
    regular_layer,
    self_loop_traverse,
)
from gcn_tpu_torch.ops.lstm import bilstm
from gcn_tpu_torch.ops.pooling import pool
from gcn_tpu_torch.ops.sddmm import edge_softmax, sddmm
from gcn_tpu_torch.ops.spmm import (
    node_degrees,
    spmm_forward,
    spmm_reverse,
    valid_edges,
)
from gcn_tpu_torch.ops.spmm_fused import fused_gcn_spmm

# attention_impl="auto": the largest [B, N, N] f32 score buffer the dense
# backend may allocate before auto takes the edge backend (JAX's budget)
ATTN_DENSE_BYTE_BUDGET = 256 << 20


def resolve_attention_impl(impl: str, b: int, n: int) -> str:
    """The attention backend for a [B, N] batch, as JAX resolves it:
    "dense" or "edge" as asked; "auto" is dense while the [B, N, N] f32
    score buffer fits ``ATTN_DENSE_BYTE_BUDGET``, else edge."""
    if impl not in ("auto", "dense", "edge"):
        raise ValueError(f"unknown attention_impl {impl!r}: "
                         "expected auto | dense | edge")
    if impl == "auto":
        return "dense" if b * n * n * 4 <= ATTN_DENSE_BYTE_BUDGET else "edge"
    return impl


def _check_supported(cfg: ModelConfig) -> None:
    resolve_attention_impl(cfg.attention_impl, 0, 0)
    unsupported = {
        "adj_type": cfg.adj_type not in ("regular", "full_deprel",
                                         "attention", "diagonal_deprel"),
        "dataset": cfg.dataset not in ("tacred", "semeval"),
        "compute_dtype": cfg.compute_dtype != "float32",
        "use_pallas": cfg.use_pallas not in (True, False, "auto"),
        "graph_partition": cfg.graph_partition != "none",
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"the port runs f32 on one device; unsupported settings: "
            f"{', '.join(bad)}")


class TorchDense(nn.Module):
    """``x @ kernel + bias`` with flax's ``[in, out]`` kernel layout."""

    def __init__(self, fan_in: int, features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(fan_in, features))
        self.bias = nn.Parameter(torch.empty(features))

    def forward(self, x):
        return x @ self.kernel + self.bias


class BiLSTM(nn.Module):
    """Parameter container for ``ops.lstm.bilstm`` (``l{i}_{fwd,bwd}_*``)."""

    def __init__(self, in_dim: int, hidden: int, num_layers: int,
                 impl: str, dropout_rate: float):
        super().__init__()
        self.num_layers = num_layers
        self.impl = impl
        self.dropout_rate = dropout_rate
        for li in range(num_layers):
            for d in ("fwd", "bwd"):
                shapes = {"w_ih": (in_dim, 4 * hidden),
                          "w_hh": (hidden, 4 * hidden),
                          "b_ih": (4 * hidden,), "b_hh": (4 * hidden,)}
                for name, shape in shapes.items():
                    self.register_parameter(
                        f"l{li}_{d}_{name}",
                        nn.Parameter(torch.empty(shape)))
            in_dim = 2 * hidden

    def forward(self, x, lengths, deterministic=True, generator=None):
        params = [
            {d: {k: getattr(self, f"l{li}_{d}_{k}")
                 for k in ("w_ih", "w_hh", "b_ih", "b_hh")}
             for d in ("fwd", "bwd")}
            for li in range(self.num_layers)
        ]
        return bilstm(params, x, lengths, impl=self.impl,
                      inter_dropout=self.dropout_rate,
                      deterministic=deterministic, generator=generator)


class GCNClassifier(nn.Module):
    """Returns ``(logits, h_out)``: logits [B, C] and the sentence pooling
    output [B, H], both f32, as the JAX model does.

    ``unused_params`` names the parameters that no forward reaches (the
    one-wide deprel table of the regular and attention modes, kept for
    flax's tree): their gradient is zero, as under ``jax.grad``.  With
    ``use_bert_embeddings`` there is no ``word_emb``; ``ner_emb`` exists
    for TACRED only."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        if not cfg.use_bert_embeddings:
            self.word_emb = nn.Parameter(
                torch.empty(cfg.vocab_size, cfg.emb_dim))
        if cfg.pos_dim > 0:
            # SemEval's table has a 48th tag ("pad"), as in JAX
            n_pos = len(constants_for(cfg.dataset).POS_TO_ID)
            self.pos_emb = nn.Parameter(torch.empty(n_pos, cfg.pos_dim))
        if cfg.ner_dim > 0 and cfg.dataset == "tacred":
            self.ner_emb = nn.Parameter(
                torch.empty(len(constants.NER_TO_ID), cfg.ner_dim))
        if cfg.rnn:
            self.rnn = BiLSTM(cfg.input_dim, cfg.rnn_hidden, cfg.rnn_layers,
                              impl=cfg.rnn_impl,
                              dropout_rate=cfg.rnn_dropout)
        t0 = cfg.gcn_input_dim
        diagonal = cfg.adj_type == "diagonal_deprel"
        full = cfg.adj_type == "full_deprel"
        if diagonal:
            self.preprocessor = TorchDense(t0, cfg.hidden_dim)
        # the regular and attention modes' table is a one-wide dummy, as in
        # JAX; diagonal_deprel's rows are its gates, hidden_dim wide
        d = (cfg.deprel_emb_dim if full
             else cfg.hidden_dim if diagonal else 1)
        self.deprel_emb = nn.Parameter(
            torch.empty(len(constants.DEPREL_TO_ID), d))
        self.unused_params = frozenset(
            () if full or diagonal else {"deprel_emb"})
        if cfg.adj_type in ("regular", "attention"):
            for l in range(cfg.num_layers):
                t_l = t0 if l == 0 else cfg.hidden_dim
                names = ["gcn_w{}_kernel", "gcn_w{}_bias"]
                if cfg.adj_type == "attention":
                    names += ["attn_q{}", "attn_k{}"]
                for name in names:
                    shape = ((cfg.hidden_dim,) if name.endswith("bias")
                             else (t_l, cfg.hidden_dim))
                    self.register_parameter(
                        name.format(l), nn.Parameter(torch.empty(shape)))
        elif full and cfg.deprel_shared_w:
            # the reference's one W for every layer
            if cfg.num_layers > 1 and t0 != cfg.hidden_dim:
                raise ValueError(
                    "deprel_shared_w requires gcn_input_dim == hidden_dim "
                    "for stacked layers")
            self.gcn_deprel_w = nn.Parameter(
                torch.empty(d, t0, cfg.hidden_dim))
            self.gcn_deprel_b = nn.Parameter(torch.empty(d, cfg.hidden_dim))
        elif full:
            for l in range(cfg.num_layers):
                t_l = t0 if l == 0 else cfg.hidden_dim
                self.register_parameter(
                    f"gcn_deprel_w{l}",
                    nn.Parameter(torch.empty(d, t_l, cfg.hidden_dim)))
                self.register_parameter(
                    f"gcn_deprel_b{l}",
                    nn.Parameter(torch.empty(d, cfg.hidden_dim)))
        fan_in = 3 * cfg.hidden_dim
        for i in range(cfg.mlp_layers):
            setattr(self, f"mlp{i}", TorchDense(fan_in, cfg.hidden_dim))
            fan_in = cfg.hidden_dim
        self.classifier = TorchDense(fan_in, cfg.num_class)

    def deprel_weights(self, l: int):
        if self.cfg.deprel_shared_w:
            return self.gcn_deprel_w, self.gcn_deprel_b
        return (getattr(self, f"gcn_deprel_w{l}"),
                getattr(self, f"gcn_deprel_b{l}"))

    def gcn_weights(self, l: int):
        """The regular and attention modes' layer transform (kernel
        [T, H], bias [H])."""
        return (getattr(self, f"gcn_w{l}_kernel"),
                getattr(self, f"gcn_w{l}_bias"))

    def _use_factored(self) -> bool:
        v = self.cfg.deprel_factored
        return True if v in ("auto", "ragged", "pallas") else bool(v)

    def _bilinear_impl(self) -> str:
        return "ragged" if self.cfg.deprel_factored == "ragged" else "auto"

    def use_fused(self, deterministic: bool) -> bool:
        """Whether this forward takes the fused edge-list path, as JAX
        resolves it: ``use_pallas`` on ("auto" is off), and for the
        regular mode no ``no_adj``, for full_deprel no active edge dropout
        (a stochastic forward with ``edge_keep_prob < 1`` samples per-band
        masks, which the one-mask kernels do not model, and takes the
        dense bands).  The attention mode's backend is ``attention_impl``,
        not this flag."""
        cfg = self.cfg
        if cfg.use_pallas is not True or cfg.adj_type == "attention":
            return False
        if cfg.adj_type == "regular":
            return not cfg.no_adj
        return deterministic or cfg.edge_keep_prob >= 1.0

    def forward(self, batch: dict, deterministic: bool = True,
                generator=None):
        """``deterministic=False`` draws every dropout mask from
        ``generator`` (a ``torch.Generator`` on the batch's device)."""
        cfg = self.cfg
        if not deterministic and generator is None:
            raise ValueError("a stochastic forward needs a generator")
        words = batch["words"]
        if cfg.use_bert_embeddings and words.dim() != 3:
            raise ValueError("use_bert_embeddings needs float words "
                             f"[B, N, D], got {tuple(words.shape)}")
        n = words.shape[1]
        fused = self.use_fused(deterministic)
        attn_impl = None
        if cfg.adj_type == "attention":
            attn_impl = resolve_attention_impl(cfg.attention_impl,
                                               words.shape[0], n)
        if fused or attn_impl == "edge":
            # the kernels' operand types; no band is built on these paths
            edges = (batch["edge_parent"].to(torch.int32).contiguous(),
                     batch["edge_child"].to(torch.int32).contiguous(),
                     batch["edge_mask"].bool().contiguous())
            _, _, incident = node_degrees(*edges, n)
            adj, pool_exclude = None, ~incident
        else:
            adj = build_adjacency(batch["edge_parent"], batch["edge_child"],
                                  batch["edge_mask"], n)
            pool_exclude = adj.pool_mask

        if cfg.use_bert_embeddings:
            # precomputed word vectors go in as they are: no table, no
            # embedding dropout, no padding-row zeroing
            word_vecs = words.float()
        else:
            # embeddings (padding_idx=0 semantics for words)
            word_vecs = self.word_emb[words]
            mult = embedding_dropout_mask(words, cfg.vocab_size,
                                          cfg.emb_dropout, deterministic,
                                          generator)
            if mult is not None:
                word_vecs = word_vecs * mult
            word_vecs = word_vecs.masked_fill((words == 0)[..., None], 0.0)
        embs = [word_vecs]
        if cfg.pos_dim > 0:
            embs.append(self.pos_emb[batch["pos"]])
        if cfg.ner_dim > 0 and cfg.dataset == "tacred":
            embs.append(self.ner_emb[batch["ner"]])
        h = torch.cat(embs, dim=2)
        h = dropout(h, cfg.input_dropout, deterministic, generator)
        if cfg.rnn:
            h = self.rnn(h, batch["lengths"], deterministic, generator)
            h = dropout(h, cfg.rnn_dropout, deterministic, generator)

        deprel = batch["deprel"]
        if cfg.adj_type == "diagonal_deprel":
            h = self.preprocessor(h)
            e_fwd, e_rev, e_self = self._diagonal_gates(deprel)
        plans: dict = {}
        for l in range(cfg.num_layers):
            if cfg.adj_type == "regular":
                w, b = self.gcn_weights(l)
                if fused:
                    # the kernel applies the denominator and the ReLU
                    h = fused_gcn_spmm(*edges, h.contiguous(), w, b)
                else:
                    h = torch.relu(regular_layer(h, adj.combined, w, b,
                                                 cfg.no_adj) / adj.denom)
            elif cfg.adj_type == "attention":
                agg, hw, b = self._attention(
                    h, l, adj, None if attn_impl == "dense" else edges)
                # the self connection is unnormalized, and no denominator
                h = torch.relu(agg + hw + b)
            elif cfg.adj_type == "diagonal_deprel":
                if fused:
                    # the kernel applies the denominator and the ReLU; the
                    # self gate's broadcast is materialized for it, and
                    # autograd sums its gradient back to the table's row
                    h = fused_band_aggregate(*edges, e_fwd * h, e_rev * h,
                                             e_self * h)
                else:
                    h = torch.relu(diagonal_deprel_layer(
                        h, adj.forward, e_fwd, e_rev, e_self) / adj.denom)
            elif fused:
                x_f, x_r, x_s = self._full_deprel_components(
                    h, deprel, l, plans, deterministic, generator)
                h = fused_band_aggregate(*edges, x_f, x_r, x_s)
            else:
                axw = self._full_deprel_dense(h, adj, deprel, l, plans,
                                              deterministic, generator)
                h = torch.relu(axw / adj.denom)
            if l < cfg.num_layers - 1:
                h = dropout(h, cfg.gcn_dropout, deterministic, generator)

        h_out = pool(h, pool_exclude, cfg.pooling)
        subj_out = pool(h, ~batch["subj_mask"], cfg.pooling)
        obj_out = pool(h, ~batch["obj_mask"], cfg.pooling)
        out = torch.cat([h_out, subj_out, obj_out], dim=1)
        for i in range(cfg.mlp_layers):
            out = torch.relu(getattr(self, f"mlp{i}")(out))
        logits = self.classifier(out)
        return logits.float(), h_out.float()

    # ----------------------------------------------------------- attention
    def _attention(self, h, l, adj, edges):
        """One attention layer's aggregate, ``h @ W`` and bias: scaled
        dot-product scores ``q[dst]·k[src]/√H`` per tree edge, normalized
        over each destination's edges, weighting the ``h @ W`` messages of
        both bands.  The edge backend takes the edge lists ``edges``, the
        dense one (``edges`` None) the ``Adjacency``."""
        w, b = self.gcn_weights(l)
        q = h @ getattr(self, f"attn_q{l}")
        k = h @ getattr(self, f"attn_k{l}")
        hw = h @ w
        scale = 1.0 / math.sqrt(self.cfg.hidden_dim)
        if edges is None:
            return self._attention_dense(q, k, hw, adj, scale), hw, b
        ep, ec, em = edges
        n = h.shape[1]
        ok = valid_edges(ep, ec, em, n)
        # forward band: messages child → parent, normalized at the parent
        a_f = edge_softmax(ep, sddmm(ep, ec, ok, q, k) * scale, ok, n)
        agg = spmm_forward(hw, ep, ec, ok, edge_weights=a_f)
        # reverse band: messages parent → child, normalized at the child
        a_r = edge_softmax(ec, sddmm(ec, ep, ok, q, k) * scale, ok, n)
        agg = agg + spmm_reverse(hw, ep, ec, ok, edge_weights=a_r)
        return agg, hw, b

    @staticmethod
    def _attention_dense(q, k, hw, adj, scale):
        """Both bands share one score matrix ``S[b,x,y] = q[x]·k[y]``; a
        masked softmax per destination row, each term weighted by its
        edge count (a duplicated edge counts twice in the softmax and the
        aggregate, as on the edge lists), then a dense aggregate.  The
        row maximum is a constant of the softmax (JAX stops its
        gradient)."""
        s = torch.einsum("bxh,byh->bxy", q, k) * scale
        agg = None
        for cnt in (adj.forward, adj.reverse):  # destination = parent, child
            m = cnt > 0
            sm = torch.where(m, s, torch.full((), -1e30, dtype=s.dtype,
                                              device=s.device))
            mx = sm.amax(dim=2, keepdim=True).detach()
            ex = torch.where(m, cnt * torch.exp(sm - mx),
                             torch.zeros((), dtype=s.dtype, device=s.device))
            den = ex.sum(dim=2, keepdim=True).clamp(min=1e-30)
            band = (ex / den) @ hw
            agg = band if agg is None else agg + band
        return agg

    # ----------------------------------------------------- diagonal_deprel
    def _diagonal_gates(self, deprel):
        """(e_fwd [B, N, H], e_rev [B, N, H], e_self [H]): the forward gate
        at each token's deprel id, zero at id 0 (padding); the reverse gate
        at the token's own id + 42 (the reference indexes the reverse band
        by the message sender's id), not zeroed, so padding reads row 42;
        the self-loop row.  The same for every layer, as JAX reads them."""
        table = self.deprel_emb
        e_fwd = self._table_rows(table, deprel).masked_fill(
            (deprel == 0)[..., None], 0.0)
        e_rev = self._table_rows(table,
                                 deprel + constants.DEPREL_FORWARD_BOUND)
        return e_fwd, e_rev, table[constants.SELF_LOOP_INDEX]

    @staticmethod
    def _table_rows(table, ids):
        """``table[ids]`` for ids [B, N] → [B, N, D] as a one-hot matmul
        (JAX gathers): its backward is one ``onehotᵀ @ g`` product, where
        PyTorch's index backward serialises on repeated rows (89 rows for
        the 4800 tokens of a band: 6.3 ms of the non-factored C-GCN's train
        step on an H100 at B=50, N=96)."""
        onehot = torch.nn.functional.one_hot(ids.long(), table.shape[0])
        return onehot.to(table.dtype) @ table

    # --------------------------------------------------------- full_deprel
    def _relation_table(self):
        """The relation table + an all-ones row (forgotten relations and
        layers past ``deprel_max_depth``) and an all-zeros row (padding)."""
        table = self.deprel_emb
        d = table.shape[1]
        return torch.cat([table, table.new_ones((1, d)),
                          table.new_zeros((1, d))], dim=0)

    def _relation_rows(self, ids):
        """The relation table's rows for ids [B, N] → [B, N, D]."""
        return self._table_rows(self._relation_table(), ids)

    def _factored_tables(self, w, b):
        """The relation table's rows composed with W and b."""
        return compose_relation_transforms(self._relation_table(), w, b)

    def _group_plan(self, plans, key, ids, n_groups, deterministic):
        """The sort plan, shared across layers when the relation ids cannot
        differ between them (no deprel forgetting in this forward)."""
        reusable = deterministic or self.cfg.deprel_keep_prop >= 1.0
        if reusable and key in plans:
            return plans[key]
        plan = make_group_plan(ids, n_groups)
        if reusable:
            plans[key] = plan
        return plan

    def _band_ids(self, ids, l, deterministic, generator):
        """One band's relation ids: forgetting → the all-ones row; past
        deprel_max_depth every token takes the all-ones row."""
        ones_id = self.deprel_emb.shape[0]
        ids = forget_ids(ids, ones_id, self.cfg.deprel_keep_prop,
                         deterministic, generator)
        if l >= self.cfg.deprel_max_depth:
            return torch.full_like(ids, ones_id)
        return ids

    def _band_inputs(self, adj, deprel, l, deterministic, generator):
        """(a_f, ids_f, a_r, ids_r): each band's (edge-dropped) adjacency
        and relation ids, drawn in JAX's order (edge drop forward, forget
        forward, edge drop reverse, forget reverse), so that the factored
        and the non-factored paths consume one generator alike.  The
        bands are None without ``adj`` (the fused path, where edge
        dropout is inactive), the reverse ones for a directed model."""
        cfg = self.cfg
        zero_id = self.deprel_emb.shape[0] + 1
        a_f = a_r = ids_r = None
        if adj is not None:
            a_f = drop_edges(adj.forward, cfg.edge_keep_prob, deterministic,
                             generator)
        # forward band: id 0 (padding) takes the all-zeros row
        ids_f = self._band_ids(torch.where(deprel == 0, zero_id, deprel), l,
                               deterministic, generator)
        if not cfg.deprel_directed:
            if adj is not None:
                a_r = drop_edges(adj.reverse, cfg.edge_keep_prob,
                                 deterministic, generator)
            ids_r = self._band_ids(deprel + constants.DEPREL_FORWARD_BOUND,
                                   l, deterministic, generator)
        return a_f, ids_f, a_r, ids_r

    def _band_messages(self, h, ids_f, ids_r, l, plans, deterministic):
        """(x_f, x_r): h through each band's relation transforms, by one
        grouped matmul over the stacked bands (they share S); x_r is None
        for a directed model (``ids_r`` None)."""
        w, b = self.deprel_weights(l)
        s, bs = self._factored_tables(w, b)
        past_depth = l >= self.cfg.deprel_max_depth
        impl = self._bilinear_impl()
        if ids_r is None:
            plan = self._group_plan(plans, ("fwd", past_depth), ids_f,
                                    s.shape[0], deterministic)
            return grouped_bilinear(h, ids_f, s, bs, impl=impl,
                                    plan=plan), None
        ids2 = torch.cat([ids_f, ids_r], dim=0)
        plan = self._group_plan(plans, ("stk", past_depth), ids2,
                                s.shape[0], deterministic)
        x2 = grouped_bilinear(torch.cat([h, h], dim=0), ids2, s, bs,
                              impl=impl, plan=plan)
        bsz = h.shape[0]
        return x2[:bsz], x2[bsz:]

    def _self_loop_emb(self, l):
        """The self-loop relation's embedding (all-ones past
        deprel_max_depth), or None without the self loop."""
        if not self.cfg.deprel_self_loop:
            return None
        e_self = self.deprel_emb[constants.SELF_LOOP_INDEX]
        if l >= self.cfg.deprel_max_depth:
            e_self = torch.ones_like(e_self)
        return e_self

    def _full_deprel_dense(self, h, adj, deprel, l, plans, deterministic,
                           generator):
        """The dense-band full_deprel layer before its denominator:
        factored (grouped matmul) or the einsum ``full_deprel_layer``."""
        a_f, ids_f, a_r, ids_r = self._band_inputs(adj, deprel, l,
                                                   deterministic, generator)
        w, b = self.deprel_weights(l)
        e_self = self._self_loop_emb(l)
        if not self._use_factored():
            e_rev = None if ids_r is None else self._relation_rows(ids_r)
            return full_deprel_layer(h, a_f, self._relation_rows(ids_f),
                                     e_rev, e_self, w, b, adj_reverse=a_r)
        x_f, x_r = self._band_messages(h, ids_f, ids_r, l, plans,
                                       deterministic)
        out = a_f @ x_f
        if x_r is not None:
            out = out + a_r @ x_r
        if e_self is not None:
            out = out + self_loop_traverse(h, e_self, w, b)
        return out

    def _full_deprel_components(self, h, deprel, l, plans, deterministic,
                                generator):
        """(x_f, x_r, x_s) of the fused path, contiguous for the kernel:
        the layer is ``(A_f x_f + A_fᵀ x_r + x_s)/denom``, x_r zero for a
        directed model, x_s zero without the self loop.  Edge dropout is
        inactive here, so only forgetting draws.  The per-token transform
        is the grouped matmul (factored) or the ``deprel_bilinear`` v2
        kernel (``deprel_factored=False``)."""
        _, ids_f, _, ids_r = self._band_inputs(None, deprel, l,
                                               deterministic, generator)
        w, b = self.deprel_weights(l)
        if self._use_factored():
            x_f, x_r = self._band_messages(h, ids_f, ids_r, l, plans,
                                           deterministic)
        else:
            x_f = deprel_bilinear_batched(h, self._relation_rows(ids_f), w, b)
            x_r = (None if ids_r is None else deprel_bilinear_batched(
                h, self._relation_rows(ids_r), w, b))
        if x_r is None:
            x_r = torch.zeros_like(x_f)
        e_self = self._self_loop_emb(l)
        if e_self is not None:
            x_s = self_loop_traverse(h, e_self, w, b)
        else:
            x_s = torch.zeros_like(x_f)
        return x_f.contiguous(), x_r.contiguous(), x_s.contiguous()


@torch.no_grad()
def init_params(model: GCNClassifier, generator: torch.Generator) -> None:
    """Random parameters with the JAX model's initial distributions, drawn
    from ``generator`` (on the CPU; the values do not depend on the
    device)."""
    cfg = model.cfg

    def uniform(p, bound):
        p.copy_(torch.rand(p.shape, generator=generator) * 2 * bound - bound)

    def normal(p):
        p.copy_(torch.randn(p.shape, generator=generator))

    if not cfg.use_bert_embeddings:
        uniform(model.word_emb, 1.0)
        model.word_emb[constants.PAD_ID] = 0.0
    if cfg.pos_dim > 0:
        normal(model.pos_emb)
    if cfg.ner_dim > 0 and cfg.dataset == "tacred":
        normal(model.ner_emb)
    if cfg.rnn:
        for p in model.rnn.parameters():
            uniform(p, 1.0 / math.sqrt(cfg.rnn_hidden))
    normal(model.deprel_emb)
    model.deprel_emb[0] = 0.0
    if cfg.adj_type in ("regular", "attention"):
        for l in range(cfg.num_layers):
            w, b = model.gcn_weights(l)
            bound = 1.0 / math.sqrt(w.shape[0])
            uniform(w, bound)
            uniform(b, bound)
            if cfg.adj_type == "attention":
                uniform(getattr(model, f"attn_q{l}"), bound)
                uniform(getattr(model, f"attn_k{l}"), bound)
    elif cfg.adj_type == "full_deprel":
        for l in range(1 if cfg.deprel_shared_w else cfg.num_layers):
            w, b = model.deprel_weights(l)
            bound = 1.0 / math.sqrt(w.shape[1])
            uniform(w, bound)
            uniform(b, bound)
    dense = [getattr(model, f"mlp{i}") for i in range(cfg.mlp_layers)]
    if cfg.adj_type == "diagonal_deprel":
        dense.append(model.preprocessor)
    for layer in dense + [model.classifier]:
        bound = 1.0 / math.sqrt(layer.kernel.shape[0])
        uniform(layer.kernel, bound)
        uniform(layer.bias, bound)
