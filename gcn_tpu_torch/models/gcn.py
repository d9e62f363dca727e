"""The C-GCN and the paper's GCN relation classifier.

Counterpart of ``gcn_tpu.models.gcn.GCNClassifier`` for the two
configurations the repo ships: ``cgcn_preset`` (embeddings → BiLSTM →
``full_deprel`` GCN layers on the factored path → pooling → MLP → logits)
and ``gcn_preset`` (the ``regular`` mode, with or without the BiLSTM),
differentiable end to end.  With ``use_pallas=True`` the GCN layers run
on the fused edge-list path as in JAX, with no [B, N, N] band: a
``full_deprel`` layer is one ``fused_band_aggregate`` call (while edge
dropout is inactive), a ``regular`` layer one ``fused_gcn_spmm`` call
(unless ``no_adj``); ``"auto"`` is off, the dense bands.
``deterministic=False`` applies the JAX model's stochastic points in its
order, each drawn from the caller's ``torch.Generator``: embedding
dropout, input dropout, the BiLSTM's inter-layer dropout, rnn dropout,
then per GCN layer edge dropout and deprel forgetting on the forward
band, the same on the reverse band, and gcn dropout between layers.
Unpacked batches, f32.  Other modes raise ``NotImplementedError``.

Parameters keep the flax names and layouts (``word_emb``,
``rnn.l0_fwd_w_ih [D, 4H]``, ``gcn_deprel_w0 [D, T, H]``,
``gcn_w0_kernel [T, H]``, ``mlp0.kernel [in, out]``, ...), so
``convert.params_from_jax`` carries a flax tree across name for name.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from gcn_tpu_torch import constants
from gcn_tpu_torch.config import ModelConfig
from gcn_tpu_torch.ops.adjacency import build_adjacency
from gcn_tpu_torch.ops.band_aggregate import fused_band_aggregate
from gcn_tpu_torch.ops.dropout import (
    drop_edges,
    dropout,
    embedding_dropout_mask,
    forget_ids,
)
from gcn_tpu_torch.ops.gcn_layers import (
    compose_relation_transforms,
    grouped_bilinear,
    make_group_plan,
    regular_layer,
    self_loop_traverse,
)
from gcn_tpu_torch.ops.lstm import bilstm
from gcn_tpu_torch.ops.pooling import pool
from gcn_tpu_torch.ops.spmm import node_degrees
from gcn_tpu_torch.ops.spmm_fused import fused_gcn_spmm


def _check_supported(cfg: ModelConfig) -> None:
    unsupported = {
        "adj_type": cfg.adj_type not in ("regular", "full_deprel"),
        "deprel_factored": (cfg.adj_type == "full_deprel"
                            and cfg.deprel_factored is False),
        "dataset": cfg.dataset != "tacred",
        "use_bert_embeddings": cfg.use_bert_embeddings,
        "compute_dtype": cfg.compute_dtype != "float32",
        "use_pallas": cfg.use_pallas not in (True, False, "auto"),
        "graph_partition": cfg.graph_partition != "none",
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"the port runs the regular mode and the factored full_deprel "
            f"mode; unsupported settings: {', '.join(bad)}")


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
    regular mode's one-wide deprel table, kept for flax's tree): their
    gradient is zero, as under ``jax.grad``."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.word_emb = nn.Parameter(torch.empty(cfg.vocab_size, cfg.emb_dim))
        if cfg.pos_dim > 0:
            self.pos_emb = nn.Parameter(
                torch.empty(len(constants.POS_TO_ID), cfg.pos_dim))
        if cfg.ner_dim > 0:
            self.ner_emb = nn.Parameter(
                torch.empty(len(constants.NER_TO_ID), cfg.ner_dim))
        in_dim = cfg.emb_dim + cfg.pos_dim + cfg.ner_dim
        if cfg.rnn:
            self.rnn = BiLSTM(in_dim, cfg.rnn_hidden, cfg.rnn_layers,
                              impl=cfg.rnn_impl,
                              dropout_rate=cfg.rnn_dropout)
        t0 = 2 * cfg.rnn_hidden if cfg.rnn else in_dim
        # the regular mode's table is a one-wide dummy, as in JAX
        d = cfg.deprel_emb_dim if cfg.adj_type == "full_deprel" else 1
        self.deprel_emb = nn.Parameter(
            torch.empty(len(constants.DEPREL_TO_ID), d))
        self.unused_params = frozenset(
            {"deprel_emb"} if cfg.adj_type == "regular" else ())
        if cfg.adj_type == "regular":
            for l in range(cfg.num_layers):
                t_l = t0 if l == 0 else cfg.hidden_dim
                self.register_parameter(
                    f"gcn_w{l}_kernel",
                    nn.Parameter(torch.empty(t_l, cfg.hidden_dim)))
                self.register_parameter(
                    f"gcn_w{l}_bias", nn.Parameter(torch.empty(
                        cfg.hidden_dim)))
        elif cfg.deprel_shared_w:
            # the reference's one W for every layer
            if cfg.num_layers > 1 and t0 != cfg.hidden_dim:
                raise ValueError(
                    "deprel_shared_w requires gcn_input_dim == hidden_dim "
                    "for stacked layers")
            self.gcn_deprel_w = nn.Parameter(
                torch.empty(d, t0, cfg.hidden_dim))
            self.gcn_deprel_b = nn.Parameter(torch.empty(d, cfg.hidden_dim))
        else:
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
        """The regular mode's layer transform (kernel [T, H], bias [H])."""
        return (getattr(self, f"gcn_w{l}_kernel"),
                getattr(self, f"gcn_w{l}_bias"))

    def _bilinear_impl(self) -> str:
        return "ragged" if self.cfg.deprel_factored == "ragged" else "auto"

    def use_fused(self, deterministic: bool) -> bool:
        """Whether this forward takes the fused edge-list path, as JAX
        resolves it: ``use_pallas`` on ("auto" is off), and for the
        regular mode no ``no_adj``, for full_deprel no active edge dropout
        (a stochastic forward with ``edge_keep_prob < 1`` samples per-band
        masks, which the one-mask kernels do not model, and takes the
        dense bands)."""
        cfg = self.cfg
        if cfg.use_pallas is not True:
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
        n = words.shape[1]
        fused = self.use_fused(deterministic)
        if fused:
            # the kernels' operand types; no band is built on this path
            edges = (batch["edge_parent"].to(torch.int32).contiguous(),
                     batch["edge_child"].to(torch.int32).contiguous(),
                     batch["edge_mask"].bool().contiguous())
            _, _, incident = node_degrees(*edges, n)
            adj, pool_exclude = None, ~incident
        else:
            adj = build_adjacency(batch["edge_parent"], batch["edge_child"],
                                  batch["edge_mask"], n)
            pool_exclude = adj.pool_mask

        # embeddings (padding_idx=0 semantics for words)
        word_vecs = self.word_emb[words]
        mult = embedding_dropout_mask(words, cfg.vocab_size, cfg.emb_dropout,
                                      deterministic, generator)
        if mult is not None:
            word_vecs = word_vecs * mult
        word_vecs = word_vecs.masked_fill((words == 0)[..., None], 0.0)
        embs = [word_vecs]
        if cfg.pos_dim > 0:
            embs.append(self.pos_emb[batch["pos"]])
        if cfg.ner_dim > 0:
            embs.append(self.ner_emb[batch["ner"]])
        h = torch.cat(embs, dim=2)
        h = dropout(h, cfg.input_dropout, deterministic, generator)
        if cfg.rnn:
            h = self.rnn(h, batch["lengths"], deterministic, generator)
            h = dropout(h, cfg.rnn_dropout, deterministic, generator)

        deprel = batch["deprel"]
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
            elif fused:
                x_f, x_r, x_s = self._full_deprel_components(
                    h, deprel, l, plans, deterministic, generator)
                h = fused_band_aggregate(*edges, x_f, x_r, x_s)
            else:
                axw = self._full_deprel_factored(h, adj, deprel, l, plans,
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

    def _factored_tables(self, w, b):
        """Relation table + an all-ones and an all-zeros row, composed."""
        table = self.deprel_emb
        d = table.shape[1]
        table_aug = torch.cat([table, table.new_ones((1, d)),
                               table.new_zeros((1, d))], dim=0)
        return compose_relation_transforms(table_aug, w, b)

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

    def _self_loop(self, h, l):
        """The self-loop transform of h (all-ones past deprel_max_depth)."""
        w, b = self.deprel_weights(l)
        e_self = self.deprel_emb[constants.SELF_LOOP_INDEX]
        if l >= self.cfg.deprel_max_depth:
            e_self = torch.ones_like(e_self)
        return self_loop_traverse(h, e_self, w, b)

    def _full_deprel_factored(self, h, adj, deprel, l, plans, deterministic,
                              generator):
        """The dense-band full_deprel layer before its denominator."""
        cfg = self.cfg
        zero_id = self.deprel_emb.shape[0] + 1
        # forward band: id 0 (padding) takes the all-zeros row
        a_f = drop_edges(adj.forward, cfg.edge_keep_prob, deterministic,
                         generator)
        ids_f = self._band_ids(torch.where(deprel == 0, zero_id, deprel), l,
                               deterministic, generator)
        ids_r = None
        if not cfg.deprel_directed:
            a_r = drop_edges(adj.reverse, cfg.edge_keep_prob, deterministic,
                             generator)
            ids_r = self._band_ids(deprel + constants.DEPREL_FORWARD_BOUND,
                                   l, deterministic, generator)
        x_f, x_r = self._band_messages(h, ids_f, ids_r, l, plans,
                                       deterministic)
        out = a_f @ x_f
        if x_r is not None:
            out = out + a_r @ x_r
        if cfg.deprel_self_loop:
            out = out + self._self_loop(h, l)
        return out

    def _full_deprel_components(self, h, deprel, l, plans, deterministic,
                                generator):
        """(x_f, x_r, x_s) of the fused path, contiguous for the kernel:
        the layer is ``(A_f x_f + A_fᵀ x_r + x_s)/denom``, x_r zero for a
        directed model, x_s zero without the self loop.  Edge dropout is
        inactive here, so only forgetting draws."""
        cfg = self.cfg
        zero_id = self.deprel_emb.shape[0] + 1
        ids_f = self._band_ids(torch.where(deprel == 0, zero_id, deprel), l,
                               deterministic, generator)
        ids_r = None
        if not cfg.deprel_directed:
            ids_r = self._band_ids(deprel + constants.DEPREL_FORWARD_BOUND,
                                   l, deterministic, generator)
        x_f, x_r = self._band_messages(h, ids_f, ids_r, l, plans,
                                       deterministic)
        if x_r is None:
            x_r = torch.zeros_like(x_f)
        if cfg.deprel_self_loop:
            x_s = self._self_loop(h, l)
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

    uniform(model.word_emb, 1.0)
    model.word_emb[constants.PAD_ID] = 0.0
    if cfg.pos_dim > 0:
        normal(model.pos_emb)
    if cfg.ner_dim > 0:
        normal(model.ner_emb)
    if cfg.rnn:
        for p in model.rnn.parameters():
            uniform(p, 1.0 / math.sqrt(cfg.rnn_hidden))
    normal(model.deprel_emb)
    model.deprel_emb[0] = 0.0
    if cfg.adj_type == "regular":
        for l in range(cfg.num_layers):
            w, b = model.gcn_weights(l)
            bound = 1.0 / math.sqrt(w.shape[0])
            uniform(w, bound)
            uniform(b, bound)
    else:
        for l in range(1 if cfg.deprel_shared_w else cfg.num_layers):
            w, b = model.deprel_weights(l)
            bound = 1.0 / math.sqrt(w.shape[1])
            uniform(w, bound)
            uniform(b, bound)
    dense = [getattr(model, f"mlp{i}") for i in range(cfg.mlp_layers)]
    for layer in dense + [model.classifier]:
        bound = 1.0 / math.sqrt(layer.kernel.shape[0])
        uniform(layer.kernel, bound)
        uniform(layer.bias, bound)

