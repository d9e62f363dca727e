"""The C-GCN and the paper's GCN in plain PyTorch, float32: the
parameters, the forward pass with its dropout, the training loss and the
sgd step with its global-norm clip, written from the model's equations
(Zhang, Qi & Manning, EMNLP 2018; its reference code's ``model/gcn.py``)
with no kernel, graph or cache.

The parameters keep one layout with the program under test, so that the
benchmark can hand both the same weights: matrices ``[in, out]``, the
BiLSTM's ``w_ih [D, 4H]`` and ``w_hh [H, 4H]`` in gate order i, f, g, o,
the deprel weights ``[D, T, H]``.  Dropout masks are ``torch.rand`` draws
below the keep probability from the step's generator, in the forward's
order: input, rnn, then between GCN layers.  A ``full_deprel`` layer is the
per-token bilinear ``x[m] = sum_d e[m, d] (h[m] W[d] + b[d])`` over the
forward band (``e`` the token's relation row; padding the zero row) and the
reverse band (the relation + 42), plus the self loop through row 84;
``regular`` is ``((A + A^T + I_incident) h + h) W + 2b``; both divide by
``deg_out + deg_in + incident + 1`` under a ReLU.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import tacred_ids as ids


def param_spec(m: dict) -> list[tuple]:
    """(name, shape, init, bound) of every parameter of model config
    ``m``; init is "uniform" (in ±bound) or "normal"; ``word_emb``'s and
    ``deprel_emb``'s row 0 are zero."""
    spec = [("word_emb", (m["vocab_size"], m["emb_dim"]), "uniform", 1.0),
            ("pos_emb", (len(ids.POS_TO_ID), m["pos_dim"]), "normal", 0),
            ("ner_emb", (len(ids.NER_TO_ID), m["ner_dim"]), "normal", 0)]
    d_in = m["emb_dim"] + m["pos_dim"] + m["ner_dim"]
    if m["rnn"]:
        h = m["rnn_hidden"]
        bound = 1.0 / math.sqrt(h)
        for d in ("fwd", "bwd"):
            spec += [(f"rnn.l0_{d}_w_ih", (d_in, 4 * h), "uniform", bound),
                     (f"rnn.l0_{d}_w_hh", (h, 4 * h), "uniform", bound),
                     (f"rnn.l0_{d}_b_ih", (4 * h,), "uniform", bound),
                     (f"rnn.l0_{d}_b_hh", (4 * h,), "uniform", bound)]
        d_in = 2 * h
    full = m["adj_type"] == "full_deprel"
    spec.append(("deprel_emb", (ids.DEPREL_ROWS,
                                m["deprel_emb_dim"] if full else 1),
                 "normal", 0))
    hid = m["hidden_dim"]
    for l in range(m["num_layers"]):
        t = d_in if l == 0 else hid
        bound = 1.0 / math.sqrt(t)
        if full:
            dd = m["deprel_emb_dim"]
            spec += [(f"gcn_deprel_w{l}", (dd, t, hid), "uniform", bound),
                     (f"gcn_deprel_b{l}", (dd, hid), "uniform", bound)]
        else:
            spec += [(f"gcn_w{l}_kernel", (t, hid), "uniform", bound),
                     (f"gcn_w{l}_bias", (hid,), "uniform", bound)]
    fan = 3 * hid
    for i in range(m["mlp_layers"]):
        spec += [(f"mlp{i}.kernel", (fan, hid), "uniform",
                  1 / math.sqrt(fan)),
                 (f"mlp{i}.bias", (hid,), "uniform", 1 / math.sqrt(fan))]
        fan = hid
    spec += [("classifier.kernel", (fan, m["num_class"]), "uniform",
              1 / math.sqrt(fan)),
             ("classifier.bias", (m["num_class"],), "uniform",
              1 / math.sqrt(fan))]
    return spec


def make_weights(m: dict, seed: int, device) -> dict:
    """Every parameter from ``seed``, on ``device`` in f32: one ``rand``
    call for the uniform ones and one ``randn`` for the normal ones, from
    a ``torch.Generator`` on that device."""
    spec = param_spec(m)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    sizes = {k: [int(np.prod(s)) for _, s, init, _ in spec if init == k]
             for k in ("uniform", "normal")}
    u = torch.rand(sum(sizes["uniform"]), generator=gen, device=device)
    n = torch.randn(sum(sizes["normal"]), generator=gen, device=device)
    at = {"uniform": 0, "normal": 0}
    out = {}
    for name, shape, init, bound in spec:
        size = int(np.prod(shape))
        flat = (u if init == "uniform" else n)[at[init]:at[init] + size]
        at[init] += size
        p = flat.view(shape)
        if init == "uniform":
            p = p * (2 * bound) - bound
        out[name] = p
    out["word_emb"][ids.PAD_ID] = 0.0
    out["deprel_emb"][0] = 0.0
    return out


def _dropout(x, rate, gen):
    if gen is None or rate <= 0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _reverse(x, lengths):
    """Each row's first ``length`` steps reversed; the tail zero."""
    t = x.shape[1]
    pos = torch.arange(t, device=x.device)[None, :]
    idx = (lengths[:, None] - 1 - pos).clamp(min=0)
    rev = torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))
    return rev * (pos < lengths[:, None])[:, :, None]


def bilstm(P, x, lengths):
    """[B, T, D] → [B, T, 2H]: both directions, the reverse one over the
    reversed valid prefix; state frozen and output zero past the length."""
    b, t, _ = x.shape
    xs = torch.stack([x, _reverse(x, lengths)])               # [2, B, T, D]
    w_ih = torch.stack([P["rnn.l0_fwd_w_ih"], P["rnn.l0_bwd_w_ih"]])
    w_hh = torch.stack([P["rnn.l0_fwd_w_hh"], P["rnn.l0_bwd_w_hh"]])
    bias = torch.stack([P["rnn.l0_fwd_b_ih"] + P["rnn.l0_fwd_b_hh"],
                        P["rnn.l0_bwd_b_ih"] + P["rnn.l0_bwd_b_hh"]])
    xp = torch.einsum("zbtd,zdg->zbtg", xs, w_ih) + bias[:, None, None, :]
    hid = w_hh.shape[1]
    h = x.new_zeros(2, b, hid)
    c = x.new_zeros(2, b, hid)
    outs = []
    for step in range(t):
        g = xp[:, :, step] + torch.bmm(h, w_hh)
        i, f, gg, o = g.split(hid, dim=2)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        live = (step < lengths)[None, :, None]
        c = torch.where(live, c_new, c)
        h = torch.where(live, h_new, h)
        outs.append(h_new * live)
    hs = torch.stack(outs, dim=2)                            # [2, B, T, H]
    return torch.cat([hs[0], _reverse(hs[1], lengths)], dim=2)


def _full_deprel(P, m, h, batch, l, adj):
    table = P["deprel_emb"]
    dd = table.shape[1]
    ext = torch.cat([table, table.new_ones(1, dd), table.new_zeros(1, dd)])
    deprel = batch["deprel"]
    ones_row, zero_row = ids.DEPREL_ROWS, ids.DEPREL_ROWS + 1
    if l >= m["deprel_max_depth"]:
        e_f = e_r = ext[torch.full_like(deprel, ones_row)]
        e_self = torch.ones_like(table[ids.SELF_LOOP_INDEX])
    else:
        e_f = ext[torch.where(deprel == 0, zero_row, deprel)]
        e_r = ext[deprel + ids.DEPREL_FORWARD_BOUND]
        e_self = table[ids.SELF_LOOP_INDEX]
    w, b = P[f"gcn_deprel_w{l}"], P[f"gcn_deprel_b{l}"]
    y = torch.einsum("bnt,dth->bndh", h, w)
    x_f = torch.einsum("bnd,bndh->bnh", e_f, y) + e_f @ b
    x_r = torch.einsum("bnd,bndh->bnh", e_r, y) + e_r @ b
    loop = h @ torch.einsum("d,dth->th", e_self, w) + e_self @ b
    return adj @ x_f + adj.transpose(1, 2) @ x_r + loop


SUPPORTED = {"rnn_layers": 1, "emb_dropout": 0.0, "edge_keep_prob": 1.0,
             "deprel_keep_prop": 1.0, "deprel_self_loop": True,
             "deprel_directed": False, "deprel_shared_w": False,
             "pooling": "max", "dataset": "tacred",
             "compute_dtype": "float32"}


def forward(P, m, batch, gen=None):
    """(logits [B, C], pooled sentence [B, H]); ``gen`` None: no
    dropout.  Raises for settings this reference does not model."""
    off = {k: m[k] for k, v in SUPPORTED.items() if m[k] != v}
    if off or m["adj_type"] not in ("full_deprel", "regular"):
        raise NotImplementedError(f"the reference does not model {off} "
                                  f"/ adj_type {m['adj_type']!r}")
    words = batch["words"]
    wv = P["word_emb"][words] * (words != ids.PAD_ID)[:, :, None]
    h = torch.cat([wv, P["pos_emb"][batch["pos"]],
                   P["ner_emb"][batch["ner"]]], dim=2)
    h = _dropout(h, m["input_dropout"], gen)
    lengths = batch["lengths"]
    if m["rnn"]:
        h = _dropout(bilstm(P, h, lengths), m["rnn_dropout"], gen)
    adj = batch["adj"]
    deg = adj.sum(2) + adj.sum(1)
    incident = deg > 0
    denom = (deg + incident.float() + 1.0)[:, :, None]
    for l in range(m["num_layers"]):
        if m["adj_type"] == "full_deprel":
            out = _full_deprel(P, m, h, batch, l, adj)
        else:
            ah = (adj @ h + adj.transpose(1, 2) @ h
                  + incident[:, :, None] * h + h)
            out = ah @ P[f"gcn_w{l}_kernel"] + 2 * P[f"gcn_w{l}_bias"]
        h = torch.relu(out / denom)
        if l < m["num_layers"] - 1:
            h = _dropout(h, m["gcn_dropout"], gen)

    def pool(keep):
        return h.masked_fill(~keep[:, :, None], -ids.INFINITY).amax(1)

    pooled = pool(incident)
    x = torch.cat([pooled, pool(batch["subj"]), pool(batch["obj"])], dim=1)
    for i in range(m["mlp_layers"]):
        x = torch.relu(x @ P[f"mlp{i}.kernel"] + P[f"mlp{i}.bias"])
    return x @ P["classifier.kernel"] + P["classifier.bias"], pooled


def loss_fn(P, m, t, batch, gen):
    """Cross-entropy over the batch's real rows plus ``pooling_l2`` times
    their squared pooled sentence and ``conv_l2`` times the squared GCN
    weights."""
    logits, pooled = forward(P, m, batch, gen)
    valid = batch["valid"].float()
    count = valid.sum().clamp(min=1.0)
    loss = (F.cross_entropy(logits, batch["labels"], reduction="none")
            * valid).sum() / count
    if t.get("pooling_l2", 0) > 0:
        loss = loss + t["pooling_l2"] * (pooled.square().sum(1)
                                         * valid).sum() / count
    if t.get("conv_l2", 0) > 0:
        loss = loss + t["conv_l2"] * sum(
            p.square().sum() for k, p in P.items()
            if k.startswith(("gcn_w", "gcn_deprel_")))
    return loss


def sgd_step(P, m, t, batch, gen):
    """One step in place: the loss, every gradient clipped together to
    global norm ``max_grad_norm``, ``p -= lr * g``.  Returns the loss."""
    leaves = {k: v.detach().requires_grad_() for k, v in P.items()}
    loss = loss_fn(leaves, m, t, batch, gen)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves.values())]
    norm = torch.sqrt(sum(g.double().square().sum() for g in grads))
    scale = min(1.0, t["max_grad_norm"] / float(norm))
    with torch.no_grad():
        for k, g in zip(leaves, grads):
            P[k] = P[k] - t["lr"] * scale * g
    return float(loss.detach())


def scores(P, m, batch):
    """(probabilities [B, C] f64, each row's cross-entropy [B] f64) of the
    deterministic forward."""
    with torch.no_grad():
        logits, _ = forward(P, m, batch)
        logits = logits.double()
        return (torch.softmax(logits, dim=1),
                F.cross_entropy(logits, batch["labels"], reduction="none"))
