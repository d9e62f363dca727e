"""Reference PyTorch checkpoints → gcn_tpu's parameter tree.

Counterpart of ``gcn_tpu.compat.torch_import``, array for array: the
reference's ``nn.Linear`` weights ``[out, in]`` are transposed to the
flax ``[in, out]`` kernels, ``nn.LSTM``'s per-direction
``weight_ih_l{k}[_reverse]`` keep their (i, f, g, o) gate order, the
``full_deprel`` layer's one shared Linear ``W [D·H, T]`` is reinterpreted
as ``[D, T, H]`` as the reference does (its ``model/gcn.py:301-303``),
replicated per layer when ``deprel_shared_w`` is off, and the output MLP's
Linears sit at ``out_mlp.{0, 2, ...}`` (ReLUs between them).  The tree
goes into the port with ``convert.params_from_jax``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from gcn_tpu_torch.config import ModelConfig


def _numpy(v) -> np.ndarray:
    """A numpy array of a state value (numpy or a CPU tensor)."""
    return np.asarray(v.detach().cpu() if hasattr(v, "detach") else v)


def torch_state_to_params(state: Mapping, cfg: ModelConfig) -> dict:
    """The ``{'params': ...}`` tree of a reference state dict (numpy arrays
    or tensors, e.g. ``torch.load(f, weights_only=True)['model']``)."""
    s = {k: _numpy(v) for k, v in state.items()}
    p: dict = {}

    if not cfg.use_bert_embeddings:
        p["word_emb"] = s["gcn_model.emb.weight"]
    if cfg.pos_dim > 0:
        p["pos_emb"] = s["gcn_model.pos_emb.weight"]
    if cfg.ner_dim > 0 and cfg.dataset == "tacred":
        p["ner_emb"] = s["gcn_model.ner_emb.weight"]
    p["deprel_emb"] = s["gcn_model.deprel_emb.weight"]

    if cfg.rnn:
        rnn = {}
        for li in range(cfg.rnn_layers):
            for d, suffix in (("fwd", ""), ("bwd", "_reverse")):
                pre = "gcn_model.gcn.rnn."
                rnn[f"l{li}_{d}_w_ih"] = s[f"{pre}weight_ih_l{li}{suffix}"].T
                rnn[f"l{li}_{d}_w_hh"] = s[f"{pre}weight_hh_l{li}{suffix}"].T
                rnn[f"l{li}_{d}_b_ih"] = s[f"{pre}bias_ih_l{li}{suffix}"]
                rnn[f"l{li}_{d}_b_hh"] = s[f"{pre}bias_hh_l{li}{suffix}"]
        p["rnn"] = rnn

    if cfg.adj_type == "diagonal_deprel":
        p["preprocessor"] = {
            "kernel": s["gcn_model.gcn.preprocessor.weight"].T,
            "bias": s["gcn_model.gcn.preprocessor.bias"],
        }

    if cfg.adj_type == "regular":
        for l in range(cfg.num_layers):
            p[f"gcn_w{l}_kernel"] = s[f"gcn_model.gcn.W.{l}.weight"].T
            p[f"gcn_w{l}_bias"] = s[f"gcn_model.gcn.W.{l}.bias"]
    elif cfg.adj_type == "full_deprel":
        d, h = cfg.deprel_emb_dim, cfg.hidden_dim
        w3 = s["gcn_model.gcn.W.weight"].reshape(d, -1, h)  # [D*H, T]
        b2 = s["gcn_model.gcn.W.bias"].reshape(d, h)        # [D*H]
        if cfg.deprel_shared_w:
            p["gcn_deprel_w"] = w3
            p["gcn_deprel_b"] = b2
        else:
            # the reference has one shared weight: every layer takes it
            for l in range(cfg.num_layers):
                p[f"gcn_deprel_w{l}"] = w3
                p[f"gcn_deprel_b{l}"] = b2

    for i in range(cfg.mlp_layers):
        p[f"mlp{i}"] = {
            "kernel": s[f"gcn_model.out_mlp.{2 * i}.weight"].T,
            "bias": s[f"gcn_model.out_mlp.{2 * i}.bias"],
        }
    p["classifier"] = {
        "kernel": s["classifier.weight"].T,
        "bias": s["classifier.bias"],
    }
    return {"params": p}
