"""gcn_tpu's parameter tree (or the port's ``state_dict``) → a reference
PyTorch state dict.

Counterpart of ``gcn_tpu.compat.torch_export``, the inverse of
``torch_import``: numpy arrays under the reference's names, with its
aliased keys (the reference registers each embedding on its relation
model and again on the GCN submodule, so ``gcn_model.emb.weight`` and
``gcn_model.gcn.emb.weight`` are one array).  Only what the reference can
hold is exported: ``full_deprel`` needs ``deprel_shared_w`` (one shared
bilinear weight there), and the ``attention`` mode has no counterpart.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from gcn_tpu_torch.config import ModelConfig
from gcn_tpu_torch.convert import params_to_jax


def params_to_torch_state(params: dict, cfg: ModelConfig) -> dict:
    """The reference state dict of a ``{'params': ...}`` tree."""
    p = params["params"]
    out: dict[str, np.ndarray] = {}

    def npy(x):
        return np.asarray(x)

    if cfg.adj_type == "attention":
        raise ValueError(
            "attention mode has no reference counterpart to export to")

    def aliased(name, value):
        out[f"gcn_model.{name}"] = npy(value)
        out[f"gcn_model.gcn.{name}"] = out[f"gcn_model.{name}"]

    if not cfg.use_bert_embeddings:
        aliased("emb.weight", p["word_emb"])
    if cfg.pos_dim > 0:
        aliased("pos_emb.weight", p["pos_emb"])
    if cfg.ner_dim > 0 and cfg.dataset == "tacred":
        aliased("ner_emb.weight", p["ner_emb"])
    aliased("deprel_emb.weight", p["deprel_emb"])

    if cfg.rnn:
        rnn = p["rnn"]
        for li in range(cfg.rnn_layers):
            for d, suffix in (("fwd", ""), ("bwd", "_reverse")):
                pre = "gcn_model.gcn.rnn."
                out[f"{pre}weight_ih_l{li}{suffix}"] = npy(
                    rnn[f"l{li}_{d}_w_ih"]).T
                out[f"{pre}weight_hh_l{li}{suffix}"] = npy(
                    rnn[f"l{li}_{d}_w_hh"]).T
                out[f"{pre}bias_ih_l{li}{suffix}"] = npy(
                    rnn[f"l{li}_{d}_b_ih"])
                out[f"{pre}bias_hh_l{li}{suffix}"] = npy(
                    rnn[f"l{li}_{d}_b_hh"])

    if cfg.adj_type == "diagonal_deprel":
        out["gcn_model.gcn.preprocessor.weight"] = npy(
            p["preprocessor"]["kernel"]).T
        out["gcn_model.gcn.preprocessor.bias"] = npy(p["preprocessor"]["bias"])

    if cfg.adj_type == "regular":
        for l in range(cfg.num_layers):
            out[f"gcn_model.gcn.W.{l}.weight"] = npy(p[f"gcn_w{l}_kernel"]).T
            out[f"gcn_model.gcn.W.{l}.bias"] = npy(p[f"gcn_w{l}_bias"])
    elif cfg.adj_type == "full_deprel":
        if not cfg.deprel_shared_w:
            raise ValueError(
                "reference full_deprel has a single shared weight; export "
                "requires deprel_shared_w=True")
        d, h = cfg.deprel_emb_dim, cfg.hidden_dim
        w3 = npy(p["gcn_deprel_w"])  # [D, T, H]
        # the import's reshape of [D*H, T] to [D, T, H] reinterprets the
        # row-major buffer, so its inverse is the plain reshape
        out["gcn_model.gcn.W.weight"] = w3.reshape(d * h, w3.shape[1])
        out["gcn_model.gcn.W.bias"] = npy(p["gcn_deprel_b"]).reshape(d * h)

    for i in range(cfg.mlp_layers):
        out[f"gcn_model.out_mlp.{2 * i}.weight"] = npy(
            p[f"mlp{i}"]["kernel"]).T
        out[f"gcn_model.out_mlp.{2 * i}.bias"] = npy(p[f"mlp{i}"]["bias"])
    out["classifier.weight"] = npy(p["classifier"]["kernel"]).T
    out["classifier.bias"] = npy(p["classifier"]["bias"])
    return out


def state_dict_to_torch_state(state_dict: Mapping, cfg: ModelConfig) -> dict:
    """The reference state dict of the port's ``state_dict`` (a model's, a
    trainer's ``full_state_dict()``, which is whole where a
    ``DistributedTrainer``'s model holds parts on a ``model`` axis, or
    ``convert.params_from_jax``'s): ``params_to_torch_state`` of
    ``convert.params_to_jax``, so that ``torch_state_to_params`` and
    ``params_from_jax`` give the ``state_dict`` back."""
    return params_to_torch_state(params_to_jax(state_dict), cfg)
