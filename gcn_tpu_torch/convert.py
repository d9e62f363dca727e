"""Carry a flax parameter tree across to the port's ``state_dict`` and back.

``gcn_tpu.models.gcn.GCNClassifier.init`` gives ``{'params': {...}}`` with
nested dicts (``rnn``, ``preprocessor``, ``mlp0``, ``classifier``); the
port's modules use the same names and layouts, so the mapping is a flatten
with ``.`` as the separator::

    word_emb (absent with use_bert_embeddings), pos_emb,
    ner_emb (TACRED only), deprel_emb ([85, hidden] for diagonal_deprel)
    rnn/l{i}_{fwd,bwd}_{w_ih,w_hh,b_ih,b_hh}   → rnn.l{i}_...
    preprocessor/{kernel,bias}          (diagonal_deprel)
    gcn_deprel_w{l}, gcn_deprel_b{l}    (gcn_deprel_w, gcn_deprel_b when
                                        deprel_shared_w is set)
    gcn_w{l}_kernel, gcn_w{l}_bias      (regular and attention modes)
    attn_q{l}, attn_k{l}                (attention mode)
    mlp{i}/{kernel,bias}, classifier/{kernel,bias}

The tree holds numpy arrays (``jax.device_get`` of the params), so this
module needs neither JAX nor flax.  ``params_to_jax`` is the inverse, so
that parameters can be compared after training steps on both sides.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def params_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """Flatten a (possibly ``{'params': ...}``-wrapped) tree of numpy arrays
    into a ``state_dict`` of f32 CPU tensors."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for key, value in node.items():
            name = f"{prefix}{key}"
            if isinstance(value, Mapping):
                walk(value, name + ".")
            else:
                out[name] = torch.from_numpy(
                    np.array(value, dtype=np.float32, copy=True))

    walk(tree, "")
    return out


def params_to_jax(state_dict: Mapping) -> dict:
    """The inverse of ``params_from_jax``: a ``{'params': {...}}`` tree of
    f32 numpy arrays, nested at each ``.`` of the ``state_dict`` names,
    each level's keys sorted as JAX's pytrees hold them."""
    tree: dict = {}
    for name in sorted(state_dict):
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = state_dict[name].detach().to(
            "cpu", torch.float32).numpy().copy()

    def ordered(node):
        return {k: ordered(v) if isinstance(v, dict) else v
                for k, v in sorted(node.items())}

    return {"params": ordered(tree)}
