"""Optimizers with the JAX package's update rules, written out by hand.

Counterpart of ``gcn_tpu.train.optim``: ``build_optimizer`` chains

1. the word-embedding freeze (``partial_embedding_freeze``): gradient rows
   ``>= topn`` of ``word_emb`` are zeroed, every row when ``topn <= 0``,
   before clipping;
2. optax's ``clip_by_global_norm``: scale by ``max_norm / norm`` only when
   ``norm >= max_norm`` (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to
   the norm and is not used);
3. the core rule: ``sgd``; ``adagrad``/``myadagrad`` (accumulator from 0.1,
   ``g / (sqrt(acc) + 1e-10)``, per-step ``lr_decay``); ``adam`` at a fixed
   1e-3 and ``adamax`` at a fixed 2e-3, whatever the passed rate; and
   ``adadelta`` (ρ 0.9, ε 1e-6) at the passed rate.

``torch.optim``'s rules differ from optax's in places (adamax puts its ε
elsewhere, adagrad starts its accumulator at 0), so every rule is written
here over plain tensors.  The learning rate is a plain attribute that
``set_learning_rate`` changes in place; the rules read it at each step.
"""

from __future__ import annotations

import torch

CORES = ("sgd", "adagrad", "myadagrad", "adam", "adamax", "adadelta")
_FIXED_LR = {"adam": 1e-3, "adamax": 2e-3}
_B1, _B2, _ADAM_EPS = 0.9, 0.999, 1e-8
_RHO, _ADADELTA_EPS = 0.9, 1e-6
_ADAGRAD_INIT, _ADAGRAD_EPS = 0.1, 1e-10


class Optimizer:
    """Freeze → clip → core over a dict of named parameters, updated in
    place.  State tensors live beside the parameters, on their device."""

    def __init__(self, name: str, learning_rate: float,
                 max_grad_norm: float = 5.0, topn: int = int(1e10),
                 lr_decay: float = 0.0, word_emb_name: str = "word_emb"):
        if name not in CORES:
            raise ValueError(f"Unsupported optimizer: {name}")
        self.name = name
        self.learning_rate = float(learning_rate)
        self.max_grad_norm = max_grad_norm
        self.topn = topn
        self.lr_decay = lr_decay
        self.word_emb_name = word_emb_name
        self.count = 0
        self.state: dict[str, dict[str, torch.Tensor]] = {}

    def init(self, params: dict[str, torch.Tensor]) -> None:
        """Fresh state for ``params`` (name → tensor)."""
        self.count = 0
        self.state = {}
        for k, p in params.items():
            if self.name in ("adagrad", "myadagrad"):
                self.state[k] = {"accum": torch.full_like(p, _ADAGRAD_INIT)}
            elif self.name in ("adam", "adamax"):
                self.state[k] = {"mu": torch.zeros_like(p),
                                 "nu": torch.zeros_like(p)}
            elif self.name == "adadelta":
                self.state[k] = {"e_g": torch.zeros_like(p),
                                 "e_x": torch.zeros_like(p)}

    def freeze(self, grads: dict[str, torch.Tensor]):
        """Zero the word-embedding gradient rows ``>= topn``."""
        g = grads.get(self.word_emb_name)
        if g is None or self.topn >= g.shape[0]:
            return grads
        out = dict(grads)
        if self.topn <= 0:
            out[self.word_emb_name] = torch.zeros_like(g)
        else:
            row = torch.arange(g.shape[0], device=g.device)[:, None]
            out[self.word_emb_name] = torch.where(row < self.topn, g, 0.0)
        return out

    def clip(self, grads: dict[str, torch.Tensor]):
        """optax ``clip_by_global_norm``, with no host sync."""
        norm = torch.stack([g.float().square().sum()
                            for g in grads.values()]).sum().sqrt()
        trigger = norm < self.max_grad_norm
        return {k: torch.where(trigger, g,
                               g / norm.to(g.dtype) * self.max_grad_norm)
                for k, g in grads.items()}

    def updates(self, grads: dict[str, torch.Tensor]):
        """The core rule: the update to add to each parameter."""
        self.count += 1
        step = self.count
        out = {}
        for k, g in grads.items():
            st = self.state.get(k)
            if self.name == "sgd":
                u = g * -self.learning_rate
            elif self.name in ("adagrad", "myadagrad"):
                st["accum"] = st["accum"] + g * g
                decay = 1.0 / (1.0 + (step - 1.0) * self.lr_decay)
                u = (decay * g / (st["accum"].sqrt() + _ADAGRAD_EPS)
                     * -self.learning_rate)
            elif self.name == "adam":
                st["mu"] = (1 - _B1) * g + _B1 * st["mu"]
                st["nu"] = (1 - _B2) * g * g + _B2 * st["nu"]
                mu_hat = st["mu"] / (1 - _B1 ** step)
                nu_hat = st["nu"] / (1 - _B2 ** step)
                u = mu_hat / (nu_hat.sqrt() + _ADAM_EPS) * -_FIXED_LR["adam"]
            elif self.name == "adamax":
                st["mu"] = (1 - _B1) * g + _B1 * st["mu"]
                st["nu"] = torch.maximum(g.abs() + _ADAM_EPS, _B2 * st["nu"])
                mu_hat = st["mu"] / (1 - _B1 ** step)
                u = mu_hat / st["nu"] * -_FIXED_LR["adamax"]
            else:  # adadelta
                st["e_g"] = (1 - _RHO) * g * g + _RHO * st["e_g"]
                delta = ((st["e_x"] + _ADADELTA_EPS).sqrt()
                         / (st["e_g"] + _ADADELTA_EPS).sqrt() * g)
                st["e_x"] = (1 - _RHO) * delta * delta + _RHO * st["e_x"]
                u = delta * -self.learning_rate
            out[k] = u
        return out

    @torch.no_grad()
    def step(self, params: dict[str, torch.Tensor],
             grads: dict[str, torch.Tensor]) -> None:
        """Freeze, clip, and add the core rule's update to ``params``."""
        for k, u in self.updates(self.clip(self.freeze(grads))).items():
            params[k].add_(u)


def build_optimizer(name: str, learning_rate: float,
                    max_grad_norm: float = 5.0, topn: int = int(1e10),
                    lr_decay: float = 0.0) -> Optimizer:
    """Freeze-mask → global-norm clip → optimizer (see ``Optimizer``)."""
    return Optimizer(name, learning_rate, max_grad_norm=max_grad_norm,
                     topn=topn, lr_decay=lr_decay)


def set_learning_rate(opt: Optimizer, new_lr: float) -> Optimizer:
    """Change the rate the next step uses (the plateau decay hook)."""
    opt.learning_rate = float(new_lr)
    return opt
