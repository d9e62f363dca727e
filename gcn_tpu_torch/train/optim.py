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

``external_clip=True`` skips the clip stage: the row-sparse embedding
step (``train.sparse_emb``) clips itself, over a norm that counts rows this
chain never sees.  The state keeps its layout either way.  A step updates
the parameters it is given gradients for and leaves the others alone.

``torch.optim``'s rules differ from optax's in places (adamax puts its ε
elsewhere, adagrad starts its accumulator at 0), so every rule is written
here over plain tensors.  A step makes no host sync and touches only
tensors that outlive it, so a CUDA graph can capture it: the step count
``count`` is an int32 tensor beside the parameters, from which adam's and
adamax's bias corrections ``1 - b**count`` and adagrad's per-step decay
are computed on the device in f32, as optax computes them; the learning
rate ``learning_rate`` is an f32 scalar tensor that ``set_learning_rate``
fills in place; the state tensors are updated in place.

``state_tree`` and ``load_state_tree`` carry the state across as optax
holds it for gcn_tpu's ``build_optimizer``: ``inject_hyperparams`` around
``chain(freeze, clip, core)``, so that a checkpoint of either package
resumes in the other.  The one step count stands for optax's three
(``inject_hyperparams``' ``count``, adam's and adamax's ``count``,
adagrad's ``step``), which advance together.
"""

from __future__ import annotations

import numpy as np
import torch

from gcn_tpu_torch.convert import params_from_jax, params_to_jax

CORES = ("sgd", "adagrad", "myadagrad", "adam", "adamax", "adadelta")
_FIXED_LR = {"adam": 1e-3, "adamax": 2e-3}
_B1, _B2, _ADAM_EPS = 0.9, 0.999, 1e-8
_RHO, _ADADELTA_EPS = 0.9, 1e-6
_ADAGRAD_INIT, _ADAGRAD_EPS = 0.1, 1e-10


def clip_by_global_norm(tensors: dict[str, torch.Tensor],
                        max_norm: float) -> dict[str, torch.Tensor]:
    """optax ``clip_by_global_norm`` over the tensors, with no host sync:
    all scaled by ``max_norm / norm`` only when ``norm >= max_norm``."""
    norm = torch.stack([g.float().square().sum()
                        for g in tensors.values()]).sum().sqrt()
    trigger = norm < max_norm
    return {k: torch.where(trigger, g, g / norm.to(g.dtype) * max_norm)
            for k, g in tensors.items()}


class Optimizer:
    """Freeze → clip → core over a dict of named parameters, updated in
    place.  State tensors live beside the parameters, on their device."""

    def __init__(self, name: str, learning_rate: float,
                 max_grad_norm: float = 5.0, topn: int = int(1e10),
                 lr_decay: float = 0.0, word_emb_name: str = "word_emb",
                 external_clip: bool = False):
        if name not in CORES:
            raise ValueError(f"Unsupported optimizer: {name}")
        self.name = name
        self.learning_rate = torch.tensor(float(learning_rate),
                                          dtype=torch.float32)
        self.max_grad_norm = max_grad_norm
        self.topn = topn
        self.lr_decay = lr_decay
        self.word_emb_name = word_emb_name
        self.external_clip = external_clip
        self.count = torch.zeros((), dtype=torch.int32)
        self.state: dict[str, dict[str, torch.Tensor]] = {}

    def init(self, params: dict[str, torch.Tensor]) -> None:
        """Fresh state for ``params`` (name → tensor), the count and the
        rate on their device."""
        device = next(iter(params.values())).device if params else "cpu"
        self.count = torch.zeros((), dtype=torch.int32, device=device)
        self.learning_rate = self.learning_rate.to(device)
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
        return clip_by_global_norm(grads, self.max_grad_norm)

    def state_tensors(self) -> list[torch.Tensor]:
        """Every tensor a step changes: the count and the state."""
        return [self.count] + [t for st in self.state.values()
                               for t in st.values()]

    def updates(self, grads: dict[str, torch.Tensor]):
        """The core rule: the update to add to each parameter."""
        self.count.add_(1)
        step = self.count.float()
        lr = self.learning_rate
        if self.name in ("adagrad", "myadagrad"):
            decay = 1.0 / (1.0 + (step - 1.0) * self.lr_decay)
        elif self.name in ("adam", "adamax"):
            bc1 = 1 - torch.pow(_B1, step)
            bc2 = 1 - torch.pow(_B2, step)
        out = {}
        for k, g in grads.items():
            st = self.state.get(k)
            if self.name == "sgd":
                u = g * -lr
            elif self.name in ("adagrad", "myadagrad"):
                st["accum"].copy_(st["accum"] + g * g)
                u = decay * g / (st["accum"].sqrt() + _ADAGRAD_EPS) * -lr
            elif self.name == "adam":
                st["mu"].copy_((1 - _B1) * g + _B1 * st["mu"])
                st["nu"].copy_((1 - _B2) * g * g + _B2 * st["nu"])
                mu_hat = st["mu"] / bc1
                nu_hat = st["nu"] / bc2
                u = mu_hat / (nu_hat.sqrt() + _ADAM_EPS) * -_FIXED_LR["adam"]
            elif self.name == "adamax":
                st["mu"].copy_((1 - _B1) * g + _B1 * st["mu"])
                st["nu"].copy_(torch.maximum(g.abs() + _ADAM_EPS,
                                             _B2 * st["nu"]))
                mu_hat = st["mu"] / bc1
                u = mu_hat / st["nu"] * -_FIXED_LR["adamax"]
            else:  # adadelta
                st["e_g"].copy_((1 - _RHO) * g * g + _RHO * st["e_g"])
                delta = ((st["e_x"] + _ADADELTA_EPS).sqrt()
                         / (st["e_g"] + _ADADELTA_EPS).sqrt() * g)
                st["e_x"].copy_((1 - _RHO) * delta * delta
                                + _RHO * st["e_x"])
                u = delta * -lr
            out[k] = u
        return out

    def _core_layout(self) -> tuple[dict, str | None]:
        """optax's tree of the core (``inner_state."2"``) with each state
        tensor's key where its ``{"params": ...}`` tree goes, and the key of
        the core's step count (None where it keeps none)."""
        if self.name == "sgd":
            return {"0": {}, "1": {}}, None
        if self.name in ("adagrad", "myadagrad"):  # AdagradState(step, accum)
            return {"0": {"step": None, "accum": "accum"}, "1": {}}, "step"
        if self.name in ("adam", "adamax"):
            return {"0": {"count": None, "mu": "mu", "nu": "nu"},
                    "1": {}}, "count"
        return {"0": {}, "1": {"e_g": "e_g", "e_x": "e_x"}, "2": {}}, None

    def state_tree(self) -> dict:
        """The state as an optax tree of numpy arrays (see the module's
        docstring); keys in optax's order."""
        layout, _ = self._core_layout()
        count = np.asarray(int(self.count), np.int32)

        def fill(node):
            return {k: fill(v) if isinstance(v, dict)
                    else count if v is None
                    else params_to_jax({n: st[v]
                                        for n, st in self.state.items()})
                    for k, v in node.items()}

        return {"count": count,
                "hyperparams": {"learning_rate": np.asarray(
                    float(self.learning_rate), np.float32)},
                "hyperparams_states": {},
                "inner_state": {"0": {}, "1": {}, "2": fill(layout)}}

    def load_state_tree(self, tree: dict,
                        params: dict[str, torch.Tensor]) -> None:
        """Take the state from an optax tree of ``state_tree``'s layout,
        each tensor onto its parameter's device and dtype; state tensors
        that exist already are overwritten in place (a captured step
        reads them where they are)."""
        layout, count_key = self._core_layout()
        core = tree["inner_state"]["2"]
        state: dict[str, dict[str, torch.Tensor]] = {}

        def take(node, have, path):
            if set(node) != set(have):
                raise ValueError(
                    f"{self.name} state at {path or 'inner_state/2'}: keys "
                    f"{sorted(have)}, expected {sorted(node)}")
            for k, v in node.items():
                if isinstance(v, dict):
                    take(v, have[k], f"{path}/{k}")
                elif v is not None:
                    flat = params_from_jax(have[k])
                    if set(flat) != set(params):
                        raise ValueError(f"{self.name} state {v}: parameters "
                                         f"{sorted(set(flat) ^ set(params))} "
                                         f"differ")
                    for n, t in flat.items():
                        if t.shape != params[n].shape:
                            raise ValueError(f"{self.name} state {v} of {n}: "
                                             f"{tuple(t.shape)}, expected "
                                             f"{tuple(params[n].shape)}")
                        state.setdefault(n, {})[v] = t.to(params[n].device,
                                                          params[n].dtype)

        take(layout, core, "")
        count_at = core["0"][count_key] if count_key else tree["count"]
        self.count.fill_(int(count_at))
        self.learning_rate.fill_(float(tree["hyperparams"]["learning_rate"]))
        for n, st in state.items():
            have = self.state.setdefault(n, {})
            for v, t in st.items():
                if v in have and have[v].shape == t.shape:
                    have[v].copy_(t)
                else:
                    have[v] = t

    @torch.no_grad()
    def step(self, params: dict[str, torch.Tensor],
             grads: dict[str, torch.Tensor]) -> None:
        """Freeze, clip (unless ``external_clip``), and add the core rule's
        update to ``params``."""
        grads = self.freeze(grads)
        if not self.external_clip:
            grads = self.clip(grads)
        for k, u in self.updates(grads).items():
            params[k].add_(u)


def build_optimizer(name: str, learning_rate: float,
                    max_grad_norm: float = 5.0, topn: int = int(1e10),
                    lr_decay: float = 0.0,
                    external_clip: bool = False) -> Optimizer:
    """Freeze-mask → global-norm clip → optimizer (see ``Optimizer``);
    ``external_clip=True`` leaves the clip to the caller."""
    return Optimizer(name, learning_rate, max_grad_norm=max_grad_norm,
                     topn=topn, lr_decay=lr_decay,
                     external_clip=external_clip)


def set_learning_rate(opt: Optimizer, new_lr: float) -> Optimizer:
    """Change the rate the next step uses (the plateau decay hook), in
    place, so a captured step reads it too."""
    opt.learning_rate.fill_(float(new_lr))
    return opt
