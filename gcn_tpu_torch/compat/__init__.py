"""Reference checkpoints (``best_model.pt`` of the original PyTorch C-GCN)
in and out of the port.

Counterpart of ``gcn_tpu.compat``: ``torch_import.torch_state_to_params``
maps the reference's state dict to gcn_tpu's ``{'params': ...}`` tree of
numpy arrays, which ``convert.params_from_jax`` carries into the port's
``state_dict``; ``torch_export.params_to_torch_state`` is its inverse, and
``torch_export.state_dict_to_torch_state`` goes there straight from the
port's ``state_dict``::

    ckpt = torch.load("best_model.pt", weights_only=True)
    state = {k: v.numpy() for k, v in ckpt["model"].items()}
    params = torch_state_to_params(state, cfg.model)
    evaluator = Evaluator(cfg, params_from_jax(params))
"""
