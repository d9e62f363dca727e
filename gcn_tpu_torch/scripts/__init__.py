"""The port's command-line entry points, as ``python -m
gcn_tpu_torch.scripts.<name>``: ``train``, ``train_semeval``, ``eval`` and
``prepare_vocab``, with the arguments of the repository's root scripts."""
