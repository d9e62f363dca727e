"""gcn_tpu_torch — the PyTorch/CUDA port of gcn_tpu for NVIDIA Hopper.

The evaluation forward (``train.evaluator.Evaluator``) and the train step
(``train.trainer.Trainer``) of the C-GCN and the paper's GCN run end to
end over ``data.dataset.Batcher`` batches, in the regular, full_deprel
and attention modes, with a hand-written CUDA kernel (``csrc/``) for each
of the JAX package's Pallas kernels.  The package imports torch and numpy
only.
"""
