"""The plain reference the benchmark judges the program's outputs by:
plain PyTorch and numpy, importing nothing of the program or of JAX."""
