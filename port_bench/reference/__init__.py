"""The plain reference the benchmark holds the port to: D3DP in plain
PyTorch and numpy, written from the paper's code (arXiv:2303.11579) and
independent of the program; it imports nothing of d3dp_tpu_torch, d3dp_tpu
or JAX."""
