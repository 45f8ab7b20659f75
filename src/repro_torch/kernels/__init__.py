"""Hand-written CUDA kernels for Hopper, each with a plain-torch twin."""
