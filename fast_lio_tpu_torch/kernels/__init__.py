"""Hand-written CUDA kernels for Hopper, their wrappers and their build."""
