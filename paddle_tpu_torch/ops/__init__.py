"""Tensor ops of the port: plain PyTorch functions, and under `cuda/` the
hand-written CUDA kernels with their wrappers."""
