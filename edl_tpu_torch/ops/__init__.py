"""Attention and cross-entropy ops; the CUDA kernels live under ``csrc/``."""
