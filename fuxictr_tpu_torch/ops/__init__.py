"""Layers and kernels. Hand-written CUDA sources live in ``ops/csrc``."""
