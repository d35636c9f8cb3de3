"""Kernels (hand-written for Hopper) with their plain PyTorch versions, and top-k."""
