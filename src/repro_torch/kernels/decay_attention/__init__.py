"""Chunked decay linear attention (RWKV6 / Mamba2): hand-written CUDA kernel
+ plain PyTorch version."""
