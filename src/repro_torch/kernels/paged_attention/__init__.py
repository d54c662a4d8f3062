"""Paged decode attention: hand-written CUDA kernel + plain PyTorch version."""
