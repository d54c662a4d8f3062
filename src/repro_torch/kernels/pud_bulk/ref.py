"""Plain PyTorch version of the pool block copy (the CPU path, and what the
CUDA kernel is checked against)."""
from __future__ import annotations

import torch


def block_copy_ref(pool: torch.Tensor, src_dst: torch.Tensor) -> torch.Tensor:
    """Parallel-copy semantics, in place: every source is gathered from the
    pre-op pool, then all destinations are written.  ``pool`` is
    ``(num_blocks, block_elems)``; ``src_dst`` is ``(n_pairs, 2)``."""
    src_dst = src_dst.to(device=pool.device, dtype=torch.long)
    pool[src_dst[:, 1]] = pool[src_dst[:, 0]]
    return pool
