"""Plain PyTorch versions of the pud_bulk kernels (the CPU path, and what
the CUDA kernels are checked against)."""
from __future__ import annotations

import torch

# PyTorch lacks some bitwise ops for the wide unsigned types (``bitwise_not``
# on uint32 raises); their bits are computed through the signed type of the
# same width and viewed back.
_SIGNED_VIEW = {torch.uint16: torch.int16, torch.uint32: torch.int32,
                torch.uint64: torch.int64}


def bulk_op_ref(*operands: torch.Tensor, op: str) -> torch.Tensor:
    """Elementwise ``zero/copy/not/and/or/xor/maj`` over same-shape operands,
    as a new tensor; ``zero`` takes a shape/dtype donor.  ``not`` of a bool
    is a logical not; ``maj = (x & y) | (y & z) | (x & z)``."""
    dtype = operands[0].dtype
    view = _SIGNED_VIEW.get(dtype)
    xs = [x.view(view) for x in operands] if view is not None else list(operands)
    if op == "zero":
        out = torch.zeros_like(xs[0])
    elif op == "copy":
        out = xs[0].clone()
    elif op == "not":
        out = torch.bitwise_not(xs[0])
    elif op == "and":
        out = xs[0] & xs[1]
    elif op == "or":
        out = xs[0] | xs[1]
    elif op == "xor":
        out = xs[0] ^ xs[1]
    elif op == "maj":
        x, y, z = xs
        out = (x & y) | (y & z) | (x & z)
    else:
        raise ValueError(op)
    return out.view(dtype) if view is not None else out


def block_copy_ref(pool: torch.Tensor, src_dst: torch.Tensor) -> torch.Tensor:
    """Parallel-copy semantics, in place: every source is gathered from the
    pre-op pool, then all destinations are written.  ``pool`` is
    ``(num_blocks, block_elems)``; ``src_dst`` is ``(n_pairs, 2)``."""
    src_dst = src_dst.to(device=pool.device, dtype=torch.long)
    pool[src_dst[:, 1]] = pool[src_dst[:, 0]]
    return pool
