"""Int8 gradient compression with error feedback.

Each tensor is quantized to int8 with a per-tensor scale, and the
quantization residual is carried into the next step (error feedback keeps
the scheme unbiased over time).  ``compress_grads`` is the value-level
quantize -> dequantize with an error-feedback state tree.  The reference's
``compressed_psum`` (an all-reduce of the int8 payload across a mesh) waits
for the port of distribution (ROADMAP.md)."""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.tree import flatten, leaves, tree_map, unflatten


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = x.abs().max() / 127.0 + 1e-12
    # torch.round, like jnp.round, rounds half to even
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_state(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def compress_grads(grads: Any, err: Any) -> Tuple[Any, Any]:
    """Returns (dequantized grads as seen post-reduction, new error state)."""

    def one(g, e):
        g = g.float() + e
        q, s = _quantize(g)
        deq = _dequantize(q, s)
        return deq, g - deq

    flat_g, tdef = flatten(grads)
    outs = [one(g, e) for g, e in zip(flat_g, leaves(err), strict=True)]
    return (
        unflatten(tdef, [o[0] for o in outs]),
        unflatten(tdef, [o[1] for o in outs]),
    )
