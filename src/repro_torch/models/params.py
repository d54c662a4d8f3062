"""Declarative parameter trees.

A module is a (nested) dict of :class:`ParamDef`; :func:`init_params` turns
it into a dict of tensors on one device.  Matmul and embedding weights are
stored once in the compute dtype (the reference casts them to the activation
dtype at every use, which rounds the same way); norm parameters
(``ParamDef.f32``) stay float32 because the norms compute in float32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Tuple

import torch

__all__ = ["ParamDef", "init_params", "map_defs", "count_params"]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    init: str = "normal"              # normal | zeros | ones | embed
    scale: float = 1.0
    f32: bool = False                 # keep float32 (norm parameters)


def map_defs(fn: Callable[[ParamDef], Any], defs: Any) -> Any:
    """Apply ``fn`` to every ParamDef of a nested dict, keeping its paths."""
    if isinstance(defs, ParamDef):
        return fn(defs)
    return {k: map_defs(fn, v) for k, v in defs.items()}


def _init_leaf(d: ParamDef, generator: torch.Generator, device) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=torch.float32, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=torch.float32, device=device)
    x = torch.randn(d.shape, generator=generator, dtype=torch.float32, device=device)
    if d.init == "embed":
        return x * d.scale
    # fan-in scaled normal: the last-but-one axis is the fan-in, as in the
    # reference, so a stacked wq (L, d, H, hd) gets 1/sqrt(H).
    fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[0]
    return x * (d.scale / math.sqrt(max(fan_in, 1)))


def init_params(
    defs: Any, *, dtype: torch.dtype, generator: torch.Generator, device
) -> Any:
    """Materialize a ParamDef tree; every random draw comes from ``generator``
    (which must live on ``device``).  Leaves are drawn in the dict's order."""

    def one(d: ParamDef) -> torch.Tensor:
        x = _init_leaf(d, generator, device)
        return x if d.f32 else x.to(dtype)

    return map_defs(one, defs)


def count_params(tree: Any) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel()
    return sum(count_params(v) for v in tree.values())
