"""Params bridge: the reference's numpy params tree -> the port's tensors.

``params_from_numpy`` takes the tree the reference produces with
``jax.tree.map(np.asarray, LM.init(key))`` — nested dicts, stacked leading
layer axis — and returns the same paths as tensors on ``device``.  Matmul and
embedding weights are cast once to ``cfg.dtype`` (identical to the
reference's per-use ``.astype(x.dtype)``); norm parameters stay float32.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.params import ParamDef
from repro_torch.models.transformer import LM

__all__ = ["params_from_numpy", "params_to_numpy"]


def params_from_numpy(model: LM, tree: Dict, *, device="cuda") -> Dict:
    device = resolve_device(device)

    def walk(defs: Any, node: Any, path: str) -> Any:
        if isinstance(defs, ParamDef):
            arr = np.asarray(node)
            if tuple(arr.shape) != tuple(defs.shape):
                raise ValueError(f"{path}: shape {arr.shape} != {defs.shape}")
            t = torch.from_numpy(np.array(arr, dtype=np.float32))   # own copy
            return t.to(device=device, dtype=torch.float32 if defs.f32 else model.dtype)
        if set(defs) != set(node):
            raise ValueError(f"{path or '/'}: keys {sorted(node)} != {sorted(defs)}")
        return {k: walk(defs[k], node[k], f"{path}/{k}") for k in defs}

    return walk(model.param_defs(), tree, "")


def params_to_numpy(params: Any) -> Any:
    """The inverse layout: float32 numpy arrays with the same paths."""
    if isinstance(params, torch.Tensor):
        return params.detach().float().cpu().numpy()
    return {k: params_to_numpy(v) for k, v in params.items()}
