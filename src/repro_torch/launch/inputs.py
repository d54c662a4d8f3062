"""Input builders for every (arch x shape) cell: the reference's batch layout.

``batch_shapes(cfg, shape)`` names each entry of a step function's
``batch`` with its shape and dtype; ``make_batch`` builds it from a numpy
seed, the same arrays as the reference's ``make_batch`` bit for bit.
Modality frontends are stubs: [vlm] precomputed patch embeddings spliced over
the first positions, [audio] precomputed frame embeddings.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, RunShape

__all__ = ["N_PATCHES", "batch_shapes", "make_batch"]

N_PATCHES = 256  # vlm stub: patch embeddings replace the first 256 positions


def _pos_shape(cfg: ModelConfig, B: int, S: int) -> Tuple[int, ...]:
    return (B, S, 3) if cfg.rope == "mrope" else (B, S)


def batch_shapes(cfg: ModelConfig, shape: RunShape) -> Dict[str, Any]:
    """Name -> (shape, dtype) for the step-function ``batch`` argument."""
    B = shape.global_batch
    S = 1 if shape.is_decode else shape.seq_len
    out: Dict[str, Any] = {
        "tokens": ((B, S), torch.int32),
        "positions": (_pos_shape(cfg, B, S), torch.int32),
    }
    if shape.mode == "train":
        out["targets"] = ((B, S), torch.int32)
        out["loss_mask"] = ((B, S), torch.float32)
    if cfg.frontend == "vision" and not shape.is_decode:
        out["patch_embeds"] = ((B, min(N_PATCHES, S), cfg.d_model), torch.bfloat16)
    if cfg.is_encdec and not shape.is_decode:
        out["enc_embeds"] = ((B, shape.seq_len, cfg.d_model), torch.bfloat16)
    return out


def make_batch(
    cfg: ModelConfig, shape: RunShape, seed: int = 0, *, device="cuda"
) -> Dict[str, torch.Tensor]:
    """Concrete random batch on ``device``, drawn from
    ``np.random.default_rng(seed)`` in ``batch_shapes``' order.  The
    embeddings are drawn in float64 and rounded to bfloat16 through float32,
    as the reference's ``jnp.asarray`` does without 64-bit mode (the two
    roundings differ from one direct rounding where float32 lands on a
    bfloat16 tie)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for k, (s, d) in batch_shapes(cfg, shape).items():
        if k in ("tokens", "targets"):
            arr = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=s)).to(d)
        elif k == "positions":
            B, S = s[0], s[1]
            arr = torch.arange(S, dtype=d).expand(B, S)
            if len(s) == 3:
                arr = arr[..., None].expand(B, S, 3)
            arr = arr.contiguous()
        elif k == "loss_mask":
            arr = torch.ones(s, dtype=d)
        else:  # frontend embeddings
            arr = torch.from_numpy((rng.normal(size=s) * 0.02).astype(np.float32)).to(d)
        out[k] = arr.to(device)
    return out
