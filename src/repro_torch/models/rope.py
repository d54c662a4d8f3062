"""Rotary position embeddings: standard, partial (ChatGLM-style 2D), and
M-RoPE (Qwen2-VL: separate temporal/height/width sections).

All three rotate *interleaved* (even, odd) channel pairs, as the reference
does, not the rotate-half convention."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig


def _rot_half_pairs(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate consecutive (even, odd) channel pairs (computed f32, cast back)."""
    xf = x.float()
    x1, x2 = xf[..., 0::2], xf[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.stack([o1, o2], dim=-1).reshape(x.shape).to(x.dtype)


def _inv_freq(dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)


def _angles(positions: torch.Tensor, dim: int, theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) -> cos/sin (..., dim//2)."""
    inv = _inv_freq(dim, theta, positions.device)
    ang = positions[..., None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(
    cfg: ModelConfig,
    x: torch.Tensor,            # (B, S, H, hd)
    positions: torch.Tensor,    # (B, S) or (B, S, 3) for mrope
) -> torch.Tensor:
    hd = x.shape[-1]
    if cfg.rope == "none":
        return x

    if cfg.rope == "rope":
        cos, sin = _angles(positions, hd, cfg.rope_theta)      # (B,S,hd/2)
        return _rot_half_pairs(x, cos[:, :, None, :], sin[:, :, None, :])

    if cfg.rope == "rope2d":
        # ChatGLM: rotary over the first half of channels only.
        rd = hd // 2
        cos, sin = _angles(positions, rd, cfg.rope_theta)
        rot = _rot_half_pairs(x[..., :rd], cos[:, :, None, :], sin[:, :, None, :])
        return torch.cat([rot, x[..., rd:]], dim=-1)

    if cfg.rope == "mrope":
        # positions (B, S, 3): (t, h, w); channel sections per stream.  The
        # reference reads any last axis as the streams; a 2-D array there
        # gives every token the first row's first three positions (ROADMAP.md,
        # fault 6), so it raises here.
        if positions.dim() != 3 or positions.shape[-1] != 3:
            raise ValueError(f"mrope takes (B, S, 3) positions, got {tuple(positions.shape)}")
        st, sh, sw = cfg.mrope_sections
        if (st + sh + sw) * 2 != hd:
            raise ValueError(f"mrope sections {cfg.mrope_sections} do not cover head width {hd}")
        inv = _inv_freq(hd, cfg.rope_theta, positions.device)
        # stream per channel pair: [0:st] -> t, [st:st+sh] -> h, the rest -> w
        # (built on the device: a CUDA graph captures no host copy)
        pair = torch.arange(hd // 2, device=positions.device)
        sec = (pair >= st).long() + (pair >= st + sh).long()
        ang = positions.float()[..., sec] * inv                # (B,S,hd/2)
        cos, sin = torch.cos(ang), torch.sin(ang)
        return _rot_half_pairs(x, cos[:, :, None, :], sin[:, :, None, :])

    raise ValueError(cfg.rope)
