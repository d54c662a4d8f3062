"""Plain PyTorch version of flash attention: materializes the score matrix
in f32 (a port of the reference's ``flash_attention/ref.py``)."""
from __future__ import annotations

import torch


def attention_ref(
    q: torch.Tensor,   # (B, Hq, Sq, D)
    k: torch.Tensor,   # (B, Hkv, Sk, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: float | None = None,
    kv_len: int | None = None,
) -> torch.Tensor:
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    scale = (D ** -0.5) if scale is None else scale
    kv_len = Sk if kv_len is None else kv_len
    group = Hq // Hkv
    k = torch.repeat_interleave(k, group, dim=1)
    v = torch.repeat_interleave(v, group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    kpos = torch.arange(Sk, device=q.device)[None, None, None, :]
    mask = kpos < kv_len
    if causal:
        qpos = torch.arange(Sq, device=q.device)[None, None, :, None]
        mask = mask & (qpos >= kpos)
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)  # fully-masked rows -> zeros
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
