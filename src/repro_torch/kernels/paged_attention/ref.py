"""Plain PyTorch version of paged decode attention: gathers each sequence's
KV stream out of the pool and runs dense masked attention in f32.  With
``return_lse`` it also returns the log-sum-exp of the masked scores."""
from __future__ import annotations

import torch


def paged_attention_ref(
    q: torch.Tensor,             # (B, Hkv, group, D)
    k_pool: torch.Tensor,        # (num_blocks, block_size, Hkv, D)
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # (B, max_blocks) int, -1 padded
    seq_lens: torch.Tensor,      # (B,) int
    *,
    scale: float,
    return_lse: bool = False,
):
    """Returns out (B, Hkv, group, D) in q's type, and with ``return_lse``
    also the f32 log-sum-exp (B, Hkv, group) of the scaled, masked scores
    (-inf for a length-0 row)."""
    B, Hkv, group, D = q.shape
    _, block_size, _, _ = k_pool.shape
    max_blocks = block_tables.shape[1]
    S = max_blocks * block_size

    idx = block_tables.long().clamp_min(0)                  # (B, nb)
    k = k_pool[idx].reshape(B, S, Hkv, D).transpose(1, 2)   # (B, Hkv, S, D)
    v = v_pool[idx].reshape(B, S, Hkv, D).transpose(1, 2)

    s = torch.einsum("bhgd,bhsd->bhgs", q.float(), k.float()) * scale
    pos = torch.arange(S, device=q.device)[None, None, None, :]
    mask = pos < seq_lens.long()[:, None, None, None]
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)                 # empty rows -> 0
    out = torch.einsum("bhgs,bhsd->bhgd", p, v.float()).to(q.dtype)
    return (out, torch.logsumexp(s, dim=-1)) if return_lse else out
