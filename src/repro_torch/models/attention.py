"""Multi-head attention (MHA/GQA/MQA) with selectable inner implementation.

``impl``:
  * "naive"   — materializes the (S, S) score matrix,
  * "chunked" — online softmax over KV blocks (flash-style memory behaviour),
  * "pallas"  — the flash-attention kernel (``kernels/flash_attention``): the
                hand-written Hopper kernel on CUDA tensors, its plain version
                on the CPU.  Forward only, as in the reference, and with the
                reference's semantics: it is given neither ``kv_len`` nor
                ``q_offset``, so it is exact only where Sq == Sk == kv_len
                (the no-cache forward of ``train_loss`` and ``prefill_logits``).

Decode mode consumes an explicit KV cache: either a dense ``(k, v)`` pair
``(B, S_max, KV, hd)`` or the split ``{"main", "recent"}`` cache, each with
the number of tokens already cached.  Unlike the reference's functional
``dynamic_update_slice``, the new K/V are written into the cache tensors in
place (no cache-sized copy per step); the returned cache holds the same
tensors.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.params import ParamDef
from repro_torch.models.rope import apply_rope

NEG_INF = -1e30


def attn_defs(cfg: ModelConfig, d_model: Optional[int] = None) -> Dict:
    d = d_model or cfg.d_model
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {
        "wq": ParamDef((d, H, hd)),
        "wk": ParamDef((d, KV, hd)),
        "wv": ParamDef((d, KV, hd)),
        "wo": ParamDef((H, hd, d)),
    }


def project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")`` as one matmul: x (..., d), w (d, H, k)."""
    return (x @ w.reshape(w.shape[0], -1)).reshape(*x.shape[:-1], *w.shape[1:])


def _repeat_kv(k: torch.Tensor, group: int) -> torch.Tensor:
    if group == 1:
        return k
    return torch.repeat_interleave(k, group, dim=2)


def _naive_attention(q, k, v, *, causal, kv_len, scale, q_offset=0):
    """q (B,Sq,H,hd), k/v (B,Sk,H,hd) — full score matrix."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    kpos = torch.arange(Sk, device=q.device)[None, None, None, :]
    mask = kpos < kv_len
    if causal:
        qpos = (q_offset + torch.arange(Sq, device=q.device))[None, None, :, None]
        mask = mask & (kpos <= qpos)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def _attention_with_lse(q, k, v, *, kv_len, kv_offset, scale, q_pos):
    """Partial attention over one KV segment, returning (out_f32, lse).

    q (B,Sq,H,hd); k/v (B,Sk,KV,hd).  GQA-native grouped einsums: KV is
    never repeated ``group`` times.  Operands are rounded to the compute
    dtype (``q.dtype``) and the products accumulate in f32 — the
    reference's ``preferred_element_type=f32`` (a product of two bf16 values
    is exact in f32).  Segment tokens occupy absolute positions
    [kv_offset, kv_offset+kv_len); causal masking uses absolute query
    positions ``q_pos`` (B, Sq).
    """
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    group = H // KV
    Sk = k.shape[1]
    cd = q.dtype  # compute dtype (bf16 in production)
    qg = q.reshape(B, Sq, KV, group, hd)
    s = torch.einsum(
        "bqkgd,bskd->bkgqs", qg.float(), k.to(cd).float()
    ) * scale                                              # (B,KV,g,Sq,Sk)
    ar = torch.arange(Sk, device=q.device)
    kpos = kv_offset + ar
    mask = (ar[None, None, None, None, :] < kv_len) & (
        kpos[None, None, None, None, :] <= q_pos[:, None, None, :, None]
    )
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1)                                         # (B,KV,g,Sq)
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(-1)
    # p is rounded to the compute dtype before the PV product
    out = torch.einsum("bkgqs,bskd->bkgqd", p.to(cd).float(), v.to(cd).float())
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = out / l_safe[..., None]
    lse = torch.where(l == 0.0, NEG_INF, m + torch.log(l_safe))
    # -> (B, Sq, H, hd), (B, Sq, H)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)
    lse = lse.permute(0, 3, 1, 2).reshape(B, Sq, H)
    return out, lse


def merge_segments(parts):
    """Exactly combine [(out_normalized, lse), ...] partial attentions."""
    m = parts[0][1]
    for _, lse in parts[1:]:
        m = torch.maximum(m, lse)
    m = torch.clamp_min(m, NEG_INF)  # keep finite when all segments are empty
    num = 0.0
    den = 0.0
    for out, lse in parts:
        w = torch.exp(lse - m)                              # (B,Sq,H)
        num = num + out * w[..., None]
        den = den + w
    den = torch.where(den == 0.0, 1.0, den)
    return num / den[..., None]


def _chunked_attention(q, k, v, *, causal, kv_len, scale, q_offset=0, block_k=512):
    """Online softmax over KV chunks: O(Sq*block_k) live memory, GQA-native."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    group = H // KV
    Sk = k.shape[1]
    dev = q.device
    qf = q.reshape(B, Sq, KV, group, hd).float()
    qpos = (q_offset + torch.arange(Sq, device=dev))[None, None, None, :, None]
    m = torch.full((B, KV, group, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, group, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, group, Sq, hd), dtype=torch.float32, device=dev)
    for k0 in range(0, Sk, block_k):
        kc = k[:, k0:k0 + block_k].float()
        vc = v[:, k0:k0 + block_k].float()
        n = kc.shape[1]
        if n < block_k:   # zero-pad the ragged last chunk, as the reference does
            kc = torch.nn.functional.pad(kc, (0, 0, 0, 0, 0, block_k - n))
            vc = torch.nn.functional.pad(vc, (0, 0, 0, 0, 0, block_k - n))
        s = torch.einsum("bqkgd,bskd->bkgqs", qf, kc) * scale   # (B,KV,g,Sq,bk)
        kpos = (k0 + torch.arange(block_k, device=dev))[None, None, None, None, :]
        mask = kpos < kv_len
        if causal:
            mask = mask & (kpos <= qpos)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        l = alpha * l + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p, vc)
        m = m_new
    out = acc / torch.where(l[..., None] == 0, 1.0, l[..., None])
    # (B, KV, g, Sq, hd) -> (B, Sq, H, hd)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)


def _inner_attention(q, k, v, *, impl, causal, kv_len, scale, q_offset=0):
    group = q.shape[2] // k.shape[2]
    if impl == "pallas":
        # as the reference: kv_len and q_offset are not passed on
        o = flash_ops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, scale=scale,
        )
        return o.transpose(1, 2)
    if impl == "chunked":
        return _chunked_attention(
            q, k, v, causal=causal, kv_len=kv_len, scale=scale, q_offset=q_offset
        )
    k = _repeat_kv(k, group)
    v = _repeat_kv(v, group)
    return _naive_attention(
        q, k, v, causal=causal, kv_len=kv_len, scale=scale, q_offset=q_offset
    )


def apply_attention(
    p: Dict,
    cfg: ModelConfig,
    x: torch.Tensor,                    # (B, S, d)
    positions: torch.Tensor,            # (B, S) or (B, S, 3)
    *,
    impl: str = "naive",
    causal: bool = True,
    cache=None,
    cache_len=None,                     # tokens already cached (int)
):
    B, S, d = x.shape
    hd = cfg.hd
    scale = 1.0 / math.sqrt(hd)

    q = apply_rope(cfg, project(x, p["wq"]), positions)
    k = apply_rope(cfg, project(x, p["wk"]), positions)
    v = project(x, p["wv"])

    if cache is None:
        out = _inner_attention(
            q, k, v, impl=impl, causal=causal, kv_len=S, scale=scale
        )
        new_cache = None
    elif isinstance(cache, dict):
        # Split KV cache: "main" is read-only within a decode step, new
        # tokens go to the small "recent" ring; the two segments merge
        # exactly via logsumexp weights.
        mk, mv = cache["main"]
        rk, rv = cache["recent"]
        len_main, len_rec = cache_len  # (tokens in main, tokens in recent)
        rk[:, len_rec:len_rec + S] = k.to(rk.dtype)
        rv[:, len_rec:len_rec + S] = v.to(rv.dtype)
        q_pos = positions[:, :, 0] if positions.dim() == 3 else positions
        out_m, lse_m = _attention_with_lse(
            q, mk, mv, kv_len=len_main, kv_offset=0, scale=scale,
            q_pos=q_pos,
        )
        out_r, lse_r = _attention_with_lse(
            q, rk, rv, kv_len=len_rec + S, kv_offset=len_main,
            scale=scale, q_pos=q_pos,
        )
        out = merge_segments([(out_m, lse_m), (out_r, lse_r)]).to(q.dtype)
        new_cache = {"recent": (rk, rv)}
    else:
        ck, cv = cache
        ck[:, cache_len:cache_len + S] = k.to(ck.dtype)
        cv[:, cache_len:cache_len + S] = v.to(cv.dtype)
        # decode (S == 1) always materializes the (B, H, 1, Sk) scores
        decode_impl = "naive" if S == 1 else impl
        out = _inner_attention(
            q, ck, cv,
            impl=decode_impl, causal=causal, kv_len=cache_len + S,
            scale=scale, q_offset=cache_len,
        )
        new_cache = (ck, cv)

    wo = p["wo"]
    y = out.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1])
    return y, new_cache
