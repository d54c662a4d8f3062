"""Multi-head attention (MHA/GQA/MQA) with selectable inner implementation.

``impl``:
  * "naive"   — materializes the (S, S) score matrix,
  * "chunked" — online softmax over KV blocks (flash-style memory behaviour),
  * "pallas"  — the flash-attention kernel (``kernels/flash_attention``): the
                hand-written Hopper kernel on CUDA tensors, its plain version
                on the CPU.  Forward only, as in the reference, and with the
                reference's semantics: it is given neither ``kv_len`` nor
                ``q_offset``, so it is exact only where Sk == kv_len and, if
                causal, Sq == Sk (the no-cache forward of ``train_loss`` and
                ``prefill_logits``, and cross-attention at any Sq).

Cross-attention (the encdec family) takes its K/V as given through
``kv_override``: only q is projected, the call is never causal, and the
cache is returned untouched.

Decode mode consumes an explicit KV cache: either a dense ``(k, v)`` pair
``(B, S_max, KV, hd)`` or the split ``{"main", "recent"}`` cache, each with
the number of tokens already cached.  Unlike the reference's functional
``dynamic_update_slice``, the new K/V are written into the cache tensors in
place (no cache-sized copy per step); the returned cache holds the same
tensors.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import constraint, flatten, unflatten
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.layers import column_parallel
from repro_torch.models.params import ParamDef
from repro_torch.models.rope import apply_rope

NEG_INF = -1e30


def attn_defs(cfg: ModelConfig, d_model: Optional[int] = None) -> Dict:
    d = d_model or cfg.d_model
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {
        "wq": ParamDef((d, H, hd), ("embed", "heads", "head_dim")),
        "wk": ParamDef((d, KV, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamDef((d, KV, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamDef((H, hd, d), ("heads", "head_dim", "embed")),
    }


def project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")`` as one matmul: x (..., d), w (d, H, k).
    Under a mesh the (H, k) columns are split over the tensor-parallel axis
    (``column_parallel``); where the heads do not divide it (KV heads), the
    slices are gathered back into whole heads."""
    return unflatten(column_parallel(x, flatten(w, 1, -1)), -1, w.shape[1:])


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
    qg = unflatten(q, 2, (KV, group))
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


def _ring_segment(q, k, v, *, kv_len, kv_offset, scale, q_pos):
    """``_attention_with_lse`` over the recent ring, whose positions no mesh
    axis splits (the cache keeps it batch-sharded only).  Under a mesh each
    rank of the axis that splits the main segment's positions ("kv_seq"'s)
    attends to its slice of the ring, a view of its shard, masked at or past
    ``kv_len`` as the whole ring is, and the slices' partial attentions are
    merged over the axis: the largest lse gathered, the weighted outputs and
    the weights summed.  Where the axis has one rank or does not divide the
    ring, the whole ring on every rank."""
    mesh = shd.region_mesh(k)
    axis = shd.logical_spec("kv_seq")[0]
    n = shd.axis_size(axis) if mesh is not None and axis is not None else 1
    if n == 1 or k.shape[1] % n:
        return _attention_with_lse(q, k, v, kv_len=kv_len, kv_offset=kv_offset, scale=scale,
                                   q_pos=q_pos)
    batch = shd.filter_spec(shd.logical_spec("batch"), q.shape[:1], mesh)[0]
    width = k.shape[1] // n

    def local(ql, kl, vl, pos):
        lo = shd.axis_index(axis) * width
        out, lse = _attention_with_lse(ql, kl[:, lo:lo + width], vl[:, lo:lo + width],
                                       kv_len=kv_len - lo, kv_offset=kv_offset + lo,
                                       scale=scale, q_pos=pos)
        m = shd.all_gather(lse.detach()[..., None], axis, -1).amax(-1)
        w = torch.exp(lse - m)
        den = shd.psum(w, axis)
        return shd.psum(out * w[..., None], axis) / den[..., None], m + torch.log(den)

    spec = shd.P(batch, None, None, None)
    return shd.shard_map(local, mesh=mesh, in_specs=(spec, spec, spec, shd.P(batch, None)),
                         out_specs=(spec, shd.P(batch, None, None)), splits=(axis,))(
        q, k, v, q_pos)


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
    qf = unflatten(q, 2, (KV, group)).float()
    qpos = (q_offset + torch.arange(Sq, device=dev))[None, None, None, :, None]
    m = torch.full((B, KV, group, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, group, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, group, Sq, hd), dtype=torch.float32, device=dev)
    for k0 in range(0, Sk, block_k):
        kc = k[:, k0:k0 + block_k].float()
        vc = v[:, k0:k0 + block_k].float()
        n = kc.shape[1]
        if n < block_k:   # zero-pad the ragged last chunk, as the reference does
            # (a concatenation: PyTorch 2.11's DTensor pads a tensor of a 2-D
            # mesh into a malformed one-dim placement)
            pad = torch.zeros((B, block_k - n) + tuple(kc.shape[2:]), dtype=kc.dtype,
                              device=kc.device)
            kc, vc = torch.cat([kc, pad], dim=1), torch.cat([vc, pad], dim=1)
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


def _query_heads(fn, axis, group, q, k, v):
    """``fn`` on this rank's query heads [r*Hl, (r+1)*Hl) along ``axis``
    (Hl dividing ``group``) and the one KV head they read, (r*Hl) // group."""
    lo = shd.axis_index(axis) * q.shape[2] // group
    return fn(q, k[:, :, lo:lo + 1], v[:, :, lo:lo + 1])


def _inner_attention(q, k, v, *, impl, causal, kv_len, scale, q_offset=0):
    mesh = shd.region_mesh(q)
    if mesh is not None:
        # attention is independent per batch row and per query head: run it
        # on each rank's shards (PyTorch 2.11's DTensor cannot flatten the
        # sharded head dim its einsums need).  The heads are split where the
        # KV heads divide the mesh axis; else, where the query heads do and
        # each rank's query heads lie in one KV group, q alone is split and
        # each rank reads that group's KV head (a view of k and v, whole in
        # heads); else only the batch is split.
        batch = shd.filter_spec(shd.logical_spec("batch"), q.shape[:1], mesh)[0]
        heads = shd.logical_spec("heads")[0]
        q_spec = shd.filter_spec(shd.P(batch, None, heads, None), q.shape, mesh)
        kv_spec = shd.filter_spec(shd.P(batch, None, heads, None), k.shape, mesh)
        fn = functools.partial(_inner_attention, impl=impl, causal=causal, kv_len=kv_len,
                               scale=scale, q_offset=q_offset)
        group = q.shape[2] // k.shape[2]
        if kv_spec[2] is None and q_spec[2] is not None:
            hl = q.shape[2] // shd.axis_size(heads)
            if group % hl:
                q_spec = kv_spec
            else:
                fn = functools.partial(_query_heads, fn, heads, group)
        return shd.shard_map(fn, mesh=mesh, in_specs=(q_spec, kv_spec, kv_spec),
                             out_specs=q_spec)(q, k, v)
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
    kv_override=None,                   # cross-attention: (k, v) (B, Sk, KV, hd)
):
    B, S, d = x.shape
    hd = cfg.hd
    scale = 1.0 / math.sqrt(hd)

    q = project(x, p["wq"])
    if cache is not None and S == 1:
        # decode: q is tiny — replicate heads so the attention contractions
        # stay aligned with the kv_seq-sharded cache
        q = constraint(q, "batch", "seq", None, None)
    else:
        q = constraint(q, "batch", "seq", "heads", None)
    q = apply_rope(cfg, q, positions)
    if kv_override is None:
        k = constraint(project(x, p["wk"]), "batch", "seq", "kv_heads", None)
        v = constraint(project(x, p["wv"]), "batch", "seq", "kv_heads", None)
        k = apply_rope(cfg, k, positions)

    if kv_override is not None:
        # keys at or past kv_len are masked; the pallas path is not told, as
        # in the reference (the cross cache is exactly the encoder's length)
        k, v = kv_override
        out = _inner_attention(
            q, k, v, impl=impl, causal=False,
            kv_len=cache_len if cache_len is not None else k.shape[1], scale=scale,
        )
        new_cache = cache
    elif cache is None:
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
        out_r, lse_r = _ring_segment(
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

    if cache is not None and S == 1:
        out = constraint(out, "batch", "seq", None, None)
    else:
        out = constraint(out, "batch", "seq", "heads", None)
    y = flatten(out, 2, 3) @ flatten(p["wo"], 0, 1)
    return constraint(y, "batch", "seq_res", None), new_cache
