"""Decode step over the PUMA paged KV pool (dense/moe families).

Attention reads KV through the *block table* with the paged-attention
kernel (``repro_torch.kernels.paged_attention``), and the new token's K/V is
returned for the caller to write into pool blocks placed by the PUMA policy.

The runner mirrors ``LM.decode_step`` (same params, same math) with the
dense cache swapped for (k_pool, v_pool, block_table, seq_lens); the layer
loop is a plain Python loop.  ``paged_decode_step`` runs it eagerly;
``paged_decode_step_jit`` replays it as a CUDA graph, the serving engine's
decode hot path on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import torch_dtype
from repro_torch.configs.base import ModelConfig
from repro_torch.graphs import CapturedStep, GraphCache, HostInputs
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models.attention import project
from repro_torch.models.rope import apply_rope
from repro_torch.models.transformer import layer_params

__all__ = ["paged_decode_step", "paged_decode_step_jit"]


def paged_decode_step(
    params,
    cfg: ModelConfig,
    tokens: torch.Tensor,        # (B, 1)
    positions: torch.Tensor,     # (B, 1), or (B, 1, 3) for an mrope config
    k_pool: torch.Tensor,        # (L, nb, bs, KV, hd)
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # (B, max_blocks) int32
    seq_lens: torch.Tensor,      # (B,) length INCLUDING the current token
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (logits (B, V), new_k (L, B, KV, hd), new_v (L, B, KV, hd)).

    ``positions`` rotate q and the new k as ``apply_rope`` does: (B, 1),
    or (B, 1, 3) (t, h, w) for an ``mrope`` config, which raises on 2-D
    positions.  The caller scatters new_k/new_v into pool blocks.
    Attention masks to ``seq_lens``, which already counts the current
    token; its K/V is merged analytically with the attention over the pool.
    """
    x = L.embed_tokens(params["embed"], tokens, torch_dtype(cfg.dtype))   # (B, 1, d)

    new_ks, new_vs = [], []
    for li in range(cfg.n_layers):
        lp = layer_params(params["layers"], li)
        h = L.apply_norm(lp["ln1"], x)
        q = apply_rope(cfg, project(h, lp["attn"]["wq"]), positions)
        k1 = apply_rope(cfg, project(h, lp["attn"]["wk"]), positions)
        v1 = project(h, lp["attn"]["wv"])

        attn_out = _paged_attention_with_current(
            q[:, 0], k_pool[li], v_pool[li], block_tables, seq_lens,
            k1[:, 0].to(k_pool.dtype), v1[:, 0].to(v_pool.dtype),
        )
        wo = lp["attn"]["wo"]
        a = attn_out.reshape(attn_out.shape[0], -1) @ wo.reshape(-1, wo.shape[-1])
        x = x + a[:, None]
        h = L.apply_norm(lp["ln2"], x)
        if cfg.n_experts:
            m, _ = MOE.apply_moe(lp["moe"], cfg, h)
        else:
            m = L.apply_mlp(lp["mlp"], h)
        x = x + m
        new_ks.append(k1[:, 0])
        new_vs.append(v1[:, 0])

    x = L.apply_norm(params["final_ln"], x)
    logits = L.logits_from(params["embed"], x)[:, 0]
    return logits, torch.stack(new_ks), torch.stack(new_vs)


def _paged_attention_with_current(q, k_pool, v_pool, block_tables, seq_lens, k_cur, v_cur):
    """Attention over pooled KV plus the in-flight token: attention over the
    pool with lengths ``seq_len - 1`` (the kernel, which also returns the
    past log-sum-exp), then the current token merged exactly through that
    log-sum-exp."""
    B, H, hd = q.shape
    KV = k_pool.shape[2]
    scale = hd ** -0.5
    group = H // KV

    # past contribution (lengths exclude the current token), in q's dtype,
    # and its log-sum-exp (B, KV, group) in f32
    past_len = seq_lens - 1
    out_past, lse_past = paged_ops.paged_attention(
        q, k_pool, v_pool, block_tables, past_len, scale=scale, return_lse=True,
    )

    # merge current token: softmax over [past, current] decomposes into a
    # weighted average of the past attention output and v_cur.
    qg = q.reshape(B, KV, group, hd).float()
    s_cur = torch.einsum("bkgd,bkd->bkg", qg, k_cur.float()) * scale

    has_past = (past_len > 0)[:, None, None]
    m = torch.maximum(torch.where(has_past, lse_past, float("-inf")), s_cur)
    w_past = torch.where(has_past, torch.exp(lse_past - m), 0.0)
    w_cur = torch.exp(s_cur - m)
    denom = w_past + w_cur
    out = (
        out_past.reshape(B, KV, group, hd).float() * w_past[..., None]
        + v_cur.float()[:, :, None, :] * w_cur[..., None]
    ) / denom[..., None]
    return out.reshape(B, H, hd).to(q.dtype)


def paged_decode_step_jit(
    params,
    cfg: ModelConfig,
    tokens: np.ndarray,          # (B, 1) host arrays, as paged_decode_step's
    positions: np.ndarray,       # (B, 1), or (B, 1, 3) for an mrope config
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: np.ndarray,
    seq_lens: np.ndarray,
    *,
    graphs: Optional[GraphCache],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`paged_decode_step` as a CUDA graph: the counterpart of the
    reference's ``paged_decode_step_jit``, which compiles the step once per
    (batch, pool) shape.

    One graph per (config, B, block-table width, the pools' storage, shape
    and dtype, the params dict) in ``graphs``
    (``repro_torch.graphs.graph_cache(model)``), retired once its pools are
    freed.
    The four host arrays are written into pinned staging and copied into the
    graph's static inputs without blocking the host; the replay reads the
    pools where they are, so in-place writes to them (token K/V, ``fork``
    and ``compact`` through the block-copy kernel) are seen, and the
    paged-attention kernel reads neither lengths nor table on the host.
    Returns the graph's own (logits, new_k, new_v): consume them before the
    next replay of any graph in ``graphs``.  A failed capture raises.

    With ``graphs=None`` (the engine's ``jit=False``), and on CPU pools,
    the step runs eagerly: CPUs have no graphs.
    """
    host = (tokens, positions, block_tables, seq_lens)
    if graphs is None or k_pool.device.type != "cuda":
        t = [torch.from_numpy(a).to(k_pool.device) for a in host]
        return paged_decode_step(params, cfg, t[0], t[1], k_pool, v_pool, t[2], t[3])
    key = graph_key(params, cfg, k_pool, v_pool, tokens, block_tables)

    def make(pool):
        inputs = HostInputs(host, k_pool.device)
        tok, pos, tbl, lens = inputs.tensors
        return CapturedStep(
            lambda: paged_decode_step(params, cfg, tok, pos, k_pool, v_pool, tbl, lens),
            pool=pool, inputs=inputs, keep=(params,), weak=(k_pool, v_pool))

    step = graphs.get(key, make)
    step.inputs.load(host)
    return step.replay()


def graph_key(params, cfg: ModelConfig, k_pool, v_pool, tokens, block_tables) -> tuple:
    """The key of a step's graph in its ``GraphCache``: the config (so a vlm
    graph, whose positions are (B, 1, 3), and a dense one never share a
    capture), the params dict, the pools' storage, shape and dtype, B and
    the block-table width."""
    return ("paged_decode_step", cfg, id(params), k_pool.data_ptr(), v_pool.data_ptr(),
            k_pool.shape, k_pool.dtype, tokens.shape[0], block_tables.shape[1])
