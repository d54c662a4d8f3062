"""RWKV6 "Finch" block: token-shift time-mix with data-dependent per-channel
decay (LoRA-modulated) + bonus, and the squared-ReLU channel-mix FFN.

The wkv recurrence is the ``bonus`` variant of
:mod:`repro_torch.models.linear_scan`; decode carries (shift_tm, shift_cm,
wkv) states per layer, O(1) in sequence length.  ``w0``, ``u`` and
``ln_scale`` stay float32 (the reference uses them on float32 values); every
other leaf is stored in the compute dtype, as the reference casts it at use.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import constraint, flatten, gather_dim, unflatten
from repro_torch.models.layers import column_parallel
from repro_torch.models.linear_scan import (chunked_decay_attention, chunked_on_shards,
                                            decay_attention_step, step_on_shards)
from repro_torch.models.params import ParamDef

LORA_R = 64


class RwkvState(NamedTuple):
    shift_tm: torch.Tensor    # (B, d) last input to time-mix
    shift_cm: torch.Tensor    # (B, d) last input to channel-mix
    wkv: torch.Tensor         # (B, H, hd, hd) f32


def _heads(cfg: ModelConfig) -> Tuple[int, int]:
    hd = cfg.ssm_head_dim
    return cfg.d_model // hd, hd


def time_mix_defs(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    H, hd = _heads(cfg)
    return {
        "mu_r": ParamDef((d,), ("embed_tp",), init="zeros"),
        "mu_k": ParamDef((d,), ("embed_tp",), init="zeros"),
        "mu_v": ParamDef((d,), ("embed_tp",), init="zeros"),
        "mu_g": ParamDef((d,), ("embed_tp",), init="zeros"),
        "mu_w": ParamDef((d,), ("embed_tp",), init="zeros"),
        "wr": ParamDef((d, d), ("embed", "heads")),
        "wk": ParamDef((d, d), ("embed", "heads")),
        "wv": ParamDef((d, d), ("embed", "heads")),
        "wg": ParamDef((d, d), ("embed", "heads")),
        "w0": ParamDef((d,), ("embed_tp",), init="zeros", f32=True),
        "w_lora_a": ParamDef((d, LORA_R), ("embed", None)),
        "w_lora_b": ParamDef((LORA_R, d), (None, "embed_tp"), init="zeros"),
        "u": ParamDef((H, hd), ("heads", None), init="zeros", f32=True),
        "ln_scale": ParamDef((d,), ("embed_tp",), init="ones", f32=True),
        "wo": ParamDef((d, d), ("heads", "embed")),
    }


def channel_mix_defs(cfg: ModelConfig) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu_k": ParamDef((d,), ("embed_tp",), init="zeros"),
        "mu_r": ParamDef((d,), ("embed_tp",), init="zeros"),
        "wk": ParamDef((d, f), ("embed", "mlp")),
        "wv": ParamDef((f, d), ("mlp", "embed")),
        "wr": ParamDef((d, d), ("embed", "embed_tp")),
    }


def _shift(x: torch.Tensor, prev: Optional[torch.Tensor]) -> torch.Tensor:
    """Token shift: x_{t-1} (prev carries the last token across steps)."""
    if prev is None:
        pad = torch.zeros_like(x[:, :1])
    else:
        pad = prev[:, None].to(x.dtype)
    return torch.cat([pad, x[:, :-1]], dim=1)


def apply_time_mix(
    p: Dict,
    cfg: ModelConfig,
    x: torch.Tensor,                     # (B, S, d)
    state: Optional[RwkvState] = None,
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    S = x.shape[1]
    H, hd = _heads(cfg)

    xs = _shift(x, state.shift_tm if state is not None else None)
    dx = xs - x
    xr, xk, xv, xg, xw = (x + dx * p[f"mu_{n}"] for n in "rkvgw")

    # the heads split off the projections' columns (under a mesh gathered
    # first where the columns' shards do not fall on whole heads)
    r = unflatten(xr @ p["wr"], -1, (H, hd))
    k = unflatten(xk @ p["wk"], -1, (H, hd))
    v = unflatten(xv @ p["wv"], -1, (H, hd))
    g = F.silu(xg @ p["wg"])
    r = constraint(r, "batch", "seq", "heads", None)
    k = constraint(k, "batch", "seq", "heads", None)
    v = constraint(v, "batch", "seq", "heads", None)

    # data-dependent decay (Finch): w = exp(-exp(w0 + lora(xw)))
    lora = torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"]
    log_w = unflatten(-torch.exp(
        torch.clamp(p["w0"][None, None] + lora.float(), -8.0, 4.0)
    ), -1, (H, hd))
    log_w = constraint(log_w, "batch", "seq", "heads", None)

    wkv_prev = state.wkv if state is not None else None
    if S == 1 and state is not None:
        y1, wkv_new = step_on_shards(r[:, 0], k[:, 0], v[:, 0], log_w[:, 0], wkv_prev,
                                     bonus=p["u"], step=decay_attention_step)
        y = y1[:, None]
    else:
        y, wkv_new = chunked_on_shards(r, k, v, log_w, bonus=p["u"], initial_state=wkv_prev,
                                       chunked=chunked_decay_attention)

    # per-head group norm, gate, out-projection
    yf = y.float()
    yf = yf * torch.rsqrt((yf * yf).mean(-1, keepdim=True) + 1e-6)
    y = (flatten(yf, 2, 3) * p["ln_scale"]).to(x.dtype) * g
    out = constraint(y @ p["wo"], "batch", "seq_res", None)

    if state is not None:
        return out, (x[:, -1].to(state.shift_tm.dtype), wkv_new)
    return out, None


def apply_channel_mix(
    p: Dict,
    cfg: ModelConfig,
    x: torch.Tensor,
    shift_prev: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    xs = _shift(x, shift_prev)
    dx = xs - x
    xk = x + dx * p["mu_k"]
    xr = x + dx * p["mu_r"]
    k = constraint(torch.square(F.relu(xk @ p["wk"])), "batch", "seq", "mlp")
    kv = k @ p["wv"]
    # wr's columns are "embed_tp", split by no axis: each rank computes its
    # slice of them, gathered after the sigmoid
    r = gather_dim(torch.sigmoid(column_parallel(xr, p["wr"])), -1)
    new_shift = x[:, -1] if shift_prev is not None else None
    return constraint(r * kv, "batch", "seq_res", None), new_shift


def init_rwkv_state(cfg: ModelConfig, batch: int, dtype: torch.dtype, *,
                    device) -> RwkvState:
    H, hd = _heads(cfg)
    return RwkvState(
        shift_tm=torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
        shift_cm=torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
        wkv=torch.zeros((batch, H, hd, hd), dtype=torch.float32, device=device),
    )
