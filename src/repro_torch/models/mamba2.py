"""Mamba2 (SSD) block, zamba2's backbone.

Chunk-parallel selective state space: per-head scalar decay
``a_t = exp(-exp(A_log) * dt_t)`` feeding the shared
:mod:`repro_torch.models.linear_scan` machinery with q=C, k=B, v=dt*x.  C and
B are passed broadcast over the heads and the decay over the state dim, as
stride-0 views: nothing is materialized per head.  Includes the depthwise
causal conv on (x, B, C), gated RMS norm, and the D skip connection.  Decode
keeps (conv_state, ssd_state) per layer.  ``dt_bias``, ``A_log`` and
``norm`` stay float32 (the reference uses them on float32 values).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.linear_scan import chunked_decay_attention, decay_attention_step
from repro_torch.models.params import ParamDef


class MambaState(NamedTuple):
    conv: torch.Tensor   # (B, K-1, conv_dim)
    ssd: torch.Tensor    # (B, H, n_state, head_dim) f32


def _dims(cfg: ModelConfig) -> Tuple[int, int, int, int, int]:
    d_in = cfg.ssm_expand * cfg.d_model
    H = d_in // cfg.ssm_head_dim
    conv_dim = d_in + 2 * cfg.ssm_state
    return d_in, H, cfg.ssm_head_dim, cfg.ssm_state, conv_dim


def mamba_defs(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    d_in, H, hd, ns, conv_dim = _dims(cfg)
    return {
        "wz": ParamDef((d, d_in)),
        "wx": ParamDef((d, d_in)),
        "wB": ParamDef((d, ns)),
        "wC": ParamDef((d, ns)),
        "wdt": ParamDef((d, H)),
        "dt_bias": ParamDef((H,), init="zeros", f32=True),
        "A_log": ParamDef((H,), init="zeros", f32=True),
        "D": ParamDef((H,), init="ones"),
        "conv_w": ParamDef((cfg.ssm_conv, conv_dim), init="embed", scale=0.5),
        "norm": ParamDef((d_in,), init="ones", f32=True),
        "wo": ParamDef((d_in, d)),
    }


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, prev: Optional[torch.Tensor]):
    """Depthwise causal conv along seq; returns output + new conv state."""
    K = w.shape[0]
    S = xBC.shape[1]
    if prev is None:
        prev = torch.zeros((xBC.shape[0], K - 1, xBC.shape[-1]), dtype=xBC.dtype,
                           device=xBC.device)
    xp = torch.cat([prev, xBC], dim=1)
    out = sum(xp[:, i:i + S] * w[i][None, None, :] for i in range(K))
    new_state = xp[:, -(K - 1):] if K > 1 else prev
    return F.silu(out), new_state


def apply_mamba(
    p: Dict,
    cfg: ModelConfig,
    x: torch.Tensor,                 # (B, S, d)
    state: Optional[MambaState] = None,
) -> Tuple[torch.Tensor, Optional[MambaState]]:
    B, S, d = x.shape
    d_in, H, hd, ns, conv_dim = _dims(cfg)
    dt_f = x.dtype

    z = x @ p["wz"]
    xi = x @ p["wx"]
    Bp = x @ p["wB"]
    Cp = x @ p["wC"]
    dt = F.softplus((x @ p["wdt"]).float() + p["dt_bias"])          # (B, S, H)

    xBC = torch.cat([xi, Bp, Cp], dim=-1)
    conv_prev = state.conv if state is not None else None
    xBC, conv_new = _causal_conv(xBC, p["conv_w"], conv_prev)
    xi, Bp, Cp = torch.split(xBC, [d_in, ns, ns], dim=-1)

    xh = xi.reshape(B, S, H, hd)
    v = xh * dt.to(dt_f)[..., None]                                  # (B, S, H, hd)
    q = Cp[:, :, None, :].expand(B, S, H, ns)                        # stride 0 over H
    k = Bp[:, :, None, :].expand(B, S, H, ns)
    log_w = (-torch.exp(p["A_log"])[None, None, :] * dt)[..., None]  # (B, S, H, 1)
    log_w = log_w.expand(B, S, H, ns)                                # stride 0 over ns

    ssd_prev = state.ssd if state is not None else None
    if S == 1 and state is not None:
        y1, ssd_new = decay_attention_step(q[:, 0], k[:, 0], v[:, 0], log_w[:, 0], ssd_prev)
        y = y1[:, None]
    else:
        y, ssd_new = chunked_decay_attention(
            q, k, v, log_w, initial_state=ssd_prev, return_state=True)
    y = y + p["D"][None, None, :, None] * xh
    y = y.reshape(B, S, d_in)

    # gated RMS norm then out-projection
    yf = y.float()
    yf = yf * torch.rsqrt((yf * yf).mean(-1, keepdim=True) + 1e-6)
    y = (yf * p["norm"]).to(dt_f) * F.silu(z)
    out = y @ p["wo"]

    new_state = MambaState(conv=conv_new, ssd=ssd_new) if state is not None else None
    return out, new_state


def init_mamba_state(cfg: ModelConfig, batch: int, dtype: torch.dtype, *,
                     device) -> MambaState:
    d_in, H, hd, ns, conv_dim = _dims(cfg)
    return MambaState(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype, device=device),
        ssd=torch.zeros((batch, H, ns, hd), dtype=torch.float32, device=device),
    )
