"""Shared building blocks: norms, MLPs, embeddings."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import ParamDef

# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def norm_defs(cfg: ModelConfig, d: int | None = None) -> Dict:
    d = d or cfg.d_model
    if cfg.norm == "layernorm":
        return {
            "scale": ParamDef((d,), init="ones", f32=True),
            "bias": ParamDef((d,), init="zeros", f32=True),
        }
    return {"scale": ParamDef((d,), init="ones", f32=True)}


def apply_norm(p: Dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if "bias" in p:
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:
        ms = (xf * xf).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * p["scale"]
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# dense MLP
# ---------------------------------------------------------------------------

def mlp_defs(cfg: ModelConfig) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.activation == "swiglu":
        return {
            "wg": ParamDef((d, f)),
            "wu": ParamDef((d, f)),
            "wo": ParamDef((f, d)),
        }
    return {
        "wu": ParamDef((d, f)),
        "bu": ParamDef((f,), init="zeros"),
        "wo": ParamDef((f, d)),
        "bo": ParamDef((d,), init="zeros"),
    }


def apply_mlp(p: Dict, x: torch.Tensor) -> torch.Tensor:
    if "wg" in p:
        h = F.silu(x @ p["wg"]) * (x @ p["wu"])
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ p["wu"] + p["bu"], approximate="tanh")
    out = h @ p["wo"]
    if "bo" in p:
        out = out + p["bo"]
    return out


# ---------------------------------------------------------------------------
# embeddings / logits
# ---------------------------------------------------------------------------

def pad_vocab(cfg: ModelConfig, mult: int = 2048) -> int:
    """Pad the vocab to a multiple of ``mult`` (the reference's layout: the
    logits and the engine's argmax run over the padded vocab)."""
    return -(-cfg.vocab_size // mult) * mult


def embed_defs(cfg: ModelConfig) -> Dict:
    v = pad_vocab(cfg)
    out = {"tok": ParamDef((v, cfg.d_model), init="embed", scale=0.02)}
    if not cfg.tie_embeddings:
        out["head"] = ParamDef((cfg.d_model, v))
    return out


def embed_tokens(p: Dict, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return p["tok"].to(dtype)[tokens]


def logits_from(p: Dict, x: torch.Tensor) -> torch.Tensor:
    if "head" in p:
        return x @ p["head"]
    return x @ p["tok"].T
