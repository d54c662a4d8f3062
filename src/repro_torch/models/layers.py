"""Shared building blocks: norms, MLPs, embeddings."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import sharding as shd
from repro_torch.models.params import ParamDef

# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def norm_defs(cfg: ModelConfig, d: int | None = None) -> Dict:
    d = d or cfg.d_model
    if cfg.norm == "layernorm":
        return {
            "scale": ParamDef((d,), ("embed_tp",), init="ones", f32=True),
            "bias": ParamDef((d,), ("embed_tp",), init="zeros", f32=True),
        }
    return {"scale": ParamDef((d,), ("embed_tp",), init="ones", f32=True)}


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
            "wg": ParamDef((d, f), ("embed", "mlp")),
            "wu": ParamDef((d, f), ("embed", "mlp")),
            "wo": ParamDef((f, d), ("mlp", "embed")),
        }
    return {
        "wu": ParamDef((d, f), ("embed", "mlp")),
        "bu": ParamDef((f,), ("mlp",), init="zeros"),
        "wo": ParamDef((f, d), ("mlp", "embed")),
        "bo": ParamDef((d,), ("embed_tp",), init="zeros"),
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
    out = {"tok": ParamDef((v, cfg.d_model), ("vocab", "embed"), init="embed", scale=0.02)}
    if not cfg.tie_embeddings:
        out["head"] = ParamDef((cfg.d_model, v), ("embed", "vocab"))
    return out


def embed_tokens(p: Dict, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    mesh = shd.get_mesh()
    if mesh is None or not isinstance(p["tok"], DTensor):
        return p["tok"].to(dtype)[tokens]
    # DTensor's index over a ("vocab", "embed")-sharded table, and its
    # backward's index_put, lack sound sharding rules in PyTorch 2.11: look
    # up locally, the table gathered whole, the tokens by batch
    batch = shd.filter_spec(shd.logical_spec("batch"), tokens.shape, mesh)[0]
    return shd.shard_map(lambda t, tok: t.to(dtype)[tok], mesh=mesh,
                         in_specs=(shd.P(), shd.P(batch, None)),
                         out_specs=shd.P(batch, None, None))(p["tok"], tokens)


def logits_from(p: Dict, x: torch.Tensor) -> torch.Tensor:
    if "head" in p:
        return x @ p["head"]
    return x @ p["tok"].T
