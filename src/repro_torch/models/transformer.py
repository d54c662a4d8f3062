"""Model assembly: the dense decoder family.

One :class:`LM` object per config exposes plain functions over a params dict
(stacked leading "layers" axis, the reference's paths):

  * ``init(generator, device=...) -> params``
  * ``prefill_logits(params, batch)`` (last-position logits)
  * ``decode_step(params, batch, cache) -> (logits, cache)``
  * ``init_cache(batch, max_len, device=...)``

The layer stack is a Python loop over the stacked weights.  The moe, ssm,
hybrid, encdec and vlm families are later slices of the port (ROADMAP.md,
'Modules to port'), and raise here.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch import resolve_device, torch_dtype
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.attention import apply_attention, attn_defs
from repro_torch.models.params import ParamDef, init_params, map_defs

_LATER_FAMILIES = {
    "moe": "item 3 (MoE model math)",
    "ssm": "item 8 (other model families)",
    "hybrid": "item 8 (other model families)",
    "encdec": "item 8 (other model families)",
    "vlm": "item 8 (other model families)",
}


def stack_defs(defs: Any, n: int) -> Any:
    """Add a leading "layers" axis to every ParamDef."""
    return map_defs(
        lambda d: ParamDef((n,) + d.shape, d.init, d.scale, d.f32), defs
    )


def layer_params(stacked: Dict, li: int) -> Dict:
    """Layer ``li`` of a stacked params tree (views, no copies)."""
    if isinstance(stacked, torch.Tensor):
        return stacked[li]
    if isinstance(stacked, tuple):
        return tuple(layer_params(v, li) for v in stacked)
    return {k: layer_params(v, li) for k, v in stacked.items()}


def _dense_block(lp, cfg, impl, x, pos, cache, cache_len):
    h = L.apply_norm(lp["ln1"], x)
    a, new_cache = apply_attention(
        lp["attn"], cfg, h, pos,
        impl=impl, causal=True, cache=cache, cache_len=cache_len,
    )
    x = x + a
    h = L.apply_norm(lp["ln2"], x)
    return x + L.apply_mlp(lp["mlp"], h), new_cache


class LM:
    def __init__(self, cfg: ModelConfig, *, attn_impl: str = "naive"):
        family = "moe" if cfg.n_experts else cfg.family
        if cfg.is_encdec:
            family = "encdec"
        if family != "dense":
            raise NotImplementedError(
                f"{cfg.name}: the {family} family is not ported yet "
                f"(ROADMAP.md, 'Modules to port', {_LATER_FAMILIES[family]})"
            )
        self.cfg = cfg
        self.attn_impl = attn_impl
        self.dtype = torch_dtype(cfg.dtype)

    # -- parameter definitions ------------------------------------------------
    def param_defs(self) -> Dict:
        cfg = self.cfg
        layer = {
            "ln1": L.norm_defs(cfg),
            "attn": attn_defs(cfg),
            "ln2": L.norm_defs(cfg),
            "mlp": L.mlp_defs(cfg),
        }
        return {
            "embed": L.embed_defs(cfg),
            "final_ln": L.norm_defs(cfg),
            "layers": stack_defs(layer, cfg.n_layers),
        }

    def init(self, generator: torch.Generator | int = 0, *, device="cuda") -> Dict:
        """Random weights with the reference's init rule, drawn on ``device``
        from ``generator`` (or a fresh one seeded with the given int)."""
        device = resolve_device(device)
        if not isinstance(generator, torch.Generator):
            generator = torch.Generator(device=device).manual_seed(int(generator))
        return init_params(
            self.param_defs(), dtype=self.dtype, generator=generator, device=device
        )

    # -- forward helpers --------------------------------------------------------
    def _embed_inputs(self, params, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        x = L.embed_tokens(params["embed"], batch["tokens"], self.dtype)
        return x, batch["positions"]

    def _run_decoder_stack(self, params, x, pos, caches, cache_len):
        """Layer loop; returns (x, caches) with the caches updated in place."""
        for li in range(self.cfg.n_layers):
            cache = None if caches is None else layer_params(caches, li)
            x, _ = _dense_block(
                layer_params(params["layers"], li), self.cfg, self.attn_impl,
                x, pos, cache, cache_len,
            )
        return x, caches

    # -- public entry points ------------------------------------------------------
    def prefill_logits(self, params, batch) -> torch.Tensor:
        x, pos = self._embed_inputs(params, batch)
        x, _ = self._run_decoder_stack(params, x, pos, None, None)
        x = L.apply_norm(params["final_ln"], x[:, -1:])
        return L.logits_from(params["embed"], x)[:, 0]

    def decode_step(self, params, batch, cache) -> Tuple[torch.Tensor, Any]:
        """One step for every sequence over the cache (split or dense).  The
        cache's K/V tensors are written in place; the returned dict shares
        them and carries the advanced lengths."""
        x, pos = self._embed_inputs(params, batch)
        split = "len_rec" in cache
        cache_len = (cache["len"], cache["len_rec"]) if split else cache["len"]
        x, _ = self._run_decoder_stack(params, x, pos, cache["layers"], cache_len)
        x = L.apply_norm(params["final_ln"], x[:, -1:])
        logits = L.logits_from(params["embed"], x)[:, 0]
        new_cache = dict(cache)
        S = batch["tokens"].shape[1]
        if split:
            new_cache["len_rec"] = cache["len_rec"] + S
        else:
            new_cache["len"] = cache["len"] + S
        return logits, new_cache

    # -- caches ---------------------------------------------------------------------
    def init_cache(
        self, batch_size: int, max_len: int, recent_size: int = 256, *,
        device="cuda",
    ) -> Dict:
        """Split cache: ``main`` (read-only store) and ``recent`` (the ring
        new tokens land in), each ``(L, B, len, KV, hd)``; lengths are ints."""
        cfg = self.cfg
        device = resolve_device(device)
        kv_dt = torch_dtype(cfg.kv_cache_dtype)

        def zeros(length):
            shape = (cfg.n_layers, batch_size, length, cfg.n_kv_heads, cfg.hd)
            return torch.zeros(shape, dtype=kv_dt, device=device)

        return {
            "layers": {
                "main": (zeros(max_len), zeros(max_len)),
                "recent": (zeros(recent_size), zeros(recent_size)),
            },
            "len": 0,
            "len_rec": 0,
        }
