"""Mixture-of-Experts block (granite-MoE style: top-k routed SwiGLU experts).

The reference's single-device path: every token's top-k slots are routed
into one global ``(E, C, d)`` capacity buffer, the experts run as three
batched products over it, and each token gathers its k outputs back and
sums them by gate.  Slots past an expert's capacity ``C`` are dropped (they
scatter into a spare row that is discarded, and gather zeros).  The
reference's ``shard_map`` path (expert-TP over a mesh) is not ported: the
port has no mesh.

Three points keep the routing equal to the reference's, and the step free
of host syncs so it can be captured as a CUDA graph:

* ties: ``jax.lax.top_k`` puts the lower expert first, and ``jnp.argsort``
  is stable; ``torch.topk`` and an unstable ``torch.sort`` promise neither,
  so top-k is a stable descending sort and every argsort is stable;
* no data-dependent shapes: the capacity comes from the static shape, and
  counts and the dispatch are index-adds into fixed-size zeros (no
  ``bincount``, ``nonzero`` or boolean-mask indexing);
* the scatter is exact: every kept slot has a buffer row of its own, so
  adding it into zeros copies it bit for bit, whatever order atomic adds
  take; only the discarded drop row receives several.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import ParamDef

__all__ = ["moe_defs", "capacity", "apply_moe"]


def moe_defs(cfg: ModelConfig) -> Dict:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": ParamDef((d, E)),
        "wg": ParamDef((E, d, f)),
        "wu": ParamDef((E, d, f)),
        "wo": ParamDef((E, f, d)),
    }


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots each expert takes for ``n_tokens`` routed tokens (Python ints)."""
    return max(8, int(cfg.moe_capacity_factor * n_tokens * cfg.experts_per_tok
                      / cfg.n_experts))


def _positions_in_expert(flat_e: torch.Tensor, E: int) -> torch.Tensor:
    """pos[i] = rank of slot i among the slots routed to the same expert, in
    slot order: the double argsort (stable, as ``jnp.argsort``) gives each
    slot's rank in expert-sorted order, less the expert's first rank."""
    order = torch.argsort(flat_e, stable=True)          # slots sorted by expert
    rank = torch.argsort(order, stable=True)            # rank of each slot
    sorted_e = flat_e[order]
    experts = torch.arange(E, dtype=flat_e.dtype, device=flat_e.device)
    first_rank = torch.searchsorted(sorted_e, experts, side="left")
    return rank - first_rank[flat_e]


def _route(xt: torch.Tensor, router: torch.Tensor, cfg: ModelConfig):
    """Router probabilities (T, E) f32, normalised gates and expert ids
    (T, K), and each slot's buffer row ``dst`` (T, K): ``e * C + pos`` if
    kept, ``E * C`` (the drop row) if over capacity ``C``."""
    T = xt.shape[0]
    E, K = cfg.n_experts, cfg.experts_per_tok
    C = capacity(cfg, T)
    logits = xt @ router.to(xt.dtype)
    probs = torch.softmax(logits.float(), dim=-1)                      # (T, E)
    # top-k with jax.lax.top_k's order: descending, the lower index first on ties
    gate, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eidx = gate[:, :K], eidx[:, :K]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    pos = _positions_in_expert(eidx.reshape(-1), E).reshape(T, K)
    dst = torch.where(pos < C, eidx * C + pos, E * C)
    return probs, gate, eidx, dst


def _dispatch(xt: torch.Tensor, dst: torch.Tensor, E: int, C: int) -> torch.Tensor:
    """One scatter of all T*K slots into the (E, C, d) capacity buffer (the
    drop row, last, is discarded)."""
    T, d = xt.shape
    K = dst.shape[1]
    upd = xt[:, None, :].expand(T, K, d).reshape(T * K, d)
    buf = torch.zeros(E * C + 1, d, dtype=xt.dtype, device=xt.device).index_add(
        0, dst.reshape(-1), upd)
    return buf[: E * C].reshape(E, C, d)


def _experts(buf: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
             wo: torch.Tensor) -> torch.Tensor:
    """Every expert's SwiGLU over its C slots: (E, C, d) -> (E, C, d)."""
    g = torch.bmm(buf, wg.to(buf.dtype))
    u = torch.bmm(buf, wu.to(buf.dtype))
    return torch.bmm(F.silu(g) * u, wo.to(buf.dtype))


def _combine(eo: torch.Tensor, dst: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """One gather of (T*K, d) from the expert outputs with a zero row
    appended (dropped slots), reduced over K by gate in the outputs' dtype."""
    E, C, d = eo.shape
    T, K = dst.shape
    eo_flat = torch.cat([eo.reshape(E * C, d), eo.new_zeros(1, d)])
    picked = eo_flat[dst.reshape(-1)].reshape(T, K, d)
    return torch.einsum("tkd,tk->td", picked, gate.to(eo.dtype))


def _moe_math(
    xt: torch.Tensor,         # (T, d)
    router: torch.Tensor,     # (d, E)
    wg: torch.Tensor,         # (E, d, f)
    wu: torch.Tensor,
    wo: torch.Tensor,         # (E, f, d)
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route, dispatch and run the experts for T tokens: (out (T, d), aux)."""
    T = xt.shape[0]
    E, K = cfg.n_experts, cfg.experts_per_tok
    probs, gate, eidx, dst = _route(xt, router, cfg)

    # Switch-style load-balance aux loss
    me = probs.mean(0)
    ones = torch.ones(T * K, dtype=torch.float32, device=xt.device)
    ce = torch.zeros(E, dtype=torch.float32, device=xt.device).index_add(
        0, eidx.reshape(-1), ones) / (T * K)
    aux = E * torch.sum(me * ce)

    buf = _dispatch(xt, dst, E, capacity(cfg, T))
    out = _combine(_experts(buf, wg, wu, wo), dst, gate)
    return out, aux


def apply_moe(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux loss, f32 scalar)."""
    B, S, d = x.shape
    out, aux = _moe_math(x.reshape(B * S, d), p["router"], p["wg"], p["wu"], p["wo"], cfg)
    return out.reshape(B, S, d), aux
