"""AdamW with decoupled weight decay, global-norm clipping, and cosine
schedule.  Params, grads and moments are plain trees (nested dicts of
tensors with the reference's paths); the moments are f32, the update runs
in f32 and is cast back to each param's dtype.  Functional like the
reference: new tensors are returned and the inputs are left as they were;
with ``donate=True`` (the reference's trainer donates its params and
optimizer state to the jitted step) the same arithmetic is written into the
given params and moments instead, a slice at a time, so a step holds no
second copy of the state."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.tree import flatten, leaves, tree_map, unflatten

#: elements of one slice of an in-place (donated) update
DONATE_SLICE = 1 << 24


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    mu: Any
    nu: Any
    step: torch.Tensor      # 0-d int32 on the params' device


def init_opt_state(params: Any) -> OptState:
    """Zero f32 moments laid out as the params (a DTensor param's moments
    are DTensors of its placements); the step counter is a plain 0-d
    tensor."""
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    device = leaves(params)[0].device
    return OptState(
        mu=tree_map(zeros, params),
        nu=tree_map(zeros, params),
        step=torch.zeros((), dtype=torch.int32, device=device),
    )


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0,
    )
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(x.float() ** 2) for x in leaves(tree)))


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def apply_updates(
    params: Any, grads: Any, state: OptState, cfg: AdamWConfig, *, donate: bool = False
) -> Tuple[Any, OptState, dict]:
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()

    def upd(p, g, m, v):
        g = g.float() * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        mh, vh = m / b1c, v / b2c
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    metrics = {"grad_norm": gnorm, "lr": lr}
    if donate:
        # each element's arithmetic is upd's; DTensor leaves share their
        # placements (grads are laid out as the params), so their local
        # shards line up element for element
        scale, lr, b1c, b2c = (_local(x) for x in (scale, lr, b1c, b2c))
        for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.mu),
                              leaves(state.nu), strict=True):
            g = _local(g).reshape(-1)
            p, m, v = (_local(t).view(-1) for t in (p, m, v))
            for a in range(0, p.numel(), DONATE_SLICE):
                s = slice(a, a + DONATE_SLICE)
                new_p, new_m, new_v = upd(p[s], g[s], m[s], v[s])
                m[s].copy_(new_m)
                v[s].copy_(new_v)
                p[s].copy_(new_p)
        return params, OptState(state.mu, state.nu, step), metrics

    flat_p, tdef = flatten(params)
    out = [upd(p, g, m, v) for p, g, m, v in
           zip(flat_p, leaves(grads), leaves(state.mu), leaves(state.nu))]
    new_p = unflatten(tdef, [o[0] for o in out])
    new_m = unflatten(tdef, [o[1] for o in out])
    new_v = unflatten(tdef, [o[2] for o in out])
    return new_p, OptState(new_m, new_v, step), metrics
