"""Plain PyTorch version of the decay-attention kernel: the linear-scan math
of the reference's ``models/linear_scan.py``, ported as plain float32 torch.

Recurrence per (batch, head), state S (dk, dv):

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = q_t . S_t                          (mamba-style, ``bonus=None``)
    y_t = q_t . S_{t-1} + (q_t*u).k_t v_t    (rwkv-style, ``bonus=u``)

* :func:`chunked_decay_ref` — the chunk-parallel form over 32-token chunks,
  what the kernel computes (``kernels/decay_attention/kernel.py`` on a TPU);
  the model path runs it on the CPU and under autograd.
* :func:`decay_attention_step` — one step (the decode path).
* :func:`decay_attention_ref` — the sequential oracle, a loop of steps.

Numerics: pairwise weights exp(cum_i - cum_j) are computed factored
(q*exp(cum)) . (k*exp(-cum)); with the per-step log-decay clipped to
``MIN_LOG_DECAY`` and 32-token chunks, |cum| <= 57.6, so both factors stay
inside float32 range while every unmasked product is <= 1.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["MIN_LOG_DECAY", "CHUNK", "chunked_decay_ref", "decay_attention_step",
           "decay_attention_ref"]

MIN_LOG_DECAY = -1.8
CHUNK = 32


def chunked_decay_ref(
    q: torch.Tensor,          # (B, S, H, dk)
    k: torch.Tensor,          # (B, S, H, dk)
    v: torch.Tensor,          # (B, S, H, dv)
    log_w: torch.Tensor,      # (B, S, H, dk) per-step log decay (<= 0)
    *,
    bonus: Optional[torch.Tensor] = None,          # (H, dk) rwkv "u"
    initial_state: Optional[torch.Tensor] = None,  # (B, H, dk, dv)
    chunk: int = CHUNK,
    return_state: bool = False,
):
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    pad = (-S) % chunk
    nc = (S + pad) // chunk
    f32 = torch.float32

    def chunks(x: torch.Tensor) -> torch.Tensor:
        """(B, S, H, d) -> (nc, B, chunk, H, d) in f32, zero-padded."""
        x = x.to(f32)
        if pad:
            x = F.pad(x, (0, 0, 0, 0, 0, pad))
        return x.reshape(B, nc, chunk, H, x.shape[-1]).transpose(0, 1)

    qc, kc, vc = chunks(q), chunks(k), chunks(v)
    lw = chunks(log_w.to(f32).clamp(MIN_LOG_DECAY, 0.0))

    idx = torch.arange(chunk, device=q.device)
    i_idx, j_idx = idx[:, None], idx[None, :]
    mask = (j_idx <= i_idx) if bonus is None else (j_idx < i_idx)

    state = (initial_state.to(f32) if initial_state is not None
             else torch.zeros((B, H, dk, dv), dtype=f32, device=q.device))
    ys = []
    for c in range(nc):
        qb, kb, vb, lwb = qc[c], kc[c], vc[c], lw[c]      # (B, Q, H, dk/dv)
        cum = lwb.cumsum(1)                                # inclusive
        ecum = cum - lwb                                   # exclusive
        total = cum[:, -1]                                 # (B, H, dk)

        qs = qb * torch.exp(cum if bonus is None else ecum)
        ks = kb * torch.exp(-cum)
        A = torch.einsum("bihk,bjhk->bhij", qs, ks)
        A = torch.where(mask, A, 0.0)
        y = torch.einsum("bhij,bjhv->bihv", A, vb)
        if bonus is not None:
            diag = ((qb * bonus.to(f32)[None, None]) * kb).sum(-1)   # (B, Q, H)
            y = y + diag[..., None] * vb
        y = y + torch.einsum("bihk,bhkv->bihv", qs, state)

        ks_end = kb * torch.exp(total[:, None] - cum)      # <= 1
        state = state * torch.exp(total)[..., None] + torch.einsum(
            "bihk,bihv->bhkv", ks_end, vb)
        ys.append(y)
    if ys:
        y = torch.stack(ys, 1).reshape(B, nc * chunk, H, dv)[:, :S]
    else:
        y = torch.zeros((B, 0, H, dv), dtype=f32, device=q.device)
    y = y.to(q.dtype)
    if return_state:
        return y, state
    return y


def decay_attention_step(
    q1: torch.Tensor,         # (B, H, dk)
    k1: torch.Tensor,
    v1: torch.Tensor,         # (B, H, dv)
    log_w1: torch.Tensor,     # (B, H, dk)
    state: torch.Tensor,      # (B, H, dk, dv)
    *,
    bonus: Optional[torch.Tensor] = None,
):
    """Single decode step of the same recurrence (serve path, O(1) memory)."""
    f32 = torch.float32
    qf, kf, vf = q1.to(f32), k1.to(f32), v1.to(f32)
    w = torch.exp(log_w1.to(f32).clamp(MIN_LOG_DECAY, 0.0))
    kv = torch.einsum("bhk,bhv->bhkv", kf, vf)
    new_state = state * w[..., None] + kv
    if bonus is None:
        y = torch.einsum("bhk,bhkv->bhv", qf, new_state)
    else:
        y = torch.einsum("bhk,bhkv->bhv", qf, state) + (
            (qf * bonus[None]) * kf).sum(-1)[..., None] * vf
    return y.to(q1.dtype), new_state


def decay_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_w: torch.Tensor,
    *, bonus: Optional[torch.Tensor] = None,
    initial_state: Optional[torch.Tensor] = None,
    return_state: bool = False,
):
    """Sequential oracle (a loop of :func:`decay_attention_step` over time)."""
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    state = (initial_state.to(torch.float32) if initial_state is not None
             else torch.zeros((B, H, dk, dv), dtype=torch.float32, device=q.device))
    ys = []
    for t in range(S):
        y, state = decay_attention_step(q[:, t], k[:, t], v[:, t], log_w[:, t], state,
                                        bonus=bonus)
        ys.append(y)
    y = torch.stack(ys, 1) if ys else torch.zeros((B, 0, H, dv), dtype=q.dtype,
                                                  device=q.device)
    if return_state:
        return y, state
    return y
