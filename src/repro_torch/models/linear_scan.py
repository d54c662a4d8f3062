"""Chunked linear attention with per-step decay, shared by RWKV6 (Finch,
per-channel data-dependent decay + bonus) and Mamba2 (SSD, per-head scalar
decay); the reference's ``models/linear_scan.py``.

Recurrence (state S: (dk, dv) per head):

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = q_t . S_t                         (mamba-style, ``bonus=None``)
    y_t = q_t . S_{t-1} + (q_t*u).k_t v_t   (rwkv-style, ``bonus=u``)

The plain float32 math (chunked form, one step, sequential oracle) lives
beside the kernel that replaces the chunked form, in
``kernels/decay_attention/ref.py``; :func:`chunked_decay_attention` is where
the model path chooses between the two.  The blocks reach both forms
through :func:`chunked_on_shards` and :func:`step_on_shards`: under a mesh
they run on each rank's batch and head shards inside ``shard_map`` (every
(batch row, head) is independent, so no collective is needed), and the
decay math sees plain tensors, never DTensors.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.dist import sharding as shd
from repro_torch.kernels.decay_attention import ops as decay_ops
from repro_torch.kernels.decay_attention.ref import (  # noqa: F401  (re-exported)
    CHUNK,
    MIN_LOG_DECAY,
    chunked_decay_ref,
    decay_attention_ref,
    decay_attention_step,
)

__all__ = ["MIN_LOG_DECAY", "CHUNK", "chunked_decay_attention", "decay_attention_step",
           "decay_attention_ref", "takes_kernel", "chunked_on_shards", "step_on_shards"]


def takes_kernel(*tensors: Optional[torch.Tensor]) -> bool:
    """The dispatch rule of :func:`chunked_decay_attention`:

    * CPU tensors take the plain chunked math;
    * CUDA tensors that autograd does not record launch the hand-written
      kernel (``kernels/decay_attention``), which raises if it cannot run:
      this is not a fallback on failure;
    * CUDA tensors under autograd take the plain chunked math: the kernel has
      no backward pass (nor has the reference's), and the reference trains
      these families on the chunked math.
    """
    ts = [t for t in tensors if t is not None]
    if ts[0].device.type != "cuda":
        return False
    return not (torch.is_grad_enabled() and any(t.requires_grad for t in ts))


def chunked_decay_attention(
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
    if takes_kernel(q, k, v, log_w, bonus, initial_state):
        if chunk != CHUNK:
            raise ValueError(f"the decay-attention kernel takes chunk={CHUNK}, not {chunk}")
        return decay_ops.decay_attention(q, k, v, log_w, bonus=bonus,
                                         initial_state=initial_state,
                                         return_state=return_state)
    return chunked_decay_ref(q, k, v, log_w, bonus=bonus, initial_state=initial_state,
                             chunk=chunk, return_state=return_state)


def chunked_on_shards(q, k, v, log_w, *, bonus=None, initial_state=None,
                      chunked=chunked_decay_attention):
    """``chunked(q, k, v, log_w, bonus=, initial_state=, return_state=True)``
    -> (y, final state), the model path's chunked form, on each rank's
    shards under a mesh (:func:`_on_shards`).  q and k (B, S, H, dk), or
    (B, S, dk) where every head shares them (Mamba2's C and B); log_w
    (B, S, H, dk), or (B, S, H) with one decay a head (Mamba2's).  The
    blocks pass ``chunked`` (and the step's ``step``) by the name they
    import, so that a comparison run or a test may replace it there."""
    def run(q, k, v, log_w, bonus, state):
        return chunked(q, k, v, log_w, bonus=bonus, initial_state=state, return_state=True)

    return _on_shards(run, q, k, v, log_w, bonus, initial_state, seq=True)


def step_on_shards(q1, k1, v1, log_w1, state, *, bonus=None, step=decay_attention_step):
    """``step(q1, k1, v1, log_w1, state, bonus=)`` -> (y1, new state), one
    decode step, on each rank's shards under a mesh; the forms of
    :func:`chunked_on_shards` without the sequence dim."""
    def run(q, k, v, log_w, bonus, state):
        return step(q, k, v, log_w, state, bonus=bonus)

    return _on_shards(run, q1, k1, v1, log_w1, bonus, state, seq=False)


def _broadcast(q, k, v, log_w):
    """q and k shared by every head, and one decay a head, as stride-0 views
    over the heads and the state dim (the decay kernel's scalar path reads
    such views once); per-head tensors as they are."""
    if q.dim() < v.dim():
        q = q.unsqueeze(-2).expand(*v.shape[:-1], q.shape[-1])
        k = k.unsqueeze(-2).expand(*v.shape[:-1], k.shape[-1])
    if log_w.dim() < v.dim():
        log_w = log_w.unsqueeze(-1).expand(*log_w.shape, q.shape[-1])
    return q, k, v, log_w


def _on_shards(run, q, k, v, log_w, bonus, state, *, seq: bool):
    """``run(q, k, v, log_w, bonus, state)`` on the broadcast forms
    (:func:`_broadcast`).  Under a mesh inside ``shard_map``: the batch split
    over "batch"'s axes and the heads over "heads"', each where it divides
    them (else whole), so each rank runs the decay on plain tensors of its
    own rows and heads; the shared q and k and the per-head decay are
    broadcast on the rank, so the views keep their stride 0.  The bonus is
    split by heads only: its gradient is summed over the batch's ranks.
    Without a mesh, the plain call."""
    def local(q, k, v, log_w, bonus, state):
        return run(*_broadcast(q, k, v, log_w), bonus, state)

    args = (q, k, v, log_w, bonus, state)
    mesh = shd.region_mesh(*args)
    if mesh is None:
        return local(*args)
    b = shd.filter_spec(shd.logical_spec("batch"), v.shape[:1], mesh)[0]
    h = shd.filter_spec(shd.logical_spec("heads"), v.shape[-2:-1], mesh)[0]
    mid = (None,) if seq else ()
    per_head = shd.P(b, *mid, h, None)
    shared = shd.P(b, *mid, None)
    specs = (per_head if q.dim() == v.dim() else shared,
             per_head if k.dim() == v.dim() else shared,
             per_head,
             per_head if log_w.dim() == v.dim() else shd.P(b, *mid, h),
             shd.P(h, None),
             shd.P(b, h, None, None))
    given = [i for i, a in enumerate(args) if a is not None]

    def on_rank(*ts):
        full = [None] * len(args)
        for i, t in zip(given, ts):
            full[i] = t
        return local(*full)

    return shd.shard_map(on_rank, mesh=mesh, in_specs=tuple(specs[i] for i in given),
                         out_specs=(per_head, specs[-1]))(*(args[i] for i in given))
