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
the model path chooses between the two.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decay_attention import ops as decay_ops
from repro_torch.kernels.decay_attention.ref import (  # noqa: F401  (re-exported)
    CHUNK,
    MIN_LOG_DECAY,
    chunked_decay_ref,
    decay_attention_ref,
    decay_attention_step,
)

__all__ = ["MIN_LOG_DECAY", "CHUNK", "chunked_decay_attention", "decay_attention_step",
           "decay_attention_ref", "takes_kernel"]


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
