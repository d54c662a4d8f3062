"""Chunked decay linear attention: ``linear_scan.chunked_decay_attention``'s
function over ``(B, S, H, d)`` tensors, with the optional initial state and
final state of the model path.

CPU tensors take :func:`ref.chunked_decay_ref`; CUDA tensors launch the
hand-written kernel in ``csrc/decay_attention.cu`` (or raise).  The kernel
reads q, k, v and log_w through their strides, stride 0 included (Mamba2
broadcasts C and B over heads and the decay over the state dim), and masks a
ragged S itself: the TPU wrapper's padding of S and d is not carried over.
It takes q, k and v in float32 or bfloat16 alike, log_w, the bonus u and the
initial state in float32, dk and dv up to :data:`MAX_D`; the output is in q's
type, the final state in float32.  With ``initial_state=None`` and the state
thrown away it is the reference's ``kernels/decay_attention/ops.py:
decay_attention`` (which rounds u to q's type first; the model path keeps u
in float32, and so does this).

Forward only, like the reference (its kernel has no ``custom_vjp``): a call
that autograd would have to differentiate raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch import kernels
from repro_torch.kernels import _build
from repro_torch.kernels.decay_attention import ref as _ref

__all__ = ["decay_attention", "MAX_D"]

MAX_D = 64
_ENTRY = {torch.float32: "decay_attention_f32", torch.bfloat16: "decay_attention_bf16"}


def decay_attention(
    q: torch.Tensor,          # (B, S, H, dk)
    k: torch.Tensor,          # (B, S, H, dk)
    v: torch.Tensor,          # (B, S, H, dv)
    log_w: torch.Tensor,      # (B, S, H, dk)
    *,
    bonus: Optional[torch.Tensor] = None,          # (H, dk): the rwkv variant
    initial_state: Optional[torch.Tensor] = None,  # (B, H, dk, dv)
    return_state: bool = False,
):
    if q.dim() != 4 or k.shape != q.shape or log_w.shape != q.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"log_w {tuple(log_w.shape)}")
    B, S, H, dk = q.shape
    if v.dim() != 4 or v.shape[:3] != q.shape[:3]:
        raise ValueError(f"v {tuple(v.shape)} does not match q {tuple(q.shape)}")
    dv = v.shape[3]
    if bonus is not None and bonus.shape != (H, dk):
        raise ValueError(f"bonus {tuple(bonus.shape)} is not (H, dk) = {(H, dk)}")
    if initial_state is not None and initial_state.shape != (B, H, dk, dv):
        raise ValueError(f"initial_state {tuple(initial_state.shape)} is not "
                         f"(B, H, dk, dv) = {(B, H, dk, dv)}")
    tensors = [t for t in (q, k, v, log_w, bonus, initial_state) if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "decay_attention is forward-only (as in the reference): call it under "
            "torch.no_grad(), or use the plain chunked form for training")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    if q.device.type == "cpu":
        return _ref.chunked_decay_ref(q, k, v, log_w, bonus=bonus,
                                      initial_state=initial_state, return_state=return_state)
    if q.device.type == "cuda":
        return _launch(q, k, v, log_w, bonus, initial_state, return_state)
    raise ValueError(f"unsupported device {q.device}")


def _launch(q, k, v, log_w, bonus, h0, return_state):
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _ENTRY:
        raise TypeError(f"kernel takes float32 or bfloat16 for q, k and v alike, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    for name, t in (("log_w", log_w), ("bonus", bonus), ("initial_state", h0)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"kernel takes {name} in float32, got {t.dtype}")
    B, S, H, dk = q.shape
    dv = v.shape[3]
    if dk > MAX_D or dv > MAX_D or dk < 1 or dv < 1:
        raise ValueError(f"kernel takes dk and dv in 1..{MAX_D}, got dk {dk}, dv {dv}")
    if B > 65535:
        raise ValueError(f"kernel takes at most 65535 sequences, got {B}")
    out = torch.empty((B, S, H, dv), dtype=q.dtype, device=q.device)
    hT = (torch.empty((B, H, dk, dv), dtype=torch.float32, device=q.device)
          if return_state else None)
    u = bonus.contiguous() if bonus is not None else None
    h0 = h0.contiguous() if h0 is not None else None
    dims = (ctypes.c_longlong * 5)(B, S, H, dk, dv)
    strides = (ctypes.c_longlong * 20)(
        *(t.stride(i) for t in (q, k, v, log_w, out) for i in range(4)))
    lib = _build.library("decay_attention")
    fn = getattr(lib, _ENTRY[q.dtype])
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.POINTER(ctypes.c_longlong)] * 2 + [
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = fn(ptr(q), ptr(k), ptr(v), ptr(log_w), ptr(u), ptr(h0), ptr(out), ptr(hT),
                    dims, strides, int(bonus is not None), stream)
    _build.check(lib, status, f"decay_attention (q {tuple(q.shape)}, v {tuple(v.shape)}, "
                              f"{q.dtype})")
    kernels.launches["decay_attention"] += 1
    return (out, hT) if return_state else out
