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

The kernel takes one of five paths, chosen before it launches by type and
strides alone (:func:`kernel_path`); a path that fails raises, none falls
back to another or to the plain version:

* ``"scalar_tc"``: bfloat16 with q and k shared by every head (stride 0
  over heads) and one decay per head (log_w stride 0 over the state dim),
  Mamba2's call: tensor cores, no factored decay weights.
* ``"vector_tc"``: every other bfloat16 call (RWKV6's): tensor cores.
* ``"scalar_tc_f32"`` and ``"vector_tc_f32"``: the same two forms in
  float32, each product three TF32 products on tensor cores.
* ``"simt"``: float32 views the tensor-core paths' copies cannot read, on
  CUDA cores, element by element.

``last_path`` holds the path of the last launch, and
``kernels.launches["decay_attention:<path>"]`` counts launches by path.

The tensor-core paths copy rows of q, k, v (and of log_w on the vector
forms) in 16-byte pieces, so they take only views whose d is contiguous and
a multiple of 8 (bfloat16) or 4 (float32) elements, whose base is 16-byte
aligned and whose other strides are multiples of 16 bytes (a dimension of
size 1 is exempt).  A bfloat16 view that misses this raises rather than
being copied; a float32 one takes ``simt``.  The model path's views meet
it.

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

__all__ = ["decay_attention", "kernel_path", "MAX_D", "PATHS"]

MAX_D = 64
_ENTRY = {torch.float32: "decay_attention_f32", torch.bfloat16: "decay_attention_bf16"}
#: the kernel paths, by the code the C entry points take
PATHS = ("simt", "scalar_tc", "vector_tc", "scalar_tc_f32", "vector_tc_f32")

#: the kernel path of the last launch
last_path = None


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


def _rows_ok(t: torch.Tensor, align: int) -> bool:
    """d contiguous, the base and every other stride on ``align`` bytes (a
    dimension of size 1 is exempt; stride 0 is a multiple of anything)."""
    item = t.element_size()
    return (t.stride(3) == 1 and t.data_ptr() % align == 0
            and all(t.shape[i] == 1 or (t.stride(i) * item) % align == 0 for i in range(3)))


def kernel_path(q, k, v, log_w) -> str:
    """The kernel path a call on the card takes, decided from type and
    strides alone: ``"scalar_tc"`` (bfloat16) or ``"scalar_tc_f32"``
    (float32) when q and k are stride 0 over heads and log_w stride 0 over
    the state dim, else ``"vector_tc"`` or ``"vector_tc_f32"``; a float32
    view that the 16-byte row copies cannot read takes ``"simt"``.  Raises
    ValueError for such a bfloat16 view."""
    scalar = q.stride(2) == 0 and k.stride(2) == 0 and log_w.stride(3) == 0
    dk, dv = q.shape[3], v.shape[3]
    bad = [name for name, t in (("q", q), ("k", k), ("v", v)) if not _rows_ok(t, 16)]
    if not scalar and not _rows_ok(log_w, 16):
        bad.append("log_w")
    if q.dtype != torch.bfloat16:
        if dk % 4 or dv % 4 or bad:
            return "simt"
        return "scalar_tc_f32" if scalar else "vector_tc_f32"
    if dk % 8 or dv % 8 or bad:
        raise ValueError(
            f"the bfloat16 kernel paths copy rows in 16-byte pieces: they take dk and dv "
            f"multiples of 8 (got {dk}, {dv}) and views with d contiguous, a 16-byte aligned "
            f"base and strides of whole 16 bytes (not so: {', '.join(bad) or 'none'})")
    return "scalar_tc" if scalar else "vector_tc"


def _launch(q, k, v, log_w, bonus, h0, return_state):
    global last_path
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
    path = kernel_path(q, k, v, log_w)
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
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = fn(ptr(q), ptr(k), ptr(v), ptr(log_w), ptr(u), ptr(h0), ptr(out), ptr(hT),
                    dims, strides, int(bonus is not None), PATHS.index(path), stream)
    _build.check(lib, status, f"decay_attention (q {tuple(q.shape)}, v {tuple(v.shape)}, "
                              f"{q.dtype}, {path} path)")
    last_path = path
    kernels.launches["decay_attention"] += 1
    kernels.launches[f"decay_attention:{path}"] += 1
    return (out, hT) if return_state else out
