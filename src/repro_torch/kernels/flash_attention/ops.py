"""Flash attention forward: ``softmax(q k^T * scale) v`` of ``(B, Hq, Sq, D)``
queries against ``(B, Hkv, Sk, D)`` keys and values, query head ``h`` on KV
head ``h // (Hq / Hkv)``, causal mask ``qpos >= kpos`` counted from 0.

CPU tensors take :func:`ref.attention_ref`; CUDA tensors launch the
hand-written kernel in ``csrc/flash_attention.cu`` (or raise).  The kernel
reads q, k and v through their strides (D contiguous), so transposed views
cost no copy, and writes an output laid out like q.  Ragged Sq and Sk are
masked in the kernel: the reference's zero-padding to its tiles is a TPU
detail and is not carried over.

Forward only, like the reference (which has no ``custom_vjp``): a call that
autograd would have to differentiate raises instead of returning an output
with no gradient.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref as _ref

__all__ = ["flash_attention"]

_ENTRY = {torch.float32: "flash_attention_f32", torch.bfloat16: "flash_attention_bf16"}

#: the kernel path of the last launch: "mma" (bf16 on tensor cores) or "simt"
last_path = None


def flash_attention(
    q: torch.Tensor,   # (B, Hq, Sq, D)
    k: torch.Tensor,   # (B, Hkv, Sk, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, Hq, Sq, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or Hq % k.shape[1]:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention is forward-only (as in the reference): call it under "
            "torch.no_grad(), or train with attn_impl='chunked'"
        )
    devices = {t.device for t in (q, k, v)}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    scale = (D ** -0.5) if scale is None else scale
    if q.device.type == "cpu":
        return _ref.attention_ref(q, k, v, causal=causal, scale=scale)
    if q.device.type == "cuda":
        return _launch(q, k, v, causal, scale)
    raise ValueError(f"unsupported device {q.device}")


def _launch(q, k, v, causal, scale) -> torch.Tensor:
    global last_path
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _ENTRY:
        raise TypeError(f"kernel takes float32 or bfloat16 for q, k and v alike, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 and t.shape[3] > 1 and t.numel():
            raise ValueError(f"{name} must have its last (head) dim contiguous")
    out = torch.empty_like(q)   # q's layout: a transposed view gives a transposed output
    B, Hq, Sq, D = q.shape
    dims = (ctypes.c_longlong * 6)(B, Hq, k.shape[1], Sq, k.shape[2], D)
    strides = (ctypes.c_longlong * 12)(
        *(t.stride(i) for t in (q, k, v, out) for i in range(3)))
    lib = _build.library("flash_attention")
    fn = getattr(lib, _ENTRY[q.dtype])
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_longlong)] * 2 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dims, strides,
                    float(scale), int(bool(causal)), stream)
    # >= 0: the path that ran; < 0: minus a CUDA error
    _build.check(lib, max(-status, 0), f"flash_attention (q {tuple(q.shape)}, "
                                       f"k {tuple(k.shape)}, {q.dtype})")
    last_path = "mma" if status == 1 else "simt"
    kernels.launches["flash_attention"] += 1
    return out
