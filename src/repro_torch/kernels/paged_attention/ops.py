"""Paged decode attention: (B, Hq, D) queries against KV pages listed in a
block table.

CPU tensors take :func:`ref.paged_attention_ref`; CUDA tensors launch the
hand-written kernel in ``csrc/paged_attention.cu`` (or raise).  The query
heads of one KV head form a group that shares each loaded page; there is no
padding of the group (the reference pads it to 8 rows only for the TPU).
Pages are q's type, or float8 e4m3 (``kv_cache_dtype="float8_e4m3fn"``),
widened to f32 in the kernel; the output is in q's type.  With
``return_lse`` the call also returns the f32 log-sum-exp of each query
head's scaled, masked scores, (B, Hkv, group), -inf for a length-0 row.

On the card one call makes two CUDA launches (the split kernel, then the
combine) and counts one in ``kernels.launches["paged_attention"]``.  It reads
neither ``seq_lens`` nor the table on the host, so it can be captured in a
CUDA graph.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import kernels
from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention import ref as _ref

__all__ = ["paged_attention", "split_tokens"]

# (q dtype, page dtype) -> C entry point
_ENTRY = {
    (torch.float32, torch.float32): "paged_attention_f32",
    (torch.bfloat16, torch.bfloat16): "paged_attention_bf16",
    (torch.float32, torch.float8_e4m3fn): "paged_attention_f32_fp8",
    (torch.bfloat16, torch.float8_e4m3fn): "paged_attention_bf16_fp8",
}


def paged_attention(
    q: torch.Tensor,             # (B, Hq, D)
    k_pool: torch.Tensor,        # (num_blocks, block_size, Hkv, D)
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # (B, max_blocks) int, -1 padded
    seq_lens: torch.Tensor,      # (B,) int
    *,
    scale: float | None = None,
    return_lse: bool = False,
):
    """Returns out (B, Hq, D), and with ``return_lse`` also the LSE
    (B, Hkv, group)."""
    B, Hq, D = q.shape
    Hkv = k_pool.shape[2]
    if Hq % Hkv:
        raise ValueError(f"{Hq} query heads are not a multiple of {Hkv} KV heads")
    group = Hq // Hkv
    scale = (D ** -0.5) if scale is None else scale
    qg = q.reshape(B, Hkv, group, D)
    devices = {t.device for t in (q, k_pool, v_pool, block_tables, seq_lens)}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    if q.device.type == "cpu":
        out, lse = _ref.paged_attention_ref(
            qg, k_pool, v_pool, block_tables, seq_lens, scale=scale, return_lse=True
        )
    elif q.device.type == "cuda":
        out, lse = _launch(qg, k_pool, v_pool, block_tables, seq_lens, scale)
    else:
        raise ValueError(f"unsupported device {q.device}")
    out = out.reshape(B, Hq, D)
    return (out, lse) if return_lse else out


@functools.cache
def split_tokens(block_size: int) -> int:
    """Tokens one block of the kernel takes at this page size (whole pages);
    the kernel builds on first use, so this needs ``nvcc``."""
    fn = _build.library("paged_attention").paged_attention_split_tokens
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return fn(block_size)


# The C entry points' signatures and the workspace sizes are set up once:
# a decode step makes one call a layer, and the call's host time is most of
# its cost there.
@functools.cache
def _entry(name: str):
    fn = getattr(_build.library("paged_attention"), name)
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=1024)
def _workspace_floats(B, Hkv, group, D, bs, max_blocks) -> int:
    """f32 floats of the split kernel's partials, (m, l, acc[D]) per
    (b, h, g) and split."""
    fn = _build.library("paged_attention").paged_attention_workspace_floats
    fn.argtypes, fn.restype = [ctypes.c_int] * 6, ctypes.c_longlong
    return fn(B, Hkv, group, D, bs, max_blocks)


def _launch(q, k_pool, v_pool, block_tables, seq_lens, scale):
    """The kernel on (B, Hkv, group, D) queries: (out, lse)."""
    B, Hkv, group, D = q.shape
    nb, bs, hkv_pool, d_pool = k_pool.shape
    if v_pool.shape != k_pool.shape or (hkv_pool, d_pool) != (Hkv, D):
        raise ValueError(f"pool shapes {tuple(k_pool.shape)} / {tuple(v_pool.shape)} "
                         f"do not match q {tuple(q.shape)}")
    entry = _ENTRY.get((q.dtype, k_pool.dtype))
    if k_pool.dtype != v_pool.dtype or entry is None:
        raise TypeError(
            f"kernel takes q in float32 or bfloat16 with both pools in q's type or "
            f"float8_e4m3fn, got {q.dtype}/{k_pool.dtype}/{v_pool.dtype}"
        )
    if block_tables.dim() != 2 or block_tables.shape[0] != B or seq_lens.shape != (B,):
        raise ValueError(f"block table {tuple(block_tables.shape)} / lens "
                         f"{tuple(seq_lens.shape)} do not match batch {B}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary "
                             f"(the kernel loads 16 bytes at a time)")
    tbl = block_tables.to(torch.int32).contiguous()
    lens = seq_lens.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if B == 0:
        return out, torch.empty(B, Hkv, group, dtype=torch.float32, device=q.device)
    # one allocation: the LSE, then the workspace (the LSE keeps it alive)
    n_lse = B * Hkv * group
    buf = torch.empty(n_lse + _workspace_floats(B, Hkv, group, D, bs, tbl.shape[1]),
                      dtype=torch.float32, device=q.device)
    lse = buf[:n_lse].view(B, Hkv, group)
    lib = _build.library("paged_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = _entry(entry)(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tbl.data_ptr(),
            lens.data_ptr(), out.data_ptr(), buf.data_ptr(),
            B, Hkv, group, D, bs, tbl.shape[1], nb, float(scale), stream,
        )
    # the source decides the split and the instance; shapes it cannot take
    # come back as "invalid argument"
    _build.check(lib, status, f"paged_attention (group={group}, D={D}, block_size={bs}, "
                              f"{q.dtype}, pages {k_pool.dtype})")
    kernels.launches["paged_attention"] += 1
    return out, lse
