"""Paged decode attention: (B, Hq, D) queries against KV pages listed in a
block table.

CPU tensors take :func:`ref.paged_attention_ref`; CUDA tensors launch the
hand-written kernel in ``csrc/paged_attention.cu`` (or raise).  The query
heads of one KV head form a group that shares each loaded page; there is no
padding of the group (the reference pads it to 8 rows only for the TPU).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention import ref as _ref

__all__ = ["paged_attention"]

_ENTRY = {torch.float32: "paged_attention_f32", torch.bfloat16: "paged_attention_bf16"}


def paged_attention(
    q: torch.Tensor,             # (B, Hq, D)
    k_pool: torch.Tensor,        # (num_blocks, block_size, Hkv, D)
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # (B, max_blocks) int, -1 padded
    seq_lens: torch.Tensor,      # (B,) int
    *,
    scale: float | None = None,
) -> torch.Tensor:
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
        out = _ref.paged_attention_ref(
            qg, k_pool, v_pool, block_tables, seq_lens, scale=scale
        )
    elif q.device.type == "cuda":
        out = _launch(qg, k_pool, v_pool, block_tables, seq_lens, scale)
    else:
        raise ValueError(f"unsupported device {q.device}")
    return out.reshape(B, Hq, D)


def _launch(q, k_pool, v_pool, block_tables, seq_lens, scale) -> torch.Tensor:
    B, Hkv, group, D = q.shape
    nb, bs, hkv_pool, d_pool = k_pool.shape
    if v_pool.shape != k_pool.shape or (hkv_pool, d_pool) != (Hkv, D):
        raise ValueError(f"pool shapes {tuple(k_pool.shape)} / {tuple(v_pool.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if not (q.dtype == k_pool.dtype == v_pool.dtype) or q.dtype not in _ENTRY:
        raise TypeError(
            f"kernel takes float32 or bfloat16 for q and both pools alike, got "
            f"{q.dtype}/{k_pool.dtype}/{v_pool.dtype} (fp8 pages: ROADMAP.md)"
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
        return out
    lib = _build.library("paged_attention")
    fn = getattr(lib, _ENTRY[q.dtype])
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = fn(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tbl.data_ptr(),
            lens.data_ptr(), out.data_ptr(),
            B, Hkv, group, D, bs, tbl.shape[1], nb, float(scale), stream,
        )
    # the source decides tile and shared-memory sizes; shapes it cannot take
    # come back as "invalid argument"
    _build.check(lib, status, f"paged_attention (group={group}, D={D}, block_size={bs}, "
                              f"{q.dtype})")
    kernels.launches["paged_attention"] += 1
    return out
