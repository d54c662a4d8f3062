"""PUD substrate ops: elementwise bulk ops and RowClone over a block pool.

``pud_zero/copy/not/and/or/xor/maj`` apply Ambit/RowClone-style bulk ops
elementwise to same-size operands and return a new tensor of the first
operand's shape and dtype.  CPU tensors take :func:`ref.bulk_op_ref`; CUDA
tensors launch the hand-written kernel in ``csrc/bulk_op.cu`` (or raise).

``pool_block_copy`` is RowClone over a block pool, ``pool[dst] <- pool[src]``
in place: CPU tensors take :func:`ref.block_copy_ref`; CUDA tensors launch
``csrc/block_copy.cu`` (or raise).  The index lists are checked on the host
before either: in range, destinations unique, and sources disjoint from
destinations (the kernel copies all pairs at once).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.kernels import _build
from repro_torch.kernels.pud_bulk import ref as _ref

__all__ = ["pud_zero", "pud_copy", "pud_not", "pud_and", "pud_or", "pud_xor",
           "pud_maj", "pool_block_copy"]

# op -> (code in csrc/bulk_op.cu, number of operands read)
_BULK_OPS = {"zero": (0, 0), "copy": (1, 1), "not": (2, 1), "and": (3, 2),
             "or": (4, 2), "xor": (5, 2), "maj": (6, 3)}


def _dispatch(op: str, *xs: torch.Tensor) -> torch.Tensor:
    """Check the operands, then run ``op`` on the device they lie on."""
    x0 = xs[0]
    for x in xs[1:]:
        if x.numel() != x0.numel() or x.dtype != x0.dtype or x.device != x0.device:
            raise ValueError(
                f"pud_{op}: operands differ ({x0.numel()} {x0.dtype} on {x0.device} "
                f"vs {x.numel()} {x.dtype} on {x.device})"
            )
    if op not in ("zero", "copy") and x0.dtype != torch.bool and (
            x0.dtype.is_floating_point or x0.dtype.is_complex):
        raise TypeError(f"pud_{op} takes integer or bool tensors, not {x0.dtype}")
    xs = tuple(x.reshape(x0.shape) for x in xs)
    if x0.device.type == "cpu":
        return _ref.bulk_op_ref(*xs, op=op)
    if x0.device.type != "cuda":
        raise ValueError(f"unsupported device {x0.device}")
    code, arity = _BULK_OPS[op]
    ins = [x.contiguous() for x in xs[:arity]]
    out = torch.empty(x0.shape, dtype=x0.dtype, device=x0.device)
    _launch_bulk(code, out, ins, not_mask=0x01 if x0.dtype == torch.bool else 0xFF)
    return out


def _launch_bulk(code: int, out: torch.Tensor, ins, not_mask: int) -> None:
    lib = _build.library("bulk_op")
    fn = lib.bulk_op
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ptrs = [x.data_ptr() for x in ins] + [None] * (3 - len(ins))
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        status = fn(code, out.data_ptr(), *ptrs, out.numel() * out.element_size(),
                    not_mask, stream)
    _build.check(lib, status, "bulk_op")
    kernels.launches["bulk_op"] += 1


def pud_zero(x: torch.Tensor) -> torch.Tensor:
    """RowClone zero-init (shape/dtype donor ``x``)."""
    return _dispatch("zero", x)


def pud_copy(x: torch.Tensor) -> torch.Tensor:
    return _dispatch("copy", x)


def pud_not(x: torch.Tensor) -> torch.Tensor:
    return _dispatch("not", x)


def pud_and(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return _dispatch("and", x, y)


def pud_or(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return _dispatch("or", x, y)


def pud_xor(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return _dispatch("xor", x, y)


def pud_maj(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    return _dispatch("maj", x, y, z)


def _host_indices(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.int64).reshape(-1)


def pool_block_copy(pool: torch.Tensor, src, dst) -> torch.Tensor:
    """Copy block ``src[i]`` onto block ``dst[i]`` of ``pool`` for every i,
    with parallel-copy semantics: every source is read as it was before the
    call, also where it is another pair's destination.

    ``pool``: ``(num_blocks, ...)``, contiguous, any dtype; trailing dims are
    flattened per block.  ``src``/``dst``: host index lists (sequences,
    numpy arrays or tensors).  Writes ``pool`` in place and returns it.  On
    the card, pairs whose sources and destinations overlap run as several
    launches (:func:`copy_waves`), each over disjoint blocks.
    """
    src, dst = _host_indices(src), _host_indices(dst)
    nb = pool.shape[0]
    if src.shape != dst.shape:
        raise ValueError(f"src {src.shape} and dst {dst.shape} differ in length")
    if src.size and (min(src.min(), dst.min()) < 0 or max(src.max(), dst.max()) >= nb):
        raise ValueError(f"block index out of range [0, {nb})")
    if len(np.unique(dst)) != dst.size:
        raise ValueError("destination blocks repeat")
    if not pool.is_contiguous():
        raise ValueError("pool must be contiguous")
    if src.size == 0:
        return pool
    waves = copy_waves(src, dst)   # raises on a cycle, on either device
    flat = pool.view(nb, -1)
    src_dst = torch.from_numpy(np.stack([src, dst], axis=1).astype(np.int32))
    if pool.device.type == "cpu":
        _ref.block_copy_ref(flat, src_dst)
    elif pool.device.type == "cuda":
        for wave in waves:
            _launch(flat, src_dst[wave].to(pool.device, non_blocking=False))
    else:
        raise ValueError(f"unsupported device {pool.device}")
    return pool


def copy_waves(src: np.ndarray, dst: np.ndarray) -> list:
    """Index arrays splitting the pairs into groups to run one after another,
    each group's sources and destinations disjoint, so that copying each
    group in parallel in place keeps the parallel-copy semantics: a pair
    runs only once every other pair that reads its destination has run.
    (Compaction plans can chain a move into a block another move empties.)
    Raises on a cycle of moves, which no group order can do in place."""
    if not np.intersect1d(src, dst).size:
        return [np.arange(src.size)]
    pending, waves = np.arange(src.size), []
    while pending.size:
        s, d = src[pending], dst[pending]
        readers = (d[:, None] == s[None, :]).sum(axis=1) - (s == d)
        ready = readers == 0
        if not ready.any():
            raise ValueError("cyclic block moves cannot be copied in place")
        waves.append(pending[ready])
        pending = pending[~ready]
    return waves


def _launch(flat: torch.Tensor, src_dst: torch.Tensor) -> None:
    lib = _build.library("block_copy")
    fn = lib.block_copy
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    block_bytes = flat.shape[1] * flat.element_size()
    with torch.cuda.device(flat.device):
        stream = torch.cuda.current_stream(flat.device).cuda_stream
        status = fn(flat.data_ptr(), src_dst.data_ptr(), src_dst.shape[0],
                    block_bytes, stream)
    _build.check(lib, status, "block_copy")
    kernels.launches["block_copy"] += 1
