"""RowClone over a block pool: ``pool[dst] <- pool[src]``, in place.

CPU tensors take :func:`ref.block_copy_ref`; CUDA tensors launch the
hand-written kernel in ``csrc/block_copy.cu`` (or raise).  The index lists
are checked on the host before either: in range, destinations unique, and
sources disjoint from destinations (the kernel copies all pairs at once).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.kernels import _build
from repro_torch.kernels.pud_bulk import ref as _ref

__all__ = ["pool_block_copy"]


def _host_indices(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.int64).reshape(-1)


def pool_block_copy(pool: torch.Tensor, src, dst) -> torch.Tensor:
    """Copy block ``src[i]`` onto block ``dst[i]`` of ``pool`` for every i.

    ``pool``: ``(num_blocks, ...)``, contiguous, any dtype; trailing dims are
    flattened per block.  ``src``/``dst``: host index lists (sequences,
    numpy arrays or tensors).  Writes ``pool`` in place and returns it.
    """
    src, dst = _host_indices(src), _host_indices(dst)
    nb = pool.shape[0]
    if src.shape != dst.shape:
        raise ValueError(f"src {src.shape} and dst {dst.shape} differ in length")
    if src.size and (min(src.min(), dst.min()) < 0 or max(src.max(), dst.max()) >= nb):
        raise ValueError(f"block index out of range [0, {nb})")
    if len(np.unique(dst)) != dst.size:
        raise ValueError("destination blocks repeat")
    if np.intersect1d(src, dst).size:
        raise ValueError("source and destination blocks overlap")
    if not pool.is_contiguous():
        raise ValueError("pool must be contiguous")
    if src.size == 0:
        return pool
    flat = pool.view(nb, -1)
    src_dst = torch.from_numpy(np.stack([src, dst], axis=1).astype(np.int32))
    if pool.device.type == "cpu":
        _ref.block_copy_ref(flat, src_dst)
    elif pool.device.type == "cuda":
        _launch(flat, src_dst.to(pool.device, non_blocking=False))
    else:
        raise ValueError(f"unsupported device {pool.device}")
    return pool


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
