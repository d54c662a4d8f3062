"""Paged KV-cache pool with PUMA placement — the serving-side integration.

One pool holds the KV blocks of *all* live requests for *all* layers:

  K pool: (n_layers, num_blocks, block_size, kv_heads, head_dim)
  V pool: same

A request's logical KV stream is a :class:`~repro_torch.core.arena.TileHandle`
(one tile = one block).  Placement uses PUMA policy: the first request block
goes worst-fit, subsequent blocks of the same request go ``extend`` (same
arena, adjacent slot when possible), and a fork is ``alloc_align``-ed
against its parent so block *k* of both lives in the same arena.

K and V are torch tensors on the pool's device, written in place; the host
keeps the bookkeeping and hands the kernels a numpy int32 *block table*
(max_seqs, max_blocks) and ``seq_lens``.  PUMA placement keeps consecutive
table entries contiguous, so a sequence's pages stream from adjacent memory.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device, torch_dtype
from repro_torch.core.arena import TileHandle, TilePool
from repro_torch.kernels.pud_bulk.ops import pool_block_copy

if TYPE_CHECKING:
    from repro_torch.robustness.faults import FaultInjector

__all__ = ["KVPoolConfig", "PagedKVPool"]


@dataclasses.dataclass(frozen=True)
class KVPoolConfig:
    num_blocks: int = 1024
    block_size: int = 16            # tokens per block
    kv_heads: int = 8
    head_dim: int = 128
    n_layers: int = 1               # layers sharing this pool object
    max_seqs: int = 64
    max_blocks_per_seq: int = 256
    blocks_per_arena: int = 64      # "subarray" capacity
    n_channels: int = 1             # memory channels the arenas stripe over
    policy: str = "puma"
    dtype: str = "bfloat16"

    @property
    def n_arenas(self) -> int:
        assert self.num_blocks % self.blocks_per_arena == 0
        return self.num_blocks // self.blocks_per_arena

    def __post_init__(self):
        n_arenas = self.num_blocks // self.blocks_per_arena
        if self.n_channels < 1 or n_arenas % self.n_channels:
            raise ValueError(
                f"n_channels={self.n_channels} must divide "
                f"n_arenas={n_arenas} (num_blocks/blocks_per_arena)"
            )


class PagedKVPool:
    """Host bookkeeping + device buffers for paged KV serving."""

    def __init__(
        self,
        cfg: KVPoolConfig,
        injector: Optional["FaultInjector"] = None,
        *,
        device="cuda",
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.pool = TilePool(
            cfg.n_arenas, cfg.blocks_per_arena, cfg.policy,
            n_channels=cfg.n_channels, injector=injector,
        )
        dt = torch_dtype(cfg.dtype)
        shape = (cfg.n_layers, cfg.num_blocks, cfg.block_size, cfg.kv_heads, cfg.head_dim)
        self.k = torch.zeros(shape, dtype=dt, device=self.device)
        self.v = torch.zeros(shape, dtype=dt, device=self.device)
        # seq slot -> (k_handle, token_count)
        self._seqs: Dict[int, Tuple[TileHandle, int]] = {}
        self._free_slots = list(range(cfg.max_seqs))
        #: trace recorder; the serving engine wires it in — None = no tracing.
        self.trace = None

    # -- capacity reasoning (admission control) -------------------------------
    def blocks_for(self, n_tokens: int) -> int:
        """KV blocks needed to hold ``n_tokens`` tokens."""
        return -(-n_tokens // self.cfg.block_size)

    @property
    def capacity_blocks(self) -> int:
        """Hard per-sequence block ceiling: a request needing more than this
        can *never* be admitted, regardless of pool state."""
        return min(self.cfg.num_blocks, self.cfg.max_blocks_per_seq)

    # -- request lifecycle ----------------------------------------------------
    def admit(self, n_prompt_tokens: int) -> Optional[int]:
        """Admit a request; allocate blocks for its prompt. Returns seq slot."""
        if not self._free_slots:
            return None
        blocks = -(-n_prompt_tokens // self.cfg.block_size)
        h = self.pool.alloc(blocks)
        if h is None:
            return None
        slot = self._free_slots.pop(0)
        self._seqs[slot] = (h, n_prompt_tokens)
        if self.trace is not None:
            self.trace.on_admit(slot, h.tiles, alloc=self.cfg.policy)
        return slot

    def fork(self, slot: int, copy_data: bool = True) -> Optional[int]:
        """Beam/prefix fork: new sequence whose blocks are PUMA-aligned to
        the parent's, with the KV pages cloned in-pool — the RowClone
        analogue (``pool_block_copy``, in place on a view of the pool; PUMA
        placement keeps source and destination in the same arena)."""
        if slot not in self._seqs or not self._free_slots:
            return None
        parent, ntok = self._seqs[slot]
        h = self.pool.alloc_align(len(parent.tiles), parent)
        if h is None:
            return None
        if copy_data and parent.tiles:
            src = np.asarray(parent.tiles, np.int64)
            dst = np.asarray(h.tiles, np.int64)
            L = self.cfg.n_layers
            nb = self.cfg.num_blocks
            # fold the layer dim into the block index so one kernel call
            # clones every layer's pages
            offs = (np.arange(L, dtype=np.int64) * nb)[:, None]
            src_all = (src[None, :] + offs).reshape(-1)
            dst_all = (dst[None, :] + offs).reshape(-1)
            pool_block_copy(self.k.view((L * nb,) + self.k.shape[2:]), src_all, dst_all)
            pool_block_copy(self.v.view((L * nb,) + self.v.shape[2:]), src_all, dst_all)
        new_slot = self._free_slots.pop(0)
        self._seqs[new_slot] = (h, ntok)
        return new_slot

    def append_token(self, slot: int) -> bool:
        """Decode step bookkeeping: extend by a block when the current one fills."""
        h, ntok = self._seqs[slot]
        ntok += 1
        if ntok > len(h.tiles) * self.cfg.block_size:
            if not self.pool.extend(h, 1):
                return False
            if self.trace is not None:
                contig = len(h.tiles) < 2 or h.tiles[-1] == h.tiles[-2] + 1
                self.trace.on_extend(slot, h.tiles[-1], contig)
        self._seqs[slot] = (h, ntok)
        return True

    def release(self, slot: int) -> None:
        h, _ = self._seqs.pop(slot)
        self.pool.free(h)
        if self.trace is not None:
            self.trace.on_release(slot)
        self._free_slots.append(slot)

    # -- trace helpers -----------------------------------------------------------
    def tiles_of(self, slot: int) -> List[int]:
        """Current tile list of a live sequence (trace emission)."""
        return list(self._seqs[slot][0].tiles)

    def block_of_token(self, slot: int) -> int:
        """Pool block holding the sequence's latest token — the block a
        decode-step ``write_token_kv`` just landed in."""
        h, ntok = self._seqs[slot]
        return h.tiles[(ntok - 1) // self.cfg.block_size]

    # -- device views -----------------------------------------------------------
    def block_table(self) -> np.ndarray:
        """(max_seqs, max_blocks) int32, -1 padded."""
        cfg = self.cfg
        tbl = np.full((cfg.max_seqs, cfg.max_blocks_per_seq), -1, np.int32)
        for slot, (h, _) in self._seqs.items():
            n = min(len(h.tiles), cfg.max_blocks_per_seq)
            tbl[slot, :n] = h.tiles[:n]
        return tbl

    def seq_lens(self) -> np.ndarray:
        out = np.zeros((self.cfg.max_seqs,), np.int32)
        for slot, (_, ntok) in self._seqs.items():
            out[slot] = ntok
        return out

    def write_prompt_kv(
        self, slot: int, layer: int, k: torch.Tensor, v: torch.Tensor
    ) -> None:
        """Scatter a prompt's K/V (n_tokens, kv_heads, head_dim) into the
        sequence's blocks, in place; the tail of the last block is zeroed."""
        cfg = self.cfg
        h, _ = self._seqs[slot]
        n = k.shape[0]
        pad = len(h.tiles) * cfg.block_size - n
        if pad:
            k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
            v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kb = k.reshape(len(h.tiles), cfg.block_size, cfg.kv_heads, cfg.head_dim)
        vb = v.reshape(len(h.tiles), cfg.block_size, cfg.kv_heads, cfg.head_dim)
        idx = torch.tensor(h.tiles, dtype=torch.long, device=self.device)
        self.k[layer].index_copy_(0, idx, kb.to(self.k.dtype))
        self.v[layer].index_copy_(0, idx, vb.to(self.v.dtype))

    def write_token_kv(
        self, slot: int, layer: int, k1: torch.Tensor, v1: torch.Tensor
    ) -> None:
        """Write one decoded token's K/V (kv_heads, head_dim), in place."""
        cfg = self.cfg
        h, ntok = self._seqs[slot]
        pos = ntok - 1
        block = h.tiles[pos // cfg.block_size]
        off = pos % cfg.block_size
        self.k[layer, block, off] = k1.to(self.k.dtype)
        self.v[layer, block, off] = v1.to(self.v.dtype)

    def occupancy(self) -> Dict[str, float]:
        """Point-in-time pool occupancy sample (all floats, JSON-friendly)."""
        total = self.pool.total_tiles
        free = self.pool.free_tiles()
        return {
            "total_tiles": float(total),
            "free_tiles": float(free),
            "used_tiles": float(total - free),
            "used_fraction": (total - free) / total if total else 0.0,
            "live_seqs": float(len(self._seqs)),
            "free_slots": float(len(self._free_slots)),
        }

    # -- PUMA metric --------------------------------------------------------------
    def contiguity_report(self) -> Dict[str, float]:
        """Pool-wide contiguous-run statistics (the paper's '% in PUD'
        analogue) plus ``channel_balance``: mean/max used blocks per channel."""
        fracs, runs, tiles = [], 0, 0
        for h, _ in self._seqs.values():
            fracs.append(h.contiguous_run_fraction())
            runs += len(h.runs())
            tiles += len(h.tiles)
        occ = self.pool.channel_occupancy()
        return {
            "mean_contiguous_fraction": float(np.mean(fracs)) if fracs else 1.0,
            "descriptors_per_tile": runs / tiles if tiles else 0.0,
            "live_seqs": float(len(self._seqs)),
            "channels": float(occ["channels"]),
            "channel_balance": float(occ["balance"]),
        }

    def channel_occupancy(self) -> Dict[str, object]:
        """Per-channel used/free block counts (detail behind the balance)."""
        return self.pool.channel_occupancy()
