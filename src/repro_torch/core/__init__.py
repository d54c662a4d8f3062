"""PUMA core for serving: the arena tile pool and the paged KV pool.

The DRAM map, allocators, PUD cost model and controller are later slices of
the port (ROADMAP.md)."""
from repro_torch.core.arena import TileHandle, TilePool
from repro_torch.core.kv_pool import KVPoolConfig, PagedKVPool

__all__ = ["TileHandle", "TilePool", "KVPoolConfig", "PagedKVPool"]
