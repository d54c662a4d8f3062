"""PUMA core: the paper's contribution (allocation policy + PUD model) and
its accelerator adaptation (arena pool + paged KV cache)."""
from repro_torch.core.dram import (
    AddressMap,
    DramGeometry,
    InterleaveScheme,
    BANK_REGION_SCHEME,
    CACHELINE_INTERLEAVED_SCHEME,
    default_map,
)
from repro_torch.core.allocators import (
    Allocation,
    HugePageModel,
    MallocModel,
    PhysicalMemory,
    PosixMemalignModel,
)
from repro_torch.core.puma import PumaAllocator
from repro_torch.core.pud import PudCostModel, execute_op, plan_rows, simulate_op
from repro_torch.core.arena import TileHandle, TilePool
from repro_torch.core.kv_pool import KVPoolConfig, PagedKVPool

__all__ = [
    "AddressMap",
    "DramGeometry",
    "InterleaveScheme",
    "BANK_REGION_SCHEME",
    "CACHELINE_INTERLEAVED_SCHEME",
    "default_map",
    "Allocation",
    "HugePageModel",
    "MallocModel",
    "PhysicalMemory",
    "PosixMemalignModel",
    "PumaAllocator",
    "PudCostModel",
    "execute_op",
    "plan_rows",
    "simulate_op",
    "TileHandle",
    "TilePool",
    "KVPoolConfig",
    "PagedKVPool",
]
