"""Models of the baseline memory allocators the paper evaluates against.

The paper's §1 study: ``malloc`` and ``posix_memalign`` give virtually
contiguous but *physically scattered* pages, so 0 % of PUD operations can
execute in DRAM; huge-page-backed allocation is physically contiguous per
2 MB page but coarse, so multi-operand PUD ops co-locate only opportunistically
(<= ~60 % at 32 Kb+ allocation sizes).

Everything is modeled at the level the OS sees: a ``PhysicalMemory`` with
4 KB base pages and 2 MB huge pages, boot-time fragmentation, and allocators
that build VA->PA page tables.  ``Allocation`` is the common currency shared
with :mod:`repro_torch.core.puma` and consumed by :mod:`repro_torch.core.pud`; its
extent list is normalized (sorted + physically-adjacent extents coalesced)
at construction so translation is O(log E) bisect and bulk consumers walk
whole runs via :meth:`Allocation.runs` instead of probing byte-by-byte.
"""
from __future__ import annotations

import dataclasses
import random
from bisect import bisect_right
from typing import TYPE_CHECKING, Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.core.dram import AddressMap
from repro_torch.robustness.errors import (
    BasePageExhausted,
    HugePageExhausted,
    TranslationError,
)

if TYPE_CHECKING:  # avoid importing the injector at runtime: decide-only dep
    from repro_torch.robustness.faults import FaultInjector

PAGE = 4096
HUGE_PAGE = 2 * 1024 * 1024

__all__ = [
    "PAGE",
    "HUGE_PAGE",
    "Extent",
    "Allocation",
    "PhysicalMemory",
    "MallocModel",
    "PosixMemalignModel",
    "HugePageModel",
]


@dataclasses.dataclass(frozen=True)
class Extent:
    """A physically contiguous run backing part of an allocation."""

    va_off: int   # offset within the allocation's VA range
    pa: int       # physical base address
    nbytes: int


@dataclasses.dataclass
class Allocation:
    """VA-contiguous allocation with its VA->PA mapping.

    Extents are normalized at construction: sorted by ``va_off`` and
    *coalesced* — VA-adjacent extents that are also PA-adjacent merge into
    one.  After coalescing every extent is a maximal physically contiguous
    run, so translation is a single ``bisect`` over the cached ``va_off``
    array instead of a linear scan, and :meth:`runs` hands callers whole
    (pa, nbytes) runs so nobody ever probes byte-by-byte.
    """

    va: int
    size: int
    extents: List[Extent]          # sorted by va_off, covering [0, size_padded)
    allocator: str

    def __post_init__(self):
        exts = sorted(self.extents, key=lambda e: e.va_off)
        merged: List[Extent] = []
        for e in exts:
            if merged:
                m = merged[-1]
                if m.va_off + m.nbytes == e.va_off and m.pa + m.nbytes == e.pa:
                    merged[-1] = Extent(m.va_off, m.pa, m.nbytes + e.nbytes)
                    continue
            merged.append(e)
        self.extents = merged
        # Parallel plain-int lists: bisect + index, no attribute chasing.
        self._va_offs: List[int] = [e.va_off for e in merged]
        self._va_ends: List[int] = [e.va_off + e.nbytes for e in merged]
        self._pas: List[int] = [e.pa for e in merged]
        self._row_sa_cache: Dict[int, Tuple[object, np.ndarray]] = {}

    def pa_of(self, va_off: int) -> int:
        """Translate an offset inside the allocation to a physical address.

        Raises :class:`TranslationError` (a ``ValueError``) on unmapped
        offsets — including any offset into a zero-size/zero-extent
        allocation.
        """
        i = bisect_right(self._va_offs, va_off) - 1
        if i >= 0 and va_off < self._va_ends[i]:
            return self._pas[i] + (va_off - self._va_offs[i])
        raise TranslationError(
            f"offset {va_off} not mapped (size={self.size})",
            va_off=va_off, size=self.size, allocator=self.allocator,
        )

    def contiguous_run(self, va_off: int, nbytes: int) -> Optional[int]:
        """PA base if [va_off, va_off+nbytes) is one physically contiguous run.

        An unmapped *start* offset (negative, in a hole, beyond the mapping,
        or any offset of a zero-extent allocation) raises
        :class:`TranslationError`; a run whose *end* merely overflows the
        mapping returns None, like any other non-contiguous request.
        """
        i = bisect_right(self._va_offs, va_off) - 1
        if i < 0 or not self.extents or va_off >= self._va_ends[i]:
            raise TranslationError(
                f"offset {va_off} not mapped (size={self.size})",
                va_off=va_off, size=self.size, allocator=self.allocator,
            )
        if va_off + nbytes > self._va_ends[-1]:
            return None
        # extents are coalesced, so a contiguous run cannot span two of them
        if va_off + nbytes <= self._va_ends[i]:
            return self._pas[i] + (va_off - self._va_offs[i])
        return None

    def runs(self, va_off: int, nbytes: int) -> Iterator[Tuple[int, int]]:
        """Yield maximal physically contiguous ``(pa, nbytes)`` runs covering
        ``[va_off, va_off + nbytes)``, in VA order."""
        end = va_off + nbytes
        i = bisect_right(self._va_offs, va_off) - 1
        cur = va_off
        while cur < end:
            if i < 0 or i >= len(self.extents) or not (
                self._va_offs[i] <= cur < self._va_ends[i]
            ):
                raise TranslationError(
                    f"offset {cur} not mapped (size={self.size})",
                    va_off=cur, size=self.size, allocator=self.allocator,
                )
            n = min(end, self._va_ends[i]) - cur
            yield self._pas[i] + (cur - self._va_offs[i]), n
            cur += n
            i += 1


class PhysicalMemory:
    """Free-page bookkeeping for a booted system.

    ``occupancy`` simulates a long-running machine: that fraction of base
    pages is already in use (scattered), so fresh 4 KB allocations come from
    a shuffled free list — the physical-discontiguity source the paper
    identifies.  Huge pages are reserved at boot from the *low, unfragmented*
    end of memory (standard hugetlbfs behaviour), so they are individually
    contiguous and mostly mutually adjacent.
    """

    def __init__(
        self,
        amap: AddressMap,
        *,
        occupancy: float = 0.35,
        n_huge_pages: int = 512,
        huge_scatter: float = 0.15,
        seed: int = 0,
        injector: Optional["FaultInjector"] = None,
    ):
        self.amap = amap
        self.rng = random.Random(seed)
        #: fault injector consulted on every huge-page grab (transient
        #: exhaustion); None = never inject.
        self.injector = injector
        total = amap.total_bytes
        self.n_huge = n_huge_pages
        huge_bytes = n_huge_pages * HUGE_PAGE
        if huge_bytes > total // 2:
            raise ValueError("huge page pool exceeds half of memory")

        # Huge-page pool: boot-time reservation, mostly sequential.  A
        # fraction `huge_scatter` of pages is displaced to random slots to
        # model a pool grown after boot / CMA fragmentation.
        slots = list(range(total // HUGE_PAGE))
        seq = slots[: n_huge_pages]
        n_scattered = int(n_huge_pages * huge_scatter)
        if n_scattered:
            displaced = self.rng.sample(range(n_huge_pages), n_scattered)
            far = self.rng.sample(slots[n_huge_pages:], n_scattered)
            for i, slot in zip(displaced, far):
                seq[i] = slot
        self.free_huge: List[int] = [s * HUGE_PAGE for s in seq]  # FIFO order

        # Base pages in the non-huge region: a long-running system hands out
        # physically scattered frames.  Drawing uniformly at random (with a
        # used-set) is distributionally the same as pre-shuffling the whole
        # free list but O(1) per page instead of O(total/4K) at boot.
        self._base_lo = (n_huge_pages * HUGE_PAGE) // PAGE
        self._base_hi = total // PAGE
        n_base = self._base_hi - self._base_lo
        self._free_budget = int(n_base * (1.0 - occupancy))
        self._used: set = set()

    # -- base 4 KB pages ----------------------------------------------------
    def take_pages(self, n: int) -> List[int]:
        if n > self._free_budget:
            raise BasePageExhausted(
                f"out of base pages ({n} wanted)",
                wanted=n, free=self._free_budget,
            )
        out: List[int] = []
        while len(out) < n:
            p = self.rng.randrange(self._base_lo, self._base_hi)
            if p in self._used:
                continue
            self._used.add(p)
            out.append(p * PAGE)
        self._free_budget -= n
        return out

    def release_pages(self, pas: List[int]) -> None:
        for pa in pas:
            self._used.discard(pa // PAGE)
        self._free_budget += len(pas)

    # -- 2 MB huge pages ----------------------------------------------------
    def take_huge(self, n: int) -> List[int]:
        if n > len(self.free_huge):
            raise HugePageExhausted(
                f"out of huge pages ({n} wanted)",
                wanted=n, free=len(self.free_huge),
            )
        if n and self.injector is not None and self.injector.huge_denied():
            # transient denial (reservation contention): the pool is not
            # actually drained — retry-with-backoff may succeed.
            raise HugePageExhausted(
                f"huge page grab denied ({n} wanted)", injected=True,
                wanted=n, free=len(self.free_huge),
            )
        out, self.free_huge = self.free_huge[:n], self.free_huge[n:]
        return out

    def release_huge(self, pas: List[int]) -> None:
        self.free_huge.extend(pas)


class _VaSpace:
    """Trivial bump allocator for virtual addresses (never reused)."""

    def __init__(self, base: int = 0x7F00_0000_0000):
        self._next = base

    def take(self, size: int, align: int) -> int:
        va = -(-self._next // align) * align
        self._next = va + size
        return va


class MallocModel:
    """glibc-style malloc: small requests packed into a heap, large requests
    mmap'd.  Either way the backing 4 KB pages are physically scattered."""

    name = "malloc"
    MMAP_THRESHOLD = 128 * 1024
    HEAP_ALIGN = 16

    def __init__(self, mem: PhysicalMemory):
        self.mem = mem
        self.va = _VaSpace(0x5555_0000_0000)
        self._heap_va: Optional[int] = None
        self._heap_off = 0
        self._heap_extents: List[Extent] = []

    def _grow_heap(self, need: int) -> None:
        npages = -(-need // PAGE) + 8
        pas = self.mem.take_pages(npages)
        if self._heap_va is None:
            self._heap_va = self.va.take(1 << 30, PAGE)  # reserve a VA window
        off = len(self._heap_extents) * PAGE
        for i, pa in enumerate(pas):
            self._heap_extents.append(Extent(off + i * PAGE, pa, PAGE))

    def alloc(self, size: int) -> Allocation:
        if size >= self.MMAP_THRESHOLD:
            npages = -(-size // PAGE)
            pas = self.mem.take_pages(npages)
            va = self.va.take(npages * PAGE, PAGE)
            extents = [Extent(i * PAGE, pa, PAGE) for i, pa in enumerate(pas)]
            return Allocation(va, size, extents, self.name)
        # heap path: bump pointer at 16-byte alignment
        off = -(-self._heap_off // self.HEAP_ALIGN) * self.HEAP_ALIGN
        end = off + size
        mapped = len(self._heap_extents) * PAGE
        if end > mapped:
            self._grow_heap(end - mapped)
        self._heap_off = end
        # slice the heap extents covering [off, end)
        extents = []
        for e in self._heap_extents:
            if e.va_off + e.nbytes <= off or e.va_off >= end:
                continue
            start = max(e.va_off, off)
            stop = min(e.va_off + e.nbytes, end)
            extents.append(
                Extent(start - off, e.pa + (start - e.va_off), stop - start)
            )
        return Allocation(self._heap_va + off, size, extents, self.name)


class PosixMemalignModel(MallocModel):
    """posix_memalign: virtually aligned, still physically scattered (§1)."""

    name = "posix_memalign"

    def __init__(self, mem: PhysicalMemory, alignment: int = 8192):
        super().__init__(mem)
        self.alignment = alignment

    def alloc(self, size: int) -> Allocation:
        npages = -(-size // PAGE)
        pas = self.mem.take_pages(npages)
        va = self.va.take(npages * PAGE, max(self.alignment, PAGE))
        extents = [Extent(i * PAGE, pa, PAGE) for i, pa in enumerate(pas)]
        return Allocation(va, size, extents, self.name)


class HugePageModel:
    """Huge-page-backed allocation, the paper's strongest baseline.

    Two modes:

    * ``mmap`` (default — what the paper describes: each operand is its own
      "huge page allocation"): every request maps fresh whole huge pages.
      Rows are perfectly aligned and physically contiguous, but since a
      2 MB page spans multiple 1 MB subarrays, *which* subarray row *k* of
      each operand occupies depends on which huge page the pool handed out —
      multi-operand co-location is opportunistic (paper: "it is likely that
      such operands will reside in different DRAM subarrays").

    * ``heap``: a libhugetlbfs-style morecore packs requests into shared
      huge pages with power-of-two alignment capped at the base-page size —
      small requests additionally lose row alignment.
    """

    name = "hugepage"

    def __init__(self, mem: PhysicalMemory, mode: str = "mmap"):
        assert mode in ("mmap", "heap"), mode
        self.mem = mem
        self.mode = mode
        self.name = f"hugepage-{mode}"
        self.va = _VaSpace(0x2AAA_0000_0000)
        self._cur_pa: Optional[int] = None
        self._cur_off = 0

    def _alignment_for(self, size: int) -> int:
        a = 1 << (size - 1).bit_length() if size > 1 else 1
        return max(16, min(a, PAGE))

    def alloc(self, size: int) -> Allocation:
        if self.mode == "heap":
            align = self._alignment_for(size)
            if self._cur_pa is not None:
                off = -(-self._cur_off // align) * align
                if off + size <= HUGE_PAGE:
                    self._cur_off = off + size
                    va = self.va.take(size, align)
                    return Allocation(
                        va, size, [Extent(0, self._cur_pa + off, size)], self.name
                    )
        # fresh huge page(s): one mmap per request
        n = -(-size // HUGE_PAGE)
        pas = self.mem.take_huge(n)
        va = self.va.take(n * HUGE_PAGE, HUGE_PAGE)
        if self.mode == "heap":
            # morecore keeps packing pages: this allocation only owns
            # [0, size) — the remainder belongs to future requests.
            extents = []
            voff = 0
            for pa in pas:
                n_here = min(HUGE_PAGE, size - voff)
                extents.append(Extent(voff, pa, n_here))
                voff += n_here
            if n == 1:
                self._cur_pa, self._cur_off = pas[0], size
            else:
                self._cur_pa, self._cur_off = None, 0
            return Allocation(va, size, extents, self.name)
        extents = []
        voff = 0
        for pa in pas:
            extents.append(Extent(voff, pa, HUGE_PAGE))
            voff += HUGE_PAGE
        return Allocation(va, size, extents, self.name)
