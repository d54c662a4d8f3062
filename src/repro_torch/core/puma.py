"""PUMA: subarray-aware lazy allocation for Processing-Using-Memory (paper §2).

Faithful functional reproduction of the kernel module:

* ``pim_preallocate(n)`` — reserve ``n`` huge pages into the PUD pool; split
  each into rank-row-sized *memory regions*; index every region by its
  global subarray ID using the DRAM interleave decode (:mod:`repro_torch.core.dram`).
* ``pim_alloc(size)`` — worst-fit over the *ordered array* of per-subarray
  free-region counts (paper: a buddy-allocator-style ordered array [146]):
  take regions from the subarray with the most free regions, spilling to the
  next-largest until satisfied.  The returned object is virtually contiguous
  (the kernel re-mmaps scattered regions; here the Allocation's extents model
  exactly that mapping).
* ``pim_alloc_align(size, hint)`` — walk the hint allocation's regions and
  place region *k* of the new allocation in the *same subarray* as region
  *k* of the hint, falling back to worst-fit when that subarray is full
  (paper §2 "Aligned Allocation", steps 1-5).
* an *allocation hashmap* keyed by virtual address tracks live allocations
  so future ``pim_alloc_align`` calls can find their hint.

``pim_free`` is added beyond the paper so that long-running property tests
and the serving integration can recycle the pool.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import TYPE_CHECKING, Dict, List, Optional

import numpy as np

from repro_torch.core.allocators import (
    HUGE_PAGE,
    PAGE,
    Allocation,
    Extent,
    HugePageModel,
    PhysicalMemory,
    PosixMemalignModel,
)
from repro_torch.core.dram import AddressMap
from repro_torch.robustness.errors import (
    BasePageExhausted,
    DoubleFree,
    HugePageExhausted,
    PoolExhausted,
)

from repro_torch.robustness.faults import injected_alloc_miss

if TYPE_CHECKING:
    from repro_torch.robustness.faults import FaultInjector
    from repro_torch.robustness.journal import Journal

__all__ = ["PumaStats", "PumaAllocator", "FallbackStats", "RobustAllocator"]


@dataclasses.dataclass
class PumaStats:
    preallocated_regions: int = 0
    live_allocations: int = 0
    regions_in_use: int = 0
    align_hits: int = 0      # regions placed in the hinted subarray
    align_misses: int = 0    # worst-fit fallbacks during pim_alloc_align
    failed_allocs: int = 0
    injected_misses: int = 0      # transient misses forced by the injector
    quarantined_regions: int = 0  # regions pulled for blacklisted subarrays
    remapped_regions: int = 0     # live regions migrated off dead subarrays


class _OrderedArray:
    """Per-subarray free-region bookkeeping with worst-fit selection.

    The paper uses "an ordered array ... similar to the Linux buddy
    allocator, where each entry represents the number of memory regions in a
    single subarray".  We keep (a) a free-list per subarray and (b) a lazy
    max-heap over (count, subarray) for O(log S) worst-fit.

    With ``channels > 1`` the same bookkeeping is additionally sliced per
    channel (a subarray's channel is ``sa % channels`` — the global ID is
    channel-innermost): one lazy max-heap and one running total per channel,
    so :meth:`worst_fit_subarray` can answer "emptiest subarray *of channel
    c*" in O(log S) for the channel-striping allocation path.
    """

    def __init__(self, channels: int = 1):
        self.channels = channels
        self.free: Dict[int, List[int]] = {}   # subarray -> region PAs (LIFO)
        self._heap: List[tuple] = []           # (-count, subarray), lazy
        self._heap_ch: List[List[tuple]] = [[] for _ in range(channels)]
        self._total = 0                        # running free-region count
        self._total_ch = [0] * channels

    def _push(self, subarray: int) -> None:
        entry = (-len(self.free.get(subarray, ())), subarray)
        heapq.heappush(self._heap, entry)
        if self.channels > 1:
            heapq.heappush(self._heap_ch[subarray % self.channels], entry)

    def add_region(self, subarray: int, pa: int) -> None:
        lst = self.free.setdefault(subarray, [])
        lst.append(pa)
        self._push(subarray)
        self._total += 1
        self._total_ch[subarray % self.channels] += 1

    def add_regions(self, subarrays: np.ndarray, pas: np.ndarray) -> None:
        """Bulk insert: group by subarray, extend each free list once, and
        push ONE heap entry per touched subarray instead of one per region."""
        if len(pas) == 0:
            return
        order = np.argsort(subarrays, kind="stable")
        sas = np.asarray(subarrays)[order]
        ps = np.asarray(pas)[order]
        starts = np.flatnonzero(np.r_[True, sas[1:] != sas[:-1]])
        stops = np.r_[starts[1:], len(sas)]
        for start, stop in zip(starts.tolist(), stops.tolist()):
            sa = int(sas[start])
            lst = self.free.setdefault(sa, [])
            lst.extend(ps[start:stop].tolist())
            self._push(sa)
        self._total += len(ps)
        if self.channels > 1:
            counts = np.bincount(
                sas % self.channels, minlength=self.channels
            )
            for c in range(self.channels):
                self._total_ch[c] += int(counts[c])
        else:
            self._total_ch[0] += len(ps)

    def take_from(self, subarray: int) -> Optional[int]:
        lst = self.free.get(subarray)
        if not lst:
            return None
        pa = lst.pop()
        self._push(subarray)
        self._total -= 1
        self._total_ch[subarray % self.channels] -= 1
        return pa

    def take_specific(self, subarray: int, pa: int) -> bool:
        """Remove one *specific* region PA from a subarray's free list —
        the forced-placement primitive journal replay uses to reproduce the
        original allocator's decisions exactly (worst-fit tie-breaks are
        irrelevant when every placement is replayed from the log)."""
        lst = self.free.get(subarray)
        if not lst or pa not in lst:
            return False
        lst.remove(pa)
        self._push(subarray)
        self._total -= 1
        self._total_ch[subarray % self.channels] -= 1
        return True

    def worst_fit_subarray(self, channel: Optional[int] = None) -> Optional[int]:
        """Subarray with the largest number of free regions (lazy heap);
        restricted to one channel's subarrays when ``channel`` is given."""
        # channels == 1: the global view IS channel 0's view (and _push
        # skips the per-channel heaps to keep preallocation cheap)
        if channel is None or self.channels == 1:
            heap = self._heap
        else:
            heap = self._heap_ch[channel]
        while heap:
            neg, sa = heap[0]
            if len(self.free.get(sa, ())) == -neg and -neg > 0:
                return sa
            heapq.heappop(heap)  # stale entry
        return None

    def drain(self, subarray: int) -> List[int]:
        """Remove and return every free region of ``subarray`` (blacklist
        quarantine).  Heap entries invalidate lazily via a 0-count push."""
        lst = self.free.pop(subarray, [])
        if lst:
            self._total -= len(lst)
            self._total_ch[subarray % self.channels] -= len(lst)
            self._push(subarray)
        return lst

    def total_free(self, channel: Optional[int] = None) -> int:
        return self._total if channel is None else self._total_ch[channel]

    def channel_free(self) -> List[int]:
        return list(self._total_ch)

    def free_counts(self) -> Dict[int, int]:
        return {sa: len(v) for sa, v in self.free.items() if v}


class PumaAllocator:
    name = "puma"

    def __init__(
        self,
        mem: PhysicalMemory,
        amap: Optional[AddressMap] = None,
        *,
        stripe_channels: bool = False,
        injector: Optional["FaultInjector"] = None,
        journal: Optional["Journal"] = None,
    ):
        self.mem = mem
        self.amap = amap or mem.amap
        self.region_bytes = self.amap.region_bytes
        self.n_channels = self.amap.geo.channels
        #: stripe first allocations round-robin across channels (worst-fit
        #: *within* each channel) so consecutive logical rows land on
        #: different channels and the channel-parallel PUD executor scales.
        #: Off by default — and a no-op at channels=1 — so the paper's
        #: single-channel placement is untouched.
        self.stripe_channels = stripe_channels
        self._next_channel = 0
        self._ordered = _OrderedArray(self.n_channels)
        self._used_per_channel = np.zeros(self.n_channels, dtype=np.int64)
        self._allocations: Dict[int, Allocation] = {}  # the allocation hashmap
        self._regions_of: Dict[int, List[int]] = {}    # va -> region PAs
        self._va_next = 0x7000_0000_0000
        self.stats = PumaStats()
        #: fault injector (transient alloc misses + permanent-fault
        #: blacklist source); None = fault-free.
        self.injector = injector
        #: subarrays quarantined after permanent faults; their regions are
        #: never handed out again.
        self._blacklisted: set = set()
        self._quarantined: List[int] = []   # region PAs pulled from the pool
        if injector is not None:
            for sa in sorted(injector.blacklist):
                self._blacklisted.add(sa)
        #: crash-consistency journal (``repro_torch.robustness.journal``): every
        #: state-changing operation appends its *outcome* (actual placements)
        #: so replay is forced and bit-exact; None = not journaled.
        self.journal = journal

    # -- 1) pre-allocation (paper step (1)) ---------------------------------
    def pim_preallocate(self, n_huge_pages: int) -> int:
        """Populate the PUD pool; returns the number of regions indexed.

        Every huge page's regions are decoded in one numpy batch (huge pages
        are region-aligned, so the region set is a plain arange) and inserted
        grouped-by-subarray — no per-region Python calls.
        """
        hps = self.mem.take_huge(n_huge_pages)
        if not hps:
            return 0
        if self.journal is not None:
            self.journal.append("prealloc", hps=list(hps))
        rb = self.region_bytes
        per_hp = np.arange(HUGE_PAGE // rb, dtype=np.int64) * rb
        rpas = (np.asarray(hps, dtype=np.int64)[:, None] + per_hp).ravel()
        sas = self.amap.region_subarrays(rpas)
        self.stats.preallocated_regions += len(rpas)
        if self._blacklisted:
            # regions landing in dead subarrays go straight to quarantine
            bl = np.fromiter(self._blacklisted, dtype=np.int64)
            bad = np.isin(sas, bl)
            if bad.any():
                self._quarantined.extend(rpas[bad].tolist())
                self.stats.quarantined_regions += int(bad.sum())
                rpas, sas = rpas[~bad], sas[~bad]
        self._ordered.add_regions(sas, rpas)
        return len(rpas)

    # -- helpers -------------------------------------------------------------
    def _nregions(self, size: int) -> int:
        return -(-size // self.region_bytes)

    def _mk_allocation(self, size: int, region_pas: List[int]) -> Allocation:
        """Re-mmap model: scattered regions become one contiguous VA range."""
        va = self._va_next
        self._va_next += len(region_pas) * self.region_bytes
        extents = [
            Extent(i * self.region_bytes, pa, self.region_bytes)
            for i, pa in enumerate(region_pas)
        ]
        alloc = Allocation(va, size, extents, self.name)
        self._allocations[va] = alloc
        self._regions_of[va] = region_pas
        if self.journal is not None:
            self.journal.append(
                "alloc", va=va, size=size, regions=list(region_pas)
            )
        self.stats.live_allocations += 1
        self.stats.regions_in_use += len(region_pas)
        if self.n_channels > 1:
            self._used_per_channel += np.bincount(
                self.amap.region_channels(np.asarray(region_pas, np.int64)),
                minlength=self.n_channels,
            )
        else:
            self._used_per_channel[0] += len(region_pas)
        return alloc

    def _release(self, region_pas: List[int]) -> None:
        if not region_pas:
            return
        pas = np.asarray(region_pas, dtype=np.int64)
        # regions leave the in-use set either way (freed or quarantined)
        if self.n_channels > 1:
            self._used_per_channel -= np.bincount(
                self.amap.region_channels(pas), minlength=self.n_channels
            )
        else:
            self._used_per_channel[0] -= len(pas)
        sas = self.amap.region_subarrays(pas)
        if self._blacklisted:
            # freed regions of dead subarrays are quarantined, not recycled
            bl = np.fromiter(self._blacklisted, dtype=np.int64)
            bad = np.isin(sas, bl)
            if bad.any():
                self._quarantined.extend(pas[bad].tolist())
                self.stats.quarantined_regions += int(bad.sum())
                pas, sas = pas[~bad], sas[~bad]
                if pas.size == 0:
                    return
        self._ordered.add_regions(sas, pas)

    def _injected_miss(self) -> bool:
        """Transient fragmented-arena miss forced by the fault injector
        (shared hook — see :func:`repro_torch.robustness.faults.injected_alloc_miss`)."""
        return injected_alloc_miss(self.injector, self.stats, "failed_allocs")

    # -- 2) first allocation: worst-fit (paper step (2)) ----------------------
    def pim_alloc(self, size: int) -> Optional[Allocation]:
        self.sync_blacklist()
        if self._injected_miss():
            return None
        need = self._nregions(size)
        if need > self._ordered.total_free():
            self.stats.failed_allocs += 1
            return None
        if self.stripe_channels and self.n_channels > 1:
            return self._pim_alloc_striped(size, need)
        got: List[int] = []
        while len(got) < need:
            sa = self._ordered.worst_fit_subarray()
            if sa is None:  # cannot happen given the total_free gate
                self._release(got)
                self.stats.failed_allocs += 1
                return None
            # drain the worst-fit subarray before moving to the next largest
            while len(got) < need:
                pa = self._ordered.take_from(sa)
                if pa is None:
                    break
                got.append(pa)
        return self._mk_allocation(size, got)

    def _pim_alloc_striped(self, size: int, need: int) -> Optional[Allocation]:
        """Channel-striped worst-fit: region ``k`` comes from the next
        channel in round-robin order (skipping exhausted channels), from
        that channel's emptiest subarray.  Consecutive logical rows then
        live on different channels, so one PUD op's row list partitions
        ~evenly across the per-channel controllers."""
        got: List[int] = []
        while len(got) < need:
            pa = None
            for _ in range(self.n_channels):
                ch = self._next_channel
                self._next_channel = (ch + 1) % self.n_channels
                sa = self._ordered.worst_fit_subarray(channel=ch)
                if sa is None:
                    continue
                pa = self._ordered.take_from(sa)
                if pa is not None:
                    break
            if pa is None:  # cannot happen given the total_free gate
                self._release(got)
                self.stats.failed_allocs += 1
                return None
            got.append(pa)
        return self._mk_allocation(size, got)

    # -- 3) aligned allocation (paper step (3)) -------------------------------
    def pim_alloc_align(self, size: int, hint: Allocation) -> Optional[Allocation]:
        # step 1: hashmap lookup; no match -> allocation fails (paper)
        if hint.va not in self._allocations:
            self.stats.failed_allocs += 1
            return None
        self.sync_blacklist()
        if self._injected_miss():
            return None
        hint_regions = self._regions_of[hint.va]
        need = self._nregions(size)
        if need > self._ordered.total_free():
            self.stats.failed_allocs += 1
            return None
        got: List[int] = []
        # steps 2-4: iterate hint regions, allocate in the same subarray,
        # fall back to worst-fit when that subarray has no free region.
        # One batch decode answers every hint lookup up front; the scalar
        # decode ran once per hint region before.
        hint_sas = self.amap.region_subarrays(
            np.asarray(hint_regions[:need], dtype=np.int64)
        )
        for k in range(need):
            if k < len(hint_regions):
                target_sa = int(hint_sas[k])
                pa = self._ordered.take_from(target_sa)
                if pa is not None:
                    got.append(pa)
                    self.stats.align_hits += 1
                    continue
            self.stats.align_misses += 1
            sa = self._ordered.worst_fit_subarray()
            if sa is None:
                self._release(got)
                self.stats.failed_allocs += 1
                return None
            got.append(self._ordered.take_from(sa))
        # step 5: re-mmap into contiguous VA (modelled by _mk_allocation)
        return self._mk_allocation(size, got)

    # -- beyond-paper: recycling ----------------------------------------------
    def pim_free(self, alloc: Allocation) -> None:
        if alloc.va not in self._allocations:
            raise DoubleFree(
                f"{alloc.va:#x} is not a live PUMA allocation", va=alloc.va
            )
        region_pas = self._regions_of.pop(alloc.va)
        del self._allocations[alloc.va]
        if self.journal is not None:
            self.journal.append("free", va=alloc.va)
        self._release(region_pas)
        self.stats.live_allocations -= 1
        self.stats.regions_in_use -= len(region_pas)

    # -- robustness: permanent-fault blacklisting + row remap -----------------
    def sync_blacklist(self) -> int:
        """Pull newly blacklisted subarrays from the fault injector (permanent
        RowClone failures observed by the PUD executor) and quarantine/remap
        them.  Returns the number of subarrays newly blacklisted."""
        if self.injector is None:
            return 0
        fresh = self.injector.new_permanent_faults(self._blacklisted)
        for sa in sorted(fresh):
            self.blacklist_subarray(sa)
        return len(fresh)

    def blacklist_subarray(self, sa: int, phys: Optional[np.ndarray] = None) -> int:
        """Handle a permanent subarray failure: quarantine its free regions
        and *remap* every live allocation's regions out of it (the kernel's
        row-remap path; the migration itself is a RowClone copy per row —
        pass ``phys`` to actually move the bytes on the modeled memory).

        Returns the number of live regions remapped.  Raises
        :class:`PoolExhausted` when the pool has no spare region to remap
        into (the row's data would be lost on real hardware; callers should
        treat the allocation as failed).
        """
        self._blacklisted.add(sa)
        drained = self._ordered.drain(sa)
        if drained:
            self._quarantined.extend(drained)
            self.stats.quarantined_regions += len(drained)
        remapped = 0
        remap_log: List[List[int]] = []   # [va, k, old_pa, new_pa] per move
        rb = self.region_bytes
        for va, regions in self._regions_of.items():
            if not regions:
                continue
            sas = self.amap.region_subarrays(np.asarray(regions, np.int64))
            hits = np.flatnonzero(sas == sa)
            if hits.size == 0:
                continue
            for k in hits.tolist():
                tgt = self._ordered.worst_fit_subarray()
                new_pa = self._ordered.take_from(tgt) if tgt is not None else None
                if new_pa is None:
                    raise PoolExhausted(
                        "no spare region to remap faulty subarray into",
                        subarray=sa, va=va,
                    )
                old_pa = regions[k]
                if phys is not None:
                    phys[new_pa:new_pa + rb] = phys[old_pa:old_pa + rb]
                self._quarantined.append(old_pa)
                self.stats.quarantined_regions += 1
                regions[k] = new_pa
                remap_log.append([va, k, old_pa, new_pa])
                remapped += 1
                if self.n_channels > 1:
                    self._used_per_channel[
                        int(self.amap.channel_of_subarray(sa))] -= 1
                    self._used_per_channel[
                        int(self.amap.channel_of_subarray(int(tgt)))] += 1
            # rebuild the allocation's extent list in place (same VA, same
            # hashmap identity — aligned-allocation hints keep working)
            alloc = self._allocations[va]
            alloc.extents = [
                Extent(i * rb, pa, rb) for i, pa in enumerate(regions)
            ]
            alloc.__post_init__()
        self.stats.remapped_regions += remapped
        if self.journal is not None:
            self.journal.append(
                "blacklist", sa=sa, drained=list(drained), remaps=remap_log
            )
        return remapped

    @property
    def blacklisted_subarrays(self) -> List[int]:
        return sorted(self._blacklisted)

    def quarantined_regions(self) -> int:
        return len(self._quarantined)

    # introspection used by tests / benchmarks
    def lookup(self, va: int) -> Optional[Allocation]:
        return self._allocations.get(va)

    def free_regions(self) -> int:
        return self._ordered.total_free()

    def free_counts(self) -> Dict[int, int]:
        return self._ordered.free_counts()

    def fragmentation(self) -> float:
        """1 - (largest per-subarray free count / total free) — the allocator
        mirror of :meth:`repro_torch.core.arena.TilePool.fragmentation`.

        Regions inside one subarray are interchangeable for PUD placement, so
        the "largest free run" at this layer is the biggest block of
        co-locatable free regions: 0.0 means all free capacity sits in one
        subarray (any future aligned pair co-locates), values near 1.0 mean
        the free capacity is spread one region per subarray and
        ``pim_alloc_align`` is doomed to worst-fit misses — the churn-decay
        signal the long-horizon benchmark tracks.
        """
        total = self._ordered.total_free()
        if total == 0:
            return 0.0
        best = max((len(v) for v in self._ordered.free.values()), default=0)
        return 1.0 - best / total

    def channel_report(self) -> Dict[str, object]:
        """Per-channel pool state — the placement-balance figure of merit.

        ``used_balance`` is mean/max of per-channel in-use region counts:
        1.0 means live allocations are perfectly striped across channels,
        1/C means everything sits on one channel (no PUD parallelism).
        """
        used = self._used_per_channel
        mx = int(used.max()) if used.size else 0
        return {
            "channels": self.n_channels,
            "free_regions": self._ordered.channel_free(),
            "used_regions": used.tolist(),
            "used_balance": float(used.mean() / mx) if mx > 0 else 1.0,
            "fragmentation": self.fragmentation(),
        }

    # uniform interface with the baseline allocators
    def alloc(self, size: int) -> Allocation:
        a = self.pim_alloc(size)
        if a is None:
            raise PoolExhausted(
                "PUMA pool exhausted", wanted=self._nregions(size),
                free=self._ordered.total_free(),
            )
        return a


# ---------------------------------------------------------------------------
# Recovery layer: bounded retry-with-backoff fallback chain.
# Mirrors the kernel allocator's fallback order: PUD pool (PUMA) -> fresh
# huge pages -> scattered base pages.  Each tier degrades placement quality
# (PUD-executable -> row-aligned-but-opportunistic -> 0% PUD) but never
# fails the caller until base pages are gone too.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FallbackStats:
    puma: int = 0            # allocations served by the PUD pool
    huge: int = 0            # ... by fresh huge pages (degraded tier 2)
    base: int = 0            # ... by scattered base pages (degraded tier 3)
    retries: int = 0         # failed attempts that were retried
    refills: int = 0         # pim_preallocate refills between retries
    failures: int = 0        # requests that exhausted every tier
    backoff_ns: float = 0.0  # simulated backoff time spent waiting

    @property
    def served(self) -> int:
        return self.puma + self.huge + self.base

    def fallback_fraction(self) -> float:
        """Fraction of served allocations that fell off the PUMA tier."""
        return (self.huge + self.base) / self.served if self.served else 0.0


class RobustAllocator:
    """Hardened allocation front-end over a :class:`PumaAllocator`.

    ``alloc`` walks the chain PUMA -> huge-page -> base-page with bounded
    per-tier retries and exponential (simulated) backoff:

    1. **PUMA tier** — ``pim_alloc``/``pim_alloc_align``; a miss triggers a
       pool refill (``pim_preallocate``) when the pool is genuinely short,
       then a bounded retry (which also absorbs injector-transient misses).
    2. **huge-page tier** — per-request fresh huge pages (row-aligned but
       only opportunistically co-located, the paper's strongest baseline);
       injector denials are retried up to ``max_retries``.
    3. **base-page tier** — scattered 4 KB pages (0 % PUD-executable).

    Raises :class:`PoolExhausted` only when every tier is dry.  ``free``
    routes by the allocation's ``allocator`` tag so callers can churn
    without tracking which tier served them.
    """

    name = "puma-robust"

    def __init__(
        self,
        puma: PumaAllocator,
        *,
        max_retries: int = 3,
        backoff_ns: float = 200.0,
        refill_huge_pages: int = 8,
    ):
        self.puma = puma
        self.mem = puma.mem
        self.max_retries = max_retries
        self.backoff_ns = backoff_ns
        self.refill_huge_pages = refill_huge_pages
        self._huge = HugePageModel(puma.mem, mode="mmap")
        self._base = PosixMemalignModel(puma.mem)
        self._tier_of: Dict[int, str] = {}   # va -> serving tier
        self.stats = FallbackStats()

    def _backoff(self, attempt: int) -> None:
        self.stats.retries += 1
        self.stats.backoff_ns += self.backoff_ns * (2 ** attempt)

    # -- tier 1: PUMA ---------------------------------------------------------
    def _try_puma(self, size: int, hint: Optional[Allocation]) -> Optional[Allocation]:
        for attempt in range(self.max_retries + 1):
            if hint is not None:
                a = self.puma.pim_alloc_align(size, hint)
                if a is None and self.puma.lookup(hint.va) is None:
                    # dead hint: aligned allocation can never succeed (paper);
                    # fall through to plain worst-fit instead of retrying.
                    hint = None
                    a = self.puma.pim_alloc(size)
            else:
                a = self.puma.pim_alloc(size)
            if a is not None:
                return a
            if attempt == self.max_retries:
                break
            self._backoff(attempt)
            need = self.puma._nregions(size)
            if need > self.puma.free_regions():
                # genuinely short: grow the PUD pool like the kernel module
                try:
                    self.puma.pim_preallocate(self.refill_huge_pages)
                    self.stats.refills += 1
                except HugePageExhausted as e:
                    if not e.injected:
                        break   # reservation is truly dry: go to tier 2
        return None

    # -- tier 2/3: degraded --------------------------------------------------
    def _try_huge(self, size: int) -> Optional[Allocation]:
        for attempt in range(self.max_retries + 1):
            try:
                return self._huge.alloc(size)
            except HugePageExhausted as e:
                if not e.injected:
                    return None
                if attempt < self.max_retries:
                    self._backoff(attempt)
        return None

    def alloc(self, size: int, hint: Optional[Allocation] = None) -> Allocation:
        a = self._try_puma(size, hint)
        if a is not None:
            self.stats.puma += 1
            self._tier_of[a.va] = "puma"
            return a
        a = self._try_huge(size)
        if a is not None:
            self.stats.huge += 1
            self._tier_of[a.va] = "huge"
            return a
        try:
            a = self._base.alloc(size)
        except BasePageExhausted:
            self.stats.failures += 1
            raise PoolExhausted(
                "allocation failed in every tier (puma, huge, base)",
                size=size,
            )
        self.stats.base += 1
        self._tier_of[a.va] = "base"
        return a

    def free(self, alloc: Allocation) -> None:
        tier = self._tier_of.pop(alloc.va, None)
        if tier is None:
            raise DoubleFree(
                f"{alloc.va:#x} was not served by this allocator", va=alloc.va
            )
        if tier == "puma":
            self.puma.pim_free(alloc)
        elif tier == "huge":
            # mmap-mode huge allocations own whole (coalesced) huge pages
            self.mem.release_huge(
                [e.pa + off
                 for e in alloc.extents
                 for off in range(0, e.nbytes, HUGE_PAGE)]
            )
        else:  # base pages
            self.mem.release_pages(
                [e.pa + off
                 for e in alloc.extents
                 for off in range(0, e.nbytes, PAGE)]
            )

    def tier_of(self, alloc: Allocation) -> Optional[str]:
        return self._tier_of.get(alloc.va)
