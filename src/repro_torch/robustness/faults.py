"""Deterministic, seeded fault injection for the PUMA stack.

One :class:`FaultInjector` (configured by a :class:`FaultPlan`) threads
through every layer that can fail:

* ``PhysicalMemory.take_huge``   — huge-page-pool exhaustion (transient
  denials at ``huge_exhaust_rate``), modelling a contended boot reservation;
* ``PumaAllocator.pim_alloc*``   — fragmented-arena allocation misses at
  ``alloc_miss_rate`` (the ordered array transiently cannot produce a
  region, as under concurrent churn);
* ``TilePool.alloc``/``extend``  — the same transient miss on the
  device-side tile pool, which is what drives the serving engine's
  preemption path;
* ``pud.simulate_op``/``execute_op`` — RowClone copy failures at a per-row
  ``rowclone_fail_rate``; a ``permanent_fraction`` of those are permanent
  subarray faults, which blacklist the subarray (the allocator then
  quarantines and remaps its rows);
* ``ChannelController`` — per-channel controller stalls (refresh storms,
  thermal throttle) at ``channel_stall_rate`` x ``channel_stall_ns``.

Determinism: every decision comes from one ``random.Random(seed)`` stream,
so a fixed seed plus a fixed call sequence reproduces the exact fault
pattern — the chaos suite and CI gate rely on this.

The injector only *decides*; each hook site owns its failure semantics
(raise a typed error, return None, add latency).  ``FaultStats`` counts
every injected event so benchmarks can report the injected load next to
the observed degradation.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Iterable, Optional, Sequence, Set, Tuple

import numpy as np

__all__ = ["FaultPlan", "FaultStats", "FaultInjector", "injected_alloc_miss"]


def injected_alloc_miss(
    injector: Optional["FaultInjector"], stats, failed_attr: str = "failed"
) -> bool:
    """Shared transient-miss hook for pool allocators.

    Consults ``injector.alloc_missed()`` and, when the miss fires, bumps the
    caller's failure counter (``failed_attr`` — ``failed`` on
    :class:`~repro_torch.core.arena.PoolStats`, ``failed_allocs`` on
    :class:`~repro_torch.core.puma.PumaStats`) plus its ``injected_misses``.
    ``PumaAllocator`` and ``TilePool`` both delegate their ``_injected_miss``
    to this one helper so the miss semantics cannot drift apart.
    """
    if injector is None or not injector.alloc_missed():
        return False
    setattr(stats, failed_attr, getattr(stats, failed_attr) + 1)
    stats.injected_misses += 1
    return True


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Injection knobs.  All rates are probabilities in [0, 1]; the default
    plan injects nothing (an injector with a default plan is a no-op)."""

    seed: int = 0
    #: P[one RowClone row op faults] — the paper-scale documented rate for
    #: the chaos suite is 1e-3.
    rowclone_fail_rate: float = 0.0
    #: fraction of RowClone faults that are *permanent* subarray failures
    #: (blacklist + remap) rather than transient (CPU retry only).
    permanent_fraction: float = 0.0
    #: P[a take_huge call is denied] — huge-page-pool exhaustion.
    huge_exhaust_rate: float = 0.0
    #: P[a pool allocation transiently misses] (PUMA ordered array and the
    #: serving TilePool both consult this).
    alloc_miss_rate: float = 0.0
    #: P[a dispatched channel burst hits an injected stall].
    channel_stall_rate: float = 0.0
    #: stall duration added to the channel's busy frontier when it fires.
    channel_stall_ns: float = 500.0
    #: subarrays dead from t=0 (manufacturing faults): never allocated from,
    #: never PUD-executed in.
    blacklist_subarrays: Tuple[int, ...] = ()

    def __post_init__(self):
        for f in ("rowclone_fail_rate", "permanent_fraction",
                  "huge_exhaust_rate", "alloc_miss_rate",
                  "channel_stall_rate"):
            v = getattr(self, f)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{f}={v} outside [0, 1]")
        if self.channel_stall_ns < 0:
            raise ValueError(f"channel_stall_ns={self.channel_stall_ns} < 0")


@dataclasses.dataclass
class FaultStats:
    rowclone_faults: int = 0
    permanent_faults: int = 0
    huge_denials: int = 0
    alloc_misses: int = 0
    channel_stalls: int = 0
    stall_ns: float = 0.0

    def total_injected(self) -> int:
        return (self.rowclone_faults + self.huge_denials
                + self.alloc_misses + self.channel_stalls)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class FaultInjector:
    """Seeded decision source for every fault hook.

    One injector instance is shared across the layers of one simulated
    machine so the blacklist and the statistics are globally consistent.
    """

    def __init__(self, plan: Optional[FaultPlan] = None):
        self.plan = plan or FaultPlan()
        self.rng = random.Random(self.plan.seed)
        self.stats = FaultStats()
        self.blacklist: Set[int] = set(self.plan.blacklist_subarrays)

    # -- huge-page pool -------------------------------------------------------
    def huge_denied(self) -> bool:
        """True when this ``take_huge`` call should fail transiently."""
        p = self.plan.huge_exhaust_rate
        if p and self.rng.random() < p:
            self.stats.huge_denials += 1
            return True
        return False

    # -- allocator misses -----------------------------------------------------
    def alloc_missed(self) -> bool:
        """True when this pool allocation should transiently miss."""
        p = self.plan.alloc_miss_rate
        if p and self.rng.random() < p:
            self.stats.alloc_misses += 1
            return True
        return False

    # -- RowClone row faults --------------------------------------------------
    def rowclone_faults(self, subarrays: Sequence[int]) -> np.ndarray:
        """Per-row fault mask for one op's PUD rows (global subarray IDs).

        Permanent faults additionally move the row's subarray onto the
        blacklist; the caller is responsible for quarantining/remapping
        (see :meth:`PumaAllocator.blacklist_subarray`).
        """
        n = len(subarrays)
        mask = np.zeros(n, dtype=bool)
        p = self.plan.rowclone_fail_rate
        if not p or n == 0:
            return mask
        for i in range(n):
            if self.rng.random() < p:
                mask[i] = True
                self.stats.rowclone_faults += 1
                if (self.plan.permanent_fraction
                        and self.rng.random() < self.plan.permanent_fraction):
                    sa = int(subarrays[i])
                    if sa >= 0 and sa not in self.blacklist:
                        self.blacklist.add(sa)
                        self.stats.permanent_faults += 1
        return mask

    # -- blacklist ------------------------------------------------------------
    def is_blacklisted(self, subarray: int) -> bool:
        return subarray in self.blacklist

    def blacklisted_mask(self, subarrays: np.ndarray) -> np.ndarray:
        """Boolean mask of blacklisted entries (vectorized)."""
        sas = np.asarray(subarrays, dtype=np.int64)
        if not self.blacklist:
            return np.zeros(sas.shape, dtype=bool)
        bl = np.fromiter(self.blacklist, dtype=np.int64)
        return np.isin(sas, bl)

    def new_permanent_faults(self, known: Iterable[int]) -> Set[int]:
        """Blacklisted subarrays the caller has not yet quarantined."""
        return self.blacklist - set(known)

    # -- controller stalls ----------------------------------------------------
    def stall_ns(self) -> float:
        """Injected stall for one channel burst (0.0 = no stall)."""
        p = self.plan.channel_stall_rate
        if p and self.rng.random() < p:
            self.stats.channel_stalls += 1
            self.stats.stall_ns += self.plan.channel_stall_ns
            return self.plan.channel_stall_ns
        return 0.0
