"""Structural invariant audits for the PUMA allocation stack.

Each ``check_*`` function walks one layer's bookkeeping and cross-checks the
redundant views against each other — free lists vs. running totals vs. stats
counters vs. live-allocation extents — returning an :class:`InvariantReport`.
They are *read-only* and cheap enough to run after every injected fault in
the chaos suite, which is exactly how the property/chaos tests use them:
inject, audit, continue.

The conservation law for the PUD pool (with fault quarantine):

    preallocated == free + in_use + quarantined

i.e. a region handed to the allocator is always in exactly one of the three
states; a violation means a leak (region vanished) or a double-free / overlap
(region counted twice).
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, List

import numpy as np

from repro_torch.robustness.errors import InvariantViolation

if TYPE_CHECKING:
    from repro_torch.core.arena import TilePool
    from repro_torch.core.kv_pool import PagedKVPool
    from repro_torch.core.puma import PumaAllocator

__all__ = [
    "InvariantReport",
    "check_allocator",
    "check_tile_pool",
    "check_kv_pool",
    "check_engine",
]


@dataclasses.dataclass
class InvariantReport:
    subject: str
    checked: int = 0
    violations: List[str] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations

    def _check(self, cond: bool, msg: str) -> None:
        self.checked += 1
        if not cond:
            self.violations.append(msg)

    def assert_ok(self) -> "InvariantReport":
        if self.violations:
            raise InvariantViolation(
                f"{self.subject}: {len(self.violations)} invariant violation(s): "
                + "; ".join(self.violations[:5]),
                subject=self.subject,
                n_violations=len(self.violations),
            )
        return self


# ---------------------------------------------------------------------------
# PUD-pool allocator (core/puma.py)
# ---------------------------------------------------------------------------

def check_allocator(al: "PumaAllocator") -> InvariantReport:
    """Audit a :class:`~repro_torch.core.puma.PumaAllocator`:

    * free-list / heap / per-channel totals agree;
    * free, in-use, and quarantined region PAs are region-aligned and
      pairwise disjoint (no overlap, no double-free);
    * allocation extents mirror the region lists exactly (the re-mmap view);
    * no free region sits in a blacklisted subarray;
    * conservation: preallocated == free + in_use + quarantined.
    """
    rep = InvariantReport(subject="PumaAllocator")
    rb = al.region_bytes
    ordered = al._ordered

    free_pas: List[int] = []
    for sa, lst in ordered.free.items():
        free_pas.extend(lst)
        rep._check(
            sa not in al._blacklisted or not lst,
            f"blacklisted subarray {sa} still has {len(lst)} free regions",
        )
    rep._check(
        len(free_pas) == ordered.total_free(),
        f"free-list size {len(free_pas)} != running total {ordered.total_free()}",
    )
    rep._check(
        sum(ordered.channel_free()) == ordered.total_free(),
        "per-channel free totals do not sum to the global total",
    )

    in_use: List[int] = []
    for va, regions in al._regions_of.items():
        in_use.extend(regions)
        alloc = al._allocations.get(va)
        rep._check(alloc is not None, f"region list for va {va:#x} has no allocation")
        if alloc is None:
            continue
        # extents are coalesced (PA-adjacent merge), so audit the *mapping*:
        # contiguous VA coverage of the padded size, and region k translating
        # to the k-th region PA.
        covered = 0
        for e in alloc.extents:
            rep._check(
                e.va_off == covered,
                f"va {va:#x}: VA hole or overlap at offset {e.va_off}",
            )
            covered = e.va_off + e.nbytes
        rep._check(
            covered == len(regions) * rb,
            f"va {va:#x}: extents cover {covered} bytes, "
            f"expected {len(regions) * rb}",
        )
        try:
            translates = all(
                alloc.pa_of(i * rb) == pa for i, pa in enumerate(regions)
            )
        except ValueError:  # region list longer than the mapping: corrupt
            translates = False
        rep._check(
            translates,
            f"va {va:#x}: extent translation diverges from the region list",
        )
        rep._check(
            len(regions) * rb >= alloc.size,
            f"va {va:#x}: {len(regions)} regions cannot back {alloc.size} bytes",
        )
    rep._check(
        len(al._allocations) == len(al._regions_of),
        "allocation hashmap and region map disagree on live allocations",
    )
    rep._check(
        al.stats.live_allocations == len(al._allocations),
        f"stats.live_allocations={al.stats.live_allocations} != "
        f"{len(al._allocations)} live entries",
    )
    rep._check(
        al.stats.regions_in_use == len(in_use),
        f"stats.regions_in_use={al.stats.regions_in_use} != {len(in_use)}",
    )
    rep._check(
        int(al._used_per_channel.sum()) == len(in_use),
        "per-channel used counters do not sum to the in-use region count",
    )

    quarantined = list(al._quarantined)
    everything = free_pas + in_use + quarantined
    rep._check(
        all(pa % rb == 0 for pa in everything),
        "region PA not region-aligned",
    )
    rep._check(
        len(set(everything)) == len(everything),
        "region PA appears in more than one state (overlap / double-count)",
    )
    rep._check(
        al.stats.quarantined_regions == len(quarantined),
        f"stats.quarantined_regions={al.stats.quarantined_regions} != "
        f"{len(quarantined)}",
    )
    rep._check(
        al.stats.preallocated_regions
        == len(free_pas) + len(in_use) + len(quarantined),
        f"conservation broken: preallocated={al.stats.preallocated_regions} != "
        f"free={len(free_pas)} + in_use={len(in_use)} + "
        f"quarantined={len(quarantined)}",
    )
    # live regions must not remain on blacklisted subarrays (remap completeness)
    if al._blacklisted and in_use:
        sas = al.amap.region_subarrays(np.asarray(in_use, np.int64))
        bl = np.fromiter(al._blacklisted, dtype=np.int64)
        rep._check(
            not np.isin(sas, bl).any(),
            "live region still mapped to a blacklisted subarray",
        )
    return rep


# ---------------------------------------------------------------------------
# Device tile pool (core/arena.py)
# ---------------------------------------------------------------------------

def check_tile_pool(pool: "TilePool") -> InvariantReport:
    """Audit a :class:`~repro_torch.core.arena.TilePool`: free lists sorted and
    in-range, live handles disjoint from the free set and from each other,
    and conservation free + used == total."""
    rep = InvariantReport(subject="TilePool")
    tpa = pool.tiles_per_arena

    free_tiles: List[int] = []
    for a, lst in enumerate(pool._free):
        rep._check(
            all(0 <= s < tpa for s in lst),
            f"arena {a}: free slot out of range",
        )
        rep._check(
            all(x < y for x, y in zip(lst, lst[1:])),
            f"arena {a}: free list not strictly sorted (duplicate slot?)",
        )
        free_tiles.extend(a * tpa + s for s in lst)

    used_tiles: List[int] = []
    for hid, h in pool._handles.items():
        rep._check(h.hid == hid, f"handle {hid}: hid mismatch")
        rep._check(
            all(0 <= t < pool.total_tiles for t in h.tiles),
            f"handle {hid}: tile index out of range",
        )
        used_tiles.extend(h.tiles)

    rep._check(
        len(set(used_tiles)) == len(used_tiles),
        "tile owned by two handles (overlap) or twice by one",
    )
    rep._check(
        not set(free_tiles) & set(used_tiles),
        "tile simultaneously free and owned by a live handle",
    )
    rep._check(
        len(free_tiles) + len(used_tiles) == pool.total_tiles,
        f"conservation broken: free={len(free_tiles)} + used={len(used_tiles)} "
        f"!= total={pool.total_tiles} (leaked tiles)",
    )
    return rep


# ---------------------------------------------------------------------------
# Paged KV pool + serving engine (core/kv_pool.py, serve/engine.py)
# ---------------------------------------------------------------------------

def check_kv_pool(kv: "PagedKVPool") -> InvariantReport:
    """Audit a :class:`~repro_torch.core.kv_pool.PagedKVPool`: the underlying tile
    pool plus slot bookkeeping and block tables."""
    rep = check_tile_pool(kv.pool)
    rep.subject = "PagedKVPool"
    cfg = kv.cfg

    slots = set(kv._seqs)
    free_slots = list(kv._free_slots)
    rep._check(
        len(set(free_slots)) == len(free_slots), "duplicate free seq slot"
    )
    rep._check(
        not slots & set(free_slots), "seq slot both live and free"
    )
    rep._check(
        len(slots) + len(free_slots) == cfg.max_seqs,
        f"slot conservation broken: live={len(slots)} + free={len(free_slots)} "
        f"!= max_seqs={cfg.max_seqs}",
    )
    for slot, (h, ntok) in kv._seqs.items():
        rep._check(
            h.hid in kv.pool._handles,
            f"slot {slot}: handle {h.hid} not live in the tile pool",
        )
        rep._check(
            0 <= ntok <= len(h.tiles) * cfg.block_size,
            f"slot {slot}: {ntok} tokens exceed {len(h.tiles)} blocks",
        )
    tbl = kv.block_table()
    rep._check(
        int(tbl.max(initial=-1)) < cfg.num_blocks,
        "block table references a block beyond the pool",
    )
    return rep


def check_engine(eng) -> InvariantReport:
    """Audit a :class:`~repro_torch.serve.engine.ServeEngine`: the KV pool plus
    request accounting — every submitted request is in exactly one of
    queued / live / done / rejected / cancelled (zero silent drops).

    Requests injected directly into ``eng.live`` (bypassing ``submit``, as
    the fork test does) break the submitted-count identity; use this checker
    on engines driven through the public API.
    """
    rep = check_kv_pool(eng.pool)
    rep.subject = "ServeEngine"

    accounted = (
        len(eng.queue) + len(eng.live) + len(eng.done)
        + len(eng.rejected) + len(eng.cancelled)
    )
    rep._check(
        eng.submitted == accounted,
        f"request accounting broken: submitted={eng.submitted} != "
        f"queued={len(eng.queue)} + live={len(eng.live)} + done={len(eng.done)} "
        f"+ rejected={len(eng.rejected)} + cancelled={len(eng.cancelled)}",
    )
    for slot, req in eng.live.items():
        rep._check(req.slot == slot, f"rid {req.rid}: slot field diverges")
        rep._check(
            req.status == "running", f"rid {req.rid}: live but {req.status!r}"
        )
        rep._check(
            slot in eng.pool._seqs,
            f"rid {req.rid}: live without KV blocks (slot {slot})",
        )
    for req in eng.queue:
        rep._check(
            req.status == "queued", f"rid {req.rid}: queued but {req.status!r}"
        )
        rep._check(req.slot is None, f"rid {req.rid}: queued but holds a slot")
    for name, lst, want in (
        ("done", eng.done, "done"),
        ("rejected", eng.rejected, "rejected"),
        ("cancelled", eng.cancelled, "cancelled"),
    ):
        for req in lst:
            rep._check(
                req.status == want, f"rid {req.rid}: in {name} but {req.status!r}"
            )
            if want != "done":
                rep._check(
                    req.error is not None,
                    f"rid {req.rid}: {name} without a recorded error (silent drop)",
                )
    return rep
