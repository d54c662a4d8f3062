"""Crash-consistent allocator journaling.

An append-only :class:`Journal` records the *outcome* of every state-changing
operation on a pool allocator — which physical regions an allocation actually
received, which tiles a handle actually got, which rows a blacklist remap or
a compaction pass actually moved.  Because outcomes (not requests) are
logged, replay is **forced**: it re-applies the recorded placements through
specific-take primitives (:meth:`_OrderedArray.take_specific`,
:meth:`TilePool._take_slot`) instead of re-running worst-fit, so the rebuilt
state is bit-exact regardless of heap tie-breaks, lazy-heap staleness, or
RNG state — the property the CI churn gate asserts.

Crash model: a crash truncates the log at an arbitrary event boundary
(events are atomic; a torn event is treated as absent, like a WAL record
without its commit).  :meth:`Journal.crash_copy` produces the truncated
survivor; :func:`replay_allocator` / :func:`replay_pool` /
:func:`replay_kv_pool` rebuild the pre-crash state, which must then pass
every auditor in :mod:`repro_torch.robustness.invariants` — that round trip is
what "crash-consistent" means here.

Snapshots bound replay cost on long-horizon churn: :meth:`Journal.snapshot`
captures a full serialized state (see :func:`snapshot_allocator` /
:func:`snapshot_pool`) and truncates the log; replay restores the snapshot
and applies only the tail.  ``to_json``/``from_json`` round-trip the whole
journal through plain JSON for on-disk persistence.

This module is runtime-dependency-free with respect to ``repro_torch.core`` (the
core pools import *us* for type hints only); every core import here is
deferred into the replay/snapshot functions, mirroring how
:mod:`repro_torch.robustness.invariants` stays acyclic.
"""
from __future__ import annotations

import dataclasses
import json
from typing import TYPE_CHECKING, Any, Dict, List, Optional

import numpy as np

from repro_torch.robustness.errors import JournalReplayError

if TYPE_CHECKING:
    from repro_torch.core.arena import TilePool
    from repro_torch.core.kv_pool import KVPoolConfig, PagedKVPool
    from repro_torch.core.puma import PumaAllocator

__all__ = [
    "Event",
    "Journal",
    "snapshot_allocator",
    "restore_allocator",
    "snapshot_pool",
    "restore_pool",
    "replay_allocator",
    "replay_pool",
    "replay_kv_pool",
    "allocator_digest",
    "pool_digest",
    "kv_pool_digest",
]


@dataclasses.dataclass(frozen=True)
class Event:
    """One durable log record: an operation *outcome*."""

    seq: int
    kind: str
    data: Dict[str, Any]

    def to_obj(self) -> Dict[str, Any]:
        return {"seq": self.seq, "kind": self.kind, **self.data}

    @staticmethod
    def from_obj(obj: Dict[str, Any]) -> "Event":
        d = dict(obj)
        return Event(seq=d.pop("seq"), kind=d.pop("kind"), data=d)


class Journal:
    """Append-only event log with optional snapshot base.

    One journal instance is attached to one subject (a ``PumaAllocator``, a
    ``TilePool``, or a ``PagedKVPool`` — the KV pool shares its journal with
    its inner tile pool, interleaving slot-level and tile-level events in
    one totally ordered log).
    """

    def __init__(self):
        self.base: Optional[Dict[str, Any]] = None   # snapshot state, if any
        self.base_seq: int = 0          # events before this seq are folded in
        self.events: List[Event] = []
        self._next_seq = 0

    def __len__(self) -> int:
        return len(self.events)

    def append(self, kind: str, **data: Any) -> Event:
        ev = Event(self._next_seq, kind, data)
        self._next_seq += 1
        self.events.append(ev)
        return ev

    # -- snapshot / truncation ------------------------------------------------
    def snapshot(self, state: Dict[str, Any]) -> None:
        """Install ``state`` as the new replay base and truncate the log —
        the WAL-checkpoint analogue.  Replay cost after this is O(tail)."""
        self.base = state
        self.base_seq = self._next_seq
        self.events = []

    # -- crash model ----------------------------------------------------------
    def crash_copy(self, keep_events: int) -> "Journal":
        """The journal a crash would leave behind: the snapshot base plus the
        first ``keep_events`` tail events (atomic-event truncation)."""
        j = Journal()
        j.base = json.loads(json.dumps(self.base)) if self.base else None
        j.base_seq = self.base_seq
        j.events = list(self.events[:keep_events])
        j._next_seq = j.events[-1].seq + 1 if j.events else j.base_seq
        return j

    # -- persistence ----------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({
            "base": self.base,
            "base_seq": self.base_seq,
            "events": [e.to_obj() for e in self.events],
        })

    @staticmethod
    def from_json(text: str) -> "Journal":
        obj = json.loads(text)
        j = Journal()
        j.base = obj["base"]
        j.base_seq = obj["base_seq"]
        j.events = [Event.from_obj(e) for e in obj["events"]]
        j._next_seq = j.events[-1].seq + 1 if j.events else j.base_seq
        return j


def _need(cond: bool, msg: str, **ctx: Any) -> None:
    if not cond:
        raise JournalReplayError(msg, **ctx)


# ---------------------------------------------------------------------------
# PumaAllocator: snapshot / restore / forced replay
# ---------------------------------------------------------------------------

def snapshot_allocator(al: "PumaAllocator") -> Dict[str, Any]:
    """Serialize the durable state of a :class:`PumaAllocator`.

    Only conservation-relevant state is captured (free lists, live
    allocations, quarantine, blacklist, the counters the auditors check).
    QoS-only counters (align hits/misses, failed/injected counts) are
    telemetry, not state — they restore to zero.
    """
    return {
        "subject": "PumaAllocator",
        "free": [[int(sa), [int(pa) for pa in lst]]
                 for sa, lst in sorted(al._ordered.free.items()) if lst],
        "allocs": [[int(va), int(al._allocations[va].size),
                    [int(pa) for pa in regions]]
                   for va, regions in sorted(al._regions_of.items())],
        "quarantined": [int(pa) for pa in al._quarantined],
        "blacklisted": sorted(int(sa) for sa in al._blacklisted),
        "va_next": int(al._va_next),
        "preallocated": int(al.stats.preallocated_regions),
    }


def restore_allocator(
    state: Dict[str, Any],
    mem,
    *,
    amap=None,
    stripe_channels: bool = False,
) -> "PumaAllocator":
    """Rebuild a :class:`PumaAllocator` from a snapshot onto fresh ``mem``.

    Huge pages covering any region the snapshot owns are withdrawn from
    ``mem.free_huge`` so a post-restore ``pim_preallocate`` cannot hand the
    same physical rows out twice.
    """
    from repro_torch.core.allocators import HUGE_PAGE, Allocation, Extent
    from repro_torch.core.puma import PumaAllocator

    _need(state.get("subject") == "PumaAllocator",
          f"snapshot subject {state.get('subject')!r} is not a PumaAllocator")
    al = PumaAllocator(mem, amap, stripe_channels=stripe_channels)
    rb = al.region_bytes

    owned: List[int] = []
    for sa, lst in state["free"]:
        for pa in lst:
            al._ordered.add_region(int(sa), int(pa))
            owned.append(int(pa))
    for va, size, regions in state["allocs"]:
        extents = [Extent(i * rb, int(pa), rb) for i, pa in enumerate(regions)]
        alloc = Allocation(int(va), int(size), extents, al.name)
        al._allocations[int(va)] = alloc
        al._regions_of[int(va)] = [int(pa) for pa in regions]
        owned.extend(int(pa) for pa in regions)
        al.stats.live_allocations += 1
        al.stats.regions_in_use += len(regions)
        if al.n_channels > 1:
            al._used_per_channel += np.bincount(
                al.amap.region_channels(np.asarray(regions, np.int64)),
                minlength=al.n_channels,
            )
        else:
            al._used_per_channel[0] += len(regions)
    al._quarantined = [int(pa) for pa in state["quarantined"]]
    owned.extend(al._quarantined)
    al.stats.quarantined_regions = len(al._quarantined)
    al._blacklisted = set(int(sa) for sa in state["blacklisted"])
    al._va_next = int(state["va_next"])
    al.stats.preallocated_regions = int(state["preallocated"])

    hps = {pa - pa % HUGE_PAGE for pa in owned}
    mem.free_huge = [pa for pa in mem.free_huge if pa not in hps]
    return al


def _force_take_region(al: "PumaAllocator", pa: int) -> int:
    sa = int(al.amap.region_subarrays(np.asarray([pa], np.int64))[0])
    _need(al._ordered.take_specific(sa, pa),
          f"region {pa:#x} (subarray {sa}) not free at replay", pa=pa, sa=sa)
    return sa


def _shift_channel(al: "PumaAllocator", old_pa: int, new_pa: int) -> None:
    if al.n_channels > 1:
        chs = al.amap.region_channels(np.asarray([old_pa, new_pa], np.int64))
        al._used_per_channel[int(chs[0])] -= 1
        al._used_per_channel[int(chs[1])] += 1


def _rebuild_extents(al: "PumaAllocator", va: int) -> None:
    from repro_torch.core.allocators import Extent

    rb = al.region_bytes
    alloc = al._allocations[va]
    alloc.extents = [
        Extent(i * rb, pa, rb) for i, pa in enumerate(al._regions_of[va])
    ]
    alloc.__post_init__()


def apply_allocator_event(al: "PumaAllocator", ev: Event) -> None:
    """Force one journal event onto ``al`` (replay primitive).

    Kinds: ``prealloc`` / ``alloc`` / ``free`` / ``blacklist`` / ``compact``.
    """
    from repro_torch.core.allocators import HUGE_PAGE, Allocation, Extent

    rb = al.region_bytes
    d = ev.data
    if ev.kind == "prealloc":
        hps = [int(pa) for pa in d["hps"]]
        want = set(hps)
        al.mem.free_huge = [pa for pa in al.mem.free_huge if pa not in want]
        per_hp = np.arange(HUGE_PAGE // rb, dtype=np.int64) * rb
        rpas = (np.asarray(hps, dtype=np.int64)[:, None] + per_hp).ravel()
        sas = al.amap.region_subarrays(rpas)
        al.stats.preallocated_regions += len(rpas)
        if al._blacklisted:
            bl = np.fromiter(al._blacklisted, dtype=np.int64)
            bad = np.isin(sas, bl)
            if bad.any():
                al._quarantined.extend(rpas[bad].tolist())
                al.stats.quarantined_regions += int(bad.sum())
                rpas, sas = rpas[~bad], sas[~bad]
        al._ordered.add_regions(sas, rpas)
    elif ev.kind == "alloc":
        va, size = int(d["va"]), int(d["size"])
        regions = [int(pa) for pa in d["regions"]]
        for pa in regions:
            _force_take_region(al, pa)
        extents = [Extent(i * rb, pa, rb) for i, pa in enumerate(regions)]
        al._allocations[va] = Allocation(va, size, extents, al.name)
        al._regions_of[va] = regions
        al._va_next = max(al._va_next, va + len(regions) * rb)
        al.stats.live_allocations += 1
        al.stats.regions_in_use += len(regions)
        if al.n_channels > 1:
            al._used_per_channel += np.bincount(
                al.amap.region_channels(np.asarray(regions, np.int64)),
                minlength=al.n_channels,
            )
        else:
            al._used_per_channel[0] += len(regions)
    elif ev.kind == "free":
        va = int(d["va"])
        _need(va in al._allocations, f"free of unknown va {va:#x}", va=va)
        regions = al._regions_of.pop(va)
        del al._allocations[va]
        al._release(regions)
        al.stats.live_allocations -= 1
        al.stats.regions_in_use -= len(regions)
    elif ev.kind == "blacklist":
        sa = int(d["sa"])
        al._blacklisted.add(sa)
        for pa in d["drained"]:
            _need(al._ordered.take_specific(sa, int(pa)),
                  f"drained region {int(pa):#x} not free at replay", pa=pa)
            al._quarantined.append(int(pa))
            al.stats.quarantined_regions += 1
        touched = set()
        for va, k, old_pa, new_pa in d["remaps"]:
            va, k, old_pa, new_pa = int(va), int(k), int(old_pa), int(new_pa)
            regions = al._regions_of.get(va)
            _need(regions is not None and regions[k] == old_pa,
                  f"remap target mismatch at va {va:#x}[{k}]", va=va, k=k)
            _force_take_region(al, new_pa)
            regions[k] = new_pa
            al._quarantined.append(old_pa)
            al.stats.quarantined_regions += 1
            al.stats.remapped_regions += 1
            _shift_channel(al, old_pa, new_pa)
            touched.add(va)
        for va in touched:
            _rebuild_extents(al, va)
    elif ev.kind == "compact":
        touched = set()
        for va, k, old_pa, new_pa in d["moves"]:
            va, k, old_pa, new_pa = int(va), int(k), int(old_pa), int(new_pa)
            regions = al._regions_of.get(va)
            _need(regions is not None and regions[k] == old_pa,
                  f"compaction move mismatch at va {va:#x}[{k}]", va=va, k=k)
            _force_take_region(al, new_pa)
            regions[k] = new_pa
            old_sa = int(al.amap.region_subarrays(
                np.asarray([old_pa], np.int64))[0])
            al._ordered.add_region(old_sa, old_pa)
            _shift_channel(al, old_pa, new_pa)
            touched.add(va)
        for va in touched:
            _rebuild_extents(al, va)
    else:
        raise JournalReplayError(
            f"unknown allocator journal event {ev.kind!r}", kind=ev.kind
        )


def replay_allocator(
    journal: Journal,
    mem,
    *,
    amap=None,
    stripe_channels: bool = False,
) -> "PumaAllocator":
    """Rebuild a :class:`PumaAllocator` from a (possibly crash-truncated)
    journal: restore the snapshot base if present, then force-apply the tail.

    ``mem`` must be a *fresh* :class:`PhysicalMemory` built with the same
    geometry/seed as the original machine (its huge-page pool is consumed as
    recorded ``prealloc`` events replay).
    """
    from repro_torch.core.puma import PumaAllocator

    if journal.base is not None:
        al = restore_allocator(
            journal.base, mem, amap=amap, stripe_channels=stripe_channels
        )
    else:
        al = PumaAllocator(mem, amap, stripe_channels=stripe_channels)
    for ev in journal.events:
        apply_allocator_event(al, ev)
    return al


def allocator_digest(al: "PumaAllocator") -> str:
    """Canonical JSON digest of an allocator's durable state — two
    allocators with equal digests are bit-identical for every auditor and
    every future placement decision."""
    return json.dumps(snapshot_allocator(al), sort_keys=True)


# ---------------------------------------------------------------------------
# TilePool: snapshot / restore / forced replay
# ---------------------------------------------------------------------------

def snapshot_pool(pool: "TilePool") -> Dict[str, Any]:
    """Serialize the durable state of a :class:`TilePool`."""
    return {
        "subject": "TilePool",
        "geometry": [pool.n_arenas, pool.tiles_per_arena,
                     pool.policy, pool.n_channels],
        "free": [[int(s) for s in lst] for lst in pool._free],
        "handles": [[int(hid), [int(t) for t in h.tiles]]
                    for hid, h in sorted(pool._handles.items())],
        "next_hid": int(pool._next_hid),
    }


def restore_pool(state: Dict[str, Any], seed: int = 0) -> "TilePool":
    from repro_torch.core.arena import TileHandle, TilePool

    _need(state.get("subject") == "TilePool",
          f"snapshot subject {state.get('subject')!r} is not a TilePool")
    n_arenas, tpa, policy, n_channels = state["geometry"]
    pool = TilePool(n_arenas, tpa, policy, seed=seed, n_channels=n_channels)
    pool._free = [[int(s) for s in lst] for lst in state["free"]]
    for a in range(n_arenas):
        pool._push_count(a)
    for hid, tiles in state["handles"]:
        pool._handles[int(hid)] = TileHandle(int(hid), [int(t) for t in tiles])
    pool._next_hid = int(state["next_hid"])
    return pool


def _force_take_tile(pool: "TilePool", tile: int) -> None:
    arena, slot = divmod(int(tile), pool.tiles_per_arena)
    _need(pool._take_slot(arena, slot) == tile,
          f"tile {tile} (arena {arena}, slot {slot}) not free at replay",
          tile=tile)


def apply_pool_event(pool: "TilePool", ev: Event) -> None:
    """Force one journal event onto a tile pool.

    Kinds: ``alloc`` / ``extend`` / ``free`` / ``compact``.
    """
    from repro_torch.core.arena import TileHandle

    d = ev.data
    if ev.kind == "alloc":
        hid = int(d["hid"])
        tiles = [int(t) for t in d["tiles"]]
        for t in tiles:
            _force_take_tile(pool, t)
        pool._handles[hid] = TileHandle(hid, tiles)
        pool._next_hid = max(pool._next_hid, hid + 1)
        pool.stats.allocs += 1
    elif ev.kind == "extend":
        hid, tile = int(d["hid"]), int(d["tile"])
        _need(hid in pool._handles, f"extend of dead handle {hid}", hid=hid)
        _force_take_tile(pool, tile)
        pool._handles[hid].tiles.append(tile)
    elif ev.kind == "free":
        hid = int(d["hid"])
        _need(hid in pool._handles, f"free of dead handle {hid}", hid=hid)
        h = pool._handles.pop(hid)
        for t in h.tiles:
            pool._give_back(t)
        pool.stats.frees += 1
    elif ev.kind == "compact":
        for hid, k, old, new in d["moves"]:
            hid, k, old, new = int(hid), int(k), int(old), int(new)
            h = pool._handles.get(hid)
            _need(h is not None and h.tiles[k] == old,
                  f"compaction move mismatch at handle {hid}[{k}]", hid=hid)
            _force_take_tile(pool, new)
            h.tiles[k] = new
            pool._give_back(old)
    else:
        raise JournalReplayError(
            f"unknown pool journal event {ev.kind!r}", kind=ev.kind
        )


def replay_pool(journal: Journal, seed: int = 0, **pool_kwargs) -> "TilePool":
    """Rebuild a :class:`TilePool` from its journal.

    Without a snapshot base the journal must open with geometry-bearing
    events recorded by a journaled pool; pass ``pool_kwargs``
    (``n_arenas``/``tiles_per_arena``/``policy``/``n_channels``) to seed the
    empty pool in that case.
    """
    from repro_torch.core.arena import TilePool

    if journal.base is not None:
        pool = restore_pool(journal.base, seed=seed)
    else:
        pool = TilePool(seed=seed, **pool_kwargs)
    for ev in journal.events:
        apply_pool_event(pool, ev)
    return pool


def pool_digest(pool: "TilePool") -> str:
    return json.dumps(snapshot_pool(pool), sort_keys=True)


# ---------------------------------------------------------------------------
# PagedKVPool: forced replay of the interleaved tile + slot log
# ---------------------------------------------------------------------------

def replay_kv_pool(
    journal: Journal, cfg: "KVPoolConfig", *, device="cuda"
) -> "PagedKVPool":
    """Rebuild the *bookkeeping* of a :class:`PagedKVPool` (slot map, block
    tables, tile pool) from its journal.  Device KV buffers (on ``device``)
    restore to zeros — the journal is an allocator WAL, not a data log;
    callers that need the bytes re-run prefill, exactly like a serving
    engine recovering its cache after a restart.

    The KV pool shares one journal with its inner tile pool, so tile-level
    kinds (``alloc``/``extend``/``free``/``compact``) interleave with
    slot-level kinds (``kv_admit``/``kv_fork``/``kv_append``/``kv_release``)
    in one total order.
    """
    from repro_torch.core.kv_pool import PagedKVPool

    kv = PagedKVPool(cfg, device=device)
    pool = kv.pool
    for ev in journal.events:
        d = ev.data
        if ev.kind in ("alloc", "extend", "free", "compact"):
            apply_pool_event(pool, ev)
        elif ev.kind in ("kv_admit", "kv_fork"):
            slot, hid, ntok = int(d["slot"]), int(d["hid"]), int(d["ntok"])
            _need(hid in pool._handles,
                  f"{ev.kind} references dead handle {hid}", hid=hid)
            _need(slot in kv._free_slots,
                  f"{ev.kind} into occupied slot {slot}", slot=slot)
            kv._free_slots.remove(slot)
            kv._seqs[slot] = (pool._handles[hid], ntok)
        elif ev.kind == "kv_append":
            slot = int(d["slot"])
            _need(slot in kv._seqs, f"kv_append to dead slot {slot}", slot=slot)
            h, ntok = kv._seqs[slot]
            kv._seqs[slot] = (h, ntok + 1)
        elif ev.kind == "kv_release":
            slot = int(d["slot"])
            _need(slot in kv._seqs, f"kv_release of dead slot {slot}", slot=slot)
            kv._seqs.pop(slot)
            kv._free_slots.append(slot)
        else:
            raise JournalReplayError(
                f"unknown KV journal event {ev.kind!r}", kind=ev.kind
            )
    return kv


def kv_pool_digest(kv: "PagedKVPool") -> str:
    state = {
        "pool": snapshot_pool(kv.pool),
        "seqs": [[int(slot), int(h.hid), int(ntok)]
                 for slot, (h, ntok) in sorted(kv._seqs.items())],
        "free_slots": sorted(int(s) for s in kv._free_slots),
    }
    return json.dumps(state, sort_keys=True)
