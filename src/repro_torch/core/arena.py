"""PUMA on an accelerator: a tile-granular, arena-indexed device memory pool.

The device's HBM plays the role of the DRAM channel; we pre-allocate one
flat device buffer (the ``pim_preallocate`` analogue) and manage it host-side
as ``n_arenas`` arenas ("subarrays") of ``tiles_per_arena`` tiles ("rows").
A tile is the hardware-aligned unit — for KV-cache blocks a tile is one
(block_size, kv_heads, head_dim) page whose last two dims are (8,128)-lane
aligned; for bitplane buffers it is an (8,128) uint32 tile.

Placement policy is PUMA's, verbatim:

* ``alloc``       — worst-fit over arenas (ordered free-count array),
                    draining the emptiest arena in *contiguous slot runs*;
* ``alloc_align`` — walk a hint handle's tiles and co-locate tile *k* in the
                    same arena (adjacent slot when free), worst-fit fallback;
* handles live in a hashmap so later aligned allocations can find the hint.

Why it matters on the device: kernels that stream a handle's tiles (paged attention,
bulk copy/zero) issue one DMA descriptor per *contiguous run* of tile
indices.  PUMA placement maximizes run length exactly the way it maximizes
same-subarray residency in DRAM; the metric ``contiguous_run_fraction`` is
the device analogue of the paper's "% of operations executed in PUD".

Baseline policies (``first_fit``, ``random``) mirror malloc/hugepage for the
benchmark comparison.

Channel striping (``n_channels > 1``): arenas are assigned round-robin to
channels (``arena % n_channels`` — mirroring the DRAM global-subarray ID
being channel-innermost), and the PUMA ``alloc`` path stripes a request's
tiles across channels in contiguous per-channel chunks: round-robin over
channels, worst-fit arena *within* the channel.  Block tables then spread
across channels, so the channel-parallel PUD/DMA substrate sees balanced
per-channel load; :meth:`TilePool.channel_occupancy` reports the balance.
The default ``n_channels=1`` keeps the original single-pool behaviour
bit-for-bit.
"""
from __future__ import annotations

import bisect
import dataclasses
import heapq
import random
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence

from repro_torch.robustness.errors import DoubleFree
from repro_torch.robustness.faults import injected_alloc_miss

if TYPE_CHECKING:
    from repro_torch.robustness.faults import FaultInjector

__all__ = ["TileHandle", "PoolStats", "TilePool"]


@dataclasses.dataclass
class TileHandle:
    """A logical buffer: an ordered list of global tile indices."""

    hid: int
    tiles: List[int]          # global tile index = arena * tiles_per_arena + slot

    def __len__(self) -> int:
        return len(self.tiles)

    def runs(self) -> List[tuple]:
        """Maximal (start, length) runs of consecutive tile indices."""
        out = []
        i = 0
        while i < len(self.tiles):
            j = i
            while (
                j + 1 < len(self.tiles) and self.tiles[j + 1] == self.tiles[j] + 1
            ):
                j += 1
            out.append((self.tiles[i], j - i + 1))
            i = j + 1
        return out

    def contiguous_run_fraction(self) -> float:
        """Fraction of tile->tile transitions that stay contiguous.

        1.0 means the whole handle is one DMA descriptor; 0.0 means every
        tile needs its own gather — the device analogue of 0 % PUD execution.
        """
        if len(self.tiles) <= 1:
            return 1.0
        good = sum(
            1
            for a, b in zip(self.tiles, self.tiles[1:])
            if b == a + 1
        )
        return good / (len(self.tiles) - 1)


@dataclasses.dataclass
class PoolStats:
    allocs: int = 0
    frees: int = 0
    align_hits: int = 0
    align_misses: int = 0
    failed: int = 0
    injected_misses: int = 0   # transient misses forced by the fault injector


class TilePool:
    """Host-side allocator over a (n_arenas x tiles_per_arena) tile grid."""

    POLICIES = ("puma", "first_fit", "random")

    def __init__(
        self,
        n_arenas: int,
        tiles_per_arena: int,
        policy: str = "puma",
        seed: int = 0,
        n_channels: int = 1,
        injector: Optional["FaultInjector"] = None,
        journal=None,   # any object with append(kind, **fields)
    ):
        assert policy in self.POLICIES, policy
        assert n_channels >= 1 and n_arenas % n_channels == 0, (
            f"n_arenas={n_arenas} must be a multiple of n_channels={n_channels}"
        )
        self.n_arenas = n_arenas
        self.tiles_per_arena = tiles_per_arena
        self.policy = policy
        self.n_channels = n_channels
        self._next_channel = 0
        self.rng = random.Random(seed)
        # free slots per arena kept sorted ascending so contiguous runs pop
        # from the front; PUMA's ordered array is the lazy max-heap below.
        self._free: List[List[int]] = [
            list(range(tiles_per_arena)) for _ in range(n_arenas)
        ]
        self._heap: List[tuple] = [
            (-tiles_per_arena, a) for a in range(n_arenas)
        ]
        heapq.heapify(self._heap)
        # per-channel worst-fit heaps (arena % n_channels = owning channel)
        self._heap_ch: List[List[tuple]] = [
            [(-tiles_per_arena, a) for a in range(c, n_arenas, n_channels)]
            for c in range(n_channels)
        ]
        for h in self._heap_ch:
            heapq.heapify(h)
        self._handles: Dict[int, TileHandle] = {}
        self._next_hid = 1
        self.stats = PoolStats()
        #: fault injector consulted on alloc/extend (transient device-pool
        #: misses — what drives the serving engine's preemption path).
        self.injector = injector
        #: crash-consistency journal — records every alloc/extend/free
        #: outcome (actual tile placements) for forced bit-exact replay.
        self.journal = journal

    def _injected_miss(self) -> bool:
        """Shared hook — see :func:`repro_torch.robustness.faults.injected_alloc_miss`."""
        return injected_alloc_miss(self.injector, self.stats, "failed")

    # -- bookkeeping ---------------------------------------------------------
    @property
    def total_tiles(self) -> int:
        return self.n_arenas * self.tiles_per_arena

    def free_tiles(self) -> int:
        return sum(len(f) for f in self._free)

    def _push_count(self, arena: int) -> None:
        entry = (-len(self._free[arena]), arena)
        heapq.heappush(self._heap, entry)
        if self.n_channels > 1:
            heapq.heappush(self._heap_ch[arena % self.n_channels], entry)

    def _worst_fit_arena(self, channel: Optional[int] = None) -> Optional[int]:
        if channel is None or self.n_channels == 1:
            heap = self._heap
        else:
            heap = self._heap_ch[channel]
        while heap:
            neg, a = heap[0]
            if len(self._free[a]) == -neg and -neg > 0:
                return a
            heapq.heappop(heap)
        return None

    def _take_slot(self, arena: int, slot: Optional[int] = None) -> Optional[int]:
        free = self._free[arena]
        if not free:
            return None
        if slot is None:
            s = free.pop(0)
        else:
            # adjacent-slot request from alloc_align
            i = bisect.bisect_left(free, slot)
            if i == len(free) or free[i] != slot:
                return None
            free.pop(i)
            s = slot
        self._push_count(arena)
        return arena * self.tiles_per_arena + s

    def _runs_of(self, arena: int) -> List[tuple]:
        """(start_index_in_free, start_slot, length) maximal runs, ascending."""
        free = self._free[arena]
        out = []
        i = 0
        while i < len(free):
            j = i
            while j + 1 < len(free) and free[j + 1] == free[j] + 1:
                j += 1
            out.append((i, free[i], j - i + 1))
            i = j + 1
        return out

    def _take_run(self, arena: int, want: int) -> List[int]:
        """Run-aware take (beyond-paper refinement): prefer the smallest
        free run that satisfies ``want`` (best-fit over runs, so long runs
        survive for long allocations), else the longest available run."""
        runs = self._runs_of(arena)
        if not runs:
            return []
        fitting = [r for r in runs if r[2] >= want]
        idx, slot, length = (
            min(fitting, key=lambda r: r[2])
            if fitting
            else max(runs, key=lambda r: r[2])
        )
        n = min(want, length)
        del self._free[arena][idx : idx + n]
        self._push_count(arena)
        base = arena * self.tiles_per_arena
        return [base + slot + i for i in range(n)]

    def _global_to_arena(self, tile: int) -> int:
        return tile // self.tiles_per_arena

    def _register(self, tiles: List[int]) -> TileHandle:
        """Wrap freshly taken tiles in a live handle (+ journal the outcome)."""
        h = TileHandle(self._next_hid, tiles)
        self._next_hid += 1
        self._handles[h.hid] = h
        if self.journal is not None:
            self.journal.append("alloc", hid=h.hid, tiles=list(tiles))
        self.stats.allocs += 1
        return h

    # -- PUMA API ------------------------------------------------------------
    def alloc(self, n_tiles: int) -> Optional[TileHandle]:
        if self._injected_miss():
            return None
        if n_tiles > self.free_tiles():
            self.stats.failed += 1
            return None
        tiles: List[int] = []
        if self.policy == "puma":
            if self.n_channels > 1:
                # channel-striped PUMA: hand each channel a contiguous chunk
                # (round-robin over channels, worst-fit arena within), so the
                # handle's blocks spread evenly over the channel-parallel
                # substrate while each chunk stays one DMA descriptor.
                chunk = -(-n_tiles // self.n_channels)
                while len(tiles) < n_tiles:
                    got: List[int] = []
                    for _ in range(self.n_channels):
                        ch = self._next_channel
                        self._next_channel = (ch + 1) % self.n_channels
                        a = self._worst_fit_arena(channel=ch)
                        if a is None:
                            continue
                        got = self._take_run(a, min(chunk, n_tiles - len(tiles)))
                        if got:
                            break
                    if not got:  # cannot happen given the free_tiles gate
                        for t in tiles:
                            self._give_back(t)
                        self.stats.failed += 1
                        return None
                    tiles.extend(got)
            else:
                while len(tiles) < n_tiles:
                    a = self._worst_fit_arena()
                    got = self._take_run(a, n_tiles - len(tiles))
                    if not got:  # arena raced empty via stale heap entry
                        continue
                    tiles.extend(got)
        elif self.policy == "first_fit":
            for a in range(self.n_arenas):
                while len(tiles) < n_tiles:
                    t = self._take_slot(a)
                    if t is None:
                        break
                    tiles.append(t)
                if len(tiles) == n_tiles:
                    break
        else:  # random — models a fragmented generic allocator
            candidates = [
                a for a in range(self.n_arenas) if self._free[a]
            ]
            while len(tiles) < n_tiles:
                a = self.rng.choice(candidates)
                free = self._free[a]
                s = free.pop(self.rng.randrange(len(free)))
                self._push_count(a)
                tiles.append(a * self.tiles_per_arena + s)
                if not free:
                    candidates.remove(a)
        return self._register(tiles)

    def alloc_align(self, n_tiles: int, hint: TileHandle) -> Optional[TileHandle]:
        if hint.hid not in self._handles:
            self.stats.failed += 1
            return None
        if self._injected_miss():
            return None
        if n_tiles > self.free_tiles():
            self.stats.failed += 1
            return None
        tiles: List[int] = []
        for k in range(n_tiles):
            placed = None
            if k < len(hint.tiles):
                arena = self._global_to_arena(hint.tiles[k])
            elif tiles:
                # beyond the hint's length: stay local to the handle so far
                arena = self._global_to_arena(tiles[-1])
            else:
                arena = None
            if arena is not None:
                # strongest alignment: the *same slot offset* neighbourhood —
                # try the slot right after the previous placed tile first so
                # the new handle is itself contiguous, then any slot in the
                # hinted arena.
                if tiles and self._global_to_arena(tiles[-1]) == arena:
                    want = tiles[-1] % self.tiles_per_arena + 1
                    if want < self.tiles_per_arena:
                        placed = self._take_slot(arena, want)
                if placed is None:
                    placed = self._take_slot(arena)
                if placed is not None:
                    self.stats.align_hits += 1
            if placed is None:
                self.stats.align_misses += 1
                a = self._worst_fit_arena()
                if a is None:
                    for t in tiles:
                        self._give_back(t)
                    self.stats.failed += 1
                    return None
                placed = self._take_slot(a)
            tiles.append(placed)
        return self._register(tiles)

    def extend(self, handle: TileHandle, n_more: int = 1) -> bool:
        """Grow a live handle (KV-cache decode step): prefer the slot after
        the handle's last tile, then same arena, then worst-fit."""
        if handle.hid not in self._handles:
            return False
        if self._injected_miss():
            return False
        for _ in range(n_more):
            placed = None
            if handle.tiles:
                last = handle.tiles[-1]
                arena = self._global_to_arena(last)
                want = last % self.tiles_per_arena + 1
                if want < self.tiles_per_arena:
                    placed = self._take_slot(arena, want)
                if placed is None and self.policy == "puma":
                    placed = self._take_slot(arena)
                    if placed is not None:
                        self.stats.align_hits += 1
            if placed is None:
                if self.policy == "puma":
                    a = self._worst_fit_arena()
                    self.stats.align_misses += 1
                elif self.policy == "first_fit":
                    a = next(
                        (i for i in range(self.n_arenas) if self._free[i]), None
                    )
                else:
                    cand = [i for i in range(self.n_arenas) if self._free[i]]
                    a = self.rng.choice(cand) if cand else None
                if a is None:
                    return False
                if self.policy == "random":
                    free = self._free[a]
                    s = free.pop(self.rng.randrange(len(free)))
                    self._push_count(a)
                    placed = a * self.tiles_per_arena + s
                else:
                    placed = self._take_slot(a)
            handle.tiles.append(placed)
            if self.journal is not None:
                self.journal.append("extend", hid=handle.hid, tile=placed)
        return True

    def _give_back(self, tile: int) -> None:
        arena = self._global_to_arena(tile)
        slot = tile % self.tiles_per_arena
        free = self._free[arena]
        bisect.insort(free, slot)  # keep sorted so runs pop from the front
        self._push_count(arena)

    def free(self, handle: TileHandle) -> None:
        if handle.hid not in self._handles:
            raise DoubleFree(f"handle {handle.hid} is not live", hid=handle.hid)
        del self._handles[handle.hid]
        for t in handle.tiles:
            self._give_back(t)
        if self.journal is not None:
            self.journal.append("free", hid=handle.hid)
        self.stats.frees += 1

    # -- metrics ---------------------------------------------------------------
    def channel_occupancy(self) -> Dict[str, object]:
        """Per-channel used/free tile counts + load balance.

        ``balance`` is mean/max of per-channel used tiles (1.0 = perfectly
        striped block tables, 1/C = all live blocks on one channel).
        """
        used = [0] * self.n_channels
        free = [0] * self.n_channels
        for a, fr in enumerate(self._free):
            c = a % self.n_channels
            free[c] += len(fr)
            used[c] += self.tiles_per_arena - len(fr)
        mx = max(used) if used else 0
        balance = (sum(used) / len(used)) / mx if mx > 0 else 1.0
        return {
            "channels": self.n_channels,
            "used_tiles": used,
            "free_tiles": free,
            "balance": float(balance),
        }

    def fragmentation(self) -> float:
        """1 - (largest free run / total free) across the pool."""
        total = self.free_tiles()
        if total == 0:
            return 0.0
        best = 0
        for a, free in enumerate(self._free):
            run = 0
            prev = None
            for s in free:
                run = run + 1 if prev is not None and s == prev + 1 else 1
                best = max(best, run)
                prev = s
        return 1.0 - best / total
