"""RowClone-priced compaction engine.

Long-horizon churn fragments both pools this repo models:

* the **PUD region pool** (:class:`~repro_torch.core.puma.PumaAllocator`) — free
  capacity spreads thin across subarrays, so ``pim_alloc_align`` degrades to
  worst-fit misses and fresh operand pairs stop co-locating (the
  ``fragmentation()``/PUD-executable-fraction decay the churn benchmark
  records);
* the **device tile pool** (:class:`~repro_torch.core.arena.TilePool`) — handle
  tile lists fracture into short runs, so block tables need more DMA
  descriptors (``contiguous_run_fraction`` decay).

Compaction migrates live data to repair both.  Every move is priced through
:func:`repro_torch.core.pud.price_migration`: a move whose source and destination
share a subarray/arena is a RowClone FPM row copy the substrate executes in
DRAM; a cross-subarray move is a host streaming copy (the substrate cannot
FPM across subarrays), plus its cacheline traffic on the channel
controllers.  With a :class:`~repro_torch.core.controller.DramController` passed
in, the pass occupies the channel frontiers — background maintenance
competes with live traffic, which is how :mod:`repro_torch.serve.engine` accounts
it.

Planning is separated from execution:

* ``plan_*`` are pure functions over a frozen pool state.  They choose
  **collector** subarrays/arenas (the ones worth emptying: largest
  ``free + live`` capacity) and evacuate their live rows into **dump**
  subarrays with the least free capacity, so free capacity re-concentrates;
  the tile planner additionally runs an intra-arena **run-repair** phase
  first (RowClone-cheap) that re-knits fractured handle runs.  Destination
  slots are drawn only from the pass-initial free set and never reused, so
  the whole plan is batch-safe: sources and destinations are disjoint sets
  and one gathered copy executes every move bit-exactly.
* ``compact_*`` execute a plan: forced specific-takes (the same primitives
  journal replay uses), optional byte movement on a modeled physical
  memory, a single ``compact`` journal event recording the executed moves,
  and a :class:`~repro_torch.core.pud.MigrationCost` for the time the pass cost.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.robustness.errors import JournalReplayError

if TYPE_CHECKING:
    from repro_torch.core.arena import TilePool
    from repro_torch.core.controller import DramController
    from repro_torch.core.pud import MigrationCost, PudCostModel
    from repro_torch.core.puma import PumaAllocator

__all__ = [
    "Move",
    "CompactionPlan",
    "CompactionReport",
    "plan_allocator_compaction",
    "compact_allocator",
    "plan_pool_compaction",
    "compact_pool",
]


@dataclasses.dataclass(frozen=True)
class Move:
    """One live-data migration: row ``index`` of ``owner`` moves src -> dst.

    ``owner`` is a VA (allocator plan) or a handle ID (tile-pool plan);
    ``src``/``dst`` are region PAs or global tile indices.  ``rowclone``
    marks same-subarray/same-arena moves the substrate executes in DRAM.
    """

    owner: int
    index: int
    src: int
    dst: int
    rowclone: bool


@dataclasses.dataclass
class CompactionPlan:
    """A batch-safe list of moves against one frozen pool state."""

    subject: str                 # "PumaAllocator" | "TilePool"
    moves: List[Move] = dataclasses.field(default_factory=list)
    frag_before: float = 0.0

    def __len__(self) -> int:
        return len(self.moves)

    @property
    def rowclone_moves(self) -> List[Move]:
        return [m for m in self.moves if m.rowclone]

    @property
    def cpu_moves(self) -> List[Move]:
        return [m for m in self.moves if not m.rowclone]


@dataclasses.dataclass
class CompactionReport:
    """What one executed pass did and what it cost."""

    subject: str
    executed: int
    rowclone_rows: int
    cpu_rows: int
    bytes_moved: int
    frag_before: float
    frag_after: float
    cost: Optional["MigrationCost"] = None

    @property
    def total_ns(self) -> float:
        return self.cost.total_ns if self.cost else 0.0

    def as_dict(self) -> Dict[str, object]:
        return {
            "subject": self.subject,
            "executed": self.executed,
            "rowclone_rows": self.rowclone_rows,
            "cpu_rows": self.cpu_rows,
            "bytes_moved": self.bytes_moved,
            "frag_before": self.frag_before,
            "frag_after": self.frag_after,
            "total_ns": self.total_ns,
        }


# ---------------------------------------------------------------------------
# PUD region pool (core/puma.py)
# ---------------------------------------------------------------------------

def plan_allocator_compaction(
    al: "PumaAllocator", max_moves: int = 64
) -> CompactionPlan:
    """Plan free-capacity re-concentration for the PUD region pool.

    Regions inside one subarray are interchangeable for PUD placement, so
    the useful unit of repair is whole-subarray evacuation: empty the
    subarrays whose owned capacity (``free + live``) is largest, dumping
    their live regions into the subarrays with the *least* free capacity.
    Every such move necessarily crosses subarrays — RowClone FPM cannot —
    so allocator-level moves are all CPU-priced; the RowClone-cheap moves
    live at the tile-pool layer (:func:`plan_pool_compaction`).
    """
    plan = CompactionPlan("PumaAllocator", frag_before=al.fragmentation())
    # frozen views -----------------------------------------------------------
    live_by_sa: Dict[int, List[Tuple[int, int, int]]] = {}   # sa -> (va,k,pa)
    for va, regions in al._regions_of.items():
        if not regions:
            continue
        sas = al.amap.region_subarrays(np.asarray(regions, np.int64))
        for k, (pa, sa) in enumerate(zip(regions, sas.tolist())):
            live_by_sa.setdefault(int(sa), []).append((va, k, int(pa)))
    free: Dict[int, List[int]] = {
        sa: list(lst) for sa, lst in al._ordered.free.items() if lst
    }
    if not free:
        return plan

    # collectors: rank by the free capacity the subarray can actually reach —
    # its current free count plus as many of its live regions as the *other*
    # subarrays have free slots to absorb.  Partial evacuation still raises
    # the max-free concentration, which is the metric (ties break by id so
    # the plan is deterministic).
    total_free = sum(len(lst) for lst in free.values())

    def reach(sa: int) -> int:
        own = len(free.get(sa, ()))
        return own + min(len(live_by_sa[sa]), total_free - own)

    collectors = sorted(
        (sa for sa in live_by_sa if sa not in al._blacklisted),
        key=lambda sa: (-reach(sa), sa),
    )
    # dumps: least free capacity first (waste the least concentration
    # potential), excluding subarrays already collected — dumping into a
    # freshly emptied subarray would undo the pass.
    collected: set = set()
    for c in collectors:
        if len(plan.moves) >= max_moves:
            break
        dumps = sorted(
            (sa for sa, lst in free.items()
             if lst and sa != c and sa not in collected),
            key=lambda sa: (len(free[sa]), sa),
        )
        if not dumps:
            break
        di = 0
        planned_here: List[Move] = []
        for va, k, pa in live_by_sa[c]:
            while di < len(dumps) and not free[dumps[di]]:
                di += 1
            if di >= len(dumps):
                break               # dump capacity exhausted: partial pass
            dst = free[dumps[di]].pop()   # LIFO, matching take_from
            planned_here.append(Move(va, k, pa, dst, rowclone=False))
            if len(plan.moves) + len(planned_here) >= max_moves:
                break
        if planned_here:
            collected.add(c)
        plan.moves.extend(planned_here)
    return plan


def compact_allocator(
    al: "PumaAllocator",
    plan: Optional[CompactionPlan] = None,
    *,
    max_moves: int = 64,
    phys: Optional[np.ndarray] = None,
    model: Optional["PudCostModel"] = None,
    controller: Optional["DramController"] = None,
) -> CompactionReport:
    """Execute a compaction plan on the PUD region pool.

    Moves apply through forced specific-takes against the *current* state;
    a plan made against a state that has since changed raises
    :class:`JournalReplayError` (plan and execute within one maintenance
    step, as the serving engine does).  Pass ``phys`` to actually move the
    bytes (bit-exactness is what the churn gate asserts); the executed moves
    are journaled as one atomic ``compact`` event.
    """
    from repro_torch.core.pud import PudCostModel, price_migration

    if plan is None:
        plan = plan_allocator_compaction(al, max_moves=max_moves)
    rb = al.region_bytes
    moved: List[List[int]] = []
    touched = set()
    cpu_pas: List[int] = []
    for m in plan.moves:
        regions = al._regions_of.get(m.owner)
        if regions is None or regions[m.index] != m.src:
            raise JournalReplayError(
                "compaction plan is stale: source region moved",
                va=m.owner, k=m.index,
            )
        dst_sa = int(al.amap.region_subarrays(np.asarray([m.dst], np.int64))[0])
        if not al._ordered.take_specific(dst_sa, m.dst):
            raise JournalReplayError(
                "compaction plan is stale: destination region not free",
                pa=m.dst, sa=dst_sa,
            )
        if phys is not None:
            phys[m.dst:m.dst + rb] = phys[m.src:m.src + rb]
        src_sa = int(al.amap.region_subarrays(np.asarray([m.src], np.int64))[0])
        regions[m.index] = m.dst
        al._ordered.add_region(src_sa, m.src)
        if al.n_channels > 1:
            chs = al.amap.region_channels(np.asarray([m.src, m.dst], np.int64))
            al._used_per_channel[int(chs[0])] -= 1
            al._used_per_channel[int(chs[1])] += 1
        touched.add(m.owner)
        moved.append([m.owner, m.index, m.src, m.dst])
        if not m.rowclone:
            lines = np.arange(0, rb, 64, dtype=np.int64)
            cpu_pas.extend((m.src + lines).tolist())
            cpu_pas.extend((m.dst + lines).tolist())
    from repro_torch.core.allocators import Extent

    for va in touched:
        alloc = al._allocations[va]
        alloc.extents = [
            Extent(i * rb, pa, rb)
            for i, pa in enumerate(al._regions_of[va])
        ]
        alloc.__post_init__()
    if moved and al.journal is not None:
        al.journal.append("compact", moves=moved)
    cost = price_migration(
        [int(al.amap.region_subarrays(np.asarray([m.dst], np.int64))[0])
         for m in plan.rowclone_moves],
        len(plan.cpu_moves),
        rb,
        channels=al.n_channels,
        model=model or PudCostModel(),
        controller=controller,
        cpu_pas=np.asarray(cpu_pas, np.int64) if cpu_pas else None,
    ) if moved else None
    return CompactionReport(
        subject="PumaAllocator",
        executed=len(moved),
        rowclone_rows=len(plan.rowclone_moves) if moved else 0,
        cpu_rows=len(plan.cpu_moves) if moved else 0,
        bytes_moved=len(moved) * rb,
        frag_before=plan.frag_before,
        frag_after=al.fragmentation(),
        cost=cost,
    )


# ---------------------------------------------------------------------------
# Device tile pool (core/arena.py)
# ---------------------------------------------------------------------------

def plan_pool_compaction(
    pool: "TilePool", max_moves: int = 128
) -> CompactionPlan:
    """Plan tile-pool repair: run repair first, then arena evacuation.

    Phase 1 (**run repair**, RowClone-priced): for every live handle, a tile
    whose predecessor sits in the same arena but not adjacently moves into
    the free slot right after the predecessor — an intra-arena (same
    subarray) row copy that directly re-knits ``contiguous_run_fraction``.

    Phase 2 (**arena evacuation**, CPU-priced): mirrors
    :func:`plan_allocator_compaction` at arena granularity — empty the
    arenas with the most owned capacity into the arenas with the least free
    capacity, so future worst-fit allocations find long free runs again.

    Destinations come only from the pass-initial free set and are never
    reused; sources are live tiles.  The two sets are disjoint, so one
    batched gather/scatter copy (``pool_block_copy``) executes the whole
    plan safely.
    """
    tpa = pool.tiles_per_arena
    plan = CompactionPlan("TilePool", frag_before=pool.fragmentation())
    free: List[set] = [set(lst) for lst in pool._free]
    # virtual handle tile lists: phase 2 must see phase 1's placements
    vtiles: Dict[int, List[int]] = {
        hid: list(h.tiles) for hid, h in pool._handles.items()
    }

    # -- phase 1: intra-arena run repair -------------------------------------
    for hid in sorted(vtiles):
        tiles = vtiles[hid]
        for k in range(1, len(tiles)):
            if len(plan.moves) >= max_moves:
                break
            prev, cur = tiles[k - 1], tiles[k]
            want = prev + 1
            if cur == want or want // tpa != prev // tpa:
                continue
            a, s = divmod(want, tpa)
            if s not in free[a]:
                continue
            free[a].discard(s)
            plan.moves.append(Move(hid, k, cur, want, rowclone=True))
            tiles[k] = want
        if len(plan.moves) >= max_moves:
            return plan

    # -- phase 2: arena evacuation -------------------------------------------
    # Victims group by handle: a handle's tiles inside the collector arena
    # move *together* into one contiguous free run of a dump arena (best-fit
    # over runs), so evacuation repairs contiguity instead of shredding it.
    # A group with no fitting run stays put — scattering it would trade the
    # pool-level fragmentation win for a handle-level contiguity loss.
    live_by_arena: Dict[int, Dict[int, List[Tuple[int, int]]]] = {}
    for hid, tiles in vtiles.items():
        for k, t in enumerate(tiles):
            live_by_arena.setdefault(t // tpa, {}).setdefault(
                hid, []
            ).append((k, t))
    collectors = sorted(
        live_by_arena,
        key=lambda a: (
            -(len(free[a]) + sum(len(g) for g in live_by_arena[a].values())),
            a,
        ),
    )

    def runs_of(slots: set) -> List[Tuple[int, int]]:
        out, lst = [], sorted(slots)
        i = 0
        while i < len(lst):
            j = i
            while j + 1 < len(lst) and lst[j + 1] == lst[j] + 1:
                j += 1
            out.append((lst[i], j - i + 1))
            i = j + 1
        return out

    collected: set = set()
    for c in collectors:
        if len(plan.moves) >= max_moves:
            break
        planned_here: List[Move] = []
        for hid in sorted(live_by_arena[c]):
            group = sorted(live_by_arena[c][hid])        # by index k
            need = len(group)
            # best-fit run across dump arenas: smallest run that fits,
            # ties to the fullest arena then lowest id (deterministic).
            best = None
            for a in range(pool.n_arenas):
                if a == c or a in collected or not free[a]:
                    continue
                for start, length in runs_of(free[a]):
                    if length >= need and (
                        best is None
                        or (length, len(free[a]), a) < best[:3]
                    ):
                        best = (length, len(free[a]), a, start)
            if best is None:
                continue
            _, _, a, start = best
            for off, (k, t) in enumerate(group):
                free[a].discard(start + off)
                planned_here.append(
                    Move(hid, k, t, a * tpa + start + off, rowclone=False)
                )
            if len(plan.moves) + len(planned_here) >= max_moves:
                break
        if planned_here:
            collected.add(c)
        plan.moves.extend(planned_here)
    return plan


def compact_pool(
    pool: "TilePool",
    plan: Optional[CompactionPlan] = None,
    *,
    max_moves: int = 128,
    tile_bytes: int = 8192,
    model: Optional["PudCostModel"] = None,
    controller: Optional["DramController"] = None,
) -> CompactionReport:
    """Execute a tile-pool compaction plan (bookkeeping only — the caller
    owns the device buffers and applies the plan's moves to them; see
    :meth:`repro_torch.core.kv_pool.PagedKVPool.compact` for the batched
    ``pool_block_copy`` data path).  Executed moves are journaled as one
    ``compact`` event; the cost prices phase-1 moves as RowClone rows on
    the arena's channel (``arena % n_channels``) and phase-2 moves as host
    copies of ``tile_bytes`` each.
    """
    from repro_torch.core.pud import PudCostModel, price_migration

    if plan is None:
        plan = plan_pool_compaction(pool, max_moves=max_moves)
    tpa = pool.tiles_per_arena
    moved: List[List[int]] = []
    for m in plan.moves:
        h = pool._handles.get(m.owner)
        if h is None or h.tiles[m.index] != m.src:
            raise JournalReplayError(
                "compaction plan is stale: source tile moved",
                hid=m.owner, k=m.index,
            )
        a, s = divmod(m.dst, tpa)
        if pool._take_slot(a, s) != m.dst:
            raise JournalReplayError(
                "compaction plan is stale: destination tile not free",
                tile=m.dst,
            )
        h.tiles[m.index] = m.dst
        pool._give_back(m.src)
        moved.append([m.owner, m.index, m.src, m.dst])
    if moved and pool.journal is not None:
        pool.journal.append("compact", moves=moved)
    cost = price_migration(
        [m.dst // tpa for m in plan.rowclone_moves],
        len(plan.cpu_moves),
        tile_bytes,
        channels=pool.n_channels,
        model=model or PudCostModel(),
        controller=controller,
    ) if moved else None
    return CompactionReport(
        subject="TilePool",
        executed=len(moved),
        rowclone_rows=len(plan.rowclone_moves) if moved else 0,
        cpu_rows=len(plan.cpu_moves) if moved else 0,
        bytes_moved=len(moved) * tile_bytes,
        frag_before=plan.frag_before,
        frag_after=pool.fragmentation(),
        cost=cost,
    )
