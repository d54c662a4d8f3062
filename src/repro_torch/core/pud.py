"""PUD executability + timing model (RowClone / Ambit substrate, paper §3).

The evaluated substrate executes, *in DRAM*:

* ``zero``  — RowClone zero-init  (copy from a reserved all-zeros row),
* ``copy``  — RowClone FPM intra-subarray row copy,
* ``and/or/not`` — Ambit triple-row-activation Boolean ops,

and each operation proceeds row by row.  A row-granular op is PUD-executable
iff **every operand's row** (i) is physically contiguous, (ii) starts at a
rank-row boundary, and (iii) all operand rows share one global subarray —
exactly the paper's criterion ("source and destination operands are
contiguous in physical memory and DRAM-row-aligned", same subarray).
Rows that fail fall back to the CPU, as does the sub-row tail of every
allocation.

Timing constants approximate DDR3/4 values used by RowClone [104] and
Ambit [101]: an AAP (ACTIVATE-ACTIVATE-PRECHARGE) command sequence costs
~tRAS+tRP ≈ 90 ns and touches a full 8 KB rank-row.  The CPU fallback prices
a streaming read/write through the memory hierarchy.  Absolute numbers only
set the scale; the paper's Figure 2 normalizes to the malloc baseline, and
so do we.

Planning fast path
------------------

``plan_rows`` no longer probes each logical row with scalar
``contiguous_run``/``region_subarray`` calls.  Each operand's per-row global
subarray (or -1 where the row is not PUD-capable) is computed as one numpy
array — a ``searchsorted`` over the allocation's coalesced extents plus the
batch decode from :mod:`repro_torch.core.dram` — and memoized on the
``Allocation`` (the mapping is immutable after construction, so the cache
lives as long as the allocation; freeing drops the allocation and the table
with it).  Executability is then a vectorized equality across operand
tables.  ``execute_op`` walks :meth:`Allocation.runs` so every physically
contiguous run moves as one slice instead of byte-by-byte ``pa_of`` probing.
Property tests pin both fast paths to the original scalar semantics.

Channel-partitioned execution
-----------------------------

The substrate is channel-parallel: every channel has its own memory
controller (:mod:`repro_torch.core.controller`) and PUD rows living in different
channels execute concurrently.  :class:`RowPlan` therefore also records the
*global subarray per row* (``subarrays``; the owning channel is
``gsa % channels``), and:

* ``simulate_op`` partitions the PUD rows by owning channel (one
  ``bincount``) and prices the in-DRAM part as ``max`` over per-channel row
  counts x per-row AAP cost instead of a serial sum — a RowClone copy
  striped over 8 channels finishes ~8x faster.  With a
  :class:`~repro_torch.core.controller.DramController` passed in, the op is
  additionally queued on the controllers' ``busy_until`` frontiers, so
  back-to-back ops contending for one channel visibly serialize and mode
  switches (PUD interleaved with normal traffic) are charged.
* ``execute_op`` walks the row list channel by channel — the functional
  result is unchanged (rows are disjoint), but the dispatch order mirrors
  the per-channel command streams and, with a controller, records the same
  timing.

At ``channels=1`` both collapse bit-for-bit to the original single-channel
serial model (``max`` over one channel *is* the total row count); property
tests in ``tests/test_pud.py`` pin that equivalence under both interleave
schemes.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.allocators import Allocation
from repro_torch.core.controller import DramController, channel_row_counts
from repro_torch.core.dram import AddressMap

if TYPE_CHECKING:
    from repro_torch.robustness.faults import FaultInjector

__all__ = [
    "OpKind",
    "PudCostModel",
    "RowPlan",
    "row_subarray_table",
    "plan_rows",
    "simulate_op",
    "execute_op",
    "MigrationCost",
    "price_migration",
]


OpKind = str  # "zero" | "copy" | "and" | "or" | "not" | "mac"

#: operands (incl. destination) per op.  ``mac`` is the arithmetic
#: extension toward MIMDRAM/Proteus-style substrates (ROADMAP Tracegen
#: item): a decode-time multiply-accumulate over a weight row into a
#: co-located accumulator row — 2 operands (weight, accumulator), the
#: scalar input vector is broadcast through the mat drivers.
N_OPERANDS: Dict[str, int] = {
    "zero": 1, "copy": 2, "and": 3, "or": 3, "not": 2, "mac": 2,
}

#: AAP sequences per row for each PUD op (RowClone/Ambit command counts;
#: ``mac`` approximates MIMDRAM's bit-serial popcount-accumulate ladder —
#: several majority/copy rounds per element group, so 8 AAPs per row).
PUD_AAPS: Dict[str, int] = {
    "zero": 1, "copy": 2, "and": 4, "or": 4, "not": 3, "mac": 8,
}


@dataclasses.dataclass(frozen=True)
class PudCostModel:
    aap_ns: float = 90.0            # ACT(tRAS 35ns) + ACT + PRE(tRP 15ns) ≈ 90ns
    pud_issue_ns: float = 20.0      # memory-controller command overhead / row
    cpu_bw_gbs: float = 10.0        # streaming CPU bandwidth (read xor write)
    cpu_op_overhead_ns: float = 250.0   # call + loop setup per operation
    cpu_row_touch_ns: float = 40.0      # per-row TLB/prefetch restart on the
                                        # fallback path (data pulled to CPU)

    def pud_row_ns(self, op: OpKind) -> float:
        return PUD_AAPS[op] * self.aap_ns + self.pud_issue_ns

    def cpu_bytes_moved(self, op: OpKind, nbytes: int) -> int:
        # zero: write N; copy: read N + write N; and/or: 2 reads + 1 write;
        # not: read + write; mac: stream the weights + read-modify-write the
        # (vector-sized, cache-resident) accumulator ≈ read N + write N.
        streams = {
            "zero": 1, "copy": 2, "and": 3, "or": 3, "not": 2, "mac": 2,
        }[op]
        return streams * nbytes

    def cpu_ns(self, op: OpKind, nbytes: int, nrows: int = 1) -> float:
        # Unit identity, made explicit: 1 GB/s = 1e9 B / 1e9 ns = exactly
        # 1 byte/ns, so a bandwidth of ``cpu_bw_gbs`` GB/s moves
        # ``cpu_bw_gbs`` bytes per nanosecond.  (Not a coincidence of the
        # default value — the 1e9s cancel for any parameter setting.)
        bytes_per_ns = self.cpu_bw_gbs
        move = self.cpu_bytes_moved(op, nbytes) / bytes_per_ns
        return move + nrows * self.cpu_row_touch_ns


@dataclasses.dataclass
class RowPlan:
    """Per-row execution decision for one op over parallel operands."""

    n_rows: int                 # full rows in the logical buffers
    in_pud: List[bool]          # len n_rows
    tail_bytes: int             # sub-row remainder (always CPU)
    #: global subarray per row (shared by all operands on PUD rows; -1 on
    #: CPU rows).  The owning channel is ``subarrays[r] % channels`` — what
    #: the channel-partitioned executor and the controllers dispatch on.
    subarrays: Optional[np.ndarray] = None
    #: rows that started in DRAM but faulted mid-flight (injected RowClone
    #: failures) and were gracefully re-executed on the CPU.
    faulted_rows: int = 0

    @property
    def pud_fraction(self) -> float:
        if self.n_rows == 0:
            return 0.0
        return sum(self.in_pud) / self.n_rows

    def pud_subarrays(self) -> np.ndarray:
        """Global subarray of each PUD row (non-PUD rows dropped)."""
        if self.subarrays is None:
            return np.empty(0, dtype=np.int64)
        return self.subarrays[self.subarrays >= 0]

    def channel_rows(self, amap: AddressMap) -> np.ndarray:
        """PUD rows per owning channel (len = geometry's channel count)."""
        return channel_row_counts(self.pud_subarrays(), amap)


def _row_subarray(
    alloc: Allocation, row: int, region_bytes: int, amap: AddressMap
) -> Optional[int]:
    """Global subarray of logical row ``row``; None if not PUD-capable.

    Scalar reference path — ``plan_rows`` uses the vectorized
    :func:`row_subarray_table`; property tests assert they agree.
    """
    off = row * region_bytes
    pa = alloc.contiguous_run(off, region_bytes)
    if pa is None or not amap.region_is_aligned(pa):
        return None
    return amap.region_subarray(pa)


def row_subarray_table(alloc: Allocation, amap: AddressMap) -> np.ndarray:
    """Per-row global subarray of ``alloc`` as an int64 array (-1 = not
    PUD-capable), memoized on the allocation.

    Row ``r`` is PUD-capable iff the full region ``[r*region, (r+1)*region)``
    sits inside one coalesced extent (ownership + physical contiguity) at a
    region-aligned physical base; its value is then the region's global
    subarray from the batch decode.
    """
    cached = alloc._row_sa_cache.get(id(amap))
    if cached is not None and cached[0] is amap:
        return cached[1]
    region = amap.region_bytes
    n_rows = -(-alloc.size // region)
    offs = np.arange(n_rows, dtype=np.int64) * region
    va_offs = np.asarray(alloc._va_offs, dtype=np.int64)
    ends = np.asarray(alloc._va_ends, dtype=np.int64)
    pas = np.asarray(alloc._pas, dtype=np.int64)
    idx = np.searchsorted(va_offs, offs, side="right") - 1
    idxc = np.clip(idx, 0, len(va_offs) - 1)
    pa = pas[idxc] + offs - va_offs[idxc]
    ok = (idx >= 0) & (offs + region <= ends[idxc]) & (pa % region == 0)
    table = np.where(ok, amap.region_subarrays(pa), -1)
    alloc._row_sa_cache[id(amap)] = (amap, table)
    return table


def plan_rows(
    op: OpKind,
    operands: Sequence[Allocation],
    amap: AddressMap,
    injector: Optional["FaultInjector"] = None,
) -> RowPlan:
    """Decide, row by row, whether the op can execute in DRAM.

    PUD ops act on whole rows, so the final *partial* logical row can still
    execute in DRAM when every allocator padded the allocation out to a full
    owned region (PUMA and per-mmap huge pages do; heap allocators do not —
    their extents stop at the requested size, and operating on the full row
    would clobber a neighbour).  The row table's full-region contiguity
    check is exactly that ownership test.
    """
    assert len(operands) == N_OPERANDS[op], (op, len(operands))
    size = min(a.size for a in operands)
    region = amap.region_bytes
    n_full, tail = divmod(size, region)
    n_rows = n_full + (1 if tail else 0)
    if n_rows == 0:
        return RowPlan(
            n_rows=0, in_pud=[], tail_bytes=0,
            subarrays=np.empty(0, dtype=np.int64),
        )
    tables = [row_subarray_table(a, amap)[:n_rows] for a in operands]
    ok = tables[0] != -1
    for t in tables[1:]:
        ok = ok & (t == tables[0])
    if injector is not None and injector.blacklist:
        # permanently failed subarrays never execute in DRAM: their rows are
        # planned onto the CPU up front (the driver knows the blacklist).
        ok = ok & ~injector.blacklisted_mask(tables[0])
    in_pud = ok.tolist()
    tail_bytes = 0 if (not tail or in_pud[-1]) else tail
    # on PUD rows every operand shares operand 0's subarray by construction
    subarrays = np.where(ok, tables[0], -1).astype(np.int64)
    return RowPlan(
        n_rows=n_rows, in_pud=in_pud, tail_bytes=tail_bytes,
        subarrays=subarrays,
    )


@dataclasses.dataclass
class SimResult:
    op: OpKind
    size: int
    pud_fraction: float
    t_ns: float          # time with the PUD substrate available
    t_cpu_ns: float      # time if everything ran on the CPU
    #: PUD rows dispatched per channel (len = geometry channel count);
    #: None when the op took the pure-CPU path.
    rows_per_channel: Optional[List[int]] = None
    #: rows whose in-DRAM execution faulted (injected) and were re-run on
    #: the CPU — their wasted AAP time *and* the CPU retry are in ``t_ns``.
    faulted_rows: int = 0

    @property
    def speedup_vs_cpu(self) -> float:
        return self.t_cpu_ns / self.t_ns if self.t_ns > 0 else float("inf")

    @property
    def channel_balance(self) -> float:
        """mean/max PUD rows across channels (1.0 = perfectly striped)."""
        if not self.rows_per_channel:
            return 1.0
        rows = np.asarray(self.rows_per_channel, dtype=np.float64)
        mx = rows.max()
        return float(rows.mean() / mx) if mx > 0 else 1.0


def simulate_op(
    op: OpKind,
    operands: Sequence[Allocation],
    amap: AddressMap,
    model: PudCostModel = PudCostModel(),
    adaptive: bool = True,
    controller: Optional[DramController] = None,
    injector: Optional["FaultInjector"] = None,
    recorder=None,
    label: Optional[str] = None,
) -> SimResult:
    """Price one op.  ``adaptive`` (beyond-paper refinement): the PUD driver
    knows both cost models and only offloads when DRAM execution is cheaper —
    sub-row ops stay on the CPU, so PUMA never *loses* to the baseline.

    The in-DRAM part executes channel-parallel: PUD rows are partitioned by
    owning channel and the burst costs ``max`` over per-channel row counts
    (at ``channels=1`` this is exactly the old serial sum).  Passing a
    ``controller`` additionally queues the burst on the per-channel
    ``busy_until`` frontiers — contention with earlier ops and SB<->PIM mode
    switches then show up in ``t_ns``, and the dispatch advances the
    controller state (unless the adaptive driver picks the CPU, in which
    case the queues are left untouched).

    With an ``injector``, rows in blacklisted subarrays are planned onto the
    CPU up front, and the surviving PUD rows may fault mid-flight at the
    injected RowClone error rate: a faulted row's AAP time is wasted and the
    row is re-executed on the CPU — the graceful-degradation pricing the
    chaos benchmark measures.

    With a ``recorder`` (:class:`repro_torch.trace.record.TraceRecorder` — duck-
    typed, only ``emit`` is used), the fully priced op lands in the trace as
    one ``pud_op`` event, emitted *before* the controller dispatch so the
    replay executor can re-run the queue-state-aware peek against
    un-advanced controller state.  ``label`` is free-form provenance (the
    offload model passes ``arch/allocator/weight-name``).
    """
    plan = plan_rows(op, operands, amap, injector=injector)
    region = amap.region_bytes
    size = min(a.size for a in operands)

    pud_rows = sum(plan.in_pud)
    # CPU-path bytes: full regions for interior misses; the final partial
    # row contributes only its real tail bytes.
    cpu_rows = plan.n_rows - pud_rows
    cpu_bytes = cpu_rows * region
    if plan.tail_bytes:  # last row is a CPU partial row, not a full region
        cpu_bytes += plan.tail_bytes - region

    rows_per_channel: Optional[List[int]] = None
    row_ns = model.pud_row_ns(op)
    if pud_rows:
        if controller is not None:
            est = controller.peek_pud(plan.pud_subarrays(), row_ns)
            t = est.latency_ns
            rows_per_channel = est.rows_per_channel
        else:
            counts = plan.channel_rows(amap)
            t = int(counts.max()) * row_ns
            rows_per_channel = counts.tolist()
    else:
        t = 0.0
    if cpu_rows:
        t += model.cpu_op_overhead_ns
        t += model.cpu_ns(op, cpu_bytes, cpu_rows)
    elif pud_rows:
        t += model.cpu_op_overhead_ns  # syscall into the PUD driver

    t_cpu = model.cpu_op_overhead_ns + model.cpu_ns(op, size, max(plan.n_rows, 1))
    n_faulted = 0
    if adaptive and t > t_cpu:
        t = t_cpu
        rows_per_channel = None  # driver picked the CPU: nothing dispatched
    elif pud_rows and injector is not None:
        # mid-flight RowClone faults: the AAP time above is already
        # spent; each faulted row is gracefully retried on the CPU.
        faults = injector.rowclone_faults(plan.pud_subarrays().tolist())
        n_faulted = int(faults.sum())
        if n_faulted:
            plan.faulted_rows = n_faulted
            if not cpu_rows:  # first CPU entry for this op: pay setup
                t += model.cpu_op_overhead_ns
            t += model.cpu_ns(op, n_faulted * region, n_faulted)
    if recorder is not None:
        # emitted before the dispatch below: replay peeks the controller
        # queues in recorded state, then applies the ctrl_pud event.
        recorder.emit(
            "pud_op",
            op=op, label=label, size=int(size), n_rows=int(plan.n_rows),
            pud_rows=int(pud_rows), cpu_rows=int(cpu_rows),
            cpu_bytes=int(cpu_bytes), tail_bytes=int(plan.tail_bytes),
            region_bytes=int(region),
            rows_per_channel=(
                None if rows_per_channel is None
                else [int(n) for n in rows_per_channel]
            ),
            ctrl=controller is not None,
            adaptive=bool(adaptive),
            faulted_rows=int(n_faulted),
            t_ns=float(t), t_cpu_ns=float(t_cpu),
        )
    if controller is not None and rows_per_channel is not None and pud_rows:
        controller.dispatch_pud(plan.pud_subarrays(), row_ns)
    return SimResult(
        op, size, plan.pud_fraction, t, t_cpu, rows_per_channel, n_faulted
    )


# ---------------------------------------------------------------------------
# Migration pricing: what one compaction pass costs.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MigrationCost:
    """Price of one compaction pass's data movement."""

    rowclone_rows: int          # same-subarray moves executed as RowClone
    cpu_rows: int               # cross-subarray moves the substrate can't do
    bytes_moved: int
    rowclone_ns: float          # in-DRAM burst latency (channel-parallel)
    cpu_copy_ns: float          # host-side streaming copy time
    @property
    def total_ns(self) -> float:
        return self.rowclone_ns + self.cpu_copy_ns


def price_migration(
    rowclone_subarrays: Sequence[int],
    cpu_rows: int,
    row_bytes: int,
    *,
    channels: int = 1,
    model: PudCostModel = PudCostModel(),
    controller: Optional[DramController] = None,
    cpu_pas: Optional[np.ndarray] = None,
) -> MigrationCost:
    """Price one compaction pass (see :mod:`repro_torch.robustness.compaction`).

    Same-subarray moves are RowClone FPM row copies — ``pud_row_ns("copy")``
    per row, executed channel-parallel (``rowclone_subarrays`` carries one
    global subarray/arena ID per such move; the owning channel is
    ``id % channels``).  Cross-subarray moves fall back to a host streaming
    copy priced by :meth:`PudCostModel.cpu_ns`, one op-call overhead per
    pass.  With a ``controller``, both kinds are *dispatched* — the RowClone
    rows as PUD bursts, the CPU copies' cacheline traffic (``cpu_pas``) as
    normal accesses — so the pass occupies the channel frontiers and
    competes with live traffic; the maintenance pass itself is serial
    (RowClone burst, then the host copy), matching a stop-the-row background
    defragmenter.
    """
    row_ns = model.pud_row_ns("copy")
    sas = np.asarray(rowclone_subarrays, dtype=np.int64)
    if controller is not None:
        start = controller.now_ns
        done = controller.dispatch_migration(sas, row_ns, cpu_pas)
        rowclone_ns = done - start
    elif sas.size:
        counts = np.bincount(sas % channels, minlength=channels)
        rowclone_ns = float(int(counts.max()) * row_ns)
    else:
        rowclone_ns = 0.0
    cpu_copy_ns = 0.0
    if cpu_rows:
        cpu_copy_ns = model.cpu_op_overhead_ns + model.cpu_ns(
            "copy", cpu_rows * row_bytes, cpu_rows
        )
    return MigrationCost(
        rowclone_rows=int(sas.size),
        cpu_rows=int(cpu_rows),
        bytes_moved=(int(sas.size) + int(cpu_rows)) * row_bytes,
        rowclone_ns=rowclone_ns,
        cpu_copy_ns=cpu_copy_ns,
    )


# ---------------------------------------------------------------------------
# Functional execution: actually perform the op through the page tables on a
# numpy "physical memory", so tests can assert that PUD dispatch computes the
# same bytes as a plain vector op regardless of which rows took which path.
# ---------------------------------------------------------------------------

def _apply_rowwise(op: OpKind, dst: np.ndarray, srcs: List[np.ndarray]) -> None:
    if op == "zero":
        dst[:] = 0
    elif op == "copy":
        dst[:] = srcs[0]
    elif op == "and":
        np.bitwise_and(srcs[0], srcs[1], out=dst)
    elif op == "or":
        np.bitwise_or(srcs[0], srcs[1], out=dst)
    elif op == "not":
        np.bitwise_not(srcs[0], out=dst)
    else:
        raise ValueError(op)


def execute_op(
    op: OpKind,
    operands: Sequence[Allocation],
    phys: np.ndarray,
    amap: AddressMap,
    controller: Optional[DramController] = None,
    model: Optional[PudCostModel] = None,
    injector: Optional["FaultInjector"] = None,
) -> RowPlan:
    """Execute ``op`` with dst = operands[-1], srcs = operands[:-1].

    Every byte moves through the VA->PA mapping; PUD-eligible rows use the
    row-granular path (modelling in-DRAM execution), the rest byte-copies via
    the "CPU".  Both paths write the same bytes — the point is to validate
    that the *dispatch plan* is sound, which tests assert by comparing
    against a whole-buffer numpy op.

    Dispatch order mirrors the hardware's per-channel command streams: PUD
    rows are partitioned by owning channel and each channel's rows issue as
    one burst (rows are disjoint regions, so the bytes are identical to the
    row-index order the single-channel model used).  CPU rows follow.  With
    a ``controller``, the same partition is queued on the per-channel
    frontiers so execution traffic shows up in the occupancy report.

    With an ``injector``, blacklisted subarrays never enter DRAM dispatch
    and PUD rows may fault mid-flight (RowClone copy failure): a faulted
    row is transparently re-executed on the CPU path — same bytes, graceful
    degradation — and counted in the returned plan's ``faulted_rows``.
    """
    plan = plan_rows(op, operands, amap, injector=injector)
    region = amap.region_bytes
    size = min(a.size for a in operands)
    dst, srcs = operands[-1], list(operands[:-1])

    def read(a: Allocation, off: int, n: int) -> np.ndarray:
        out = np.empty(n, np.uint8)
        done = 0
        for pa, run in a.runs(off, n):
            out[done : done + run] = phys[pa : pa + run]
            done += run
        return out

    def write(a: Allocation, off: int, buf: np.ndarray) -> None:
        done = 0
        for pa, run in a.runs(off, len(buf)):
            phys[pa : pa + run] = buf[done : done + run]
            done += run

    def do_row(r: int) -> None:
        off = r * region
        # PUD rows operate on the full (owned, padded) region; the final CPU
        # row only touches the real tail bytes.
        n = region
        if not plan.in_pud[r] and r == plan.n_rows - 1 and plan.tail_bytes:
            n = plan.tail_bytes
        src_rows = [read(s, off, n) for s in srcs]
        out = np.empty(n, np.uint8)
        _apply_rowwise(op, out, src_rows)
        write(dst, off, out)

    if plan.n_rows:
        rows = np.arange(plan.n_rows)
        planned = np.asarray(plan.in_pud, dtype=bool)
        in_pud = planned
        if injector is not None and planned.any():
            # mid-flight RowClone faults: the row leaves the DRAM burst and
            # re-executes on the CPU (identical bytes — graceful degradation)
            faults = injector.rowclone_faults(
                plan.subarrays[planned].tolist()
            )
            if faults.any():
                idx = rows[planned][faults]
                in_pud = planned.copy()
                in_pud[idx] = False
                plan.faulted_rows = int(faults.sum())
        chans = np.where(
            in_pud, amap.channel_of_subarray(plan.subarrays), -1
        )
        # one burst per channel, in channel order; CPU rows (chan == -1) last
        for c in range(amap.geo.channels):
            for r in rows[chans == c].tolist():
                do_row(r)
        for r in rows[chans == -1].tolist():
            do_row(r)
        if controller is not None and planned.any():
            # faulted rows still spent their AAP time in DRAM: charge the
            # whole planned burst, not just the rows that completed there.
            controller.dispatch_pud(
                plan.pud_subarrays(), (model or PudCostModel()).pud_row_ns(op)
            )
    return plan
