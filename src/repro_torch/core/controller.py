"""Per-channel memory-controller model with PUD dispatch (HBM-PIM style).

Real PUD substrates get their headline gains from *bank-level parallelism*:
every channel has its own memory controller with its own request queue, and
the channels execute independently (the HBM-PIMulator exemplar instantiates
one ``IDRAMController`` per channel and broadcasts PIM requests across them;
MIMDRAM executes across many mats/banks concurrently).  This module gives
the repo that structure as an analytic queue model:

* :class:`ChannelController` — one channel's request queue, collapsed to a
  ``busy_until_ns`` frontier plus FR-FCFS-lite pricing:

  - **PUD bursts** are AAP (ACTIVATE-ACTIVATE-PRECHARGE) command sequences
    issued back to back; ``n_rows`` rows of op ``op`` cost
    ``n_rows * PudCostModel.pud_row_ns(op)`` once the channel is free.
  - **Normal accesses** are grouped by (bank, row) first — the "first-ready"
    half of FR-FCFS — so requests hitting an open row pay ``row_hit_ns``
    (CAS only) and row conflicts pay ``row_miss_ns`` (PRE+ACT+CAS).
  - **Mode switching**: the channel is either in normal ``SB``
    (single-bank) mode or ``PIM`` mode (the HBM-PIM SB/AB/PIM register
    dance); every transition costs ``mode_switch_ns``.  Interleaving PUD
    ops with reads/writes on one channel therefore pays visibly.

* :class:`DramController` — the device: one :class:`ChannelController` per
  channel of the :class:`~repro_torch.core.dram.AddressMap`'s geometry.
  :meth:`DramController.dispatch_pud` partitions an op's row list by owning
  channel (``channel_of_subarray`` — one modulo, no re-decode) and enqueues
  each partition on its controller; the op completes at the **max** of the
  per-channel completion times, so a RowClone copy striped over 8 channels
  finishes ~8x faster while two ops contending for one channel serialize
  through its ``busy_until_ns`` frontier.

:meth:`DramController.occupancy_report` surfaces the new figure of merit:
per-channel busy time / PUD row counts and the load-balance ratio
(mean/max rows per channel; 1.0 = perfectly striped placement).

The model is deliberately state-light (no cycle-accurate timing): it only
needs to make channel contention and placement imbalance *visible* to the
cost model, the benchmarks, and the serving simulations.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.dram import AddressMap

if TYPE_CHECKING:
    from repro_torch.robustness.faults import FaultInjector

__all__ = [
    "ControllerConfig",
    "ChannelStats",
    "ChannelController",
    "PudDispatch",
    "DramController",
    "channel_row_counts",
]


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """Timing knobs of one channel's controller (DDR-scale defaults)."""

    mode_switch_ns: float = 120.0   # SB <-> PIM mode register transition
    row_hit_ns: float = 15.0        # CAS on an already-open row (tCCD+tCL-ish)
    row_miss_ns: float = 50.0       # PRE + ACT + CAS on a row conflict
    cacheline_bytes: int = 64       # granularity of one normal access


@dataclasses.dataclass
class ChannelStats:
    pud_ops: int = 0
    pud_rows: int = 0
    mem_accesses: int = 0
    row_hits: int = 0
    row_misses: int = 0
    mode_switches: int = 0
    busy_ns: float = 0.0
    injected_stalls: int = 0       # fault-injected controller stalls
    injected_stall_ns: float = 0.0


class ChannelController:
    """One channel's request queue, collapsed to a completion frontier.

    Requests are priced in arrival order (FCFS across bursts); within one
    normal-access burst the (bank, row) grouping models FR-FCFS's row-hit
    reordering.  ``busy_until_ns`` is the time the channel next goes idle —
    enqueueing starts at ``max(now, busy_until_ns)``, which is exactly what
    makes contention between ops on the same channel visible.
    """

    SB = "SB"
    PIM = "PIM"

    def __init__(
        self,
        channel_id: int,
        cfg: Optional[ControllerConfig] = None,
        injector: Optional["FaultInjector"] = None,
    ):
        self.channel_id = channel_id
        self.cfg = cfg or ControllerConfig()
        self.busy_until_ns = 0.0
        self.mode = self.SB
        self._open_rows: Dict[int, int] = {}   # bank -> open row index
        self.stats = ChannelStats()
        #: fault injector: each dispatched burst may hit an injected stall
        #: (refresh storm / thermal throttle); None = never.
        self.injector = injector

    # -- internals ----------------------------------------------------------
    def _begin(self, now_ns: float) -> float:
        return max(now_ns, self.busy_until_ns)

    def _injected_stall(self, t: float) -> float:
        if self.injector is not None:
            stall = self.injector.stall_ns()
            if stall:
                self.stats.injected_stalls += 1
                self.stats.injected_stall_ns += stall
                t += stall
        return t

    def _switch_mode(self, mode: str, t: float) -> float:
        if self.mode != mode:
            self.mode = mode
            self.stats.mode_switches += 1
            t += self.cfg.mode_switch_ns
        return t

    def _finish(self, start: float, t: float) -> float:
        self.busy_until_ns = t
        self.stats.busy_ns += t - start
        return t

    # -- PUD command bursts -------------------------------------------------
    def enqueue_pud(self, n_rows: int, row_ns: float, now_ns: float = 0.0) -> float:
        """Queue ``n_rows`` AAP sequences of ``row_ns`` each; returns the
        completion time.  The rows of one burst issue back to back (the PUD
        driver batches a whole op's command stream per channel)."""
        start = self._begin(now_ns)
        if n_rows <= 0:
            return start
        t = self._switch_mode(self.PIM, start)
        t += n_rows * row_ns
        t = self._injected_stall(t)
        self.stats.pud_ops += 1
        self.stats.pud_rows += n_rows
        # PUD ops open/close rows themselves; the row buffer is left closed.
        self._open_rows.clear()
        return self._finish(start, t)

    def peek_pud(self, n_rows: int, row_ns: float, now_ns: float = 0.0) -> float:
        """Completion time :meth:`enqueue_pud` *would* return — no mutation.
        The adaptive PUD driver uses this to decide offload vs CPU fallback
        before committing the command stream to the queue."""
        start = self._begin(now_ns)
        if n_rows <= 0:
            return start
        t = start + (self.cfg.mode_switch_ns if self.mode != self.PIM else 0.0)
        return t + n_rows * row_ns

    # -- normal reads/writes (FR-FCFS-lite) ---------------------------------
    def enqueue_accesses(
        self,
        bank_rows: Sequence[Tuple[int, int]],
        now_ns: float = 0.0,
    ) -> float:
        """Queue one burst of normal accesses, each a ``(bank, row)`` pair.

        The burst is grouped by (bank, row) — FR-FCFS serves row hits first —
        so each distinct row pays one ``row_miss_ns`` activation (unless it
        is already open in the bank's row buffer) and every further access
        to it pays ``row_hit_ns``.
        """
        start = self._begin(now_ns)
        if not len(bank_rows):
            return start
        t = self._switch_mode(self.SB, start)
        groups: Dict[Tuple[int, int], int] = {}
        for bank, row in bank_rows:
            groups[(bank, row)] = groups.get((bank, row), 0) + 1
        hits = misses = 0
        for (bank, row), n in groups.items():
            if self._open_rows.get(bank) == row:
                hits += n
            else:
                misses += 1
                hits += n - 1
                self._open_rows[bank] = row
        t += hits * self.cfg.row_hit_ns + misses * self.cfg.row_miss_ns
        t = self._injected_stall(t)
        self.stats.mem_accesses += len(bank_rows)
        self.stats.row_hits += hits
        self.stats.row_misses += misses
        return self._finish(start, t)


@dataclasses.dataclass
class PudDispatch:
    """Outcome of dispatching one PUD op across the channels."""

    start_ns: float
    done_ns: float
    rows_per_channel: List[int]

    @property
    def latency_ns(self) -> float:
        return self.done_ns - self.start_ns

    @property
    def balance(self) -> float:
        """mean/max rows over *active* channels plus idle ones: 1.0 means the
        op's rows were spread evenly over every channel."""
        rows = np.asarray(self.rows_per_channel, dtype=np.float64)
        mx = rows.max() if rows.size else 0.0
        return float(rows.mean() / mx) if mx > 0 else 1.0


def channel_row_counts(
    row_subarrays: np.ndarray, amap: AddressMap
) -> np.ndarray:
    """Rows per owning channel for an array of global-subarray IDs.

    One ``bincount`` over ``gsa % channels`` — the vectorized partition the
    planner, the controller, and the benchmarks share.  ``-1`` entries
    (non-PUD rows) must be filtered by the caller.
    """
    chans = np.asarray(row_subarrays, dtype=np.int64) % amap.geo.channels
    return np.bincount(chans, minlength=amap.geo.channels)


class DramController:
    """One :class:`ChannelController` per channel of ``amap``'s geometry."""

    def __init__(
        self,
        amap: AddressMap,
        cfg: Optional[ControllerConfig] = None,
        injector: Optional["FaultInjector"] = None,
        recorder=None,
    ):
        self.amap = amap
        self.cfg = cfg or ControllerConfig()
        self.channels = [
            ChannelController(c, self.cfg, injector)
            for c in range(amap.geo.channels)
        ]
        self.now_ns = 0.0   # dispatch frontier (advances with completions)
        #: trace recorder (:class:`repro_torch.trace.record.TraceRecorder`, duck-
        #: typed — only ``emit`` is used): every dispatched PUD burst /
        #: access burst lands in the trace with its per-channel shape and
        #: completion times.  None = no tracing overhead.
        self.recorder = recorder

    @property
    def n_channels(self) -> int:
        return len(self.channels)

    # -- PUD ----------------------------------------------------------------
    def dispatch_pud(
        self,
        row_subarrays: np.ndarray,
        row_ns: float,
        now_ns: Optional[float] = None,
    ) -> PudDispatch:
        """Execute one PUD op whose rows live in ``row_subarrays`` (global
        subarray IDs, one per row).  Rows are partitioned by owning channel
        and enqueued per controller; the op completes at the max of the
        per-channel completion times."""
        now = self.now_ns if now_ns is None else now_ns
        counts = channel_row_counts(row_subarrays, self.amap)
        done = now
        for c, n in enumerate(counts.tolist()):
            if n:
                done = max(done, self.channels[c].enqueue_pud(n, row_ns, now))
        self.now_ns = max(self.now_ns, done)
        if self.recorder is not None:
            self.recorder.emit(
                "ctrl_pud",
                rows_per_channel=counts.tolist(), row_ns=float(row_ns),
                start=float(now), done=float(done),
            )
        return PudDispatch(now, done, counts.tolist())

    def peek_pud(
        self,
        row_subarrays: np.ndarray,
        row_ns: float,
        now_ns: Optional[float] = None,
    ) -> PudDispatch:
        """Queue-state-aware estimate of :meth:`dispatch_pud` — no mutation."""
        now = self.now_ns if now_ns is None else now_ns
        counts = channel_row_counts(row_subarrays, self.amap)
        done = now
        for c, n in enumerate(counts.tolist()):
            if n:
                done = max(done, self.channels[c].peek_pud(n, row_ns, now))
        return PudDispatch(now, done, counts.tolist())

    # -- normal traffic ------------------------------------------------------
    def dispatch_accesses(
        self, pas: np.ndarray, now_ns: Optional[float] = None
    ) -> float:
        """Price a burst of normal cacheline accesses at physical addresses
        ``pas``: partition by channel, FR-FCFS-lite within each.  Returns the
        burst completion time (max over channels)."""
        now = self.now_ns if now_ns is None else now_ns
        pas = np.asarray(pas, dtype=np.int64)
        if pas.size == 0:
            return now
        chan, rank, bank, sa = self.amap.region_coords(pas)
        # rank folds into the bank index: one controller schedules rank*bank
        geo = self.amap.geo
        bank_ids = rank * geo.banks_per_rank + bank
        rows = (pas >> self.amap._shifts["row"]) & self.amap._masks["row"]
        done = now
        for c in range(self.n_channels):
            m = chan == c
            if not m.any():
                continue
            pairs = list(zip(bank_ids[m].tolist(), rows[m].tolist()))
            done = max(done, self.channels[c].enqueue_accesses(pairs, now))
        self.now_ns = max(self.now_ns, done)
        if self.recorder is not None:
            # (channel, bank, row) triples, not raw PAs: the replay executor
            # re-queues them without needing the address map.
            self.recorder.emit(
                "ctrl_access",
                channels=self.n_channels,
                accesses=[
                    [int(c), int(b), int(r)]
                    for c, b, r in zip(
                        chan.tolist(), bank_ids.tolist(), rows.tolist()
                    )
                ],
                start=float(now), done=float(done),
            )
        return done

    # -- compaction / migration traffic ---------------------------------------
    def dispatch_migration(
        self,
        rowclone_subarrays: np.ndarray,
        row_ns: float,
        cpu_pas: Optional[np.ndarray] = None,
        now_ns: Optional[float] = None,
    ) -> float:
        """Queue one compaction pass's data movement on the channels.

        ``rowclone_subarrays`` — one global-subarray ID per same-subarray row
        copy: the substrate executes these in DRAM (RowClone FPM), so they
        enqueue as a PUD burst per owning channel.  ``cpu_pas`` — cacheline
        PAs touched by the cross-subarray copies the substrate cannot do
        (read at the source + write at the destination): they enqueue as
        normal FR-FCFS accesses, paying the SB<->PIM mode switch against any
        interleaved PUD traffic.  Returns the pass completion time; the
        channels stay busy until then, which is how background compaction
        competes with live traffic in the cost model.
        """
        now = self.now_ns if now_ns is None else now_ns
        done = now
        sas = np.asarray(rowclone_subarrays, dtype=np.int64)
        if sas.size:
            done = max(done, self.dispatch_pud(sas, row_ns, now).done_ns)
        if cpu_pas is not None and len(cpu_pas):
            done = max(done, self.dispatch_accesses(cpu_pas, now))
        self.now_ns = max(self.now_ns, done)
        return done

    # -- metrics -------------------------------------------------------------
    def occupancy_report(self) -> Dict[str, object]:
        """Per-channel occupancy + load balance — the channel figure of merit.

        ``busy_fraction`` is each channel's busy time over the makespan
        (``now_ns``); ``pud_row_balance`` is mean/max of per-channel PUD row
        counts (1.0 = perfectly striped placement, 1/C = everything on one
        channel)."""
        busy = [ch.stats.busy_ns for ch in self.channels]
        rows = np.asarray([ch.stats.pud_rows for ch in self.channels], float)
        span = self.now_ns
        mx = rows.max() if rows.size else 0.0
        return {
            "channels": self.n_channels,
            "makespan_ns": span,
            "busy_ns": busy,
            "busy_fraction": [b / span if span > 0 else 0.0 for b in busy],
            "pud_rows": rows.astype(int).tolist(),
            "pud_row_balance": float(rows.mean() / mx) if mx > 0 else 1.0,
            "mode_switches": [ch.stats.mode_switches for ch in self.channels],
            "injected_stalls": [ch.stats.injected_stalls for ch in self.channels],
            "injected_stall_ns": [
                ch.stats.injected_stall_ns for ch in self.channels
            ],
        }
