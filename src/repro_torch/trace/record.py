"""Tracegen recorder: the serving engine's memory ops as a replayable trace.

One :class:`TraceRecorder` instance hooks three layers at once:

* :class:`~repro_torch.serve.engine.ServeEngine` / :class:`~repro_torch.core.kv_pool.
  PagedKVPool` — request lifecycle (admit / extend / release), prompt-KV
  block fills (RowClone row-copy bursts for contiguous tile runs, CPU
  fallback for singleton tiles), decode-token block writes (per-channel
  FR-FCFS read/write bursts), and compaction passes.
* :mod:`repro_torch.core.pud` — every ``simulate_op`` call (the GEMV/MoE offload
  model's MAC stream) lands as one ``pud_op`` event carrying the full
  pricing breakdown: PUD rows per channel, CPU-fallback rows/bytes,
  chosen-path time vs CPU-only time, allocator provenance via ``label``.
* :class:`~repro_torch.core.controller.DramController` — channel-level dispatch
  (``ctrl_pud`` / ``ctrl_access``) with per-channel row counts and
  (channel, bank, row) coordinates.

The trace is JSONL with a pinned schema (:data:`SCHEMA_VERSION`): line 0 is
a ``header`` event carrying the schema version, the channel/bank geometry,
and every cost-model constant needed to re-price the trace from scratch;
each subsequent line is one event with a monotonic index ``i``; an optional
``end`` event carries the run totals.  Every field is a JSON scalar/list
and every float is serialized at full precision (shortest round-trip repr),
so *byte-identical regeneration* and *bit-exact replay*
(:mod:`repro_torch.trace.replay`) are both meaningful invariants — the golden
trace under ``tests/goldens/`` pins them in CI.

Pricing inside the recorder reuses :class:`~repro_torch.core.controller.
ChannelController` directly (one per channel, same FR-FCFS-lite / mode-
switch model the DRAM controller uses), so the kv-traffic timings in the
trace are the controller model's numbers, not a parallel implementation.
KV traffic is priced at *tile* granularity: one pool tile ≙ one DRAM row
of its arena ("subarray"), the channel is ``arena % channels`` and the bank
``(arena // channels) % banks_per_channel`` — the same mapping
:class:`~repro_torch.core.arena.TilePool` stripes by.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.controller import ChannelController, ControllerConfig
from repro_torch.core.pud import PudCostModel

__all__ = [
    "SCHEMA_VERSION",
    "TraceSchemaError",
    "TraceRecorder",
    "tile_runs",
]

#: Pinned trace schema. Bump on ANY change to event kinds, field names, or
#: pricing semantics — the golden-trace test and the replay executor both
#: refuse traces whose header disagrees.
SCHEMA_VERSION = 1

#: default serving-time model constants mirrored into the header
#: (must match :class:`repro_torch.serve.loadgen.SimCost`; serve_trace passes the
#: live values — these are only the stand-alone-recorder defaults).
DEFAULT_SIM = {
    "step_overhead_ns": 2_000.0,
    "decode_token_ns": 500.0,
    "prefill_token_ns": 150.0,
}


class TraceSchemaError(ValueError):
    """A trace's header does not match the pinned schema."""


def tile_runs(tiles: Sequence[int]) -> List[Tuple[int, int]]:
    """Maximal (start, length) runs of consecutive tile indices — the same
    partition :meth:`repro_torch.core.arena.TileHandle.runs` produces."""
    out: List[Tuple[int, int]] = []
    i = 0
    n = len(tiles)
    while i < n:
        j = i
        while j + 1 < n and tiles[j + 1] == tiles[j] + 1:
            j += 1
        out.append((tiles[i], j - i + 1))
        i = j + 1
    return out


class TraceRecorder:
    """Versioned, seed-deterministic per-channel op trace (JSONL)."""

    def __init__(
        self,
        *,
        channels: int = 1,
        banks_per_channel: int = 8,
        blocks_per_arena: int = 1,
        block_bytes: int = 0,
        model: Optional[PudCostModel] = None,
        ctrl: Optional[ControllerConfig] = None,
        sim: Optional[Dict[str, float]] = None,
        meta: Optional[Dict[str, object]] = None,
    ):
        self.model = model or PudCostModel()
        self.ctrl_cfg = ctrl or ControllerConfig()
        self.sim = dict(DEFAULT_SIM)
        if sim:
            self.sim.update(sim)
        self.channels = int(channels)
        self.banks_per_channel = int(banks_per_channel)
        self.blocks_per_arena = int(blocks_per_arena)
        self.block_bytes = int(block_bytes)
        # the kv-traffic pricing state: one controller per channel, same
        # model the DRAM controller uses (ctrl_* events keep their own).
        self.ctrls = [
            ChannelController(c, self.ctrl_cfg) for c in range(self.channels)
        ]
        self.now_ns = 0.0       # in-DRAM frontier (max completion so far)
        self.cpu_ns = 0.0       # accumulated CPU-fallback time
        self.events: List[Dict[str, object]] = []
        self._emit_header(meta or {})

    # -- event plumbing ------------------------------------------------------
    def _emit_header(self, meta: Dict[str, object]) -> None:
        m, c = self.model, self.ctrl_cfg
        self.emit(
            "header",
            schema=SCHEMA_VERSION,
            channels=self.channels,
            banks_per_channel=self.banks_per_channel,
            blocks_per_arena=self.blocks_per_arena,
            block_bytes=self.block_bytes,
            model={
                "aap_ns": m.aap_ns,
                "pud_issue_ns": m.pud_issue_ns,
                "cpu_bw_gbs": m.cpu_bw_gbs,
                "cpu_op_overhead_ns": m.cpu_op_overhead_ns,
                "cpu_row_touch_ns": m.cpu_row_touch_ns,
            },
            ctrl={
                "mode_switch_ns": c.mode_switch_ns,
                "row_hit_ns": c.row_hit_ns,
                "row_miss_ns": c.row_miss_ns,
                "cacheline_bytes": c.cacheline_bytes,
            },
            sim=self.sim,
            meta=meta,
        )

    def emit(self, kind: str, **fields) -> Dict[str, object]:
        """Append one event; ``i`` is the monotonic per-trace index."""
        ev: Dict[str, object] = {"i": len(self.events), "kind": kind}
        ev.update(fields)
        self.events.append(ev)
        return ev

    # -- kv-pool / engine hooks ----------------------------------------------
    def on_admit(self, slot: int, tiles: Sequence[int], alloc: str) -> None:
        self.emit(
            "admit", slot=int(slot), tiles=[int(t) for t in tiles],
            alloc=alloc,
        )

    def on_extend(self, slot: int, tile: int, contig: bool) -> None:
        """One decode-time growth block; ``contig`` = the new tile extends
        the previous run (PUMA ``extend`` hit its adjacent slot)."""
        self.emit(
            "extend", slot=int(slot), tile=int(tile), contig=bool(contig),
        )

    def on_release(self, slot: int) -> None:
        self.emit("release", slot=int(slot))

    def on_prefill(
        self, slot: int, rid: int, tokens: int, tiles: Sequence[int]
    ) -> None:
        """Prompt-KV block fill: contiguous tile runs are RowClone row
        copies (one row per tile, executed channel-parallel by owning
        arena), singleton tiles fall back to a CPU streaming write."""
        runs = tile_runs([int(t) for t in tiles])
        rowclone = [t for start, n in runs if n >= 2
                    for t in range(start, start + n)]
        cpu_tiles = [start for start, n in runs if n == 1]
        counts = [0] * self.channels
        for t in rowclone:
            counts[(t // self.blocks_per_arena) % self.channels] += 1
        start_ns = self.now_ns
        done = start_ns
        row_ns = self.model.pud_row_ns("copy")
        for c, n in enumerate(counts):
            if n:
                done = max(done, self.ctrls[c].enqueue_pud(n, row_ns, start_ns))
        self.now_ns = max(self.now_ns, done)
        cpu_ns = 0.0
        if cpu_tiles:
            cpu_ns = self.model.cpu_op_overhead_ns + self.model.cpu_ns(
                "copy", len(cpu_tiles) * self.block_bytes, len(cpu_tiles)
            )
        self.cpu_ns += cpu_ns
        self.emit(
            "prefill",
            slot=int(slot), rid=int(rid), tokens=int(tokens),
            tiles=[int(t) for t in tiles],
            rowclone_rows=len(rowclone), cpu_rows=len(cpu_tiles),
            rows_per_channel=counts, start=start_ns, done=done,
            cpu_ns=cpu_ns,
        )

    def on_step(
        self, clock: int, decoded: int, writes: Sequence[Tuple[int, int]]
    ) -> None:
        """One engine tick: each decoded token's KV lands in its sequence's
        current block — a normal (bank, row) access burst per channel."""
        per: List[List[Tuple[int, int]]] = [[] for _ in range(self.channels)]
        for _slot, tile in writes:
            arena = int(tile) // self.blocks_per_arena
            bank = (arena // self.channels) % self.banks_per_channel
            per[arena % self.channels].append((bank, int(tile)))
        start_ns = self.now_ns
        done = start_ns
        for c, pairs in enumerate(per):
            if pairs:
                done = max(done, self.ctrls[c].enqueue_accesses(pairs, start_ns))
        self.now_ns = max(self.now_ns, done)
        self.emit(
            "step",
            clock=int(clock), decoded=int(decoded),
            writes=[[int(s), int(t)] for s, t in writes],
            start=start_ns, done=done,
        )

    def on_compact(self, moves: Sequence[Tuple[int, int]], report) -> None:
        """One executed compaction pass (already priced by the compaction
        engine — the event carries the outcome, replay sums the cost)."""
        self.emit(
            "compact",
            moves=[[int(s), int(d)] for s, d in moves],
            executed=int(report.executed),
            rowclone_rows=int(report.rowclone_rows),
            cpu_rows=int(report.cpu_rows),
            bytes_moved=int(report.bytes_moved),
            total_ns=float(report.total_ns),
        )

    # -- totals --------------------------------------------------------------
    def finalize(
        self,
        *,
        clock: int,
        tokens_decoded: int,
        tokens_prefilled: int,
        maintenance_ns: float,
    ) -> Dict[str, object]:
        """Close the trace with the run totals.  ``sim_ns`` follows
        :meth:`repro_torch.serve.loadgen.SimCost.total_ns` term for term (same
        left-associated sum — bit-exact against the live engine)."""
        s = self.sim
        sim_ns = (
            s["step_overhead_ns"] * clock
            + s["decode_token_ns"] * tokens_decoded
            + s["prefill_token_ns"] * tokens_prefilled
            + maintenance_ns
        )
        totals = {
            "clock": int(clock),
            "tokens_decoded": int(tokens_decoded),
            "tokens_prefilled": int(tokens_prefilled),
            "maintenance_ns": float(maintenance_ns),
            "sim_ns": sim_ns,
            "mem_ns": self.now_ns,
            "cpu_ns": self.cpu_ns,
            "events": len(self.events) + 1,
        }
        self.emit("end", **totals)
        return totals

    # -- serialization -------------------------------------------------------
    def to_jsonl(self) -> str:
        """Canonical JSONL: sorted keys, no whitespace, one event per line.
        Floats use the shortest round-trip repr, so parse→serialize is the
        identity and byte-identity is a meaningful regression check."""
        return "".join(
            json.dumps(e, sort_keys=True, separators=(",", ":")) + "\n"
            for e in self.events
        )

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_jsonl())
