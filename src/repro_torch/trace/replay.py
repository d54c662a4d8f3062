"""Replay executor: re-price a recorded trace bit-exactly, offline.

``replay_trace`` rebuilds the cost models from the trace *header alone*
(:class:`~repro_torch.core.pud.PudCostModel`, :class:`~repro_torch.core.controller.
ControllerConfig`, fresh :class:`~repro_torch.core.controller.ChannelController`
state) and walks the events in order, recomputing every priced field —
RowClone burst completion times, FR-FCFS access bursts, ``pud_op`` times
through the same arithmetic :func:`repro_torch.core.pud.simulate_op` uses, and
the run totals — then compares each against the recorded value with exact
``==`` (all floats round-trip through JSON losslessly, and the replay
performs the identical operations on identical doubles, so bit-exact
equality is the contract, not a tolerance).

The replayer is deliberately independent of the live engine: it never
imports :mod:`repro_torch.serve` and needs no model, params, or allocator state.
A trace that replays clean is therefore a self-contained, re-priceable
artifact; a mismatch list pinpoints exactly which event and field drifted
(the loud failure mode the golden-trace test wants).

Controller state is split exactly as in recording: the header's
``channels`` controllers price kv traffic (``prefill``/``step`` events),
while ``ctrl_pud``/``ctrl_access`` events replay against a separate bank
of controllers sized from the events themselves (mirroring the live
:class:`~repro_torch.core.controller.DramController` the ops were dispatched
through).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core.controller import ChannelController, ControllerConfig
from repro_torch.core.pud import PudCostModel
from repro_torch.trace.record import SCHEMA_VERSION, TraceSchemaError, tile_runs

__all__ = ["ReplayResult", "parse_trace", "replay_trace"]


@dataclasses.dataclass
class ReplayResult:
    ok: bool
    n_events: int
    mismatches: List[str]
    totals: Optional[Dict[str, object]]      # recorded end-event totals
    recomputed: Dict[str, object]            # replayed counters/totals

    def report(self, limit: int = 20) -> str:
        if self.ok:
            return f"replay ok: {self.n_events} events bit-exact"
        head = self.mismatches[:limit]
        more = len(self.mismatches) - len(head)
        lines = [f"replay FAILED: {len(self.mismatches)} mismatches over "
                 f"{self.n_events} events"] + [f"  {m}" for m in head]
        if more > 0:
            lines.append(f"  ... and {more} more")
        return "\n".join(lines)


def parse_trace(text: str) -> List[Dict[str, object]]:
    """Parse JSONL and validate the header against the pinned schema."""
    events = [json.loads(line) for line in text.splitlines() if line.strip()]
    if not events or events[0].get("kind") != "header":
        raise TraceSchemaError("trace does not start with a header event")
    schema = events[0].get("schema")
    if schema != SCHEMA_VERSION:
        raise TraceSchemaError(
            f"trace schema {schema!r} != pinned SCHEMA_VERSION "
            f"{SCHEMA_VERSION} — regenerate the trace (and the golden, "
            f"deliberately) or replay with the matching repro.trace version"
        )
    return events


def replay_trace(
    trace: Union[str, Sequence[Dict[str, object]]]
) -> ReplayResult:
    """Re-price ``trace`` (JSONL text or parsed events) event by event."""
    events = parse_trace(trace) if isinstance(trace, str) else list(trace)
    header = events[0]
    model = PudCostModel(**header["model"])
    ctrl_cfg = ControllerConfig(**header["ctrl"])
    channels = int(header["channels"])
    banks = int(header["banks_per_channel"])
    bpa = int(header["blocks_per_arena"])
    block_bytes = int(header["block_bytes"])
    sim = header["sim"]

    kv_ctrls = [ChannelController(c, ctrl_cfg) for c in range(channels)]
    now_ns = 0.0
    cpu_ns = 0.0
    # separate controller bank for DramController-dispatched events
    dram_ctrls: List[ChannelController] = []
    dram_now = 0.0

    clock = 0
    tokens_decoded = 0
    tokens_prefilled = 0
    maintenance_ns = 0.0
    mismatches: List[str] = []
    totals: Optional[Dict[str, object]] = None

    def check(i: int, kind: str, field: str, recorded, replayed) -> None:
        if recorded != replayed:
            mismatches.append(
                f"event {i} ({kind}): {field}: recorded {recorded!r} "
                f"!= replayed {replayed!r}"
            )

    def need_dram(n: int) -> None:
        nonlocal dram_ctrls
        if not dram_ctrls:
            dram_ctrls = [ChannelController(c, ctrl_cfg) for c in range(n)]
        elif len(dram_ctrls) != n:
            mismatches.append(
                f"ctrl events disagree on channel count: "
                f"{len(dram_ctrls)} vs {n}"
            )

    for ev in events[1:]:
        i, kind = ev["i"], ev["kind"]
        if kind in ("admit", "extend", "release"):
            continue

        elif kind == "prefill":
            tiles = [int(t) for t in ev["tiles"]]
            runs = tile_runs(tiles)
            rowclone = [t for start, n in runs if n >= 2
                        for t in range(start, start + n)]
            cpu_tiles = [start for start, n in runs if n == 1]
            check(i, kind, "rowclone_rows", ev["rowclone_rows"], len(rowclone))
            check(i, kind, "cpu_rows", ev["cpu_rows"], len(cpu_tiles))
            counts = [0] * channels
            for t in rowclone:
                counts[(t // bpa) % channels] += 1
            check(i, kind, "rows_per_channel", ev["rows_per_channel"], counts)
            start = now_ns
            done = start
            row_ns = model.pud_row_ns("copy")
            for c, n in enumerate(counts):
                if n:
                    done = max(done, kv_ctrls[c].enqueue_pud(n, row_ns, start))
            now_ns = max(now_ns, done)
            c_ns = 0.0
            if cpu_tiles:
                c_ns = model.cpu_op_overhead_ns + model.cpu_ns(
                    "copy", len(cpu_tiles) * block_bytes, len(cpu_tiles)
                )
            cpu_ns += c_ns
            check(i, kind, "start", ev["start"], start)
            check(i, kind, "done", ev["done"], done)
            check(i, kind, "cpu_ns", ev["cpu_ns"], c_ns)
            tokens_prefilled += int(ev["tokens"])

        elif kind == "step":
            per: List[List[Tuple[int, int]]] = [[] for _ in range(channels)]
            for _slot, tile in ev["writes"]:
                arena = int(tile) // bpa
                bank = (arena // channels) % banks
                per[arena % channels].append((bank, int(tile)))
            start = now_ns
            done = start
            for c, pairs in enumerate(per):
                if pairs:
                    done = max(
                        done, kv_ctrls[c].enqueue_accesses(pairs, start)
                    )
            now_ns = max(now_ns, done)
            check(i, kind, "start", ev["start"], start)
            check(i, kind, "done", ev["done"], done)
            clock = int(ev["clock"])
            tokens_decoded += int(ev["decoded"])

        elif kind == "compact":
            if int(ev["executed"]):  # mirrors the engine's accounting guard
                maintenance_ns += float(ev["total_ns"])

        elif kind == "pud_op":
            op = ev["op"]
            pud_rows = int(ev["pud_rows"])
            cpu_rows = int(ev["cpu_rows"])
            rpc = ev["rows_per_channel"]
            row_ns = model.pud_row_ns(op)
            t: Optional[float]
            if pud_rows and rpc is not None:
                check(i, kind, "pud_rows", pud_rows, sum(rpc))
                if ev["ctrl"]:
                    need_dram(len(rpc))
                    start = dram_now
                    done = start
                    for c, n in enumerate(rpc):
                        if n:
                            done = max(
                                done,
                                dram_ctrls[c].peek_pud(int(n), row_ns, start),
                            )
                    t = done - start
                else:
                    t = int(max(rpc)) * row_ns
            elif pud_rows:
                t = None          # the adaptive dispatch picked the CPU
            else:
                t = 0.0
            if t is not None:
                if cpu_rows:
                    t += model.cpu_op_overhead_ns
                    t += model.cpu_ns(op, int(ev["cpu_bytes"]), cpu_rows)
                elif pud_rows:
                    t += model.cpu_op_overhead_ns
            t_cpu = model.cpu_op_overhead_ns + model.cpu_ns(
                op, int(ev["size"]), max(int(ev["n_rows"]), 1)
            )
            if t is None:
                t = t_cpu
            faulted = int(ev["faulted_rows"])
            if faulted and rpc is not None:
                if not cpu_rows:
                    t += model.cpu_op_overhead_ns
                t += model.cpu_ns(
                    op, faulted * int(ev["region_bytes"]), faulted
                )
            check(i, kind, "t_ns", ev["t_ns"], t)
            check(i, kind, "t_cpu_ns", ev["t_cpu_ns"], t_cpu)

        elif kind == "ctrl_pud":
            rpc = [int(n) for n in ev["rows_per_channel"]]
            need_dram(len(rpc))
            row_ns = float(ev["row_ns"])
            start = dram_now
            done = start
            for c, n in enumerate(rpc):
                if n:
                    done = max(
                        done, dram_ctrls[c].enqueue_pud(n, row_ns, start)
                    )
            dram_now = max(dram_now, done)
            check(i, kind, "start", ev["start"], start)
            check(i, kind, "done", ev["done"], done)

        elif kind == "ctrl_access":
            need_dram(int(ev["channels"]))
            start = dram_now
            done = start
            for c in range(len(dram_ctrls)):
                pairs = [
                    (int(b), int(r)) for ch, b, r in ev["accesses"]
                    if int(ch) == c
                ]
                if pairs:
                    done = max(
                        done, dram_ctrls[c].enqueue_accesses(pairs, start)
                    )
            dram_now = max(dram_now, done)
            check(i, kind, "start", ev["start"], start)
            check(i, kind, "done", ev["done"], done)

        elif kind == "end":
            totals = {k: v for k, v in ev.items() if k not in ("i", "kind")}
            check(i, kind, "clock", ev["clock"], clock)
            check(i, kind, "tokens_decoded", ev["tokens_decoded"],
                  tokens_decoded)
            check(i, kind, "tokens_prefilled", ev["tokens_prefilled"],
                  tokens_prefilled)
            check(i, kind, "maintenance_ns", ev["maintenance_ns"],
                  maintenance_ns)
            sim_ns = (
                sim["step_overhead_ns"] * int(ev["clock"])
                + sim["decode_token_ns"] * int(ev["tokens_decoded"])
                + sim["prefill_token_ns"] * int(ev["tokens_prefilled"])
                + float(ev["maintenance_ns"])
            )
            check(i, kind, "sim_ns", ev["sim_ns"], sim_ns)
            check(i, kind, "mem_ns", ev["mem_ns"], now_ns)
            check(i, kind, "cpu_ns", ev["cpu_ns"], cpu_ns)

        else:
            mismatches.append(f"event {i}: unknown kind {kind!r}")

    recomputed = {
        "clock": clock,
        "tokens_decoded": tokens_decoded,
        "tokens_prefilled": tokens_prefilled,
        "maintenance_ns": maintenance_ns,
        "mem_ns": now_ns,
        "cpu_ns": cpu_ns,
        "sim_ns": (
            sim["step_overhead_ns"] * clock
            + sim["decode_token_ns"] * tokens_decoded
            + sim["prefill_token_ns"] * tokens_prefilled
            + maintenance_ns
        ),
    }
    return ReplayResult(
        ok=not mismatches,
        n_events=len(events),
        mismatches=mismatches,
        totals=totals,
        recomputed=recomputed,
    )
