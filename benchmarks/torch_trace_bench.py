"""Trace & offload benchmark of the port: the reference's
``benchmarks/trace_bench.py`` on ``repro_torch``.

Three record families, all pure functions of pinned seeds:

* ``offload/{arch}/{allocator}`` — the GEMV/MoE decode offload model
  (:mod:`repro_torch.trace.gemv`) for each arch in
  :data:`repro_torch.configs.registry.TRACE_ARCHS` under all four allocator
  placements: PUD-offloaded row fraction, priced decode time, and the
  speedup of the adaptive PUD dispatch over CPU-only decode.
* ``channel/{arch}`` — PUMA channel-striped placement on a 4-channel
  BANK_REGION map dispatched through a live DRAM controller: makespan,
  per-channel balance, and parallel speedup over a serial row burst.
* ``serve/steady_trace`` — the ``steady`` serving scenario played through
  the port's ``ServeEngine`` on ``--device``, recorded into an op trace and
  re-priced bit-exactly by the replay executor; the record carries the end
  totals and the replay verdict.

No field is wall clock (``WALL_CLOCK`` is empty: the walls go to the CSV
rows only), so the smoke records equal the committed ``BENCH_trace.json``
but for its gate-only ``determinism`` entry.  ``--gate`` reruns everything
and asserts the canonical JSON is byte-identical; ``check`` (the reference's
gate) runs always.  Nothing is written unless ``--out`` is given::

    PYTHONPATH=src python benchmarks/torch_trace_bench.py --smoke --device cpu \
        --against BENCH_trace.json
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Callable, Dict, Tuple

_HERE = Path(__file__).resolve().parent
for _p in (_HERE, _HERE.parent / "src"):
    if str(_p) not in sys.path:
        sys.path.append(str(_p))

import torch_records  # noqa: E402

#: no field of these records comes from ``time.perf_counter``
WALL_CLOCK: Dict[str, Tuple[str, ...]] = {}


def bench(smoke: bool = False, device="cuda") -> Tuple[Dict, Dict[str, float]]:
    from repro_torch.configs.registry import TRACE_ARCHS
    from repro_torch.trace.gemv import ALLOCATORS, channel_study, offload_report
    from repro_torch.trace.record import SCHEMA_VERSION
    from repro_torch.trace.replay import parse_trace, replay_trace
    from repro_torch.trace.serve_trace import record_scenario

    n_tokens = 2 if smoke else 4
    results: Dict[str, Dict] = {}
    walls: Dict[str, float] = {}
    for arch in TRACE_ARCHS:
        for al in ALLOCATORS:
            t0 = time.perf_counter()
            results[f"offload/{arch}/{al}"] = offload_report(
                arch, al, n_tokens=n_tokens
            )
            walls[f"offload/{arch}/{al}"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        results[f"channel/{arch}"] = channel_study(arch, n_tokens=n_tokens)
        walls[f"channel/{arch}"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    trace, rec = record_scenario("steady", smoke=smoke, device=device)
    text = trace.to_jsonl()
    res = replay_trace(parse_trace(text))
    end = trace.events[-1]
    results["serve/steady_trace"] = {
        "scenario": "steady",
        "smoke": smoke,
        "schema": SCHEMA_VERSION,
        "events": len(trace.events),
        "done": rec["done"],
        "submitted": rec["submitted"],
        "clock": end["clock"],
        "tokens_decoded": end["tokens_decoded"],
        "tokens_prefilled": end["tokens_prefilled"],
        "sim_ns": end["sim_ns"],
        "mem_ns": end["mem_ns"],
        "cpu_ns": end["cpu_ns"],
        "maintenance_ns": end["maintenance_ns"],
        "replay_ok": bool(res.ok),
        "replay_mismatches": len(res.mismatches),
    }
    walls["serve/steady_trace"] = time.perf_counter() - t0

    results["config"] = {
        "archs": list(TRACE_ARCHS),
        "allocators": list(ALLOCATORS),
        "n_tokens": n_tokens,
        "schema": SCHEMA_VERSION,
        "smoke": smoke,
    }
    return results, walls


def _canon(results: Dict) -> str:
    return json.dumps(results, indent=1, sort_keys=True)


def check(results: Dict) -> None:
    """The reference's gate assertions."""
    from repro_torch.configs.registry import TRACE_ARCHS

    for arch in TRACE_ARCHS:
        frac = {
            al: results[f"offload/{arch}/{al}"]["offload_fraction"]
            for al in ("malloc", "posix_memalign", "hugepage", "puma")
        }
        sp = {
            al: results[f"offload/{arch}/{al}"]["speedup_vs_cpu"]
            for al in frac
        }
        # the paper's allocator story, at decode-step granularity
        assert frac["malloc"] == 0.0, (arch, frac)
        assert frac["posix_memalign"] == 0.0, (arch, frac)
        assert 0.0 < frac["hugepage"] < 0.95, (arch, frac)
        assert frac["puma"] >= 0.99, (arch, frac)
        for al in ("malloc", "posix_memalign", "hugepage"):
            assert frac["puma"] > frac[al], (arch, al, frac)
        # adaptive dispatch: never slower than CPU; PUMA clearly faster
        assert sp["malloc"] == 1.0 and sp["posix_memalign"] == 1.0, (arch, sp)
        assert sp["hugepage"] >= 1.0, (arch, sp)
        assert sp["puma"] >= 1.5, (arch, sp)
        ch = results[f"channel/{arch}"]
        assert ch["offload_fraction"] >= 0.99, (arch, ch)
        assert ch["parallel_speedup"] >= 2.0, (arch, ch)
        assert 0.0 < ch["balance"] <= 1.0, (arch, ch)
    sv = results["serve/steady_trace"]
    assert sv["replay_ok"] and sv["replay_mismatches"] == 0, sv
    assert sv["events"] > 0 and sv["sim_ns"] > 0, sv


def run(emit: Callable[[str, float, float], None], smoke: bool = False,
        gate: bool = False, device="cuda") -> Dict:
    """``benchmarks/torch_run.py`` hook: emit CSV rows."""
    results, walls = bench(smoke=smoke, device=device)
    if gate:
        rerun, _ = bench(smoke=smoke, device=device)
        results["determinism"] = {
            "identical": _canon(results) == _canon(rerun),
            "reruns": 2,
        }
        assert results["determinism"]["identical"], \
            "fixed-seed rerun diverged from the first pass"
    for name, wall in walls.items():
        rec = results[name]
        metric = rec.get("offload_fraction", rec.get("sim_ns", 0.0))
        emit(f"trace/{name}", 1e6 * wall, metric)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--smoke", action="store_true", help="fast CI mode")
    ap.add_argument("--gate", action="store_true",
                    help="rerun and assert byte-identical")
    ap.add_argument("--device", default="cuda")
    torch_records.add_flags(ap)
    args = ap.parse_args(argv)
    results = run(lambda n, us, d: print(f"{n},{us:.1f},{d}"),
                  smoke=args.smoke, gate=args.gate, device=args.device)
    for key, rec in sorted(results.items()):
        if key.startswith("offload/"):
            print(f"  {key:<45} frac={rec['offload_fraction']:<9} "
                  f"speedup={rec['speedup_vs_cpu']}")
        elif key.startswith("channel/"):
            print(f"  {key:<45} parallel={rec['parallel_speedup']} "
                  f"balance={rec['balance']}")
    sv = results["serve/steady_trace"]
    print(f"  serve/steady_trace: events={sv['events']} "
          f"replay_ok={sv['replay_ok']} sim_ns={sv['sim_ns']} on {args.device}")
    if "determinism" in results:
        print(f"  deterministic: {results['determinism']['identical']}")
    check(results)
    return torch_records.finish("torch_trace_bench", results, args, WALL_CLOCK,
                                skip=("determinism",))


if __name__ == "__main__":
    sys.exit(main())
