"""Serving load benchmark of the port: the five fixed-seed scenarios of
``benchmarks/serve_bench.py`` (steady, bursty, long_context, multi_tenant,
cancel_heavy) driven through ``repro_torch``'s ``ServeEngine`` by its
``serve/loadgen.py``, with the same smoke model, pool and
``MaintenanceConfig()``.

Each scenario gives one record of the reference's schema: SimCost
tokens/s, p50/p99 queue and completion latency in engine ticks, pool
occupancy, live contiguity, channel balance and the degraded-mode ledger.
They are functions of the scenario seeds alone (SimCost prices the run and
``eos_id`` is None, so the weights do not enter), so they must equal the
reference's ``BENCH_serve.json`` records; ``--against`` checks that.
Wall-clock times go to stdout only::

    PYTHONPATH=src python benchmarks/torch_serve_bench.py --smoke --device cpu \\
        --against BENCH_serve.json
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import Dict, Tuple

_HERE = Path(__file__).resolve().parent
for _p in (_HERE, _HERE.parent / "src"):
    if str(_p) not in sys.path:
        sys.path.append(str(_p))

import torch_records  # noqa: E402

#: no field of these records comes from the host's clock
WALL_CLOCK: Dict[str, Tuple[str, ...]] = {}


def make_engine(scenario, device="cuda"):
    from repro_torch.core.kv_pool import KVPoolConfig
    from repro_torch.serve.engine import MaintenanceConfig, ServeEngine
    from repro_torch.trace.serve_trace import smoke_model

    model, params = smoke_model(device)
    cfg = model.cfg
    base = dict(
        num_blocks=32, block_size=8, kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
        n_layers=cfg.n_layers, max_seqs=4, max_blocks_per_seq=16,
        blocks_per_arena=16, policy="puma", dtype="float32",
    )
    base.update(scenario.pool_overrides())
    return ServeEngine(model, params, KVPoolConfig(**base), device=device,
                       maintenance=MaintenanceConfig())


def run_scenario(name: str, smoke: bool, device="cuda") -> Tuple[Dict, float]:
    """One scenario end to end: (record, wall seconds); wall time is never
    part of the record."""
    from repro_torch.robustness import check_engine
    from repro_torch.serve.loadgen import build_scenario, play

    sc = build_scenario(name, smoke=smoke)
    eng = make_engine(sc, device)
    t0 = time.perf_counter()
    rec = play(eng, sc.generate(), max_steps=sc.max_steps)
    wall = time.perf_counter() - t0
    check_engine(eng).assert_ok()
    rec["scenario"] = {
        "seed": sc.seed,
        "arrival": sc.arrival.kind,
        "tenants": [t.name for t in sc.tenants],
        "pool": sc.pool_overrides(),
        "description": sc.description,
    }
    return rec, wall


def bench(smoke: bool = False, device="cuda") -> Tuple[Dict, Dict[str, float]]:
    from repro_torch.serve.loadgen import SCENARIO_NAMES

    results: Dict[str, Dict] = {}
    walls: Dict[str, float] = {}
    for name in SCENARIO_NAMES:
        results[f"scenario/{name}"], walls[name] = run_scenario(name, smoke, device)
    results["config"] = {
        "model": "stablelm_1_6b.smoke",
        "scenarios": list(SCENARIO_NAMES),
        "smoke": smoke,
        "time_model": "SimCost (deterministic; wall clock not persisted)",
    }
    return results, walls


def differing(results: Dict, reference: Dict) -> list:
    """Keys whose records differ from the reference's (``config`` and the
    scenario records; the reference's ``determinism`` entry is its gate's)."""
    return torch_records.differing(results, reference, WALL_CLOCK, skip=("determinism",))


def run(emit, smoke: bool = False, device="cuda") -> Dict:
    """``benchmarks/torch_run.py`` hook: emit the reference's CSV rows (wall
    us, SimCost tokens/s)."""
    results, walls = bench(smoke=smoke, device=device)
    for name, wall in walls.items():
        emit(f"serve/{name}", 1e6 * wall, results[f"scenario/{name}"]["tokens_per_s"])
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--smoke", action="store_true", help="the smoke request counts")
    ap.add_argument("--device", default="cuda")
    torch_records.add_flags(ap)
    args = ap.parse_args(argv)
    results, walls = bench(smoke=args.smoke, device=args.device)
    for name, wall in walls.items():
        rec = results[f"scenario/{name}"]
        print(f"  {name:<13} done={rec['done']:>4}/{rec['submitted']:<4} "
              f"tok/s(SimCost)={rec['tokens_per_s']:>10.1f} "
              f"p50/p99={rec['p50_complete_steps']}/{rec['p99_complete_steps']} "
              f"contig={rec['contiguity']:.3f} wall={wall:.2f}s on {args.device}")
    return torch_records.finish("torch_serve_bench", results, args, WALL_CLOCK,
                                skip=("determinism",))


if __name__ == "__main__":
    sys.exit(main())
