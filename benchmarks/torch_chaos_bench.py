"""Chaos benchmark of the port: the reference's ``benchmarks/chaos_bench.py``
(degraded-mode metrics under injected faults) on ``repro_torch``.

The documented chaos-suite fault plan —

  * RowClone row-failure rate **1e-3** (paper-scale transient AAP faults),
  * huge-page-pool exhaustion / transient allocation-miss rate **10 %**,
  * **one blacklisted subarray** (permanent manufacturing fault),
  * 1 % controller stalls (refresh storms),

all from one fixed seed, gives these records:

* ``alloc/clean`` vs ``alloc/faulty`` — allocation churn through
  :class:`~repro_torch.core.puma.RobustAllocator`: every request must be
  served; fallback fraction, retries, refills, simulated backoff.
* ``pud/<op>/degraded`` — simulated PUD latency with mid-flight RowClone
  faults vs fault-free (``speedup`` = clean/degraded <= 1).
* ``serve/clean`` vs ``serve/faulty`` — the hardened ``ServeEngine`` on a
  tight KV pool, on ``--device``: p50/p99 completion latency (engine
  steps), preemptions, and the zero-silent-drop ledger.
* ``determinism`` — the faulty allocation section re-run from the same
  seed must reproduce its stats bit-for-bit.

The serve records count engine steps with ``eos_id=None``, so they do not
depend on the weights or the device.  Only ``seconds`` and
``alloc/faulty``'s ``speedup`` (a ratio of two of them) are wall clock
(``WALL_CLOCK``).  ``check`` is the reference CI's gate.  Nothing is written
unless ``--out`` is given::

    PYTHONPATH=src python benchmarks/torch_chaos_bench.py --smoke --device cpu \
        [--out PATH] [--against BENCH_faults.json]
"""
from __future__ import annotations

import argparse
import random
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

_HERE = Path(__file__).resolve().parent
for _p in (_HERE, _HERE.parent / "src"):
    if str(_p) not in sys.path:
        sys.path.append(str(_p))

import torch_records  # noqa: E402
from repro_torch.core import pud  # noqa: E402
from repro_torch.core.allocators import PhysicalMemory  # noqa: E402
from repro_torch.core.dram import AddressMap, DramGeometry  # noqa: E402
from repro_torch.core.puma import PumaAllocator, RobustAllocator  # noqa: E402
from repro_torch.robustness import FaultInjector, FaultPlan, check_allocator  # noqa: E402

#: the fields of each record kind that come from ``time.perf_counter``
#: (``alloc/faulty``'s ``speedup`` is clean seconds / faulty seconds; the
#: serve records' ``speedup`` is a ratio of engine steps)
WALL_CLOCK = {"alloc": ("seconds", "speedup"), "serve": ("seconds",)}

#: fixed seed: the whole benchmark is reproducible bit-for-bit, which the
#: CI gate asserts.
CHAOS_SEED = 1234

AMAP = AddressMap()
REGION = AMAP.region_bytes
# churn geometry: 1 MB subarrays (128 rows), so blacklisting one subarray
# quarantines *part* of the pool rather than all of it (a default-geometry
# subarray is 8 MB and would swallow the whole 4 MB PUD pool).
CHURN_AMAP = AddressMap(DramGeometry(rows_per_subarray=128))


def _churn_mem(injector=None) -> PhysicalMemory:
    return PhysicalMemory(CHURN_AMAP, n_huge_pages=5, seed=0,
                          injector=injector)


def _covered_subarray() -> int:
    """A subarray the churn's PUD pool actually covers, probed fault-free
    (fixed memory seed, so deterministic) — blacklisting it guarantees the
    boot quarantine has something to quarantine."""
    pa = PumaAllocator(_churn_mem())
    pa.pim_preallocate(2)
    a = pa.pim_alloc(REGION)
    return int(CHURN_AMAP.region_subarray(a.extents[0].pa))


def chaos_plan() -> FaultPlan:
    """The documented chaos-suite fault plan."""
    return FaultPlan(
        seed=CHAOS_SEED,
        rowclone_fail_rate=1e-3,
        huge_exhaust_rate=0.10,
        alloc_miss_rate=0.10,
        channel_stall_rate=0.01,
        blacklist_subarrays=(_covered_subarray(),),
    )


# ---------------------------------------------------------------------------
# allocation churn through the fallback chain
# ---------------------------------------------------------------------------

def _churn_alloc(n_ops: int, injector: Optional[FaultInjector]) -> Dict:
    # deliberately tight: 5 huge pages total, 2 preallocated to the PUD
    # pool, so sustained churn drains tier 1 and exercises the full
    # PUMA -> huge -> base fallback chain (base pages never run out here).
    pa = PumaAllocator(_churn_mem(injector), injector=injector)
    pa.pim_preallocate(2)
    ra = RobustAllocator(pa)
    rng = random.Random(CHAOS_SEED)
    live: List = []
    t0 = time.perf_counter()
    for _ in range(n_ops):
        if live and rng.random() < 0.35:
            ra.free(live.pop(rng.randrange(len(live))))
        else:
            live.append(ra.alloc(rng.randint(1, 64) * REGION))
    seconds = time.perf_counter() - t0
    check_allocator(pa).assert_ok()
    for a in live:
        ra.free(a)
    st = ra.stats
    return {
        "n": n_ops,
        "seconds": seconds,
        "served": st.served,
        "fallback_fraction": st.fallback_fraction(),
        "tiers": {"puma": st.puma, "huge": st.huge, "base": st.base},
        "retries": st.retries,
        "refills": st.refills,
        "backoff_ns": st.backoff_ns,
        "quarantined_regions": pa.quarantined_regions(),
        "injected": injector.stats.as_dict() if injector else None,
    }


# ---------------------------------------------------------------------------
# PUD latency under RowClone faults
# ---------------------------------------------------------------------------

def _pud_degradation(op: str, n_rows: int, n_ops: int) -> Dict:
    size = n_rows * REGION

    def operands(injector=None):
        mem = PhysicalMemory(AMAP, n_huge_pages=64, seed=1)
        pa = PumaAllocator(mem, injector=injector)
        pa.pim_preallocate(32)
        ops = [pa.pim_alloc(size)]
        while len(ops) < pud.N_OPERANDS[op]:
            ops.append(pa.pim_alloc_align(size, ops[0]))
        return ops

    clean_ops = operands()
    t_clean = sum(
        pud.simulate_op(op, clean_ops, AMAP).t_ns for _ in range(n_ops)
    )
    inj = FaultInjector(FaultPlan(seed=CHAOS_SEED,
                                  rowclone_fail_rate=1e-3))
    faulty_ops = operands(injector=inj)
    results = [
        pud.simulate_op(op, faulty_ops, AMAP, injector=inj)
        for _ in range(n_ops)
    ]
    t_faulty = sum(r.t_ns for r in results)
    return {
        "n": n_ops,
        "rows_per_op": n_rows,
        "clean_ns": t_clean,
        "degraded_ns": t_faulty,
        "speedup": t_clean / t_faulty,          # <= 1: degradation factor
        "faulted_rows": sum(r.faulted_rows for r in results),
        "injected": inj.stats.as_dict(),
    }


# ---------------------------------------------------------------------------
# hardened serving under faults
# ---------------------------------------------------------------------------

def _serve(n_requests: int, max_new: int, injector: Optional[FaultInjector],
           device="cuda") -> Dict:
    from repro_torch.configs.registry import get_config
    from repro_torch.core.kv_pool import KVPoolConfig
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.trace.serve_trace import smoke_model

    cfg = get_config("stablelm_1_6b").smoke()
    # the smoke model of the serve bench (attn_impl="naive"); eos_id is
    # None, so the weights never change the schedule
    model, params = smoke_model(device)
    pool_cfg = KVPoolConfig(
        num_blocks=8, block_size=4, kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
        n_layers=cfg.n_layers, max_seqs=2, max_blocks_per_seq=8,
        blocks_per_arena=8, policy="puma", dtype="float32",
    )
    eng = ServeEngine(model, params, pool_cfg, device=device,
                      injector=injector)
    rng = np.random.default_rng(CHAOS_SEED)
    for i in range(n_requests):
        eng.submit(Request(rid=i, prompt=list(rng.integers(0, 64, 10)),
                           max_new=max_new))
    latencies: Dict[int, int] = {}
    t0 = time.perf_counter()
    seen = 0
    for _ in range(1000):
        alive = eng.step()
        for r in eng.done[seen:]:
            latencies[r.rid] = eng.clock - r.submit_clock
        seen = len(eng.done)
        if not alive:
            break
    seconds = time.perf_counter() - t0
    lats = sorted(latencies.values())
    return {
        "n": n_requests,
        "seconds": seconds,
        "done": len(eng.done),
        "rejected": len(eng.rejected),
        "cancelled": len(eng.cancelled),
        "submitted": eng.submitted,
        "tokens": eng.tokens_decoded,
        "preemptions": eng.preemptions,
        "injected_misses": eng.pool.pool.stats.injected_misses,
        "p50_steps": float(np.percentile(lats, 50)) if lats else None,
        "p99_steps": float(np.percentile(lats, 99)) if lats else None,
    }


# ---------------------------------------------------------------------------

def bench(smoke: bool = False, device="cuda") -> Dict:
    n_alloc = 150 if smoke else 600
    n_pud = 20 if smoke else 100
    pud_rows = 128 if smoke else 512
    n_req = 4 if smoke else 8
    # 20-token sequences on a 32-token pool collide -> preemption; the
    # smoke sizes are the reference's.
    max_new = 6 if smoke else 10
    plan = chaos_plan()

    results: Dict[str, Dict] = {}
    results["alloc/clean"] = _churn_alloc(n_alloc, None)
    faulty = _churn_alloc(n_alloc, FaultInjector(plan))
    faulty["speedup"] = results["alloc/clean"]["seconds"] / faulty["seconds"]
    results["alloc/faulty"] = faulty

    # bit-for-bit reproducibility of the whole faulty section (fixed seed)
    replay = _churn_alloc(n_alloc, FaultInjector(plan))
    drop = ("seconds", "speedup")   # wall time is the only non-determinism
    results["determinism"] = {
        "n": n_alloc,
        "identical": {k: v for k, v in faulty.items() if k not in drop}
        == {k: v for k, v in replay.items() if k not in drop},
    }

    for op in ("copy", "and"):
        results[f"pud/{op}/degraded"] = _pud_degradation(op, pud_rows, n_pud)

    results["serve/clean"] = _serve(n_req, max_new, None, device)
    serve_faulty = _serve(
        n_req, max_new,
        FaultInjector(FaultPlan(seed=CHAOS_SEED, alloc_miss_rate=0.10)),
        device,
    )
    clean_p99 = results["serve/clean"]["p99_steps"]
    if clean_p99 and serve_faulty["p99_steps"]:
        serve_faulty["speedup"] = clean_p99 / serve_faulty["p99_steps"]
    results["serve/faulty"] = serve_faulty

    results["config"] = {
        "seed": CHAOS_SEED,
        "rowclone_fail_rate": plan.rowclone_fail_rate,
        "huge_exhaust_rate": plan.huge_exhaust_rate,
        "alloc_miss_rate": plan.alloc_miss_rate,
        "channel_stall_rate": plan.channel_stall_rate,
        "blacklist_subarrays": list(plan.blacklist_subarrays),
        "smoke": smoke,
    }
    return results


def check(results: Dict) -> None:
    """The reference CI's chaos gate on these records."""
    f, s = results["alloc/faulty"], results["serve/faulty"]
    # the fixed seed must reproduce the faulty section bit-for-bit
    assert results["determinism"]["identical"] is True, "faulty section not reproducible"
    # the fallback chain absorbs every fault: nothing is silently dropped
    assert f["injected"]["alloc_misses"] > 0 and f["retries"] > 0, f
    assert 0.0 < f["fallback_fraction"] < 1.0, f["fallback_fraction"]
    assert f["quarantined_regions"] > 0, f["quarantined_regions"]
    # RowClone faults fire at the documented 1e-3 rate and are priced
    for op in ("copy", "and"):
        p = results[f"pud/{op}/degraded"]
        assert p["faulted_rows"] > 0 and p["speedup"] < 1.0, (op, p)
    # serving ledger: done + rejected + cancelled == submitted (zero drops)
    assert s["done"] + s["rejected"] + s["cancelled"] == s["submitted"], s
    assert s["done"] > 0 and s["injected_misses"] > 0, s


def run(emit: Callable[[str, float, float], None], smoke: bool = False,
        device="cuda") -> Dict:
    """``benchmarks/torch_run.py`` hook: emit CSV rows."""
    results = bench(smoke=smoke, device=device)
    for name, rec in results.items():
        if name == "config":
            continue
        us = 1e6 * rec.get("seconds", 0.0)
        emit(f"faults/{name}", us, round(rec.get("speedup", 0.0), 3))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--smoke", action="store_true", help="fast CI mode")
    ap.add_argument("--device", default="cuda")
    torch_records.add_flags(ap)
    args = ap.parse_args(argv)
    results = run(lambda n, us, d: print(f"{n},{us:.1f},{d}"), smoke=args.smoke,
                  device=args.device)
    f = results["alloc/faulty"]
    s = results["serve/faulty"]
    print(f"  alloc: {f['served']}/{f['n']} served, "
          f"fallback={f['fallback_fraction']:.3f}, retries={f['retries']}")
    print(f"  serve: done={s['done']} rejected={s['rejected']} "
          f"cancelled={s['cancelled']} preemptions={s['preemptions']} "
          f"p99={s['p99_steps']} on {args.device}")
    print(f"  deterministic: {results['determinism']['identical']}")
    check(results)
    return torch_records.finish("torch_chaos_bench", results, args, WALL_CLOCK)


if __name__ == "__main__":
    sys.exit(main())
