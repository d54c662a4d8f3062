"""Address-translation / PUD-planning microbenchmark of the port: the
reference's ``benchmarks/translate_bench.py`` on ``repro_torch.core``.

Times the vectorized fast path against faithful re-implementations of the
seed's scalar algorithms:

* ``decode``      — batch :meth:`AddressMap.region_subarrays` vs a scalar
                    ``region_subarray`` loop over the same region PAs,
                    under both interleave schemes.
* ``pa_of``       — bisect-over-coalesced-extents translation vs the seed's
                    linear extent scan, 8k lookups on a 512 KB malloc
                    allocation.
* ``plan``        — vectorized ``plan_rows`` (cold cache: the row->subarray
                    tables are rebuilt every call) vs the seed's per-row
                    scalar probe, 512 KB 3-operand op over malloc-scattered
                    allocations.
* ``execute``     — ``execute_op`` walking ``Allocation.runs()`` vs the
                    seed's byte-by-byte ``pa_of`` probing.
* ``preallocate`` — batch ``pim_preallocate`` of the region pool index.

Almost every field is host wall clock (``WALL_CLOCK``); only the ``n``
fields are deterministic.  ``check`` is the reference CI's speedup gate.
Nothing is written unless ``--out`` is given::

    PYTHONPATH=src python benchmarks/torch_translate_bench.py --smoke \
        [--out PATH] [--against BENCH_translate.json]
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Sequence

import numpy as np

_HERE = Path(__file__).resolve().parent
for _p in (_HERE, _HERE.parent / "src"):
    if str(_p) not in sys.path:
        sys.path.append(str(_p))

import torch_records  # noqa: E402
from repro_torch.core import pud  # noqa: E402
from repro_torch.core.allocators import Allocation, MallocModel, PhysicalMemory  # noqa: E402
from repro_torch.core.dram import (  # noqa: E402
    AddressMap,
    BANK_REGION_SCHEME,
    CACHELINE_INTERLEAVED_SCHEME,
)
from repro_torch.core.puma import PumaAllocator  # noqa: E402

#: the fields of each record kind that come from ``time.perf_counter``
_TIMED = ("scalar_ops_per_s", "batch_ops_per_s", "warm_ops_per_s", "speedup",
          "speedup_warm", "seconds")
WALL_CLOCK = {k: _TIMED for k in ("decode", "pa_of", "plan", "execute", "preallocate")}
#: the reference CI's speedup floors (scripts/ci.sh)
GATE = {"decode/bank_region": 20, "decode/cacheline": 20,
        "plan/malloc_512k_3op": 10, "execute/malloc_512k_3op": 10}


# ---------------------------------------------------------------------------
# Seed-reference implementations (the algorithms this PR replaced), kept
# here verbatim-in-spirit so the speedup baseline cannot silently drift.
# ---------------------------------------------------------------------------

def seed_pa_of(alloc: Allocation, va_off: int) -> int:
    """Seed ``Allocation.pa_of``: linear scan over the extent list."""
    for e in alloc.extents:
        if e.va_off <= va_off < e.va_off + e.nbytes:
            return e.pa + (va_off - e.va_off)
    raise ValueError(f"offset {va_off} not mapped (size={alloc.size})")


def seed_contiguous_run(alloc: Allocation, va_off: int, nbytes: int):
    """Seed ``Allocation.contiguous_run``: repeated linear scans."""
    last = alloc.extents[-1]
    if va_off + nbytes > last.va_off + last.nbytes:
        return None
    base = seed_pa_of(alloc, va_off)
    cur = va_off
    while cur < va_off + nbytes:
        for e in alloc.extents:
            if e.va_off <= cur < e.va_off + e.nbytes:
                if e.pa + (cur - e.va_off) != base + (cur - va_off):
                    return None
                cur = e.va_off + e.nbytes
                break
        else:
            return None
    return base


def seed_plan_rows(op: str, operands: Sequence[Allocation], amap: AddressMap):
    """Seed ``plan_rows``: scalar contiguous_run + region_subarray per row."""
    size = min(a.size for a in operands)
    region = amap.region_bytes
    n_full, tail = divmod(size, region)
    n_rows = n_full + (1 if tail else 0)
    in_pud: List[bool] = []
    for r in range(n_rows):
        sas = []
        for a in operands:
            pa = seed_contiguous_run(a, r * region, region)
            if pa is None or not amap.region_is_aligned(pa):
                sas.append(None)
            else:
                sas.append(amap.region_subarray(pa))
        in_pud.append(sas[0] is not None and all(s == sas[0] for s in sas))
    tail_bytes = 0 if (not tail or in_pud[-1]) else tail
    return pud.RowPlan(n_rows=n_rows, in_pud=in_pud, tail_bytes=tail_bytes)


def seed_execute_op(
    op: str, operands: Sequence[Allocation], phys: np.ndarray, amap: AddressMap
):
    """Seed ``execute_op``: grow physical runs one byte at a time."""
    plan = seed_plan_rows(op, operands, amap)
    region = amap.region_bytes
    dst, srcs = operands[-1], list(operands[:-1])

    def read(a, off, n):
        out = np.empty(n, np.uint8)
        done = 0
        while done < n:
            pa = seed_pa_of(a, off + done)
            run = 1
            while done + run < n and seed_pa_of(a, off + done + run) == pa + run:
                run += 1
            out[done : done + run] = phys[pa : pa + run]
            done += run
        return out

    def write(a, off, buf):
        done = 0
        n = len(buf)
        while done < n:
            pa = seed_pa_of(a, off + done)
            run = 1
            while done + run < n and seed_pa_of(a, off + done + run) == pa + run:
                run += 1
            phys[pa : pa + run] = buf[done : done + run]
            done += run

    for r in range(plan.n_rows):
        off = r * region
        n = region
        if not plan.in_pud[r] and r == plan.n_rows - 1 and plan.tail_bytes:
            n = plan.tail_bytes
        src_rows = [read(s, off, n) for s in srcs]
        out = np.empty(n, np.uint8)
        pud._apply_rowwise(op, out, src_rows)
        write(dst, off, out)
    return plan


# ---------------------------------------------------------------------------
# Timing harness
# ---------------------------------------------------------------------------

def _best_of(fn: Callable[[], object], repeats: int) -> float:
    """Seconds for the fastest of ``repeats`` runs (>=1 run regardless)."""
    best = float("inf")
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _clear_row_caches(operands: Sequence[Allocation]) -> None:
    for a in operands:
        a._row_sa_cache.clear()


def bench(smoke: bool = False) -> Dict:
    repeats = 2 if smoke else 5
    size = 512 * 1024          # a 512 KB 3-operand op
    n_decode = 20_000 if smoke else 200_000
    n_lookup = 8_000           # the "8k pa_of lookups" yardstick
    results: Dict[str, Dict] = {}

    # -- decode: batch vs scalar, both schemes ------------------------------
    for name, scheme in [
        ("bank_region", BANK_REGION_SCHEME),
        ("cacheline", CACHELINE_INTERLEAVED_SCHEME),
    ]:
        amap = AddressMap(scheme=scheme)
        rb = amap.region_bytes
        rng = np.random.default_rng(0)
        pas = (
            rng.integers(0, amap.total_bytes // rb, n_decode, dtype=np.int64) * rb
        )
        pas_list = pas.tolist()

        t_scalar = _best_of(
            lambda: [amap.region_subarray(p) for p in pas_list], repeats
        )
        t_batch = _best_of(lambda: amap.region_subarrays(pas), repeats)
        results[f"decode/{name}"] = {
            "n": n_decode,
            "scalar_ops_per_s": n_decode / t_scalar,
            "batch_ops_per_s": n_decode / t_batch,
            "speedup": t_scalar / t_batch,
        }

    # -- allocation-translation workloads on malloc-scattered operands ------
    amap = AddressMap()
    mal = MallocModel(PhysicalMemory(amap, seed=3))
    operands = [mal.alloc(size) for _ in range(3)]
    a0 = operands[0]
    offs = [(i * 64) % a0.size for i in range(n_lookup)]

    t_seed = _best_of(lambda: [seed_pa_of(a0, o) for o in offs], repeats)
    t_fast = _best_of(lambda: [a0.pa_of(o) for o in offs], repeats)
    results["pa_of/malloc_512k"] = {
        "n": n_lookup,
        "scalar_ops_per_s": n_lookup / t_seed,
        "batch_ops_per_s": n_lookup / t_fast,
        "speedup": t_seed / t_fast,
    }

    t_seed = _best_of(lambda: seed_plan_rows("and", operands, amap), repeats)

    def plan_cold():
        _clear_row_caches(operands)
        return pud.plan_rows("and", operands, amap)

    t_cold = _best_of(plan_cold, repeats)
    pud.plan_rows("and", operands, amap)  # prime the row tables
    t_warm = _best_of(lambda: pud.plan_rows("and", operands, amap), repeats)
    n_rows = -(-size // amap.region_bytes)
    results["plan/malloc_512k_3op"] = {
        "n": n_rows,
        "scalar_ops_per_s": n_rows / t_seed,
        "batch_ops_per_s": n_rows / t_cold,
        "warm_ops_per_s": n_rows / t_warm,
        "speedup": t_seed / t_cold,
        "speedup_warm": t_seed / t_warm,
    }

    # -- execute: small phys memory so the array fits comfortably -----------
    from repro_torch.core.dram import DramGeometry

    small = AddressMap(DramGeometry(subarrays_per_bank=16))  # 128 MB
    mal = MallocModel(
        PhysicalMemory(small, seed=3, occupancy=0.1, n_huge_pages=16)
    )
    ops_small = [mal.alloc(size) for _ in range(3)]
    phys = np.zeros(small.total_bytes, np.uint8)

    def exec_seed():
        _clear_row_caches(ops_small)
        return seed_execute_op("and", ops_small, phys, small)

    def exec_fast():
        _clear_row_caches(ops_small)
        return pud.execute_op("and", ops_small, phys, small)

    t_seed = _best_of(exec_seed, 1 if smoke else 2)
    t_fast = _best_of(exec_fast, repeats)
    results["execute/malloc_512k_3op"] = {
        "n": size,
        "scalar_ops_per_s": size / t_seed,
        "batch_ops_per_s": size / t_fast,
        "speedup": t_seed / t_fast,
    }

    # -- preallocate: the 131,072-region pool index -------------------------
    n_huge = 64 if smoke else 512

    def prealloc():
        mem = PhysicalMemory(amap, n_huge_pages=1024)
        pa = PumaAllocator(mem)
        return pa.pim_preallocate(n_huge)

    t = _best_of(prealloc, repeats)
    n_regions = n_huge * (2 * 1024 * 1024) // amap.region_bytes
    results[f"preallocate/{n_huge}hp"] = {
        "n": n_regions,
        "batch_ops_per_s": n_regions / t,
        "seconds": t,
    }
    return results


def check(results: Dict) -> None:
    """The reference CI's gate on these records: each fast path's speedup
    over its seed algorithm at least its floor in ``GATE``."""
    for name, want in GATE.items():
        got = results[name]["speedup"]
        assert got >= want, f"{name}: {got:.1f}x (need >= {want}x)"


def run(emit: Callable[[str, float, float], None], smoke: bool = False) -> Dict:
    """``benchmarks/torch_run.py`` hook: emit CSV rows."""
    results = bench(smoke=smoke)
    for name, rec in results.items():
        us = 1e6 * rec["n"] / rec["batch_ops_per_s"]
        emit(f"translate/{name}", us, round(rec.get("speedup", 0.0), 2))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--smoke", action="store_true", help="fast CI mode")
    torch_records.add_flags(ap)
    args = ap.parse_args(argv)
    results = run(lambda n, us, d: print(f"{n},{us:.1f},{d}"), smoke=args.smoke)
    for name, rec in sorted(results.items()):
        if "speedup" in rec:
            print(f"  {name}: {rec['speedup']:.1f}x")
    check(results)
    return torch_records.finish("torch_translate_bench", results, args, WALL_CLOCK)


if __name__ == "__main__":
    sys.exit(main())
