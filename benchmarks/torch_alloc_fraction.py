"""Paper §1 study on the port: fraction of PUD ops executable per allocator
x size (the reference's ``benchmarks/alloc_fraction.py`` on
``repro_torch.core``).

Reproduces the motivation numbers: malloc/posix_memalign -> 0 %, huge pages
-> partial ("up to 60 %"), PUMA -> ~100 %.

The channel view (``alloc_channel/...`` rows) breaks the same figure of
merit down per memory channel on an 8-channel geometry: the PUD-executable
fraction of the rows owned by each channel, plus the striped allocator's
per-channel subarray occupancy and its load balance — placement imbalance
caps the channel-parallel speedup at ``max`` rows per channel even when
every row is individually executable.

    PYTHONPATH=src python benchmarks/torch_alloc_fraction.py [--churn-cycles N]
"""
from __future__ import annotations

import sys
import time
from pathlib import Path
from typing import Callable, Dict, List

import numpy as np

_HERE = Path(__file__).resolve().parent
for _p in (_HERE, _HERE.parent / "src"):
    if str(_p) not in sys.path:
        sys.path.append(str(_p))

from repro_torch.core import pud  # noqa: E402
from repro_torch.core.allocators import (  # noqa: E402
    HugePageModel,
    MallocModel,
    PhysicalMemory,
    PosixMemalignModel,
)
from repro_torch.core.dram import AddressMap, BANK_REGION_SCHEME, DramGeometry  # noqa: E402
from repro_torch.core.puma import PumaAllocator  # noqa: E402

SIZES_BITS = [2_000, 8_000, 32_000, 128_000, 512_000, 2_000_000, 6_000_000]
OPS = {"zero": 1, "copy": 2, "aand": 3}
REPS = 10


def _fraction(amap, mk_alloc, op: str, nops: int, size: int) -> float:
    fr = []
    for rep in range(REPS):
        mem = PhysicalMemory(amap, seed=rep)
        al = mk_alloc(mem)
        ops = [al.alloc(size) for _ in range(nops)]
        fr.append(pud.plan_rows(op.replace("aand", "and"), ops, amap).pud_fraction)
    return float(np.mean(fr))


def _fraction_puma(amap, op: str, nops: int, size: int) -> float:
    fr = []
    for rep in range(REPS):
        mem = PhysicalMemory(amap, seed=rep)
        pa = PumaAllocator(mem)
        pa.pim_preallocate(64)
        ops = [pa.pim_alloc(size)]
        while len(ops) < nops:
            ops.append(pa.pim_alloc_align(size, ops[0]))
        fr.append(pud.plan_rows(op.replace("aand", "and"), ops, amap).pud_fraction)
    return float(np.mean(fr))


def _channel_view(emit: Callable[[str, float, float], None]) -> Dict:
    """Per-channel subarray occupancy + executable fraction (8 channels)."""
    amap = AddressMap(
        DramGeometry(channels=8, subarrays_per_bank=128), BANK_REGION_SCHEME
    )
    C = amap.geo.channels
    out: Dict[str, Dict] = {}
    for policy, stripe in [("striped", True), ("stacked", False)]:
        mem = PhysicalMemory(amap, seed=0, n_huge_pages=128, huge_scatter=1.0)
        al = PumaAllocator(mem, amap, stripe_channels=stripe)
        al.pim_preallocate(64)
        # a serving-like mix of operand sizes
        allocs = [al.pim_alloc(s) for s in (64 * 1024, 128 * 1024, 256 * 1024)]

        # executable rows per owning channel, summed over one op per alloc
        pud_rows = np.zeros(C, dtype=np.int64)
        region_rows = np.zeros(C, dtype=np.int64)
        for a in allocs:
            t0 = time.perf_counter()
            plan = pud.plan_rows("zero", [a], amap)
            us = (time.perf_counter() - t0) * 1e6
            pud_rows += plan.channel_rows(amap)
            pas = np.array([e.pa for e in a.extents], dtype=np.int64)
            nreg = np.array([e.nbytes for e in a.extents]) // amap.region_bytes
            region_rows += np.bincount(
                np.repeat(amap.region_channels(pas), nreg), minlength=C
            )
        frac = np.divide(
            pud_rows, region_rows, out=np.ones(C), where=region_rows > 0
        )
        rep = al.channel_report()
        used = np.asarray(rep["used_regions"], dtype=np.float64)
        occ_balance = float(used.mean() / used.max()) if used.max() else 1.0
        row_balance = (
            float(pud_rows.mean() / pud_rows.max()) if pud_rows.max() else 1.0
        )
        for c in range(C):
            emit(f"alloc_channel/{policy}/frac/ch{c}", us, round(frac[c], 3))
            emit(
                f"alloc_channel/{policy}/occupancy/ch{c}", 0.0, int(used[c])
            )
        emit(f"alloc_channel/{policy}/occupancy_balance", 0.0, occ_balance)
        emit(f"alloc_channel/{policy}/pud_row_balance", 0.0, row_balance)
        out[policy] = {
            "pud_fraction_per_channel": frac.tolist(),
            "used_regions_per_channel": used.astype(int).tolist(),
            "occupancy_balance": occ_balance,
            "pud_row_balance": row_balance,
        }
    return out


def run_churned(
    emit: Callable[[str, float, float], None], cycles: int
) -> Dict:
    """``--churn-cycles N`` mode: the §1 figure of merit measured against a
    churn-*aged* PUMA pool instead of a fresh one — fresh fraction, aged
    fraction, and the fraction after watermark compaction (the long-horizon
    counterpart of the static table; full curves live in
    ``benchmarks/torch_churn_bench.py``)."""
    from torch_churn_bench import _puma_arm

    sample_every = max(1, cycles // 20)
    aged, _, _ = _puma_arm(cycles, sample_every, compaction=False)
    compacted, _, _ = _puma_arm(cycles, sample_every, compaction=True)
    out = {
        "cycles": cycles,
        "fresh": aged["frac_start"],
        "aged": aged["frac_end"],
        "compacted": compacted["frac_end"],
        "compaction_passes": len(compacted["compactions"]),
    }
    emit(f"alloc_fraction/churned/{cycles}/fresh",
         1e6 * aged["seconds"], out["fresh"])
    emit(f"alloc_fraction/churned/{cycles}/aged", 0.0, out["aged"])
    emit(f"alloc_fraction/churned/{cycles}/compacted",
         1e6 * compacted["seconds"], out["compacted"])
    return out


def run(emit: Callable[[str, float, float], None]) -> Dict:
    amap = AddressMap()
    allocators = {
        "malloc": lambda m: MallocModel(m),
        "posix_memalign": lambda m: PosixMemalignModel(m),
        "hugepage": lambda m: HugePageModel(m, "mmap"),
    }
    table: Dict[str, Dict[int, float]] = {}
    for op, nops in OPS.items():
        for name, mk in allocators.items():
            for bits in SIZES_BITS:
                t0 = time.perf_counter()
                f = _fraction(amap, mk, op, nops, max(1, bits // 8))
                us = (time.perf_counter() - t0) * 1e6 / REPS
                emit(f"alloc_fraction/{op}/{name}/{bits}b", us, f)
                table.setdefault(f"{op}/{name}", {})[bits] = f
        for bits in SIZES_BITS:
            t0 = time.perf_counter()
            f = _fraction_puma(amap, op, nops, max(1, bits // 8))
            us = (time.perf_counter() - t0) * 1e6 / REPS
            emit(f"alloc_fraction/{op}/puma/{bits}b", us, f)
            table.setdefault(f"{op}/puma", {})[bits] = f
    table["channel_view"] = _channel_view(emit)
    return table


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--churn-cycles", type=int, default=0, metavar="N",
        help="age the PUMA pool with N alloc/free cycles before measuring "
             "(reports fresh vs aged vs compacted fractions)",
    )
    args = ap.parse_args()

    def emit(name: str, us: float, derived) -> None:
        print(f"{name},{us:.1f},{derived}")

    if args.churn_cycles:
        out = run_churned(emit, args.churn_cycles)
        print(f"[alloc_fraction] churned {out['cycles']} cycles: "
              f"fresh={out['fresh']} aged={out['aged']} "
              f"compacted={out['compacted']} "
              f"({out['compaction_passes']} passes)")
    else:
        run(emit)


if __name__ == "__main__":
    main()
