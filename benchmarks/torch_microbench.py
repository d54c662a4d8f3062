"""Paper Figure 2 on the port's PUD cost model: *-zero / *-copy / *-aand
speedup of PUMA over the malloc baseline, allocation sizes 2 Kb .. 6 Mb,
normalized exactly as the paper does.  The speedups are ratios of modelled
DRAM times (``simulate_op``), not of any device's times.

    PYTHONPATH=src python benchmarks/torch_microbench.py
"""
from __future__ import annotations

import time
from typing import Callable, Dict

from repro_torch.core import pud
from repro_torch.core.allocators import MallocModel, PhysicalMemory
from repro_torch.core.dram import AddressMap
from repro_torch.core.puma import PumaAllocator

SIZES_BITS = [2_000, 8_000, 32_000, 128_000, 512_000, 2_000_000, 6_000_000]
OPS = {"zero": 1, "copy": 2, "aand": 3}


def run(emit: Callable[[str, float, float], None]) -> Dict:
    """Emit ``(name, host us, speedup)`` per cell; return ``{op: {bits: speedup}}``."""
    amap = AddressMap()
    model = pud.PudCostModel()
    table: Dict[str, Dict[int, float]] = {}
    for op, nops in OPS.items():
        real_op = op.replace("aand", "and")
        for bits in SIZES_BITS:
            size = max(1, bits // 8)
            t0 = time.perf_counter()
            mem = PhysicalMemory(amap, seed=0)
            pa = PumaAllocator(mem)
            pa.pim_preallocate(64)
            ops = [pa.pim_alloc(size)]
            while len(ops) < nops:
                ops.append(pa.pim_alloc_align(size, ops[0]))
            r_puma = pud.simulate_op(real_op, ops, amap, model)

            mem2 = PhysicalMemory(amap, seed=0)
            mal = MallocModel(mem2)
            r_mal = pud.simulate_op(
                real_op, [mal.alloc(size) for _ in range(nops)], amap, model
            )
            us = (time.perf_counter() - t0) * 1e6
            speedup = r_mal.t_ns / r_puma.t_ns
            emit(f"fig2/{op}/{bits}b", us, round(speedup, 3))
            table.setdefault(op, {})[bits] = speedup
    return table


def print_table(table: Dict) -> None:
    """Figure 2 as text: one row per op, one column per allocation size."""
    print("Figure 2 (modelled): PUMA speedup over malloc")
    print(f"  {'op':6s}" + "".join(f"{b:>10d}b" for b in SIZES_BITS))
    for op, row in table.items():
        print(f"  {op:6s}" + "".join(f"{row[b]:>11.3f}" for b in SIZES_BITS))


if __name__ == "__main__":
    print_table(run(lambda *_: None))
