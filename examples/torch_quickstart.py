"""Quickstart for the PyTorch port: the paper in ~60 lines.

Reproduces PUMA's core result on the modelled 8 GB DDR system: standard
allocators can't feed a processing-using-DRAM substrate; PUMA's
subarray-aware worst-fit + hint-aligned allocation can.  The times printed
are the PUD cost model's modelled DRAM times, not times of any device.

    PYTHONPATH=src python examples/torch_quickstart.py
"""
from repro_torch.core import (
    AddressMap,
    HugePageModel,
    MallocModel,
    PhysicalMemory,
    PumaAllocator,
    plan_rows,
    simulate_op,
)

SIZE = 128_000 // 8          # a 128 Kb operand


def show(name, operands, amap) -> dict:
    plan = plan_rows("and", operands, amap)
    sim = simulate_op("and", operands, amap)
    print(
        f"  {name:14s} PUD-executable rows: {plan.pud_fraction:6.1%}   "
        f"modelled DRAM time: {sim.t_ns/1e3:8.1f} us   "
        f"(CPU-only would be {sim.t_cpu_ns/1e3:8.1f} us)"
    )
    return {"pud_fraction": plan.pud_fraction, "t_ns": sim.t_ns, "t_cpu_ns": sim.t_cpu_ns}


def main() -> dict:
    """Print the three-allocator table; return it as ``{name: {...}}``."""
    amap = AddressMap()          # paper geometry: 8 GB, 1 MB subarrays
    print("C[i] = A[i] AND B[i]  on the Ambit/RowClone substrate (modelled)")
    print(f"operand size: {SIZE} bytes;  DRAM: {amap.total_bytes//2**30} GiB, "
          f"{amap.region_bytes} B regions\n")
    rows = {}
    # 1) malloc: virtually contiguous, physically scattered -> 0 % in PUD
    mem = PhysicalMemory(amap, seed=0)
    malloc = MallocModel(mem)
    rows["malloc"] = show("malloc", [malloc.alloc(SIZE) for _ in range(3)], amap)

    # 2) huge pages: physically contiguous but subarray placement is luck
    huge = HugePageModel(mem)
    rows["huge pages"] = show("huge pages", [huge.alloc(SIZE) for _ in range(3)], amap)

    # 3) PUMA: pre-allocate a pool, worst-fit the first operand, align the rest
    puma = PumaAllocator(mem)
    puma.pim_preallocate(64)                  # pim_preallocate: 64 huge pages
    a = puma.pim_alloc(SIZE)                  # pim_alloc: worst-fit
    b = puma.pim_alloc_align(SIZE, a)         # pim_alloc_align: same subarrays
    c = puma.pim_alloc_align(SIZE, a)
    rows["PUMA"] = show("PUMA", [a, b, c], amap)

    print("\nPUMA stats:", puma.stats)
    return rows


if __name__ == "__main__":
    main()
