"""Channel-scaling benchmark of the port: the reference's
``benchmarks/channel_bench.py`` on ``repro_torch.core``.

Sweeps channel counts x operand sizes over the N-channel, bank-parallel
DRAM model:

* ``pud/<size>/ch<C>`` — simulated PUD throughput (rows/s of DRAM time) of
  a subarray-aligned 3-operand ``and`` over channel-striped PUMA
  allocations.  ``scaling/<size>`` records throughput(C) / throughput(1);
  the gate requires >= 4x at 8 channels.
* ``plan/<size>/ch<C>`` — wall time of the vectorized channel partition
  (``RowPlan.channel_rows``: one ``bincount``) vs a scalar per-row Python
  reference.
* ``contention/ch<C>`` — controller-level dispatch: the makespan of a burst
  of ops under striped placement vs single-channel placement on the same
  :class:`~repro_torch.core.controller.DramController`.

Geometry: total capacity is held at 8 GB while ``channels`` sweeps
{1, 2, 4, 8, 16} (``subarrays_per_bank`` shrinks to compensate), under
``BANK_REGION_SCHEME``.  The ``pud``, ``scaling`` and ``contention`` records
are modelled DRAM values, deterministic; only the ``plan`` records' times
are wall clock (``WALL_CLOCK``).  Nothing is written unless ``--out`` is
given::

    PYTHONPATH=src python benchmarks/torch_channel_bench.py --smoke \
        [--out PATH] [--against BENCH_channels.json]
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

_HERE = Path(__file__).resolve().parent
for _p in (_HERE, _HERE.parent / "src"):
    if str(_p) not in sys.path:
        sys.path.append(str(_p))

import torch_records  # noqa: E402
from repro_torch.core import pud  # noqa: E402
from repro_torch.core.allocators import PhysicalMemory  # noqa: E402
from repro_torch.core.controller import ControllerConfig, DramController  # noqa: E402
from repro_torch.core.dram import AddressMap, BANK_REGION_SCHEME, DramGeometry  # noqa: E402
from repro_torch.core.puma import PumaAllocator  # noqa: E402

#: the fields of each record kind that come from ``time.perf_counter``
WALL_CLOCK = {"plan": ("seconds", "scalar_seconds", "speedup")}
#: the reference CI's floors (scripts/ci.sh)
GATE = {"scaling/256k/ch8": 4.0, "contention/ch8": 4.0}

CHANNEL_COUNTS = [1, 2, 4, 8, 16]
# 3 same-subarray operands must fit one 1024-row subarray per channel
# stripe at channels=1, so per-operand size tops out at 256 KB (256 rows).
SIZES = {"64k": 64 * 1024, "128k": 128 * 1024, "256k": 256 * 1024}
SMOKE_CHANNELS = [1, 2, 8]
SMOKE_SIZES = {"256k": 256 * 1024}
BASE_SUBARRAYS = 1024   # at channels=1 -> the paper's 8 GB geometry


def make_amap(channels: int) -> AddressMap:
    """8 GB total regardless of channel count (capacity-neutral sweep)."""
    geo = DramGeometry(
        channels=channels, subarrays_per_bank=BASE_SUBARRAYS // channels
    )
    return AddressMap(geo, BANK_REGION_SCHEME)


def striped_operands(
    amap: AddressMap, size: int, n_ops: int, seed: int = 0
) -> List:
    """Subarray-aligned, channel-striped PUMA operands (fraction 1.0)."""
    mem = PhysicalMemory(amap, seed=seed, n_huge_pages=256, huge_scatter=1.0)
    alloc = PumaAllocator(mem, stripe_channels=True)
    alloc.pim_preallocate(128)
    ops = [alloc.pim_alloc(size)]
    while len(ops) < n_ops:
        ops.append(alloc.pim_alloc_align(size, ops[0]))
    return ops


def scalar_channel_partition(plan: pud.RowPlan, amap: AddressMap) -> int:
    """Scalar reference of the vectorized planner: per-row Python loop
    computing the owning channel and the serial/parallel row maximum."""
    C = amap.geo.channels
    counts = [0] * C
    for r in range(plan.n_rows):
        if plan.in_pud[r]:
            counts[int(plan.subarrays[r]) % C] += 1
    return max(counts) if counts else 0


def _best_of(fn: Callable[[], object], repeats: int) -> float:
    best = float("inf")
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def bench(smoke: bool = False) -> Dict:
    channels = SMOKE_CHANNELS if smoke else CHANNEL_COUNTS
    sizes = SMOKE_SIZES if smoke else SIZES
    repeats = 3 if smoke else 10
    results: Dict[str, Dict] = {}
    results["config"] = {
        "channels": channels,
        "sizes": {k: v for k, v in sizes.items()},
        "scheme": "bank_region",
        "total_bytes": 8 * 2**30,
        "op": "and",
        "smoke": smoke,
    }

    for sname, size in sizes.items():
        tput: Dict[int, float] = {}
        for C in channels:
            amap = make_amap(C)
            cfg = {"channels": C, "size": size}
            operands = striped_operands(amap, size, 3)

            # -- simulated PUD throughput (the model's figure of merit;
            # adaptive off: we want pure DRAM time, not the CPU fallback) --
            res = pud.simulate_op("and", operands, amap, adaptive=False)
            n_rows = res.rows_per_channel and sum(res.rows_per_channel) or 0
            assert res.pud_fraction == 1.0, (sname, C, res.pud_fraction)
            tput[C] = n_rows / res.t_ns  # rows per simulated ns
            results[f"pud/{sname}/ch{C}"] = {
                "n": n_rows,
                "t_ns": res.t_ns,
                "rows_per_us": 1e3 * tput[C],
                "channel_balance": res.channel_balance,
                "rows_per_channel": res.rows_per_channel,
                "config": cfg,
            }

            # -- planner: vectorized bincount partition vs scalar loop ----
            plan = pud.plan_rows("and", operands, amap)
            t_vec = _best_of(
                lambda: int(plan.channel_rows(amap).max()), repeats * 10
            )
            t_scalar = _best_of(
                lambda: scalar_channel_partition(plan, amap), repeats
            )
            results[f"plan/{sname}/ch{C}"] = {
                "n": plan.n_rows,
                "seconds": t_vec,
                "scalar_seconds": t_scalar,
                "speedup": t_scalar / t_vec if t_vec > 0 else float("inf"),
                "config": cfg,
            }

        # -- throughput scaling vs 1 channel (or the smallest swept) -------
        base = min(tput)
        for C in channels:
            results[f"scaling/{sname}/ch{C}"] = {
                "n": C,
                "speedup": tput[C] / tput[base],
                "config": {"baseline_channels": base, "size": size},
            }

    # -- controller-level contention: striped vs single-channel placement --
    for C in channels:
        if C == 1:
            continue
        amap = make_amap(C)
        size = 512 * 1024
        striped = striped_operands(amap, size, 1)
        # same rows forced onto one channel: an unstriped worst-fit alloc
        mem = PhysicalMemory(amap, seed=1, n_huge_pages=256, huge_scatter=1.0)
        alloc = PumaAllocator(mem, stripe_channels=False)
        alloc.pim_preallocate(128)
        single = [alloc.pim_alloc(size)]
        n_burst = 4

        def makespan(ops_list) -> float:
            ctrl = DramController(amap, ControllerConfig())
            for _ in range(n_burst):
                pud.simulate_op("zero", ops_list, amap, controller=ctrl)
            return ctrl.now_ns

        span_single = makespan(single)
        span_striped = makespan(striped)
        results[f"contention/ch{C}"] = {
            "n": n_burst,
            "makespan_striped_ns": span_striped,
            "makespan_single_channel_ns": span_single,
            "speedup": span_single / span_striped,
            "config": {"channels": C, "size": size, "burst": n_burst},
        }
    return results


def check(results: Dict) -> None:
    """The reference CI's gate: PUD throughput on striped 8-channel operands
    scales >= 4x over 1 channel, and so does the controller's makespan."""
    for name, want in GATE.items():
        got = results[name]["speedup"]
        assert got >= want, f"{name}: {got:.2f}x (need >= {want}x)"


def run(emit: Callable[[str, float, float], None], smoke: bool = False) -> Dict:
    """``benchmarks/torch_run.py`` hook: emit CSV rows."""
    results = bench(smoke=smoke)
    for name, rec in results.items():
        if name == "config":
            continue
        us = 1e6 * rec.get("seconds", 0.0)
        emit(f"channels/{name}", us, round(rec.get("speedup", 0.0), 2))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--smoke", action="store_true", help="fast CI mode")
    torch_records.add_flags(ap)
    args = ap.parse_args(argv)
    results = run(lambda n, us, d: print(f"{n},{us:.1f},{d}"), smoke=args.smoke)
    for name, rec in sorted(results.items()):
        if name.startswith("scaling/") or name.startswith("contention/"):
            print(f"  {name}: {rec['speedup']:.2f}x")
    check(results)
    return torch_records.finish("torch_channel_bench", results, args, WALL_CLOCK)


if __name__ == "__main__":
    sys.exit(main())
