"""Long-horizon churn benchmark of the port: the reference's
``benchmarks/churn_bench.py`` (allocator aging + compaction) on
``repro_torch``.

Drives 100k-scale seeded alloc/free churn through every allocator model and
records how the PUD-executable fraction of fresh operand pairs decays as
free capacity fragments, then how much of it the RowClone-priced compaction
engine recovers:

* ``alloc/<baseline>`` — malloc / posix_memalign / hugepage-mmap churn on
  the default 8 GB geometry.
* ``alloc/robust`` — :class:`~repro_torch.core.puma.RobustAllocator` churn
  on a deliberately tight PUD pool: the fallback-tier mix under pressure.
* ``alloc/puma`` vs ``alloc/puma_compact`` — the same seeded churn twice:
  aging only, and aging with watermark-triggered
  :func:`~repro_torch.robustness.compaction.compact_allocator` passes that
  move real bytes on a modelled physical memory (verified bit-exact), and
  ``recovery``, the fraction of churn-lost executable fraction won back.
* ``pool/serving_trace`` — a serving-engine-shaped trace on
  :class:`~repro_torch.core.kv_pool.PagedKVPool` (its buffers on
  ``--device``, the card by default), with watermark ``compact()`` passes
  stamped and verified bit-exact through the block tables with
  ``torch.equal``; its records are the same on either device.
* ``journal/crash_replay`` — the compaction arm's journal truncated
  mid-history and replayed twice.

Only the ``seconds`` fields are wall clock (``WALL_CLOCK``); ``recovery``
and every curve are functions of the seed.  ``gate`` is the reference's
acceptance gate.  Nothing is written unless ``--out`` is given::

    PYTHONPATH=src python benchmarks/torch_churn_bench.py --smoke \
        [--device cpu] [--out PATH] [--against BENCH_churn.json]
"""
from __future__ import annotations

import argparse
import random
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

_HERE = Path(__file__).resolve().parent
for _p in (_HERE, _HERE.parent / "src"):
    if str(_p) not in sys.path:
        sys.path.append(str(_p))

import torch_records  # noqa: E402
from repro_torch.core import pud  # noqa: E402
from repro_torch.core.allocators import (  # noqa: E402
    PAGE,
    Allocation,
    HugePageModel,
    MallocModel,
    PhysicalMemory,
    PosixMemalignModel,
)
from repro_torch.core.dram import AddressMap, DramGeometry  # noqa: E402
from repro_torch.core.puma import PumaAllocator, RobustAllocator  # noqa: E402

#: the fields of each record kind that come from ``time.perf_counter``
WALL_CLOCK = {"alloc": ("seconds",), "pool": ("seconds",)}
CHURN_SEED = 0xC0FFEE

#: default paper geometry for the baseline models (pages never run out)
AMAP = AddressMap()
#: small geometry for the PUMA arms: 16 MB total (so the bit-exactness
#: check can shadow the whole physical memory in one ndarray) carved into
#: 1 MB subarrays of 32 regions — the PUD pool spans ~8 subarrays, enough
#: for fragmentation to spread capacity thin across them.
SMALL_AMAP = AddressMap(
    DramGeometry(channels=4, subarrays_per_bank=16, rows_per_subarray=32)
)
N_HUGE = 4            # PhysicalMemory caps the huge pool at half of memory


# ---------------------------------------------------------------------------
# probes: executable fraction of *fresh* operand pairs
# ---------------------------------------------------------------------------

def _probe_fraction(
    alloc, free, amap: AddressMap, size: int, n_pairs: int = 8
) -> float:
    """Allocate ``n_pairs`` copy-operand pairs, measure the mean
    PUD-executable fraction, free them — "can new work still co-locate".
    """
    fr: List[float] = []
    for _ in range(n_pairs):
        a = alloc(size, None)
        if a is None:
            fr.append(0.0)          # pool too fragmented to even start
            break
        b = alloc(size, a)
        if b is None:
            fr.append(0.0)
            free(a)
            break
        fr.append(pud.plan_rows("copy", [a, b], amap).pud_fraction)
        free(b)
        free(a)
    return float(np.mean(fr)) if fr else 0.0


# ---------------------------------------------------------------------------
# baseline models: churn + flat reference lines
# ---------------------------------------------------------------------------

def _release_baseline(mem: PhysicalMemory, a: Allocation) -> None:
    if a.allocator.startswith("hugepage"):
        mem.release_huge([e.pa for e in a.extents])
    else:
        pas = [
            e.pa + off
            for e in a.extents
            for off in range(0, e.nbytes, PAGE)
        ]
        mem.release_pages(pas)


def _baseline_churn(name: str, mk, cycles: int, sample_every: int) -> Dict:
    mem = PhysicalMemory(AMAP, seed=0, n_huge_pages=1024)
    al = mk(mem)
    rng = random.Random(CHURN_SEED)
    region = AMAP.region_bytes
    # >= MMAP_THRESHOLD so even the malloc model's churn is page-backed
    # (its heap path is a bump pointer and never frees)
    sizes = [max(s, 128 * 1024) for s in
             (2 * region, 3 * region, 4 * region, 6 * region)]

    def alloc(size, hint):
        return al.alloc(size)

    def free(a):
        _release_baseline(mem, a)

    live: List[Allocation] = []
    curve: List[List[float]] = []
    t0 = time.perf_counter()
    for cycle in range(cycles):
        if live and (len(live) >= 256 or rng.random() < 0.5):
            _release_baseline(mem, live.pop(rng.randrange(len(live))))
        else:
            live.append(al.alloc(rng.choice(sizes)))
        if cycle % sample_every == sample_every - 1:
            curve.append([
                cycle + 1,
                round(_probe_fraction(alloc, free, AMAP, 2 * region), 4),
            ])
    seconds = time.perf_counter() - t0
    for a in live:
        _release_baseline(mem, a)
    return {
        "n": cycles,
        "seconds": seconds,
        "curve": curve,
        "frac_mean": round(float(np.mean([c[1] for c in curve])), 4),
    }


def _robust_churn(cycles: int, sample_every: int) -> Dict:
    """RobustAllocator on a tight pool: tier mix + probe fraction."""
    mem = PhysicalMemory(SMALL_AMAP, seed=3, n_huge_pages=N_HUGE)
    pa = PumaAllocator(mem)
    pa.pim_preallocate(N_HUGE - 2)
    ra = RobustAllocator(pa, refill_huge_pages=1)
    region = SMALL_AMAP.region_bytes
    rng = random.Random(CHURN_SEED)
    live: List[Allocation] = []
    curve: List[List[float]] = []
    t0 = time.perf_counter()
    for cycle in range(cycles):
        if live and (rng.random() < 0.45 or pa.free_regions() < 8):
            ra.free(live.pop(rng.randrange(len(live))))
        else:
            live.append(ra.alloc(rng.randint(1, 4 * region)))
        if cycle % sample_every == sample_every - 1:
            curve.append([
                cycle + 1,
                round(_probe_fraction(
                    lambda s, h: ra.alloc(s, hint=h), ra.free,
                    SMALL_AMAP, 2 * region,
                ), 4),
            ])
    seconds = time.perf_counter() - t0
    for a in live:
        ra.free(a)
    st = ra.stats
    return {
        "n": cycles,
        "seconds": seconds,
        "curve": curve,
        "tiers": {"puma": st.puma, "huge": st.huge, "base": st.base},
        "fallback_fraction": round(st.fallback_fraction(), 4),
    }


# ---------------------------------------------------------------------------
# the PUMA aging arms (decay vs watermark compaction)
# ---------------------------------------------------------------------------

def _puma_arm(
    cycles: int,
    sample_every: int,
    *,
    compaction: bool,
    frag_watermark: float = 0.35,
    max_moves: int = 64,
) -> Tuple[Dict, Optional[object], Optional["PumaAllocator"]]:
    """One seeded churn run; returns (record, journal, allocator)."""
    from repro_torch.robustness.compaction import compact_allocator
    from repro_torch.robustness.invariants import check_allocator
    from repro_torch.robustness.journal import Journal

    journal = Journal() if compaction else None
    mem = PhysicalMemory(SMALL_AMAP, seed=7, n_huge_pages=N_HUGE)
    pa = PumaAllocator(mem, journal=journal)
    pa.pim_preallocate(N_HUGE)
    region = pa.region_bytes
    total = pa.free_regions()
    phys = np.zeros(SMALL_AMAP.total_bytes, np.uint8) if compaction else None
    expected: Dict[int, np.ndarray] = {}

    rng = random.Random(CHURN_SEED)
    data_rng = np.random.default_rng(CHURN_SEED)

    def fill(a: Allocation) -> None:
        n = sum(e.nbytes for e in a.extents)
        data = data_rng.integers(0, 256, n, dtype=np.uint8)
        for e in a.extents:
            phys[e.pa:e.pa + e.nbytes] = data[e.va_off:e.va_off + e.nbytes]
        expected[a.va] = data

    def read_back(a: Allocation) -> np.ndarray:
        return np.concatenate([
            phys[e.pa:e.pa + e.nbytes]
            for e in sorted(a.extents, key=lambda e: e.va_off)
        ])

    def alloc(size: int, hint: Optional[Allocation]) -> Optional[Allocation]:
        a = (pa.pim_alloc_align(size, hint) if hint is not None
             else pa.pim_alloc(size))
        if a is not None and compaction:
            fill(a)
        return a

    def free(a: Allocation) -> None:
        if compaction:
            expected.pop(a.va, None)
        pa.pim_free(a)

    probe_size = 8 * region      # a quarter-subarray operand: co-locating
                                 # the pair needs one subarray with 16 free
                                 # regions — trivial when free capacity is
                                 # concentrated, impossible once churn has
                                 # spread it thin
    live: List[Allocation] = []
    curve: List[Dict] = []
    compactions: List[Dict] = []
    bit_exact = True

    def sample(cycle: int) -> float:
        frac = _probe_fraction(alloc, free, SMALL_AMAP, probe_size)
        curve.append({
            "cycle": cycle,
            "frac": round(frac, 4),
            "frag": round(pa.fragmentation(), 4),
            "free_regions": pa.free_regions(),
        })
        return frac

    t0 = time.perf_counter()
    sample(0)                    # fresh-pool reference point
    for cycle in range(cycles):
        # aging mix: operand pairs (alloc + aligned partner) and odd
        # singles, freed independently, pressure held near 90 % utilization
        roll = rng.random()
        if live and (pa.free_regions() < total // 10 or roll < 0.45):
            free(live.pop(rng.randrange(len(live))))
        elif roll < 0.85:
            size = rng.randint(region // 2, 4 * region)
            a = alloc(size, None)
            if a is not None:
                live.append(a)
                b = alloc(size, a)
                if b is not None:
                    live.append(b)
        else:
            a = alloc(rng.randint(region // 2, 2 * region), None)
            if a is not None:
                live.append(a)
        if cycle % sample_every != sample_every - 1:
            continue
        sample(cycle + 1)
        if compaction and pa.fragmentation() > frag_watermark:
            rep = compact_allocator(pa, max_moves=max_moves, phys=phys)
            check_allocator(pa).assert_ok()
            for a in live[:32]:
                if not np.array_equal(read_back(a), expected[a.va]):
                    bit_exact = False
            compactions.append({
                "cycle": cycle + 1,
                "moves": rep.executed,
                "frag_before": round(rep.frag_before, 4),
                "frag_after": round(rep.frag_after, 4),
                "total_ns": round(rep.total_ns, 1),
            })
            sample(cycle + 1)    # post-compaction point on the curve
    seconds = time.perf_counter() - t0

    rec = {
        "n": cycles,
        "seconds": seconds,
        "curve": curve,
        "frac_start": curve[0]["frac"] if curve else None,
        "frac_end": curve[-1]["frac"] if curve else None,
    }
    if compaction:
        rec["compactions"] = compactions
        rec["bit_exact"] = bit_exact
        rec["journal_events"] = len(journal.events)
    return rec, journal, pa


def _crash_replay(journal, pa_live) -> Dict:
    """Truncate the journal mid-history, replay twice, compare digests."""
    from repro_torch.robustness.invariants import check_allocator
    from repro_torch.robustness.journal import allocator_digest, replay_allocator

    def fresh_mem():
        return PhysicalMemory(SMALL_AMAP, seed=7, n_huge_pages=N_HUGE)

    full = replay_allocator(journal, fresh_mem())
    live_matches = allocator_digest(full) == allocator_digest(pa_live)
    crash = journal.crash_copy(max(1, len(journal.events) // 2))
    r1 = replay_allocator(crash, fresh_mem())
    r2 = replay_allocator(crash, fresh_mem())
    check_allocator(r1).assert_ok()
    deterministic = allocator_digest(r1) == allocator_digest(r2)
    return {
        "n": len(journal.events),
        "kept_events": len(crash.events),
        "full_replay_matches_live": live_matches,
        "crash_replay_deterministic": deterministic,
        "identical": live_matches and deterministic,
    }


# ---------------------------------------------------------------------------
# serving-engine-shaped tile-pool trace
# ---------------------------------------------------------------------------

def _pool_trace(cycles: int, sample_every: int, device="cuda") -> Dict:
    """Admission/extend/release trace shaped like the serving engine
    (request geometry from the config registry), with watermark
    ``PagedKVPool.compact()`` passes verified bit-exact through the
    block tables."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.kv_pool import KVPoolConfig, PagedKVPool
    from repro_torch.robustness.invariants import check_kv_pool
    from repro_torch.robustness.journal import (
        Journal,
        kv_pool_digest,
        replay_kv_pool,
    )

    mcfg = get_config("stablelm_1_6b").smoke()
    cfg = KVPoolConfig(
        num_blocks=256, block_size=4, kv_heads=mcfg.n_kv_heads,
        head_dim=mcfg.hd, n_layers=mcfg.n_layers, max_seqs=32,
        max_blocks_per_seq=64, blocks_per_arena=32, policy="puma",
        dtype="float32",
    )
    journal = Journal()
    kv = PagedKVPool(cfg, journal=journal, device=device)
    rng = random.Random(CHURN_SEED)
    # slot -> tokens still to decode before release
    remaining: Dict[int, int] = {}

    def contig() -> float:
        fr = [h.contiguous_run_fraction() for h, _ in kv._seqs.values()]
        return float(np.mean(fr)) if fr else 1.0

    curve: List[Dict] = []
    compactions: List[Dict] = []
    bit_exact = True
    next_compact_ok = 0
    t0 = time.perf_counter()
    for cycle in range(cycles):
        if (not remaining) or (rng.random() < 0.10 and kv._free_slots):
            prompt = rng.randint(4, 10 * cfg.block_size)
            slot = kv.admit(prompt)
            if slot is not None:
                remaining[slot] = rng.randint(1, 16 * cfg.block_size)
        elif remaining:
            slot = rng.choice(sorted(remaining))
            if kv.append_token(slot):
                remaining[slot] -= 1
            else:
                remaining[slot] = 0            # pool full: finish it now
            if remaining[slot] <= 0:
                del remaining[slot]
                kv.release(slot)
        if cycle % sample_every != sample_every - 1:
            continue
        c = contig()
        frag = kv.pool.fragmentation()
        curve.append({
            "cycle": cycle + 1,
            "contig": round(c, 4),
            "frag": round(frag, 4),
        })
        if cycle >= next_compact_ok and (c < 0.92 or frag > 0.5):
            # stamp each live block so the move can be audited end-to-end
            tags: Dict[int, torch.Tensor] = {}
            for slot, (h, _) in kv._seqs.items():
                tg = torch.tensor(
                    [slot * 1024 + i for i in range(len(h.tiles))], dtype=torch.float32,
                    device=kv.k.device,
                )
                tags[slot] = tg
                kv.k[0, torch.as_tensor(h.tiles), 0, 0, 0] = tg
            rep = kv.compact(max_moves=96)
            next_compact_ok = cycle + max(1, cycles // 10)
            if rep is None:
                continue
            check_kv_pool(kv).assert_ok()
            for slot, tg in tags.items():
                h, _ = kv._seqs[slot]
                got = kv.k[0, torch.as_tensor(h.tiles), 0, 0, 0]
                if not torch.equal(got, tg):
                    bit_exact = False
            compactions.append({
                "cycle": cycle + 1,
                "moves": rep.executed,
                "rowclone_rows": rep.rowclone_rows,
                "contig_before": round(c, 4),
                "contig_after": round(contig(), 4),
                "frag_before": round(rep.frag_before, 4),
                "frag_after": round(rep.frag_after, 4),
                "total_ns": round(rep.total_ns, 1),
            })
    seconds = time.perf_counter() - t0
    kv2 = replay_kv_pool(journal, cfg, device=device)
    replay_ok = kv_pool_digest(kv) == kv_pool_digest(kv2)
    return {
        "n": cycles,
        "seconds": seconds,
        "curve": curve,
        "compactions": compactions,
        "bit_exact": bit_exact,
        "replay_matches_live": replay_ok,
        "journal_events": len(journal.events),
    }


# ---------------------------------------------------------------------------

def bench(smoke: bool = False, device="cuda") -> Dict:
    cycles = 10_000 if smoke else 100_000
    base_cycles = 3_000 if smoke else 20_000
    pool_cycles = 8_000 if smoke else 100_000
    samples = 20

    results: Dict[str, Dict] = {}
    for name, mk in [
        ("malloc", MallocModel),
        ("posix_memalign", PosixMemalignModel),
        ("hugepage", lambda m: HugePageModel(m, "mmap")),
    ]:
        results[f"alloc/{name}"] = _baseline_churn(
            name, mk, base_cycles, base_cycles // samples
        )
    results["alloc/robust"] = _robust_churn(
        base_cycles, base_cycles // samples
    )

    aged, _, _ = _puma_arm(cycles, cycles // samples, compaction=False)
    results["alloc/puma"] = aged
    compacted, journal, pa_live = _puma_arm(
        cycles, cycles // samples, compaction=True
    )
    # recovery: the fraction of churn-lost executable fraction won back
    start = aged["frac_start"]
    lost = max(1e-9, start - aged["frac_end"])
    compacted["recovery"] = round(
        (compacted["frac_end"] - aged["frac_end"]) / lost, 4
    )
    compacted["speedup"] = compacted["recovery"]
    results["alloc/puma_compact"] = compacted

    results["journal/crash_replay"] = _crash_replay(journal, pa_live)
    results["pool/serving_trace"] = _pool_trace(
        pool_cycles, pool_cycles // samples, device
    )
    results["config"] = {
        "seed": CHURN_SEED,
        "cycles": cycles,
        "baseline_cycles": base_cycles,
        "pool_cycles": pool_cycles,
        "geometry": "4ch x 4sa/bank x 256 rows (32 MB)",
        "smoke": smoke,
    }
    return results


def gate(results: Dict) -> None:
    """The reference's churn gate: decay happens, compaction recovers >= 50 %
    of it bit-exactly, and replay is deterministic."""
    aged = results["alloc/puma"]
    comp = results["alloc/puma_compact"]
    assert aged["frac_end"] < aged["frac_start"] - 0.05, (
        f"expected executable-fraction decay under churn, got "
        f"{aged['frac_start']} -> {aged['frac_end']}"
    )
    assert comp["recovery"] >= 0.5, (
        f"compaction recovered {comp['recovery']:.2%} of the lost "
        f"executable fraction (< 50%)"
    )
    assert comp["compactions"], "the fragmentation watermark never tripped"
    assert comp["bit_exact"], "compaction corrupted migrated bytes"
    jr = results["journal/crash_replay"]
    assert jr["identical"], f"journal replay mismatch: {jr}"
    pt = results["pool/serving_trace"]
    assert pt["bit_exact"], "pool compaction corrupted block data"
    assert pt["replay_matches_live"], "pool journal replay diverged"
    print("[churn gate] decay={:.3f}->{:.3f} recovery={:.2%} "
          "passes={} pool_passes={} : OK".format(
              aged["frac_start"], aged["frac_end"], comp["recovery"],
              len(comp["compactions"]), len(pt["compactions"])))


def run(emit: Callable[[str, float, float], None], smoke: bool = False,
        device="cuda") -> Dict:
    """``benchmarks/torch_run.py`` hook: emit CSV rows."""
    results = bench(smoke=smoke, device=device)
    for name, rec in results.items():
        if name == "config":
            continue
        us = 1e6 * rec.get("seconds", 0.0)
        derived = rec.get("recovery",
                          rec.get("frac_end", rec.get("identical", 0.0)))
        emit(f"churn/{name}", us, derived)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--smoke", action="store_true", help="fast CI mode")
    ap.add_argument("--device", default="cuda", help="the serving trace's pool device")
    torch_records.add_flags(ap)
    args = ap.parse_args(argv)
    results = run(lambda n, us, d: print(f"{n},{us:.1f},{d}"), smoke=args.smoke,
                  device=args.device)
    gate(results)
    return torch_records.finish("torch_churn_bench", results, args, WALL_CLOCK)


if __name__ == "__main__":
    sys.exit(main())
