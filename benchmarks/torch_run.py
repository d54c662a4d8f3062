"""Benchmark harness of the port: the reference's ``benchmarks/run.py`` over
the port's runners, plus the aggregator that folds every ``BENCH_*.json``
record file of ``--dir`` into one summary.

  * alloc_fraction  — paper §1 motivation (``torch_alloc_fraction``)
  * microbench      — paper Figure 2 (``torch_microbench``)
  * kv_pool         — block-table contiguity per policy (``torch_kv_pool_bench``)
  * kernel          — plain-path timings + kernel agreement, and the kernels'
                      own times on the card (``torch_kernel_bench``)
  * translate       — BENCH_translate.json (``torch_translate_bench``)
  * channels        — BENCH_channels.json (``torch_channel_bench``)
  * chaos           — BENCH_faults.json (``torch_chaos_bench``)
  * churn           — BENCH_churn.json (``torch_churn_bench``)
  * serve           — BENCH_serve.json (``torch_serve_bench``)
  * trace           — BENCH_trace.json (``torch_trace_bench``)
  * roofline        — the roofline table (``torch_roofline_report``) over the
                      records ``repro_torch.launch.roofline`` wrote under
                      ``experiments/``; ``roofline/missing`` without them

Prints ``name,us_per_call,derived`` CSV rows.  The record files are written
under ``--dir`` (default ``build/bench``) and nowhere else; after the
selected modules run, every ``BENCH_*.json`` there is folded into
``--dir``/``BENCH_summary.json`` under the shared record schema
``{bench, name, n, speedup, seconds, config}`` (missing fields null);
``--aggregate-only`` skips the benchmarks::

    PYTHONPATH=src python benchmarks/torch_run.py --smoke --device cpu [--only NAME] [--dir DIR]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from pathlib import Path
from typing import Dict, List

_HERE = Path(__file__).resolve().parent
for _p in (_HERE, _HERE.parent / "src"):
    if str(_p) not in sys.path:
        sys.path.append(str(_p))

SUMMARY_PATH = "BENCH_summary.json"
DEFAULT_DIR = os.path.join("build", "bench")


def aggregate(pattern: str = "BENCH_*.json") -> List[Dict]:
    """Fold every persisted benchmark file into shared-schema records.

    Each source file maps record names to dicts with (a subset of) the
    shared fields; anything non-dict (e.g. a ``config`` block) is carried
    into the records of its file as ``config`` context.
    """
    rows: List[Dict] = []
    for path in sorted(glob.glob(pattern)):
        if os.path.basename(path) == SUMMARY_PATH:
            continue
        bench = os.path.basename(path)[len("BENCH_"):-len(".json")]
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"[aggregate] skipping {path}: {e}", file=sys.stderr)
            continue
        shared_cfg = data.get("config") if isinstance(data, dict) else None
        if not isinstance(data, dict):
            continue
        for name, rec in data.items():
            if name == "config" or not isinstance(rec, dict):
                continue
            rows.append({
                "bench": bench,
                "name": name,
                "n": rec.get("n"),
                "speedup": rec.get("speedup"),
                "seconds": rec.get("seconds"),
                "config": rec.get("config", shared_cfg),
            })
    return rows


def write_summary(rows: List[Dict], directory: str) -> None:
    path = os.path.join(directory, SUMMARY_PATH)
    with open(path, "w") as f:
        json.dump({"records": rows}, f, indent=1, sort_keys=True)
    benches = sorted({r["bench"] for r in rows})
    print(
        f"[aggregate] {len(rows)} records from {len(benches)} benchmarks "
        f"({', '.join(benches)}) -> {path}"
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--smoke", action="store_true", help="reduced sizes (CI)")
    ap.add_argument("--only", default=None,
                    help="run a single module (e.g. 'translate')")
    ap.add_argument("--aggregate-only", action="store_true",
                    help="skip benchmarks; rebuild the summary")
    ap.add_argument("--dir", default=DEFAULT_DIR,
                    help="where the record files and the summary are written")
    ap.add_argument("--device", default="cuda",
                    help="device of the kernel, chaos, serve, trace, kv_pool and churn runners")
    args = ap.parse_args(argv)
    os.makedirs(args.dir, exist_ok=True)

    def out(name: str) -> str:
        return os.path.join(args.dir, f"BENCH_{name}.json")

    if not args.aggregate_only:
        import torch_alloc_fraction
        import torch_channel_bench
        import torch_chaos_bench
        import torch_churn_bench
        import torch_kernel_bench
        import torch_kv_pool_bench
        import torch_microbench
        import torch_roofline_report
        import torch_serve_bench
        import torch_trace_bench
        import torch_translate_bench
        from torch_records import write

        print("name,us_per_call,derived")

        def emit(name: str, us: float, derived) -> None:
            print(f"{name},{us:.1f},{derived}")
            sys.stdout.flush()

        smoke, device = args.smoke, args.device
        modules = {
            "alloc_fraction": lambda: torch_alloc_fraction.run(emit),
            "microbench": lambda: torch_microbench.run(emit),
            "kv_pool": lambda: torch_kv_pool_bench.run(emit, device=device),
            "kernel": lambda: torch_kernel_bench.run(emit, device=device),
            "roofline": lambda: torch_roofline_report.run(emit),
            "translate": lambda: write(torch_translate_bench.run(emit, smoke=smoke),
                                       out("translate")),
            "channels": lambda: write(torch_channel_bench.run(emit, smoke=smoke),
                                      out("channels")),
            "chaos": lambda: write(torch_chaos_bench.run(emit, smoke=smoke, device=device),
                                   out("faults")),
            "churn": lambda: write(torch_churn_bench.run(emit, smoke=smoke, device=device),
                                   out("churn")),
            "serve": lambda: write(torch_serve_bench.run(emit, smoke=smoke, device=device),
                                   out("serve")),
            "trace": lambda: write(torch_trace_bench.run(emit, smoke=smoke, device=device),
                                   out("trace")),
        }
        selected = {
            name: fn
            for name, fn in modules.items()
            if args.only is None or args.only in name
        }
        if not selected:
            raise SystemExit(
                f"--only {args.only!r} matches no module ({', '.join(modules)})"
            )
        for fn in selected.values():
            fn()

    write_summary(aggregate(os.path.join(args.dir, "BENCH_*.json")), args.dir)


if __name__ == "__main__":
    main()
