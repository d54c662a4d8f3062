"""Records of the port's benchmark runners: writing them, and comparing them
with the reference's outside the wall-clock fields.

Each runner names its wall-clock fields once, as ``WALL_CLOCK``: a map from
a record kind (the record name up to its first ``/``) to the fields of that
kind that come from ``time.perf_counter``.  Every other field is a function
of the seeds and is compared exactly.  A runner writes its records only
where ``--out`` points; ``--against`` compares them with a reference
``BENCH_*.json`` and makes ``main`` exit 1 on a difference.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Mapping, Sequence


def kind(name: str) -> str:
    return name.split("/", 1)[0]


def deterministic(results: Dict, wall_clock: Mapping[str, Sequence[str]]) -> Dict:
    """``results`` without the wall-clock fields of each record."""
    out = {}
    for name, rec in results.items():
        drop = wall_clock.get(kind(name), ())
        out[name] = ({k: v for k, v in rec.items() if k not in drop}
                     if isinstance(rec, dict) else rec)
    return out


def differing(results: Dict, reference: Dict, wall_clock: Mapping[str, Sequence[str]],
              skip: Sequence[str] = ()) -> List[str]:
    """Names of the records, in either file but ``skip``, whose deterministic
    fields differ between ``results`` and ``reference`` (a record only one
    of them has differs)."""
    ours, theirs = deterministic(results, wall_clock), deterministic(reference, wall_clock)
    return [name for name in sorted((set(ours) | set(theirs)) - set(skip))
            if json.dumps(ours.get(name), sort_keys=True)
            != json.dumps(theirs.get(name), sort_keys=True)]


def write(results: Dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(results, f, indent=1, sort_keys=True)


def add_flags(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--out", default=None, help="write the records as JSON to this path")
    ap.add_argument("--against", default=None, metavar="BENCH_x.json",
                    help="compare the records with a reference record file; exit 1 on a "
                         "difference outside the wall-clock fields")


def finish(tag: str, results: Dict, args: argparse.Namespace,
           wall_clock: Mapping[str, Sequence[str]], skip: Sequence[str] = ()) -> int:
    """Write ``results`` to ``--out`` and compare them with ``--against``;
    the exit code for ``main``.  ``skip`` names records left out of the
    comparison (the reference's gate-only ``determinism`` entry)."""
    if args.out:
        write(results, args.out)
        print(f"[{tag}] wrote {args.out}")
    if not args.against:
        return 0
    with open(args.against) as f:
        reference = json.load(f)
    bad = differing(results, reference, wall_clock, skip)
    print(f"[{tag}] against {args.against}: "
          + (f"differ in {bad}" if bad else "every record equal"))
    return 1 if bad else 0
