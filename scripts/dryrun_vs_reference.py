"""The port's dry-run records beside the reference's, cell by cell (CPU):

    PYTHONPATH=src python scripts/dryrun_vs_reference.py [--workdir DIR]

For each cell of ``tests/ref_launch_records.py:CELLS`` (every family and
mode once, on the single-pod mesh) prints the port's per-device flops over
the reference's, both peaks in GB, and the count of each collective kind,
port / reference.
The reference runs in a process of its own (``run_reference``); the port's
cells on fake 256-rank groups in this one.  ~1 min."""
from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]

from ref_launch_records import CELLS, key, run_reference  # noqa: E402
from repro_torch.launch import dryrun, hlo_stats  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workdir", default=None, help="where the reference's records go")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        ref = run_reference("dryrun", args.workdir or tmp)
    print("| cell | flops port / ref | peak GB port / ref | "
          + " | ".join(hlo_stats.COLLECTIVES) + " |")
    for arch, shape, n in CELLS:
        k = key(arch, shape, n)
        mine = dryrun.run_cell(arch, shape, False, n_layers=n, scan_layers=False,
                               accum_steps=1)
        theirs = ref[k]
        ratio = mine["per_device"]["flops"] / theirs["per_device"]["flops"]
        counts = [f"{mine['collectives'][c]['count']} / {theirs['collectives'][c]['count']}"
                  for c in hlo_stats.COLLECTIVES]
        peaks = f"{mine['per_device']['peak_bytes'] / 1e9:.2f} / " \
                f"{theirs['per_device']['peak_bytes'] / 1e9:.2f}"
        print(f"| {arch} {shape} L{n} | {ratio:.4f} | {peaks} | " + " | ".join(counts) + " |",
              flush=True)


if __name__ == "__main__":
    main()
