"""The port's dry-run records beside the reference's, cell by cell (CPU):

    PYTHONPATH=src python scripts/dryrun_vs_reference.py [--workdir DIR] [--peak-detail [N]]

For each cell of ``tests/ref_launch_records.py:CELLS`` (every family and
mode once, on the single-pod mesh) prints the port's per-device flops over
the reference's, both peaks in GB and the port's over the reference's, the
work the sharded step repeats (ranks x the port's per-device flops over
the flops of the same step traced without a mesh: 1 where every piece of
work is done once across the ranks), and the count of each collective
kind, port / reference.  With ``--peak-detail`` it also prints, under each
cell, the N (default 8) largest storages live at the port's peak: GB,
shape, dtype and the op that made each -- how a tensor that every rank
holds whole shows itself.
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
    ap.add_argument("--peak-detail", type=int, nargs="?", const=8, default=0, metavar="N",
                    help="print the N largest storages live at each cell's peak")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        ref = run_reference("dryrun", args.workdir or tmp)
    print("| cell | flops port / ref | peak GB port / ref | peak port / ref | "
          "ranks x flops / unsharded | " + " | ".join(hlo_stats.COLLECTIVES) + " |")
    for arch, shape, n in CELLS:
        k = key(arch, shape, n)
        with hlo_stats.peak_detail() as recorders:
            mine = dryrun.run_cell(arch, shape, False, n_layers=n, scan_layers=False,
                                   accum_steps=1)
        pd, theirs = mine["per_device"], ref[k]["per_device"]
        ratio = pd["flops"] / theirs["flops"]
        repeated = mine["chips"] * pd["flops"] / dryrun.unsharded_flops(arch, shape, n)
        counts = [f"{mine['collectives'][c]['count']} / {ref[k]['collectives'][c]['count']}"
                  for c in hlo_stats.COLLECTIVES]
        peaks = f"{pd['peak_bytes'] / 1e9:.2f} / {theirs['peak_bytes'] / 1e9:.2f}"
        print(f"| {arch} {shape} L{n} | {ratio:.4f} | {peaks} | "
              f"{pd['peak_bytes'] / theirs['peak_bytes']:.4f} | {repeated:.4f} | "
              + " | ".join(counts) + " |", flush=True)
        for nbytes, shp, dtype, op in recorders[0].peak_live(args.peak_detail):
            print(f"|   live at the peak | {nbytes / 1e9:.4f} GB | {shp} {dtype} | {op} |",
                  flush=True)


if __name__ == "__main__":
    main()
