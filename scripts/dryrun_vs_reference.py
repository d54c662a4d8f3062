"""The port's dry-run records beside the reference's, cell by cell (CPU):

    PYTHONPATH=src python scripts/dryrun_vs_reference.py [--workdir DIR] [--peak-detail [N]]
        [--repeated-detail [N]]

For each cell of ``tests/ref_launch_records.py:CELLS`` (every family and
mode once, on the single-pod mesh) prints the port's per-device flops over
the reference's, both peaks in GB and the port's over the reference's, the
work the sharded step repeats (ranks x the port's per-device flops over
the flops of the same step traced without a mesh: 1 where every piece of
work is done once across the ranks), and the count of each collective
kind, port / reference.  With ``--peak-detail`` it also prints, under each
cell, the N (default 8) largest storages live at the port's peak: GB,
shape, dtype and the op that made each -- how a tensor that every rank
holds whole shows itself.  With ``--repeated-detail`` it prints, under
each cell, the N (default 8) largest groups of the sharded step's products
(one line of model code, op and local operand shapes) by 256 x their flops,
each beside the matching product of the step traced without a mesh and the
ratio of the two: over 1, every rank repeats some of that product's work
(``hlo_stats.repeated_products``).
The reference runs in a process of its own (``run_reference``); the port's
cells on fake 256-rank groups in this one.  ~1 min."""
from __future__ import annotations

import argparse
import contextlib
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
    ap.add_argument("--repeated-detail", type=int, nargs="?", const=8, default=0, metavar="N",
                    help="print the N largest groups of each cell's products by 256 x flops, "
                         "beside the step's without a mesh")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        ref = run_reference("dryrun", args.workdir or tmp)
    print("| cell | flops port / ref | peak GB port / ref | peak port / ref | "
          "ranks x flops / unsharded | " + " | ".join(hlo_stats.COLLECTIVES) + " |")
    for arch, shape, n in CELLS:
        k = key(arch, shape, n)
        sites = hlo_stats.product_sites() if args.repeated_detail else contextlib.nullcontext()
        with hlo_stats.peak_detail() as recorders, sites:
            mine = dryrun.run_cell(arch, shape, False, n_layers=n, scan_layers=False,
                                   accum_steps=1,
                                   keep_hlo=bool(args.repeated_detail))
            whole = dryrun.unsharded_trace(arch, shape, n)
        pd, theirs = mine["per_device"], ref[k]["per_device"]
        ratio = pd["flops"] / theirs["flops"]
        repeated = mine["chips"] * pd["flops"] / whole["per_device"]["flops"]
        counts = [f"{mine['collectives'][c]['count']} / {ref[k]['collectives'][c]['count']}"
                  for c in hlo_stats.COLLECTIVES]
        peaks = f"{pd['peak_bytes'] / 1e9:.2f} / {theirs['peak_bytes'] / 1e9:.2f}"
        print(f"| {arch} {shape} L{n} | {ratio:.4f} | {peaks} | "
              f"{pd['peak_bytes'] / theirs['peak_bytes']:.4f} | {repeated:.4f} | "
              + " | ".join(counts) + " |", flush=True)
        for nbytes, shp, dtype, op in recorders[0].peak_live(args.peak_detail):
            print(f"|   live at the peak | {nbytes / 1e9:.4f} GB | {shp} {dtype} | {op} |",
                  flush=True)
        record = [hlo_stats.OpEntry(**e) for e in mine.get("op_record", ())]
        for r in hlo_stats.repeated_products(record, whole["record"], mine["chips"],
                                             args.repeated_detail):
            if r["ratio"] is None:
                print(f"|   repeated x? | {mine['chips']} x {r['count']} {r['op']} "
                      f"{_operands(r['operands'])} = {r['ranks_flops']:.4g} | no unsharded "
                      f"product | {_last_lines(r['site'])} |", flush=True)
                continue
            print(f"|   repeated x{r['ratio']:.4g} (its line x{r['site_ratio']:.4g}) | "
                  f"{mine['chips']} x {r['count']} {r['op']} {_operands(r['operands'])} = "
                  f"{r['ranks_flops']:.4g} | unsharded {r['whole_op']} "
                  f"{_operands(r['whole_operands'])} = {r['whole_flops']:.4g} | "
                  f"{_last_lines(r['site'])} |", flush=True)


def _operands(operands) -> str:
    dtypes = {d for _, d in operands}
    shapes = " @ ".join(str(tuple(s)) for s, _ in operands)
    return f"{shapes} {'/'.join(sorted(dtypes))}"


def _last_lines(site: str, n: int = 3) -> str:
    """A site's innermost ``n`` lines of model code."""
    grad = site.endswith(" (grad)")
    lines = site.removesuffix(" (grad)").split(" > ")
    return " > ".join(lines[-n:]) + (" (grad)" if grad else "")


if __name__ == "__main__":
    main()
