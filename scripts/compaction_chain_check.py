#!/usr/bin/env python3
"""Do a live sequence's KV pages survive a compaction pass, in both packages?

Plays the smoke `bursty` and `multi_tenant` scenarios of
``benchmarks/serve_bench.py`` (watermark maintenance on) through the
reference engine and the port's, on the CPU.  Around every compaction pass
it snapshots each live sequence's K pages at its blocks before the pass and
compares them with the pages at its blocks after the pass, and it counts
the passes whose plan chains a move into a block another move of the same
pass empties (a source that is also a destination)::

    PYTHONPATH=src:. python scripts/compaction_chain_check.py
"""
from __future__ import annotations

import importlib.util
import pathlib

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load(path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def watch(pool_cls, planner_mod, to_numpy, stats):
    """Wrap ``pool_cls.compact`` (and the planner it calls) to record chained
    plans and damaged pages; returns a function that undoes the wrapping."""
    compact, plan = pool_cls.compact, planner_mod.plan_pool_compaction
    plans = []

    def recording_plan(*args, **kwargs):
        plans.append(plan(*args, **kwargs))
        return plans[-1]

    def checked(self, *args, **kwargs):
        live = {slot: list(h.tiles) for slot, (h, _) in self._seqs.items()}
        before = {slot: to_numpy(self.k[:, t]) for slot, t in live.items()}
        plans.clear()
        report = compact(self, *args, **kwargs)
        if report is None:
            return report
        stats["passes"] += 1
        moves = plans[-1].moves
        if {m.src for m in moves} & {m.dst for m in moves}:
            stats["chained_passes"] += 1
        for slot, old in before.items():
            now = to_numpy(self.k[:, list(self._seqs[slot][0].tiles)])
            err = float(np.abs(now - old).max()) if now.size else 0.0
            if err:
                stats["damaged"] += 1
                stats["max_err"] = max(stats["max_err"], err)
        return report

    pool_cls.compact, planner_mod.plan_pool_compaction = checked, recording_plan

    def undo():
        pool_cls.compact, planner_mod.plan_pool_compaction = compact, plan

    return undo


def main() -> None:
    import torch

    from repro.core import kv_pool as ref_kv
    from repro.robustness import compaction as ref_compaction
    from repro.serve.loadgen import build_scenario as ref_build, play as ref_play
    from repro_torch.core import kv_pool as kv
    from repro_torch.robustness import compaction
    from repro_torch.serve.loadgen import build_scenario, play

    ref_bench = _load(ROOT / "benchmarks" / "serve_bench.py")
    bench = _load(ROOT / "benchmarks" / "torch_serve_bench.py")
    print("package    scenario      passes  chained passes  damaged (pass, sequence) pairs  max |diff|")
    for name in ("bursty", "multi_tenant"):
        for pkg in ("reference", "port"):
            stats = {"passes": 0, "chained_passes": 0, "damaged": 0, "max_err": 0.0}
            if pkg == "reference":
                undo = watch(ref_kv.PagedKVPool, ref_compaction, np.asarray, stats)
                sc = ref_build(name, smoke=True)
                ref_play(ref_bench.make_engine(sc), sc.generate(), max_steps=sc.max_steps)
            else:
                undo = watch(kv.PagedKVPool, compaction, lambda t: t.detach().cpu().numpy(), stats)
                sc = build_scenario(name, smoke=True)
                with torch.no_grad():
                    play(bench.make_engine(sc, "cpu"), sc.generate(), max_steps=sc.max_steps)
            undo()
            print(f"{pkg:<10} {name:<13} {stats['passes']:>6}  {stats['chained_passes']:>14}  "
                  f"{stats['damaged']:>30}  {stats['max_err']:.4g}")


if __name__ == "__main__":
    main()
