"""Finds a cell's files by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
its metrics are the ``end_to_end`` and ``per_layer`` entries that list it
under ``workloads``, or list no cells at all.  Each name is a file:

* the configuration: the ``file`` its ``configs`` entry gives;
* the mix: ``traffic/<traffic>.json``;
* each metric: ``metrics/<name>.py``, whose ``read(ctx)`` returns the number
  or None where the run holds nothing to read;
* the comparison's limits: ``limits/<cell>.json``.

The configuration names the reference that runs it (``arch.py``),
``reference/<name>.py``, found under the same root; a configuration that
``arch.load`` refuses, and a training cell whose reference gives no
training path, are refused here.

So a new cell, mix or metric is a new file and a new entry: nothing here
changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

from portbench import arch, reference

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_file: Path
    traffic_file: Path
    limits_file: Path
    end_to_end: List[Dict]
    per_layer: List[Dict]


def load_benchmark(path: Path = ROOT / "BENCHMARK.json") -> Dict:
    return json.loads(Path(path).read_text())


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(bench: Dict, workload: str, root: Path = ROOT) -> Cell:
    """The cell named ``workload``, its files resolved (missing ones raise)."""
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no cell {workload!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    here = root / "portbench"
    cell = Cell(
        name=workload, chips=entry["chips"], config_file=root / config["file"],
        traffic_file=here / "traffic" / f"{entry['traffic']}.json",
        limits_file=here / "limits" / f"{workload}.json",
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
    )
    for name in ("config_file", "traffic_file", "limits_file"):
        if not getattr(cell, name).is_file():
            raise FileNotFoundError(f"{workload}: {getattr(cell, name)} is missing")
    for m in cell.end_to_end + cell.per_layer:
        reader_path(m["name"], root)
    a = arch.load(cell.config_file, root)
    if json.loads(cell.traffic_file.read_text())["kind"] == "train":
        reference.forward(a.reference, root)
    return cell


def reader_path(metric: str, root: Path = ROOT) -> Path:
    path = root / "portbench" / "metrics" / f"{metric}.py"
    if not path.is_file():
        raise FileNotFoundError(f"metric {metric!r} has no reader at {path}")
    return path


def reader(metric: str, root: Path = ROOT) -> Callable:
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = reader_path(metric, root)
    name = "portbench_metric_" + metric.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def limits(cell: Cell) -> Dict:
    return json.loads(cell.limits_file.read_text())
