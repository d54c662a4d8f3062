"""The readers of the program's spans, on the CPU at the smoke size.

Each cell runs once with ``--smoke --trace 1`` in a subprocess (as
``test_portbench_control.py`` runs it): every host-clock per-layer metric
of the cell, old and new, reads a number, and the window rule of each
reader that reads the program's step spans selects exactly the root spans
the program opened during the window, as many as the run's ``steps``.
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = ROOT / "portbench" / "metrics"

# the window's spans: the ids of the root spans opened while the harness's
# window ran, beside each reader's own selection by its window rule
PROBE = """
import importlib.util, json, sys, torch
torch.set_num_threads(2)
sys.path.insert(0, {root!r})
from portbench import program, serve, train
program.import_port()
from repro_torch.trace import spans
seen = {{}}
def mark(cls):
    inner = cls.window
    def window(self, seconds):
        seen["first"] = spans.RECORDER.opened
        inner(self, seconds)
        seen["last"] = spans.RECORDER.opened
        seen["steps"] = self.obs.steps
    cls.window = window
mark(serve.Server)
mark(train.Job)
def load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
rc = load("pb_run", {run!r}).main({args!r})
made = [t[0].id for t in spans.trees() if seen["first"] <= t[0].id < seen["last"]]
picked = {{}}
for name in {names!r}:
    reader = load("pb_reader", {metrics!r} + "/" + name + ".py")
    if hasattr(reader, "window"):
        picked[name] = [t[0].id for t in reader.window(seen["steps"])]
print("WINDOW " + json.dumps({{"steps": seen["steps"], "made": made, "picked": picked}}))
sys.exit(rc)
"""


def applies(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


@pytest.mark.parametrize("cell", CELLS)
def test_traced_smoke_run_reads_every_host_metric_and_the_window(cell):
    per_layer = [m for m in BENCH["per_layer"] if applies(m, cell)]
    args = ["--workload", cell, "--seed", str(2 ** 31 + 5), "--seconds", "3", "--trace", "1",
            "--smoke"]
    code = PROBE.format(root=str(ROOT), run=str(ROOT / "portbench" / "run.py"), args=args,
                        names=[m["name"] for m in per_layer], metrics=str(METRICS))
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    lines = p.stdout.strip().splitlines()
    window = json.loads(next(x for x in lines if x.startswith("WINDOW "))[len("WINDOW "):])
    result = json.loads(next(x for x in reversed(lines) if x.startswith("{")))
    host = {m["name"] for m in per_layer if m["source"] == "host_clock"}
    assert host <= set(result["metrics"]), host - set(result["metrics"])
    assert window["steps"] > 0 and len(window["made"]) == window["steps"]
    assert window["picked"], "no reader of the cell reads the program's step spans"
    for name, picked in window["picked"].items():
        assert picked == window["made"], name
