"""The benchmark's files: every cell of BENCHMARK.json resolves to its
configuration, mix, limits and metric readers by name, a new cell is a new
file and a new entry, and BENCHMARK.json keeps to the contract's shape."""
import json
import re
import shutil
from pathlib import Path

import pytest

from portbench import arch, cells, traffic

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(cell):
    c = cells.resolve(BENCH, cell)
    a = arch.load(c.config_file)
    mix = traffic.load(c.traffic_file)
    limits = cells.limits(c)
    assert all({"limit", "smoke"} <= set(entry) for entry in limits.values())
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(cells.reader(m["name"]))
    if mix["kind"] == "train":
        assert set(limits) == {"grad_gap", "grad_gap_large", "change_gap"}
        assert a.max_positions >= mix["seq"]
    else:
        assert mix["kind"] in ("closed", "open") and set(limits) == {"logit_gap"}
        assert a.max_positions >= mix["prompt"]["hi"] + mix["output"]["hi"]


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[key]]
    assert all(NAME.match(n) for n in names)
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        ns = [x["name"] for x in BENCH[key]]
        assert len(ns) == len(set(ns))
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and c["name"] in used
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", m["workloads"]))
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_added_files_are_found(tmp_path):
    """A new configuration, mix, metric and limits, each a file of its own
    plus an entry, are found with no other edit."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    here = tmp_path / "portbench"
    shutil.copy(here / "configs" / "stablelm_1_6b.json", here / "configs" / "other_model.json")
    mix = json.loads((here / "traffic" / "decode_32.json").read_text())
    mix["clients"] = mix["slots"] = 16
    (here / "traffic" / "decode_16.json").write_text(json.dumps(mix))
    (here / "metrics" / "steps_per_s.decode.py").write_text(
        "def read(ctx):\n    return ctx.obs.steps / ctx.obs.window_s\n")
    (here / "limits" / "other_model.decode_16.json").write_text(
        json.dumps({"logit_gap": {"limit": 1.0, "smoke": 1.0}}))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "other_model", "source": "https://example.org",
                             "file": "portbench/configs/other_model.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "other_model.decode_16", "config": "other_model",
                               "traffic": "decode_16", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "steps_per_s.decode", "unit": "1/s", "better": "higher",
                               "source": "host_clock", "layer": "engine host loop",
                               "moves": "out_tok_s", "workloads": ["other_model.decode_16"]})
    for m in bench["end_to_end"]:
        if m["name"] == "out_tok_s":
            m["workloads"].append("other_model.decode_16")
    c = cells.resolve(bench, "other_model.decode_16", root=tmp_path)
    assert traffic.load(c.traffic_file)["clients"] == 16
    assert [m["name"] for m in c.per_layer] == ["steps_per_s.decode"]
    ctx = type("C", (), {"obs": type("O", (), {"steps": 30, "window_s": 3.0})})
    assert cells.reader("steps_per_s.decode", root=tmp_path)(ctx) == 10.0


def test_missing_file_raises(tmp_path):
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "stablelm_1_6b.nothing", "config": "stablelm_1_6b",
                               "traffic": "nothing", "chips": 1, "why": "a test"})
    with pytest.raises(FileNotFoundError):
        cells.resolve(bench, "stablelm_1_6b.nothing")
