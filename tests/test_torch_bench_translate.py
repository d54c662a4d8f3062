"""The port's translate and channel runners
(``benchmarks/torch_{translate,channel}_bench.py``) against the reference's
``bench(smoke=True)`` on the CPU: every record equal outside the fields the
runner names as wall clock, and those fields exactly the ones the clock
moves.  Also the runners' output: nothing written without ``--out``, the
records written where it points, ``--against`` failing on a difference, and
no committed ``BENCH_*.json`` touched."""
import importlib.util
import json
import pathlib
import random
import time

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
COMMITTED = {p.name: p.read_bytes() for p in sorted(ROOT.glob("BENCH_*.json"))}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several test processes at once; one torch thread per
    process keeps them from contending for the cores."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fake_clock_runs(fn):
    """``fn()`` twice, each under its own seeded fake ``time.perf_counter``
    (steps drawn from 0.5-1.5 s): a field that differs between the two runs
    comes from the clock."""
    runs = []
    for seed in (1, 2):
        rng, now = random.Random(seed), [0.0]

        def tick():
            now[0] += rng.uniform(0.5, 1.5)
            return now[0]

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(time, "perf_counter", tick)
            runs.append(fn())
    return runs


def clock_fields(runs):
    a, b = runs
    return {(name, k) for name, rec in a.items() if isinstance(rec, dict)
            for k in rec if json.dumps(rec[k]) != json.dumps(b[name].get(k))}


def named_fields(results, wall_clock):
    return {(name, k) for name, rec in results.items() if isinstance(rec, dict)
            for k in rec if k in wall_clock.get(name.split("/", 1)[0], ())}


@pytest.fixture(scope="module", params=["translate_bench", "channel_bench"])
def pair(request):
    """(port module, reference smoke records, port smoke records under two fake clocks)."""
    name = request.param
    port = _load(f"torch_{name}")
    return port, _load(name).bench(smoke=True), fake_clock_runs(lambda: port.bench(smoke=True))


def test_smoke_records_equal_reference_outside_wall_clock(pair):
    port, reference, runs = pair
    for results in runs:
        assert sorted(results) == sorted(reference)
        assert port.torch_records.differing(results, reference, port.WALL_CLOCK) == []


def test_wall_clock_set_is_exactly_what_the_clock_moves(pair):
    port, _, runs = pair
    moved = clock_fields(runs)
    assert moved and moved == named_fields(runs[0], port.WALL_CLOCK)
    # a deterministic field named as wall clock would not move: the check fails
    widened = {k: tuple(v) + ("n",) for k, v in port.WALL_CLOCK.items()}
    assert named_fields(runs[0], widened) != moved


def test_a_deterministic_difference_is_reported(pair):
    port, reference, runs = pair
    name = next(k for k in sorted(reference) if k != "config")
    changed = dict(runs[0], **{name: dict(runs[0][name], n=-1)})
    assert port.torch_records.differing(changed, reference, port.WALL_CLOCK) == [name]
    dropped = {k: v for k, v in runs[0].items() if k != name}
    assert port.torch_records.differing(dropped, reference, port.WALL_CLOCK) == [name]


def test_channel_gate_passes_on_the_port_records():
    port = _load("torch_channel_bench")
    port.check(port.bench(smoke=True))


def test_runner_writes_only_where_out_points(tmp_path, monkeypatch, capsys):
    port = _load("torch_channel_bench")
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    assert port.main(["--smoke"]) == 0
    assert list(cwd.iterdir()) == []
    out = tmp_path / "BENCH_channels.json"
    assert port.main(["--smoke", "--out", str(out)]) == 0
    assert list(cwd.iterdir()) == []
    written = json.loads(out.read_text())
    assert port.main(["--smoke", "--against", str(out)]) == 0
    assert "every record equal" in capsys.readouterr().out
    written["scaling/256k/ch8"]["speedup"] += 1.0
    out.write_text(json.dumps(written))
    assert port.main(["--smoke", "--against", str(out)]) == 1
    assert "differ in ['scaling/256k/ch8']" in capsys.readouterr().out


def test_no_committed_record_changed():
    assert {p.name: p.read_bytes() for p in sorted(ROOT.glob("BENCH_*.json"))} == COMMITTED
