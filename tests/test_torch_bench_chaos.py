"""The port's chaos runner (``benchmarks/torch_chaos_bench.py``) against the
reference's ``bench(smoke=True)`` on the CPU: every record equal outside the
wall-clock fields the runner names, and those exactly the fields the clock
moves; the reference CI's chaos gate on the port's records.  The committed
``BENCH_faults.json`` is not the comparison: the reference's own rerun
differs from it in the last ulp of the ``pud/*/degraded`` DRAM times."""
import importlib.util
import json
import pathlib

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


def _load(path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_helpers = _load(ROOT / "tests" / "test_torch_bench_translate.py")
port = _load(ROOT / "benchmarks" / "torch_chaos_bench.py")


@pytest.fixture(scope="module")
def reference():
    return _load(ROOT / "benchmarks" / "chaos_bench.py").bench(smoke=True)


@pytest.fixture(scope="module")
def runs():
    return _helpers.fake_clock_runs(lambda: port.bench(smoke=True, device="cpu"))


def test_smoke_records_equal_reference_outside_wall_clock(reference, runs):
    for results in runs:
        assert sorted(results) == sorted(reference)
        assert port.torch_records.differing(results, reference, port.WALL_CLOCK) == []


def test_wall_clock_set_is_exactly_what_the_clock_moves(runs):
    moved = _helpers.clock_fields(runs)
    assert moved == _helpers.named_fields(runs[0], port.WALL_CLOCK)
    assert ("alloc/faulty", "speedup") in moved and ("serve/faulty", "speedup") not in moved


def test_chaos_gate_passes_on_the_port_records(runs):
    port.check(runs[0])


def test_committed_record_differs_from_a_rerun_only_in_the_last_ulp(reference):
    """The reference's own smoke rerun reproduces ``BENCH_faults.json`` but
    for the wall clock and the last ulp of the degraded DRAM times."""
    committed = json.loads((ROOT / "BENCH_faults.json").read_text())
    bad = port.torch_records.differing(reference, committed, port.WALL_CLOCK)
    assert bad == ["pud/and/degraded", "pud/copy/degraded"]
    for name in bad:
        ours, theirs = reference[name], committed[name]
        assert {k for k in ours if ours[k] != theirs[k]} == {"degraded_ns", "speedup"}
        assert ours["degraded_ns"] == pytest.approx(theirs["degraded_ns"], rel=1e-15, abs=0)


def test_no_committed_record_changed():
    assert {p.name: p.read_bytes() for p in sorted(ROOT.glob("BENCH_*.json"))} == COMMITTED
