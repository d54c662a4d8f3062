"""The port's churn runner (``benchmarks/torch_churn_bench.py``) against the
reference's ``bench(smoke=True)`` on the CPU: every record equal outside the
wall-clock ``seconds`` (``recovery``, the curves, the compaction passes and
the pool trace's bit-exact verdict through ``torch.equal`` included), the
wall-clock set exactly what the clock moves (on short arms), and the
reference's churn gate on the port's records."""
import importlib.util
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
port = _load(ROOT / "benchmarks" / "torch_churn_bench.py")


@pytest.fixture(scope="module")
def results():
    return port.bench(smoke=True, device="cpu")


def test_smoke_records_equal_reference_outside_wall_clock(results):
    reference = _load(ROOT / "benchmarks" / "churn_bench.py").bench(smoke=True)
    assert sorted(results) == sorted(reference)
    assert port.torch_records.differing(results, reference, port.WALL_CLOCK) == []


def test_churn_gate_passes_on_the_port_records(results):
    port.gate(results)
    assert results["pool/serving_trace"]["compactions"]


def test_wall_clock_set_is_exactly_what_the_clock_moves():
    """Each arm at a few hundred cycles, under two fake clocks."""
    from repro_torch.core.allocators import MallocModel

    def arms():
        return {
            "alloc/malloc": port._baseline_churn("malloc", MallocModel, 200, 20),
            "alloc/robust": port._robust_churn(200, 20),
            "alloc/puma_compact": port._puma_arm(400, 20, compaction=True)[0],
            "pool/serving_trace": port._pool_trace(400, 20, device="cpu"),
        }

    runs = _helpers.fake_clock_runs(arms)
    moved = _helpers.clock_fields(runs)
    assert moved == _helpers.named_fields(runs[0], port.WALL_CLOCK) and len(moved) == 4


def test_no_committed_record_changed():
    assert {p.name: p.read_bytes() for p in sorted(ROOT.glob("BENCH_*.json"))} == COMMITTED
