"""The port's trace runner (``benchmarks/torch_trace_bench.py``) on the CPU:
its smoke records equal the reference's ``bench(smoke=True)`` in every field
(none is wall clock) and the committed ``BENCH_trace.json`` but for its
gate-only ``determinism`` entry; ``main --against`` says so; ``--gate``
reruns byte-identically; the reference's gate holds on the records."""
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


port = _load(ROOT / "benchmarks" / "torch_trace_bench.py")


@pytest.fixture(scope="module")
def results():
    return port.bench(smoke=True, device="cpu")[0]


def test_smoke_records_equal_reference(results):
    reference, _ = _load(ROOT / "benchmarks" / "trace_bench.py").bench(smoke=True)
    assert port.WALL_CLOCK == {}
    assert json.dumps(results, sort_keys=True) == json.dumps(reference, sort_keys=True)


def test_smoke_records_equal_the_committed_file(results):
    committed = json.loads((ROOT / "BENCH_trace.json").read_text())
    assert sorted(committed) == sorted([*results, "determinism"])
    assert port.torch_records.differing(results, committed, port.WALL_CLOCK,
                                        skip=("determinism",)) == []


def test_trace_gate_passes_on_the_port_records(results):
    port.check(results)


def test_main_against_the_committed_file_and_gate(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert port.main(["--smoke", "--device", "cpu", "--against",
                      str(ROOT / "BENCH_trace.json")]) == 0
    assert "every record equal" in capsys.readouterr().out
    assert list(tmp_path.iterdir()) == []
    out = tmp_path / "BENCH_trace.json"
    assert port.main(["--smoke", "--device", "cpu", "--gate", "--out", str(out)]) == 0
    assert out.read_bytes() == (ROOT / "BENCH_trace.json").read_bytes()


def test_no_committed_record_changed():
    assert {p.name: p.read_bytes() for p in sorted(ROOT.glob("BENCH_*.json"))} == COMMITTED
