"""The port's row-printing runners and its harness on the CPU:
``torch_alloc_fraction`` (``--churn-cycles`` included) and
``torch_kv_pool_bench`` print the reference's rows, names and values;
``torch_kernel_bench`` the reference's row names with the plain path's
agreement; ``torch_run`` writes only under ``--dir``, its ``aggregate``
equals the reference's over the same files, and it refuses the roofline
module rather than skip it."""
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


def _load(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rows(fn):
    """``fn(emit)``'s (name, derived) rows and its return value; the host
    microseconds are wall clock and left out."""
    rows = []
    out = fn(lambda name, us, derived: rows.append((name, derived)))
    return rows, out


@pytest.mark.parametrize("name", ["alloc_fraction", "kv_pool_bench"])
def test_rows_equal_reference(name):
    ref_rows, ref_out = _rows(_load(name).run)
    rows, out = _rows(_load(f"torch_{name}").run)
    assert rows == ref_rows and out == ref_out and len(rows) >= 6


def test_alloc_fraction_churned_rows_equal_reference():
    ref = _load("alloc_fraction")
    port = _load("torch_alloc_fraction")
    ref_rows, ref_out = _rows(lambda emit: ref.run_churned(emit, 2000))
    rows, out = _rows(lambda emit: port.run_churned(emit, 2000))
    assert rows == ref_rows and out == ref_out
    assert out["fresh"] > out["aged"] and out["compaction_passes"] > 0


def test_kernel_bench_rows_on_the_cpu():
    """The reference's row names; ``pud_and`` exact as the reference's
    interpret mode, flash within its f32 tolerance (the reference's
    interpret-mode kernel lies 7e-7 from its plain path, the port's CPU
    wrapper is the plain path itself)."""
    ref_rows, _ = _rows(_load("kernel_bench").run)
    port = _load("torch_kernel_bench")
    rows, _ = _rows(lambda emit: port.run(emit, device="cpu"))
    assert [n for n, _ in rows] == [n for n, _ in ref_rows]
    for (name, got), (_, want) in zip(rows, ref_rows):
        if name.startswith("pud_and/"):
            assert got == want == 1.0
        else:
            assert got <= port.FLASH_TOL and want <= port.FLASH_TOL
    port.check(dict(rows))
    with pytest.raises(AssertionError):
        port.check({"flash/ref_jnp/B1H4S256D64": 1e-3})


def test_kernel_bench_needs_a_card_unless_asked_for_the_cpu():
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _load("torch_kernel_bench").main([])


def test_harness_writes_under_dir_and_aggregates_as_the_reference(tmp_path, monkeypatch):
    runner = _load("torch_run")
    cwd, out = tmp_path / "cwd", tmp_path / "records"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    for only in ("channels", "chaos", "trace"):
        runner.main(["--smoke", "--device", "cpu", "--only", only, "--dir", str(out)])
    assert list(cwd.iterdir()) == []
    assert sorted(p.name for p in out.iterdir()) == [
        "BENCH_channels.json", "BENCH_faults.json", "BENCH_summary.json", "BENCH_trace.json"]
    pattern = str(out / "BENCH_*.json")
    rows = runner.aggregate(pattern)
    assert rows == _load("run").aggregate(pattern)
    summary = json.loads((out / "BENCH_summary.json").read_text())
    assert summary == json.loads(json.dumps({"records": rows}))
    assert {r["bench"] for r in rows} == {"channels", "faults", "trace"}
    runner.main(["--aggregate-only", "--dir", str(out)])
    assert json.loads((out / "BENCH_summary.json").read_text()) == summary


def test_harness_refuses_the_roofline_module(tmp_path):
    runner = _load("torch_run")
    with pytest.raises(SystemExit, match="item 8"):
        runner.main(["--only", "roofline", "--dir", str(tmp_path)])
    with pytest.raises(SystemExit, match="matches no module"):
        runner.main(["--only", "nothing", "--device", "cpu", "--dir", str(tmp_path)])


def test_no_committed_record_changed():
    assert {p.name: p.read_bytes() for p in sorted(ROOT.glob("BENCH_*.json"))} == COMMITTED
