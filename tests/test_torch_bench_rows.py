"""The port's row-printing runners and its harness on the CPU:
``torch_alloc_fraction`` (``--churn-cycles`` included) and
``torch_kv_pool_bench`` print the reference's rows, names and values;
``torch_kernel_bench`` the reference's row names with the plain path's
agreement; ``torch_run`` writes only under ``--dir``, its ``aggregate``
equals the reference's over the same files, and its roofline module prints
the reference report's rows."""
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
    port = _load(f"torch_{name}")
    rows, out = _rows(port.run if name == "alloc_fraction"
                      else lambda emit: port.run(emit, device="cpu"))
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


def _roofline_records(scale):
    recs = {f"{arch}|{shape}|chunked": {
        "arch": arch, "shape": shape, "compute_s": 1e-3 * scale * (i + 1),
        "memory_s": 2.5e-3 * scale / (i + 1), "collective_s": 7e-4 * scale,
        "roofline_fraction": 0.1234567 * scale / (i + 1)}
        for i, (arch, shape) in enumerate([("stablelm_1_6b", "decode_32k"),
                                           ("zamba2_7b", "train_4k")])}
    recs["rwkv6_7b|long_500k|chunked"] = {"arch": "rwkv6_7b", "shape": "long_500k",
                                          "status": "error", "error": "x"}
    return recs


def test_harness_runs_the_roofline_module(tmp_path, monkeypatch, capsys):
    """``--only roofline`` runs ``torch_roofline_report``: its rows equal the
    reference report's over the same records (the port's files beside the
    reference's names), and ``roofline/missing`` without any."""
    runner, ref = _load("torch_run"), _load("roofline_report")
    exp = tmp_path / "experiments"
    exp.mkdir()
    monkeypatch.chdir(tmp_path)

    def rows():
        capsys.readouterr()
        runner.main(["--only", "roofline", "--dir", str(tmp_path / "out")])
        return [line.split(",") for line in capsys.readouterr().out.splitlines()
                if "," in line and not line.startswith("name,")]

    assert rows() == [["roofline/missing", "0.0", "0.0"]]
    for scale, (port_name, ref_name) in zip((1.0, 0.5), [
            ("torch_roofline_results.json", "roofline_results.json"),
            ("torch_roofline_final_decode.json", "roofline_final_decode.json")]):
        for name in (port_name, ref_name):
            (exp / name).write_text(json.dumps(_roofline_records(scale)))
    expected = []
    out = ref.run(lambda name, us, derived: expected.append([name, f"{us:.1f}", str(derived)]))
    assert rows() == expected and len(expected) == 4 and len(out) == 4
    with pytest.raises(SystemExit, match="matches no module"):
        runner.main(["--only", "nothing", "--device", "cpu", "--dir", str(tmp_path)])


def test_no_committed_record_changed():
    assert {p.name: p.read_bytes() for p in sorted(ROOT.glob("BENCH_*.json"))} == COMMITTED
