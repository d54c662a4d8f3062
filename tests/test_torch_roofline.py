"""The port's roofline and perf launchers (``repro_torch.launch.roofline``,
``perf``) against the reference's.

The reference's values come from one process of its own
(``tests/ref_launch_records.py tables``, ``JAX_PLATFORMS=cpu``, its own
``XLA_FLAGS``): the host tables (``ACCUM_DEFAULTS``, ``KV_DTYPE_DEFAULTS``,
``SHAPE_RULES``, ``VARIANTS``, ``auto_accum``), ``model_flops_per_device``
for every (arch, shape) of ``cells()``, ``_lin2`` and ``extrapolate`` on
fixed stand-in samples, and a roofline record's keys; compared as JSON.

Then the extrapolation against the port's own direct count at depth, exact
(the port counts every layer, so the linear forms hold to the byte), the
roofline CLI's record, its constants (the H100's, none of the TPU's), and
``perf.measure`` on one variant.
"""
import json
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from ref_launch_records import fake_per_device, run_reference  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.configs.registry import cells, get_config, lm_archs  # noqa: E402
from repro_torch.launch import dryrun, perf  # noqa: E402
from repro_torch.launch import roofline as RL  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXACT = ("flops", "fused_bytes", "collective_bytes", "bytes_accessed")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference("tables", tmp_path_factory.mktemp("ref_tables"))


def _json(x):
    return json.loads(json.dumps(x))


def test_host_tables_equal_the_reference(ref):
    pairs = [(a, s) for a in lm_archs() for s in cells(a)]
    assert _json(dryrun.ACCUM_DEFAULTS) == ref["ACCUM_DEFAULTS"]
    assert {f"{a}|{s}": v for (a, s), v in dryrun.KV_DTYPE_DEFAULTS.items()} == \
        ref["KV_DTYPE_DEFAULTS"]
    assert _json(dryrun.SHAPE_RULES) == ref["SHAPE_RULES"]
    assert _json(perf.VARIANTS) == ref["VARIANTS"]
    assert {f"{a}|{s}": dryrun.auto_accum(a, SHAPES[s]) for a, s in pairs} == ref["auto_accum"]


def test_model_flops_per_device_equal_the_reference(ref):
    mine = {f"{a}|{s}": RL.model_flops_per_device(a, s) for a in lm_archs() for s in cells(a)}
    assert _json(mine) == ref["model_flops"]


def test_lin2_and_extrapolate_equal_the_reference_on_fixed_samples(ref, monkeypatch):
    monkeypatch.setattr(RL, "run_cell",
                        lambda arch, shape, n_layers, **kw: fake_per_device(n_layers))
    assert _json(RL._lin2(fake_per_device(1)["per_device"],
                          fake_per_device(2)["per_device"])) == ref["lin2"]
    for arch in ("stablelm_1_6b", "zamba2_7b"):
        assert _json(RL.extrapolate(arch, "decode_32k", attn_impl="chunked")) == \
            ref["extrapolate"][arch]


def _direct(arch, shape, n):
    return RL._pd(dryrun.run_cell(arch, shape, False, n_layers=n, scan_layers=False,
                                  accum_steps=1))


def test_the_extrapolation_is_exact_at_depth():
    """F(L) = A + L*B from the 1- and 2-layer records gives the direct
    4-layer count of every metric."""
    f1, f2, f4 = (_direct("stablelm_1_6b", "decode_32k", n) for n in (1, 2, 4))
    co = RL._lin2(f1, f2)
    for m in EXACT:
        assert co["A"][m] + 4 * co["B"][m] == f4[m], m
    assert co["B"]["flops"] > 0 and co["B"]["collective_bytes"] > 0


def test_the_hybrid_extrapolation_is_exact_at_depth():
    """zamba2's three-term form F = A + L*Bm + (L // 6)*Ba, from its 6-, 7-
    and 12-layer records, gives the direct 13-layer count (two shared
    attention applications and a remainder layer)."""
    every = get_config("zamba2_7b").attn_every
    f6, f7, f12, f13 = (_direct("zamba2_7b", "decode_32k", n)
                        for n in (every, every + 1, 2 * every, 2 * every + 1))
    for m in EXACT:
        Bm = f7[m] - f6[m]
        Ba = f12[m] - f6[m] - every * Bm
        A = f6[m] - every * Bm - Ba
        assert A + 13 * Bm + (13 // every) * Ba == f13[m], m
        assert Ba != 0 or m == "collective_bytes"


def test_roofline_cli_writes_the_reference_keys_priced_at_the_h100(ref, tmp_path):
    out = tmp_path / "roofline.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.roofline", "--arch", "stablelm_1_6b",
         "--shape", "decode_32k", "--out", str(out)],
        capture_output=True, text=True, timeout=240, cwd=str(tmp_path),
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    (rec,) = json.loads(out.read_text()).values()
    assert sorted(rec) == sorted(ref["roofline_keys"] + ["card"])
    assert rec["card"]["peak_flops"] == 989e12 and rec["card"]["hbm_bw"] == 3.35e12
    assert rec["compute_s"] == rec["totals_per_device"]["flops"] / 989e12
    assert rec["memory_s"] == rec["totals_per_device"]["fused_bytes"] / 3.35e12
    assert rec["collective_s"] == rec["totals_per_device"]["collective_bytes"] / RL.NET_BW


def test_no_tpu_constant_prices_the_port():
    assert (RL.PEAK_FLOPS, RL.HBM_BW, RL.NVLINK_BW) == (989e12, 3.35e12, 450e9)
    sources = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + sorted(
        (ROOT / "benchmarks").glob("torch_*.py"))
    for path in sources:
        text = path.read_text()
        assert "197e12" not in text and "819e9" not in text, path


def test_perf_measure_logs_a_variant(tmp_path, monkeypatch):
    monkeypatch.setattr(perf, "PERF_LOG", str(tmp_path / "perf_log.json"))
    rec = perf.measure("stablelm_1_6b", "decode_32k", "kv_fp8")
    perf.log_experiment(rec, "fp8 pages halve the cache's bytes")
    (logged,) = json.loads((tmp_path / "perf_log.json").read_text())
    assert logged["variant"] == "kv_fp8" and logged["hypothesis"]
    base = RL.extrapolate("stablelm_1_6b", "decode_32k", attn_impl="chunked")["total"]
    assert rec["totals_per_device"]["fused_bytes"] < base["fused_bytes"]
    assert rec["peak_bytes_full"] > 0
