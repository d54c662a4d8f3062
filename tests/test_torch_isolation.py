"""The port stands alone: importing every module of ``repro_torch`` and
loading ``chip_smoke.py`` and the port's example and benchmark scripts pulls
in neither JAX nor the reference package."""
import pathlib
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SCRIPTS = [ROOT / "chip_smoke.py", ROOT / "examples" / "torch_quickstart.py",
           ROOT / "examples" / "torch_pud_bitwise.py", ROOT / "benchmarks" / "torch_microbench.py",
           ROOT / "benchmarks" / "torch_serve_bench.py", ROOT / "scripts" / "decay_bench.py",
           ROOT / "scripts" / "decay_precision.py", ROOT / "examples" / "torch_serve_paged.py",
           ROOT / "src" / "repro_torch" / "launch" / "serve.py",
           ROOT / "scripts" / "torch_decode_profile.py", ROOT / "scripts" / "flash_precision.py",
           ROOT / "scripts" / "mma_rate.py"]

_PROBE = r"""
import importlib, importlib.util, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
for i, path in enumerate(sys.argv[1:]):
    spec = importlib.util.spec_from_file_location(f"script{i}", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "repro.", "jaxlib")))
print(len(names), bad)
"""


def test_port_and_chip_smoke_import_no_jax_and_no_reference():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, *map(str, SCRIPTS)],
        capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "JAX_PLATFORMS": "cpu"},
    )
    assert proc.returncode == 0, proc.stderr
    n_modules, bad = proc.stdout.split(maxsplit=1)
    assert int(n_modules) >= 40
    assert bad.strip() == "[]", bad


_FORBIDDEN = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)(\.|\s))", re.M)


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + SCRIPTS,
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_source_has_no_jax_or_reference_import(path):
    assert not _FORBIDDEN.findall(path.read_text()), path
