"""The reference's launcher records for tests/test_torch_dryrun.py and
tests/test_torch_roofline.py, written as JSON by a process of its own.

The reference's ``launch/dryrun.py`` sets ``XLA_FLAGS`` when it is imported
(and ``roofline.py`` / ``perf.py`` with ``setdefault``), which would leak
into every later subprocess of a test worker; so the tests run this file
with ``JAX_PLATFORMS=cpu`` and the reference's own ``XLA_FLAGS`` set:

    python tests/ref_launch_records.py dryrun OUT.json    # the cells' records
    python tests/ref_launch_records.py tables OUT.json    # host tables, fake samples

The tests import this module for ``CELLS``, ``fake_per_device`` and
``run_reference``, which runs it as above (the import pulls in neither JAX
nor the reference).
"""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: (arch, shape, n_layers): every family and every mode once, at 1 layer
#: (zamba2 at attn_every and attn_every + 1)
CELLS = [
    ("stablelm_1_6b", "train_4k", 1),
    ("stablelm_1_6b", "prefill_32k", 1),
    ("stablelm_1_6b", "decode_32k", 1),
    ("granite_moe_1b_a400m", "train_4k", 1),
    ("rwkv6_7b", "decode_32k", 1),
    ("zamba2_7b", "decode_32k", 6),
    ("zamba2_7b", "decode_32k", 7),
    ("qwen2_vl_72b", "decode_32k", 1),
    ("seamless_m4t_medium", "train_4k", 1),
]

METRICS = ("flops", "bytes_accessed", "fused_bytes", "collective_bytes")


def fake_per_device(n_layers: int) -> dict:
    """A stand-in dry-run record whose metrics depend on the depth alone (the
    extrapolation's samples)."""
    return {"per_device": {m: 1000.0 * (i + 1) + (7 + i) * n_layers + 3.0 * (n_layers // 6)
                           for i, m in enumerate(METRICS)}}


def key(arch, shape, n_layers) -> str:
    return f"{arch}|{shape}|{n_layers}"


def run_reference(what: str, workdir, timeout: float = 180.0) -> dict:
    """This file's ``what`` records, from a process of its own under
    ``timeout`` seconds; raises with its exit code and the tail of its
    output unless it exits 0."""
    workdir = pathlib.Path(workdir)
    out, log = workdir / f"ref_{what}.json", workdir / f"ref_{what}.log"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    with open(log, "w") as f:
        try:
            code = subprocess.run([sys.executable, __file__, what, str(out)], stdout=f,
                                  stderr=subprocess.STDOUT, env=env, cwd=str(ROOT),
                                  timeout=timeout).returncode
        except subprocess.TimeoutExpired:
            code = "killed at the time limit"
    if code != 0:
        raise AssertionError(f"the reference's {what} records: exit {code}\n"
                             f"{log.read_text()[-3000:]}")
    return json.loads(out.read_text())


def _dryrun() -> dict:
    from repro.launch.dryrun import run_cell

    out = {}
    for arch, shape, n in CELLS:
        rec = run_cell(arch, shape, False, n_layers=n, scan_layers=False, accum_steps=1)
        out[key(arch, shape, n)] = {"per_device": rec["per_device"],
                                    "collectives": rec["collectives"]}
    return out


def _tables() -> dict:
    from repro.configs.base import SHAPES
    from repro.configs.registry import cells, lm_archs
    from repro.launch import dryrun, perf
    from repro.launch import roofline as RL

    pairs = [(a, s) for a in lm_archs() for s in cells(a)]
    RL.run_cell = lambda arch, shape, n_layers, **kw: fake_per_device(n_layers)
    return {
        "ACCUM_DEFAULTS": dryrun.ACCUM_DEFAULTS,
        "KV_DTYPE_DEFAULTS": {f"{a}|{s}": v for (a, s), v in dryrun.KV_DTYPE_DEFAULTS.items()},
        "SHAPE_RULES": dryrun.SHAPE_RULES,
        "VARIANTS": perf.VARIANTS,
        "auto_accum": {f"{a}|{s}": dryrun.auto_accum(a, SHAPES[s]) for a, s in pairs},
        "model_flops": {f"{a}|{s}": RL.model_flops_per_device(a, s) for a, s in pairs},
        "lin2": RL._lin2(fake_per_device(1)["per_device"], fake_per_device(2)["per_device"]),
        "extrapolate": {a: RL.extrapolate(a, "decode_32k", attn_impl="chunked")
                        for a in ("stablelm_1_6b", "zamba2_7b")},
        "roofline_keys": sorted(RL.roofline_cell("stablelm_1_6b", "decode_32k")),
    }


def main() -> None:
    what, path = sys.argv[1], sys.argv[2]
    out = _dryrun() if what == "dryrun" else _tables()
    with open(path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()
