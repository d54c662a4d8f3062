"""Kernel micro-timings of the port: the plain PyTorch path's time per call
and the kernel's agreement with it, at the shapes and under the row names of
the reference's ``benchmarks/kernel_bench.py`` (so the two tables line up).

* ``pud_and/ref_jnp/<rows>x128`` — ``bulk_op_ref(x, y, op="and")`` over int32
  tiles of 1024, 8192 and 65536 rows; the derived value is 1.0 when
  ``pud_and`` (the ``bulk_op`` kernel on the card) equals it exactly.
* ``flash/ref_jnp/B<B>H<H>S<S>D<D>`` — ``attention_ref`` (causal, f32) at
  (1, 4, 256, 64) and (2, 8, 512, 64); the derived value is the max abs
  error of ``flash_attention`` (the flash kernel on the card) against it.

On the CPU the wrappers take the plain path, so the derived values are the
plain path's agreement with itself, as the reference's interpret mode gives.
On the card (``--device cuda``, the default) each case adds a
``.../kernel_cuda/...`` row with the kernel's own time: CUDA events around
each call with the L2 cache flushed before it, the median of 20 calls::

    PYTHONPATH=src python benchmarks/torch_kernel_bench.py [--device cpu]
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path
from typing import Callable, Dict

import numpy as np
import torch

_SRC = Path(__file__).resolve().parents[1] / "src"
if str(_SRC) not in sys.path:
    sys.path.append(str(_SRC))

from repro_torch import resolve_device  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fl_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.pud_bulk import ops as pud_ops  # noqa: E402
from repro_torch.kernels.pud_bulk.ref import bulk_op_ref  # noqa: E402

PUD_ROWS = [1024, 8192, 65536]
FLASH_SHAPES = [(1, 4, 256, 64), (2, 8, 512, 64)]
#: flash's f32 tolerance against its plain version (the reference's own);
#: ``pud_and`` must be exact
FLASH_TOL = 2e-5


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def _time(fn, *args, iters=5):
    """Host microseconds per call of ``fn`` (after one warm-up call)."""
    device = args[0].device
    fn(*args)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync(device)
    return (time.perf_counter() - t0) * 1e6 / iters


def time_ms(fn, reps: int) -> float:
    """Median device time of one call, with the 50 MB L2 flushed before each
    (``chip_smoke.time_ms``)."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def run(emit: Callable[[str, float, float], None], device="cuda") -> Dict:
    device = resolve_device(device)
    on_card = device.type == "cuda"
    rng = np.random.default_rng(0)
    out = {}

    for rows in PUD_ROWS:
        x = torch.from_numpy(rng.integers(0, 1 << 30, (rows, 128)).astype(np.int32)).to(device)
        y = torch.from_numpy(rng.integers(0, 1 << 30, (rows, 128)).astype(np.int32)).to(device)
        us = _time(lambda a, b: bulk_op_ref(a, b, op="and"), x, y)
        match = float(torch.equal(pud_ops.pud_and(x, y), bulk_op_ref(x, y, op="and")))
        emit(f"pud_and/ref_jnp/{rows}x128", us, match)
        out[f"pud_and_{rows}"] = us
        if on_card:
            kus = 1e3 * time_ms(lambda: pud_ops.pud_and(x, y), 20)
            emit(f"pud_and/kernel_cuda/{rows}x128", kus, match)
            out[f"pud_and_kernel_{rows}"] = kus

    for (B, H, S, D) in FLASH_SHAPES:
        q = torch.from_numpy(rng.normal(size=(B, H, S, D)).astype(np.float32)).to(device)
        kv = torch.from_numpy(rng.normal(size=(B, H, S, D)).astype(np.float32)).to(device)
        us = _time(lambda a, b, c: attention_ref(a, b, c), q, kv, kv)
        err = float((fl_ops.flash_attention(q, kv, kv) - attention_ref(q, kv, kv)).abs().max())
        emit(f"flash/ref_jnp/B{B}H{H}S{S}D{D}", us, err)
        out[f"flash_{B}_{H}_{S}_{D}"] = err
        if on_card:
            kus = 1e3 * time_ms(lambda: fl_ops.flash_attention(q, kv, kv), 20)
            emit(f"flash/kernel_cuda/B{B}H{H}S{S}D{D}", kus, err)
            out[f"flash_kernel_{B}_{H}_{S}_{D}"] = kus
    return out


def check(rows: Dict[str, float]) -> None:
    """Every case's kernel within its tolerance of the plain path: ``rows``
    maps row names to derived values."""
    for name, derived in rows.items():
        if name.startswith("pud_and/"):
            assert derived == 1.0, (name, derived)
        else:
            assert derived <= FLASH_TOL, (name, derived)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rows: Dict[str, float] = {}

    def emit(name: str, us: float, derived) -> None:
        rows[name] = derived
        print(f"{name},{us:.1f},{derived}")

    run(emit, device=args.device)
    check(rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
