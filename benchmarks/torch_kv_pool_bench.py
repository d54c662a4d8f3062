"""KV-pool placement policy vs block-table contiguity (the '% executable in
PUD' analogue) under serving churn, plus the modelled DMA-descriptor
reduction: the reference's ``benchmarks/kv_pool_bench.py`` on
``repro_torch``'s ``PagedKVPool``.  The study reads only the pool's host
bookkeeping, so the pool's buffers stay on the CPU::

    PYTHONPATH=src python benchmarks/torch_kv_pool_bench.py
"""
from __future__ import annotations

import sys
import time
from pathlib import Path
from typing import Callable, Dict

import numpy as np

_SRC = Path(__file__).resolve().parents[1] / "src"
if str(_SRC) not in sys.path:
    sys.path.append(str(_SRC))

from repro_torch.core.kv_pool import KVPoolConfig, PagedKVPool  # noqa: E402


def _churn(policy: str, steps: int = 400, seed: int = 0) -> Dict[str, float]:
    cfg = KVPoolConfig(
        num_blocks=1024, blocks_per_arena=64, max_seqs=64, policy=policy
    )
    p = PagedKVPool(cfg, device="cpu")
    rng = np.random.default_rng(seed)
    live = []
    for _ in range(steps):
        if live and rng.random() < 0.45:
            p.release(live.pop(rng.integers(len(live))))
        s = p.admit(int(rng.integers(16, 192)))
        if s is not None:
            live.append(s)
        for s in live:
            p.append_token(s)
    return p.contiguity_report()


def run(emit: Callable[[str, float, float], None]) -> Dict:
    out = {}
    for policy in ["puma", "first_fit", "random"]:
        t0 = time.perf_counter()
        reps = [_churn(policy, seed=s) for s in range(3)]
        us = (time.perf_counter() - t0) * 1e6 / 3
        frac = float(np.mean([r["mean_contiguous_fraction"] for r in reps]))
        desc = float(np.mean([r["descriptors_per_tile"] for r in reps]))
        emit(f"kv_pool/contiguity/{policy}", us, round(frac, 4))
        emit(f"kv_pool/descriptors_per_tile/{policy}", us, round(desc, 4))
        out[policy] = {"contiguity": frac, "descriptors_per_tile": desc}
    return out


if __name__ == "__main__":
    run(lambda name, us, derived: print(f"{name},{us:.1f},{derived}"))
