"""Bulk bitwise pipeline on the port's PUD substrate ops: a bitmap-index
query (the paper's motivating workload family) built from pud_bulk ops.

Query: count rows where (age in [32,64)) AND (active) OR (vip) over packed
bitplane columns — three PUD instructions (two ``pud_and``, one ``pud_or``)
checked against numpy, plus a RowClone block copy that materializes the
result.  On a CUDA device the ops run the hand-written ``bulk_op`` and
``block_copy`` kernels; on the CPU their plain PyTorch versions.

    PYTHONPATH=src python examples/torch_pud_bitwise.py [--device cuda|cpu] [--rows N]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels.pud_bulk import ops


def bitmap_query(planes: dict) -> torch.Tensor:
    """``(age_lo AND age_hi AND active) OR vip`` over packed uint8 bitplanes."""
    t0 = ops.pud_and(planes["age_lo"], planes["age_hi"])
    t1 = ops.pud_and(t0, planes["active"])
    return ops.pud_or(t1, planes["vip"])


def main(argv=None) -> int:
    """Run the query; return its match count."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=1 << 16)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n = args.rows
    rng = np.random.default_rng(0)
    age = rng.integers(0, 100, n)
    active = rng.integers(0, 2, n).astype(bool)
    vip = rng.integers(0, 2, n).astype(bool)

    def pack(bits: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.packbits(bits)).to(dev)

    planes = {"age_lo": pack(age >= 32), "age_hi": pack(age < 64),
              "active": pack(active), "vip": pack(vip)}
    res = bitmap_query(planes)
    got = np.unpackbits(res.cpu().numpy())[:n].astype(bool)
    want = ((age >= 32) & (age < 64) & active) | vip
    assert (got == want).all(), "PUD bitmap query mismatch"
    matches = int(got.sum())
    print(f"bitmap query over {n} rows on {dev.type}: {matches} matches — PUD ops == numpy")

    # RowClone the result into a fresh pool block (materialized view)
    pool = torch.zeros((4, res.numel()), dtype=res.dtype, device=dev)
    pool[0] = res
    ops.pool_block_copy(pool, [0], [3])
    assert torch.equal(pool[3], res)
    print("RowClone block copy: materialized view verified")
    return matches


if __name__ == "__main__":
    main()
