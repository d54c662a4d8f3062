#!/usr/bin/env python3
"""How far apart the state path's three decay-attention routes are with depth.

    python3 scripts/state_depth_spread.py [--arch rwkv6_7b|zamba2_7b] [--depths 1,2,4]

Builds the full-width models as ``chip_smoke.py`` does (``state_setup``: the
same seeded weights, inert leaves set, the same 8 x 1024 prompts and 4 x
2048 ``prefill_logits`` batch), runs its first-layer check on both inputs
(``layer_check``), then, for the first ``d`` layers of each depth, the
logits through the kernel, the plain chunked math and the sequential oracle
(``shallow_check``).  It shows where the plain paths stop agreeing, which
sets ``chip_smoke.STATE_CHECK_DEPTH``.  Without ``--arch`` it runs rwkv6_7b
at depths 1, 2, 4, 8 and zamba2_7b at 1, 3, 5, 6, 12 (after 6 Mamba layers
comes the first shared attention block).  Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402  (puts src on sys.path)

DEFAULT = {"rwkv6_7b": (3, (1, 2, 4, 8)), "zamba2_7b": (4, (1, 3, 5, 6, 12))}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=sorted(DEFAULT))
    ap.add_argument("--depths", help="comma-separated layer counts")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    chip_smoke.phase_build()
    for arch in [args.arch] if args.arch else list(DEFAULT):
        seed, depths = DEFAULT[arch]
        if args.depths:
            depths = tuple(int(d) for d in args.depths.split(","))
        model, params, prompts, pbatch = chip_smoke.state_setup(arch, seed)
        for path, tokens, with_state in (("prompt", prompts, True),
                                         ("prefill", pbatch["tokens"], False)):
            r = chip_smoke.layer_check(model, params, tokens, with_state)
            print(f"[{arch}] first layer, {path} input {r['shape']}: kernel vs plain chunked "
                  f"output {r['out_err']:.3e} of scale {r['out_scale']:.3f}"
                  + (f", state {r['state_err']:.3e} of {r['state_scale']:.3f}"
                     if with_state else ""), flush=True)
        for depth in depths:
            t0 = time.perf_counter()
            res = chip_smoke.shallow_check(model, params, depth, prompts, pbatch)
            for path, r in res.items():
                print(f"[{arch}] {depth} layers, {path}: kernel vs chunked "
                      f"{r['kernel_vs_chunked']:.4f}, oracle vs chunked {r['oracle_vs_chunked']:.4f}, "
                      f"kernel vs oracle {r['kernel_vs_oracle']:.4f}, scale {r['scale']:.3f}, "
                      f"bf16 ulp {chip_smoke.bf16_ulp(r['scale']):g}; argmax equal "
                      f"{r['argmax_equal']} ({time.perf_counter() - t0:.1f} s)", flush=True)
        del params
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
