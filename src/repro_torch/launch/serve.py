"""Serving launcher: ``python -m repro_torch.launch.serve --arch stablelm_1_6b``.

Continuous batching over the PUMA paged KV pool on the reduced config;
``--policy`` compares placement policies.  Runs on the card unless
``--device cpu`` is given; on the card the engine decodes through CUDA
graphs (``ServeEngine``'s ``jit``, left at its default).  The weights are
the port's seeded init (the reference draws its own from
``jax.random.key(0)``); the requests, the schedule and the printed line are
the reference launcher's.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs.registry import get_config, lm_archs
from repro_torch.core.kv_pool import KVPoolConfig
from repro_torch.models.transformer import LM
from repro_torch.serve.engine import Request, ServeEngine


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm_1_6b", choices=lm_archs())
    ap.add_argument("--policy", default="puma",
                    choices=["puma", "first_fit", "random"])
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seqs", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def serve(model: LM, params, args: argparse.Namespace):
    """The reference launcher's serve on ``model`` and ``params``: its pool,
    engine and seeded prompts.  Returns (engine, done requests, seconds)."""
    cfg = model.cfg
    pool_cfg = KVPoolConfig(
        num_blocks=512, block_size=8, kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
        n_layers=cfg.n_layers, max_seqs=args.max_seqs, max_blocks_per_seq=32,
        blocks_per_arena=64, policy=args.policy, dtype="float32",
    )
    eng = ServeEngine(model, params, pool_cfg, device=args.device)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        eng.submit(Request(
            rid=i,
            prompt=list(rng.integers(0, cfg.vocab_size, int(rng.integers(8, 64)))),
            max_new=args.max_new,
        ))
    t0 = time.perf_counter()
    done = eng.run()
    return eng, done, time.perf_counter() - t0


def main(argv=None):
    args = parse_args(argv)
    cfg = get_config(args.arch).smoke()
    if cfg.family in ("ssm", "hybrid", "encdec"):
        raise SystemExit(
            f"{args.arch}: paged-KV serving applies to attention-KV archs; "
            "SSM/hybrid state serving uses the dense decode path "
            "(see DESIGN.md §Arch-applicability)"
        )
    model = LM(cfg, attn_impl="naive", remat=None)
    params = model.init(0, device=args.device)
    eng, done, dt = serve(model, params, args)
    m = eng.metrics()
    print(
        f"[serve] {args.arch} policy={args.policy}: {len(done)} requests, "
        f"{int(m['tokens'])} tokens, {m['tokens']/dt:.1f} tok/s | "
        f"contiguity={m['mean_contiguous_fraction']:.3f} "
        f"descriptors/tile={m['descriptors_per_tile']:.3f}"
    )
    return eng, done


if __name__ == "__main__":
    main()
