"""End-to-end serving example on the port: continuous batching over the PUMA
paged KV pool, comparing placement policies (block-table contiguity is the
'% executable in PUD' analogue).  On the card the engine decodes through
CUDA graphs; on the CPU eagerly.  The weights are the port's seeded init.

    PYTHONPATH=src python examples/torch_serve_paged.py [--policy puma|first_fit|random] [--device cuda|cpu]
"""
import argparse
import time

import numpy as np

from repro_torch.configs.registry import get_config
from repro_torch.core.kv_pool import KVPoolConfig
from repro_torch.models.transformer import LM
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--policy", default=None, help="run one policy (default: all)")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config("stablelm_1_6b").smoke()
    model = LM(cfg, attn_impl="naive", remat=None)
    params = model.init(0, device=args.device)
    rng = np.random.default_rng(0)
    prompts = [
        list(rng.integers(0, cfg.vocab_size, int(rng.integers(8, 48))))
        for _ in range(args.requests)
    ]

    policies = [args.policy] if args.policy else ["puma", "first_fit", "random"]
    for policy in policies:
        pool_cfg = KVPoolConfig(
            num_blocks=256, block_size=8, kv_heads=cfg.n_kv_heads,
            head_dim=cfg.hd, n_layers=cfg.n_layers, max_seqs=6,
            max_blocks_per_seq=16, blocks_per_arena=32,
            policy=policy, dtype="float32",
        )
        eng = ServeEngine(model, params, pool_cfg, device=args.device)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new=args.max_new))
        t0 = time.perf_counter()
        done = eng.run()
        dt = time.perf_counter() - t0
        m = eng.metrics()
        print(
            f"{policy:10s} served {len(done):3d} reqs, "
            f"{int(m['tokens'])} tokens in {dt:5.1f}s | "
            f"contiguity={m['mean_contiguous_fraction']:.3f} "
            f"descriptors/tile={m['descriptors_per_tile']:.3f} "
            f"align_hits={int(m['align_hits'])} misses={int(m['align_misses'])}"
        )


if __name__ == "__main__":
    main()
