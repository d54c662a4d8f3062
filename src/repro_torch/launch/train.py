"""Training launcher: ``python -m repro_torch.launch.train --arch stablelm_1_6b``.

Trains the reduced (smoke) config by default; ``--full`` takes the
production config, unreduced, on one card with full per-layer
rematerialization (no mesh: distribution is not ported yet).  Runs on the
card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs.registry import get_config, lm_archs
from repro_torch.data.pipeline import DataConfig
from repro_torch.models.transformer import LM
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm_1_6b", choices=lm_archs())
    ap.add_argument("--full", action="store_true",
                    help="production config, unreduced, remat='full'")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.smoke()

    model = LM(cfg, attn_impl="chunked", remat="full" if args.full else None)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      batch_per_shard=args.batch)
    ocfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                       total_steps=args.steps)
    tcfg = TrainerConfig(
        total_steps=args.steps, ckpt_every=args.ckpt_every,
        ckpt_dir=f"{args.ckpt_dir}/{args.arch}", log_every=10,
        accum_steps=args.accum, grad_compression=args.grad_compression,
    )
    out = Trainer(model, data, ocfg, tcfg, device=args.device).run()
    losses = [m["loss"] for _, m in out["history"]]
    print(f"[train] {args.arch}: loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({len(losses)} steps)")
    return out


if __name__ == "__main__":
    main()
