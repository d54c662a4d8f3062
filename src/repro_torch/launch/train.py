"""Training launcher: ``python -m repro_torch.launch.train --arch stablelm_1_6b``.

Trains the reduced (smoke) config by default; ``--full`` takes the
production config, unreduced, with full per-layer rematerialization.  A
single process runs ``--full`` on one card with no mesh.  Under ``torchrun``
(``WORLD_SIZE`` set) ``--full`` starts the process group (NCCL on the
card, gloo with ``--device cpu``) and builds the production mesh, (16, 16)
``("data", "model")``, which needs exactly 256 ranks, as the reference's
launcher does on its pod; the params, optimizer state and batches are then
DTensors on that mesh.  Runs on the card unless ``--device cpu`` is given.
Every family trains on the pipeline's batches, completed for its config
(``launch/inputs.py:complete_batch``).
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.configs.registry import get_config, lm_archs
from repro_torch.data.pipeline import DataConfig
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import make_production_mesh
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
    mesh, device = None, args.device
    if not args.full:
        cfg = cfg.smoke()
    elif "WORLD_SIZE" in os.environ:
        dist.init_process_group("gloo" if args.device == "cpu" else "nccl")
        if args.device != "cpu":
            device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
            torch.cuda.set_device(device)
        mesh = make_production_mesh(device_type="cpu" if args.device == "cpu" else "cuda")
        shd.set_mesh(mesh)

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
    out = Trainer(model, data, ocfg, tcfg, device=device, mesh=mesh).run()
    losses = [m["loss"] for _, m in out["history"]]
    print(f"[train] {args.arch}: loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({len(losses)} steps)")
    return out


if __name__ == "__main__":
    main()
