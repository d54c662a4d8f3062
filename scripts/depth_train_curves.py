#!/usr/bin/env python3
"""Do the reference and the port learn from the reference's init in depth?
(CPU, f32)

Trains the stablelm_1_6b family at ``init_depth_spread.py``'s narrow width
(d 256, 4 heads of 64, d_ff 704, vocab 4096) from one init (the reference's
``LM.init(jax.random.key(0))``, handed to the port through numpy) in both
packages, for ``--steps`` AdamW steps at ``launch.train``'s settings (lr
3e-3, warmup max(steps // 20, 5), cosine to ``total_steps = steps``, clip
1.0, chunked attention, seq 128 x batch 8 of ``synth_batch``, whose random
walk documents a model can predict to about ln 7 = 1.95), and prints both
loss curves and gradient norms side by side::

    PYTHONPATH=src python scripts/depth_train_curves.py [--depths 4 24] [--steps 20]

The uniform guess over the vocabulary scores ln 4096 = 8.32.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from init_depth_spread import NARROW
from repro.configs.registry import get_config as ref_get_config
from repro.data.pipeline import DataConfig, synth_batch
from repro.models.transformer import LM as RefLM
from repro.optim import adamw as ref_opt
from repro.train.step import build_train_step as ref_build_train_step
from repro_torch.configs.registry import get_config
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.transformer import LM
from repro_torch.optim import adamw as opt
from repro_torch.train.step import build_train_step


def curves(depth: int, steps: int, seq: int, batch: int, lr: float) -> dict:
    ref_cfg = dataclasses.replace(ref_get_config("stablelm_1_6b"), n_layers=depth, **NARROW)
    cfg = dataclasses.replace(get_config("stablelm_1_6b"), n_layers=depth, **NARROW)
    ref_model = RefLM(ref_cfg, attn_impl="chunked", remat=None)
    ref_params = ref_model.init(jax.random.key(0))
    model = LM(cfg, attn_impl="chunked", remat=None)
    params = params_from_numpy(model, jax.tree.map(np.asarray, ref_params), device="cpu")
    kw = dict(lr=lr, warmup_steps=max(steps // 20, 5), total_steps=steps)
    ref_step = jax.jit(ref_build_train_step(ref_model, ref_opt.AdamWConfig(**kw)))
    step = build_train_step(model, opt.AdamWConfig(**kw))
    ref_state, state = ref_opt.init_opt_state(ref_params), opt.init_opt_state(params)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, batch_per_shard=batch)
    out = {"reference": [], "port": []}
    for i in range(steps):
        b = synth_batch(data, i, 0)
        ref_params, ref_state, m = ref_step(ref_params, ref_state, {k: jnp.asarray(v) for k, v in b.items()})
        out["reference"].append((float(m["loss"]), float(m["grad_norm"])))
        params, state, m = step(params, state, {k: torch.from_numpy(v) for k, v in b.items()})
        out["port"].append((float(m["loss"]), float(m["grad_norm"])))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--depths", type=int, nargs="+", default=[4, 24])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    args = ap.parse_args()
    torch.manual_seed(0)
    print(f"uniform guess: ln {NARROW['vocab_size']} = {math.log(NARROW['vocab_size']):.4f}")
    for depth in args.depths:
        t0 = time.perf_counter()
        c = curves(depth, args.steps, args.seq, args.batch, args.lr)
        print(f"\n{depth} layers ({time.perf_counter() - t0:.0f} s)")
        print("step   reference loss  grad norm     port loss  grad norm")
        for i, ((rl, rg), (pl, pg)) in enumerate(zip(c["reference"], c["port"])):
            print(f"{i:>4}  {rl:>14.4f} {rg:>10.3e} {pl:>13.4f} {pg:>10.3e}")


if __name__ == "__main__":
    main()
