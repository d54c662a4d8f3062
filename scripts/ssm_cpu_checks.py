#!/usr/bin/env python3
"""Two CPU checks of the ssm/hybrid slice, in both packages (f32).

1. The split-cache flush near the end of the main store (zamba2_7b smoke,
   the reference's ``LM.init(jax.random.key(1))``): a main store of 6
   tokens and a recent ring of 4 (4 tokens decoded and flushed, 2 more
   decoded and flushed, then a 7th decoded), and a store of 3 with a ring
   of 2 (2 tokens, flush, 1 token, flush, a 4th token).  The reference's
   flush writes the whole ring, at a start that ``dynamic_update_slice``
   clamps (from 4 to 2, from 2 to 1); the port writes the tokens the ring
   holds.  Printed: each package's distance of the last token's logits
   from its teacher-forced prefill (the reference's own tolerance for this
   check is 5e-4).
2. How far the port's zamba2 Mamba states (conv, ssd) and logits lie from
   the reference's after a 35-token prompt and one more token, for 3 init
   keys x 3 seeds of the inert-leaf perturbation, each over max(1, max
   |ref|), below and after the shared attention block::

    PYTHONPATH=src python scripts/ssm_cpu_checks.py [--flush-only]
"""
from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.registry import get_config as ref_get_config
from repro.models.transformer import LM as RefLM
from repro_torch.configs.registry import get_config
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.inert import perturb_inert
from repro_torch.models.transformer import LM

ARCH = "zamba2_7b"


def flush_check() -> None:
    ref = RefLM(ref_get_config(ARCH).smoke(), attn_impl="naive", remat=None)
    tree = jax.tree.map(np.asarray, ref.init(jax.random.key(1)))
    model = LM(get_config(ARCH).smoke(), remat=None)
    ref_params = jax.tree.map(jnp.asarray, tree)
    params = params_from_numpy(model, tree, device="cpu")
    # (main store, recent ring, tokens after which to flush, tokens in all)
    for store, ring, flush_after, n in ((6, 4, (3, 5), 7), (3, 2, (1, 2), 4)):
        toks = np.random.default_rng(0).integers(0, model.cfg.vocab_size, (1, n)).astype(np.int32)
        pos = np.arange(n, dtype=np.int32)[None]
        runs = {
            "reference": (ref, ref_params, ref.init_cache(1, store, recent_size=ring),
                          jnp.asarray),
            "port": (model, params, model.init_cache(1, store, recent_size=ring, device="cpu"),
                     lambda a: torch.from_numpy(a).long()),
        }
        for name, (m, p, cache, conv) in runs.items():
            full = m.prefill_logits(p, {"tokens": conv(toks), "positions": conv(pos)})
            for t in range(n):
                logits, cache = m.decode_step(p, {"tokens": conv(toks[:, t:t + 1]),
                                                  "positions": conv(pos[:, t:t + 1])}, cache)
                if t in flush_after:
                    cache = m.flush_cache(cache)
            err = float(np.abs(np.asarray(logits) - np.asarray(full)).max())
            print(f"flush, store {store}, ring {ring}, {name}: token {n}'s logits {err:.3e} "
                  f"from teacher forcing (scale {float(np.abs(np.asarray(full)).max()):.3f})")


def perturb(tree, seed):
    """A copy of ``tree`` with the hybrid family's inert leaves set by the
    port's rule (``repro_torch.models.inert``)."""
    tree = jax.tree.map(np.array, tree)
    perturb_inert("hybrid", tree["layers"], seed)
    return tree


def state_spread() -> None:
    ref = RefLM(ref_get_config(ARCH).smoke(), attn_impl="naive", remat=None)
    model = LM(get_config(ARCH).smoke(), remat=None)
    decode = jax.jit(ref.decode_step)
    rng = np.random.default_rng(2)
    S = 35
    toks = rng.integers(0, model.cfg.vocab_size, size=(2, S + 2)).astype(np.int32)[:, :S + 1]
    pos = np.tile(np.arange(S + 1, dtype=np.int32), (2, 1))
    worst = {}
    print("key seed  step    logits  conv<block  ssd<block  conv>block  ssd>block")
    for key in (0, 1, 2):
        base = jax.tree.map(np.asarray, jax.jit(ref.init)(jax.random.key(key)))
        for seed in (0, 1, 2):
            tree = perturb(base, seed)
            params = params_from_numpy(model, tree, device="cpu")
            rp = jax.tree.map(jnp.asarray, tree)
            rc, oc = ref.init_cache(2, S + 1), model.init_cache(2, S + 1, device="cpu")
            for step, sl in (("prompt", slice(0, S)), ("token", slice(S, S + 1))):
                rl, rc = decode(rp, {"tokens": jnp.asarray(toks[:, sl]),
                                     "positions": jnp.asarray(pos[:, sl])}, rc)
                ol, oc = model.decode_step(params, {"tokens": torch.from_numpy(toks[:, sl]).long(),
                                                    "positions": torch.from_numpy(pos[:, sl]).long()}, oc)
                row = {"logits": _scaled(ol, rl)}
                every = model.cfg.attn_every      # layers below the first shared block
                for leaf in ("conv", "ssd"):
                    ours = getattr(oc["layers"]["mamba"], leaf).numpy()
                    theirs = np.asarray(getattr(rc["layers"]["mamba"], leaf))
                    scale = max(1.0, float(np.abs(theirs).max()))
                    diff = np.abs(ours - theirs)
                    row[f"{leaf}<block"] = float(diff[:every].max()) / scale
                    row[f"{leaf}>block"] = float(diff[every:].max()) / scale
                for k, v in row.items():
                    worst[k] = max(worst.get(k, 0.0), v)
                print(f"{key:>3} {seed:>4}  {step:<6} " + "  ".join(
                    f"{row[k]:.2e}".rjust(9) for k in ("logits", "conv<block", "ssd<block",
                                                        "conv>block", "ssd>block")))
    print("worst: " + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()))


def _scaled(ours, ref) -> float:
    ref = np.asarray(ref)
    return float(np.abs(ours.numpy() - ref).max()) / max(1.0, float(np.abs(ref).max()))


if __name__ == "__main__":
    torch.set_num_threads(1)
    flush_check()
    if "--flush-only" not in sys.argv:
        state_spread()
