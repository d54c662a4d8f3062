#!/usr/bin/env python3
"""How the reference's init rule behaves in depth, in both packages (CPU, f32).

The init draws every matmul weight with std ``1/sqrt(shape[-2])``; for the
attention projections ``wq/wk/wv (d, H, hd)`` that is ``1/sqrt(H)`` and for
``wo (H, hd, d)`` ``1/sqrt(hd)``, not one over their true fan-in.  This
script takes the stablelm_1_6b family at a narrow width (d 256, 4 heads of
64, d_ff 704, vocab 4096) and, for 4, 12 and 24 layers, prints the global
gradient norm and loss of one batch (seq 128 x 2) and how far the prefill
logits of two plain attention paths (naive and chunked, which differ only
in float rounding) lie apart, for the reference and for the port on the
reference's weights::

    PYTHONPATH=src python scripts/init_depth_spread.py
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.registry import get_config as ref_get_config
from repro.data.pipeline import DataConfig, synth_batch
from repro.models.transformer import LM as RefLM
from repro.optim.adamw import global_norm as ref_global_norm
from repro_torch.configs.registry import get_config
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.transformer import LM
from repro_torch.optim.adamw import global_norm
from repro_torch.train.step import value_and_grad

NARROW = dict(d_model=256, n_heads=4, n_kv_heads=4, head_dim=64, d_ff=704,
              vocab_size=4096, dtype="float32", kv_cache_dtype="float32")


def main() -> None:
    batch = synth_batch(DataConfig(vocab_size=4096, seq_len=128, batch_per_shard=2), 0, 0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    print("layers  package     grad norm      loss  naive-vs-chunked logits (of scale)")
    for depth in (4, 12, 24):
        ref_cfg = dataclasses.replace(ref_get_config("stablelm_1_6b"), n_layers=depth, **NARROW)
        cfg = dataclasses.replace(get_config("stablelm_1_6b"), n_layers=depth, **NARROW)
        ref_params = RefLM(ref_cfg, remat=None).init(jax.random.key(0))
        tree = jax.tree.map(np.asarray, ref_params)
        ref_logits, logits = {}, {}
        for impl in ("naive", "chunked"):
            ref_model = RefLM(ref_cfg, attn_impl=impl, remat=None)
            ref_logits[impl] = np.asarray(ref_model.prefill_logits(ref_params, jb))
            model = LM(cfg, attn_impl=impl, remat=None)
            with torch.no_grad():
                logits[impl] = model.prefill_logits(params_from_numpy(model, tree, device="cpu"), tb).numpy()
        ref_loss, ref_grads = jax.value_and_grad(RefLM(ref_cfg, attn_impl="chunked", remat=None).train_loss)(
            ref_params, jb)
        model = LM(cfg, attn_impl="chunked", remat=None)
        loss, grads = value_and_grad(model.train_loss, params_from_numpy(model, tree, device="cpu"), tb)
        for name, gn, l, z in (("reference", float(ref_global_norm(ref_grads)), float(ref_loss), ref_logits),
                               ("port", float(global_norm(grads)), float(loss), logits)):
            spread = float(np.abs(z["naive"] - z["chunked"]).max())
            print(f"{depth:>6}  {name:<10} {gn:>10.3e} {l:>9.4f}  {spread:.3e} "
                  f"({float(np.abs(z['chunked']).max()):.3f})")


if __name__ == "__main__":
    main()
