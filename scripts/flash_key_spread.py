#!/usr/bin/env python3
"""How far the head-width-128 LM's pallas prefill lies from float64, key by key (CPU).

    PYTHONPATH=src python scripts/flash_key_spread.py [--keys 8]

The model of ``tests/test_torch_flash.py::test_lm_pallas_at_head_width_128_matches_reference``:
``mistral_nemo_12b.smoke()`` at 2 layers, d 256, 4 query and 2 KV heads of
128, f32, ``synth_batch`` at seq 40 x batch 2; weights from the
reference's ``LM.init(jax.random.key(i))`` for i in 0..keys-1, bridged to
the port.  For each key it runs ``prefill_logits`` through

* the port's pallas path (the flash kernel's plain version on the CPU),
* the reference's pallas path (its Pallas kernel, interpret mode),
* the reference's naive path,

and holds each against a float64 oracle of the same forward: the port's
naive path run in float64 throughout (``Tensor.float`` made a no-op on
float64 tensors while it runs, as ``scripts/grad_precision.py`` does).
A fourth column runs the port's pallas path with only the flash kernel's
plain version lifted to float64 (inputs widened, output rounded back to
f32): what is left of the port's error then comes from the rest of the
forward, not from the attention op.
An error is max |logits - oracle| over max(1, max |oracle|).  It also
prints the port against the reference's pallas path (the test's measure,
held there to 2e-5 at key 0) and the reference's two paths against each
other.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.registry import get_config as ref_get_config
from repro.data.pipeline import DataConfig, synth_batch
from repro.models.transformer import LM as RefLM
from repro_torch.configs.registry import get_config
from repro_torch.kernels.flash_attention import ops as fl_ops
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.transformer import LM
from repro_torch.tree import flatten, unflatten

SHAPE = dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=128)
_FLOAT = torch.Tensor.float


@contextlib.contextmanager
def float64():
    """Run the port's f32 casts as no-ops on float64 tensors."""
    torch.Tensor.float = lambda self: self if self.dtype == torch.float64 else _FLOAT(self)
    try:
        yield
    finally:
        torch.Tensor.float = _FLOAT


@contextlib.contextmanager
def attention_in_float64():
    """The flash kernel's entry run in float64 on widened inputs, its
    output rounded back to the inputs' type."""
    flash = fl_ops.flash_attention

    def lifted(q, k, v, *args, **kw):
        with float64():
            return flash(q.double(), k.double(), v.double(), *args, **kw).to(q.dtype)
    fl_ops.flash_attention = lifted
    try:
        yield
    finally:
        fl_ops.flash_attention = flash


def port_logits(cfg, tree, batch, impl: str, dtype) -> np.ndarray:
    model = LM(cfg, attn_impl=impl)
    model.dtype = dtype
    flat, tdef = flatten(params_from_numpy(model, tree, device="cpu"))
    params = unflatten(tdef, [x.to(dtype) if x.is_floating_point() else x for x in flat])
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad(), float64() if dtype == torch.float64 else contextlib.nullcontext():
        out = model.prefill_logits(params, tb)
    return out.double().numpy()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--keys", type=int, default=8)
    args = ap.parse_args()
    ref_cfg = dataclasses.replace(ref_get_config("mistral_nemo_12b").smoke(), **SHAPE)
    cfg = dataclasses.replace(get_config("mistral_nemo_12b").smoke(), **SHAPE)
    batch = synth_batch(DataConfig(vocab_size=ref_cfg.vocab_size, seq_len=40, batch_per_shard=2),
                        0, 0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    print("errors over max(1, max |float64 oracle|)")
    print("| key | port pallas | ref pallas | ref naive | port, attention in f64 | port vs ref "
          "pallas | ref pallas vs naive |")
    print("| --- | --- | --- | --- | --- | --- | --- |")
    worst = {"port": 0.0, "ref": 0.0}
    past_pallas, past_both = [], []
    for key in range(args.keys):
        ref_params = RefLM(ref_cfg, attn_impl="naive", remat=None).init(jax.random.key(key))
        tree = jax.tree.map(np.asarray, ref_params)
        ref_pallas = np.asarray(RefLM(ref_cfg, attn_impl="pallas", remat=None).prefill_logits(
            ref_params, jb), np.float64)
        ref_naive = np.asarray(RefLM(ref_cfg, attn_impl="naive", remat=None).prefill_logits(
            ref_params, jb), np.float64)
        ours = port_logits(cfg, tree, batch, "pallas", torch.float32)
        with attention_in_float64():
            lifted = port_logits(cfg, tree, batch, "pallas", torch.float32)
        oracle = port_logits(cfg, tree, batch, "naive", torch.float64)
        scale = max(1.0, float(np.abs(oracle).max()))
        err = {name: float(np.abs(x - oracle).max()) / scale
               for name, x in (("port", ours), ("ref", ref_pallas), ("naive", ref_naive),
                               ("lifted", lifted))}
        pr = float(np.abs(ours - ref_pallas).max()) / scale
        rn = float(np.abs(ref_pallas - ref_naive).max()) / scale
        worst["port"], worst["ref"] = max(worst["port"], err["port"]), max(worst["ref"], err["ref"])
        if err["port"] > err["ref"]:
            past_pallas.append(key)
        if err["port"] > max(err["ref"], err["naive"]):
            past_both.append(key)
        print(f"| {key} | {err['port']:.2e} | {err['ref']:.2e} | {err['naive']:.2e} | "
              f"{err['lifted']:.2e} | {pr:.2e} | {rn:.2e} |", flush=True)
    print(f"worst over keys: port {worst['port']:.2e}, reference pallas {worst['ref']:.2e}")
    print(f"keys where the port is further from float64 than the reference's pallas path: "
          f"{past_pallas or 'none'}; than both of its paths: {past_both or 'none'}")


if __name__ == "__main__":
    main()
