#!/usr/bin/env python3
"""How far the f32 gradients of the reference and the port lie from a
float64 backward (CPU).

Setup: ``stablelm_1_6b.smoke()``, the reference's init
(``LM.init(jax.random.key(0))``), naive attention, ``synth_batch`` at
seq 48 x batch 4.  The oracle is the port run in float64 throughout
(``Tensor.float`` made a no-op on float64 tensors while it runs).  An error
is the largest, over the parameter leaves, of max |g - g64| / max |g64|.

For each of ``--batches`` batches (data steps 1, 2, ...) it prints the
reference's error, the port's, and the port's with ``project`` (the q/k/v
projection) lifted to float64 (its inputs widened, its outputs rounded back
to f32).  Then, on batch 1, it feeds each layer's attention block the
float64 run's own inputs and output cotangent, rounded to f32, in both
packages, and prints each leaf's error against the block's float64
backward::

    PYTHONPATH=src python scripts/grad_precision.py [--batches 6]
"""
from __future__ import annotations

import argparse
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.registry import get_config as ref_get_config
from repro.data.pipeline import DataConfig, synth_batch
from repro.models import attention as RA
from repro.models.transformer import LM as RefLM
from repro_torch.configs.registry import get_config
from repro_torch.models import attention as PA
from repro_torch.models import transformer as PT
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.transformer import LM
from repro_torch.train.step import value_and_grad
from repro_torch.tree import flatten, unflatten

_FLOAT = torch.Tensor.float


@contextlib.contextmanager
def float64():
    """Run the port's f32 casts as no-ops on float64 tensors."""
    torch.Tensor.float = lambda self: self if self.dtype == torch.float64 else _FLOAT(self)
    try:
        yield
    finally:
        torch.Tensor.float = _FLOAT


def lifted(fn):
    """``fn`` run in float64 on widened inputs, its outputs rounded to f32."""
    def up(x):
        if isinstance(x, dict):
            return {k: up(v) for k, v in x.items()}
        return x.double() if torch.is_tensor(x) and x.is_floating_point() else x

    @functools.wraps(fn)
    def run(*args, **kw):
        with float64():
            out = fn(*[up(a) for a in args], **{k: up(v) for k, v in kw.items()})
        return out.float() if out.dtype == torch.float64 else out
    return run


def rel_err(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def max_leaf_err(got, want) -> float:
    return max(rel_err(g, w) for g, w in zip(got, want) if np.abs(w).max() > 0)


class Setup:
    def __init__(self):
        self.ref_cfg = ref_get_config("stablelm_1_6b").smoke()
        self.cfg = get_config("stablelm_1_6b").smoke()
        self.ref_model = RefLM(self.ref_cfg, attn_impl="naive", remat=None)
        self.ref_params = self.ref_model.init(jax.random.key(0))
        self.tree = jax.tree.map(np.asarray, self.ref_params)

    def batch(self, step: int):
        return synth_batch(DataConfig(vocab_size=self.ref_cfg.vocab_size, seq_len=48,
                                      batch_per_shard=4), step, 0)

    def reference(self, batch):
        _, grads = jax.value_and_grad(self.ref_model.train_loss)(
            self.ref_params, {k: jnp.asarray(v) for k, v in batch.items()})
        return [np.asarray(g, np.float64) for g in flatten(
            jax.tree.map(lambda a: torch.from_numpy(np.array(a)), grads))[0]]

    def port(self, batch, dtype, lift_project: bool = False):
        model = LM(self.cfg, attn_impl="naive", remat=None)
        model.dtype = dtype
        flat, tdef = flatten(params_from_numpy(model, self.tree, device="cpu"))
        params = unflatten(tdef, [x.to(dtype) for x in flat])
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        project = PA.project
        if lift_project:
            PA.project = lifted(project)
        try:
            with float64() if dtype == torch.float64 else contextlib.nullcontext():
                _, grads = value_and_grad(model.train_loss, params, tb)
        finally:
            PA.project = project
        return [g.double().numpy() for g in flatten(grads)[0]]


def block_errors(s: Setup, batch) -> list:
    """Each layer's attention block on the float64 run's own inputs and
    output cotangent: {leaf: (reference error, port error)}."""
    captured, attention = [], PT.apply_attention

    def capture(p, cfg, x, pos, **kw):
        y, cache = attention(p, cfg, x, pos, **kw)
        rec = {"p": {k: v.detach().clone() for k, v in p.items()}, "x": x.detach().clone(),
               "pos": pos.clone()}
        y.register_hook(lambda g: rec.__setitem__("g", g.detach().clone()))
        captured.append(rec)
        return y, cache

    PT.apply_attention = capture
    try:
        s.port(batch, torch.float64)
    finally:
        PT.apply_attention = attention
    rows = []
    for rec in captured:
        def port_grads(dtype):
            p = {k: v.clone().float().to(dtype).requires_grad_(True) for k, v in rec["p"].items()}
            x = rec["x"].float().to(dtype).requires_grad_(True)
            with float64() if dtype == torch.float64 else contextlib.nullcontext():
                y, _ = attention(p, s.cfg, x, rec["pos"], impl="naive")
                y.backward(rec["g"].float().to(dtype))
            out = {k: v.grad.double().numpy() for k, v in p.items() if v.grad is not None}
            return {**out, "x": x.grad.double().numpy()}

        want, got = port_grads(torch.float64), port_grads(torch.float32)
        fn = lambda p, x: RA.apply_attention(p, s.ref_cfg, x, jnp.asarray(rec["pos"].numpy()),  # noqa: E731
                                             impl="naive")[0]
        _, vjp = jax.vjp(fn, {k: jnp.asarray(v.float().numpy()) for k, v in rec["p"].items()},
                         jnp.asarray(rec["x"].float().numpy()))
        gp, gx = vjp(jnp.asarray(rec["g"].float().numpy()))
        ref = {**{k: np.asarray(v, np.float64) for k, v in gp.items()}, "x": np.asarray(gx, np.float64)}
        rows.append({k: (rel_err(ref[k], want[k]), rel_err(got[k], want[k])) for k in want})
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, default=6)
    args = ap.parse_args()
    s = Setup()
    print("batch  reference   port        port, project in f64   (max over leaves, of max |g64|)")
    for step in range(1, args.batches + 1):
        b = s.batch(step)
        oracle = s.port(b, torch.float64)
        errs = [max_leaf_err(g, oracle) for g in (
            s.reference(b), s.port(b, torch.float32), s.port(b, torch.float32, lift_project=True))]
        print(f"{step:>5}  " + "  ".join(f"{e:.3e}" for e in errs), flush=True)
    print("\nbatch 1, each layer's attention block on the float64 run's own inputs and cotangent")
    for layer, row in enumerate(block_errors(s, s.batch(1))):
        print(f"layer {layer}: " + "  ".join(f"{k} ref {r:.1e} port {p:.1e}" for k, (r, p) in row.items()))


if __name__ == "__main__":
    main()
