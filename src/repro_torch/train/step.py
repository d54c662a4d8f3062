"""The train / eval step builders (shared by the trainer and the launcher).

``build_train_step`` returns ``(params, opt_state, batch[, err_state]) ->
(params, opt_state[, err_state], metrics)``: the loss and its gradient with
respect to every param leaf by ``torch.autograd.grad`` (the functional form
of ``jax.value_and_grad``: nothing accumulates in ``.grad`` across steps),
then one AdamW update.  Gradient accumulation is a Python loop over batch
splits; gradient compression (int8 + error feedback) is optional and, as in
the reference, then takes and returns the error state.

Under a mesh (``dist.sharding.set_mesh``) the same step runs over DTensor
params and batches: each gradient is laid out as its param, AdamW is
elementwise, and the metrics are gathered to plain 0-d tensors.

A step is the span ``train.step``, over ``train.forward`` and
``train.backward`` (one each a micro-batch) and ``train.optimizer``
(AdamW, its norm and clip included), each with device time on a card
(:mod:`repro_torch.trace.spans`).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.dist.sharding import spmd
from repro_torch.optim import adamw as opt
from repro_torch.optim import compression as comp
from repro_torch.trace import spans
from repro_torch.tree import flatten, unflatten


def value_and_grad(loss_fn, params: Any, batch: Dict) -> Tuple[torch.Tensor, Any]:
    """(loss, grads) of ``loss_fn(params, batch)``; grads has params' tree.
    The spans ``train.forward`` (the loss) and ``train.backward`` (the
    gradients, rematerialisation's recompute included) carry device time."""
    flat, tdef = flatten(params)
    device = flat[0].device
    with torch.enable_grad():
        leaves = [p.detach().requires_grad_(True) for p in flat]
        with spans.span("train.forward", device=device):
            loss = loss_fn(unflatten(tdef, leaves), batch)
        with spans.span("train.backward", device=device):
            grads = torch.autograd.grad(loss, leaves)
            grads = [g.redistribute(p.device_mesh, p.placements) if isinstance(g, DTensor)
                     else g for p, g in zip(flat, grads)]
    return loss.detach(), unflatten(tdef, grads)


def build_train_step(
    model,
    ocfg: opt.AdamWConfig,
    *,
    accum_steps: int = 1,
    grad_compression: bool = False,
    donate: bool = False,
):
    """``donate=True`` updates the given params and optimizer state in place
    (``adamw.apply_updates``), as the reference's trainer donates them to
    its jitted step."""

    def loss_fn(params, batch):
        return model.train_loss(params, batch)

    def train_step(params, opt_state, batch, err_state=None):
        with spmd(), spans.span("train.step", device=opt_state.step.device):
            return step(params, opt_state, batch, err_state)

    def step(params, opt_state, batch, err_state):
        if accum_steps == 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            B = next(iter(batch.values())).shape[0]
            mb = B // accum_steps
            loss = torch.zeros((), dtype=torch.float32, device=opt_state.step.device)
            grads = None
            for i in range(accum_steps):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                l, g = value_and_grad(loss_fn, params, micro)
                loss = loss + l / accum_steps
                flat_g, tdef = flatten(g)
                if grads is None:
                    grads = [torch.zeros_like(x, dtype=torch.float32) for x in flat_g]
                grads = [a + b / accum_steps for a, b in zip(grads, flat_g)]
            grads = unflatten(tdef, grads)
        if grad_compression:
            grads, err_state = comp.compress_grads(grads, err_state)
        with spans.span("train.optimizer", device=opt_state.step.device):
            params, opt_state, metrics = opt.apply_updates(params, grads, opt_state, ocfg,
                                                           donate=donate)
        metrics["loss"] = loss
        metrics = {k: v.full_tensor() if isinstance(v, DTensor) else v
                   for k, v in metrics.items()}
        if grad_compression:
            return params, opt_state, err_state, metrics
        return params, opt_state, metrics

    return train_step


def build_eval_step(model):
    def eval_step(params, batch):
        with torch.no_grad():
            return model.train_loss(params, batch)

    return eval_step
