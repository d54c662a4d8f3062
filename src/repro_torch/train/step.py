"""The train / eval step builders (shared by the trainer and the launcher).

``build_train_step`` returns ``(params, opt_state, batch[, err_state]) ->
(params, opt_state[, err_state], metrics)``: the loss and its gradient with
respect to every param leaf by ``torch.autograd.grad`` (the functional form
of ``jax.value_and_grad``: nothing accumulates in ``.grad`` across steps),
then one AdamW update.  Gradient accumulation is a Python loop over batch
splits; gradient compression (int8 + error feedback) is optional and, as in
the reference, then takes and returns the error state.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.optim import adamw as opt
from repro_torch.optim import compression as comp
from repro_torch.tree import flatten, unflatten


def value_and_grad(loss_fn, params: Any, batch: Dict) -> Tuple[torch.Tensor, Any]:
    """(loss, grads) of ``loss_fn(params, batch)``; grads has params' tree."""
    flat, tdef = flatten(params)
    with torch.enable_grad():
        leaves = [p.detach().requires_grad_(True) for p in flat]
        loss = loss_fn(unflatten(tdef, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), unflatten(tdef, list(grads))


def build_train_step(
    model,
    ocfg: opt.AdamWConfig,
    *,
    accum_steps: int = 1,
    grad_compression: bool = False,
):
    def loss_fn(params, batch):
        return model.train_loss(params, batch)

    def train_step(params, opt_state, batch, err_state=None):
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
                    grads = [torch.zeros(x.shape, dtype=torch.float32, device=x.device)
                             for x in flat_g]
                grads = [a + b / accum_steps for a, b in zip(grads, flat_g)]
            grads = unflatten(tdef, grads)
        if grad_compression:
            grads, err_state = comp.compress_grads(grads, err_state)
        params, opt_state, metrics = opt.apply_updates(params, grads, opt_state, ocfg)
        metrics["loss"] = loss
        if grad_compression:
            return params, opt_state, err_state, metrics
        return params, opt_state, metrics

    return train_step


def build_eval_step(model):
    def eval_step(params, batch):
        with torch.no_grad():
            return model.train_loss(params, batch)

    return eval_step
