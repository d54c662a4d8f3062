"""The plain reference of a training job's first steps: float32 with TF32
off, the forward pass of the configuration's reference (its ``FORWARD``:
the embedding, each layer, the final norm and head; ``model.py``'s where
the configuration names none, and a reference without one has no training
path), token cross
entropy averaged over every target, autograd, and AdamW as the job states
it (decoupled weight decay, clipping by the global norm, the linear warm-up
and cosine schedule), written out here.

It takes the harness's initial weights (the same tensors the program
started from, its own float32 copy) and the same batches, and returns what
the check compares: each step's loss, each leaf's norm of the first
gradient as AdamW takes it (after clipping), and each leaf's norm of the
change the steps made.  Memory stays small: a row of the batch at a time,
each layer recomputed in the backward (``torch.utils.checkpoint``), the
head and loss a block of positions at a time.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from portbench import reference
from portbench.arch import Arch
from portbench.reference.model import _layer, _Ops, exact_f32, head_of

LOSS_ROWS = 1024        # positions of one block of the head and loss


def leaves(tree: Dict, path: Tuple[str, ...] = ()) -> List[Tuple[str, torch.Tensor]]:
    """(dotted path, tensor) of every leaf, in the tree's order."""
    if isinstance(tree, torch.Tensor):
        return [(".".join(path), tree)]
    return [leaf for k, v in tree.items() for leaf in leaves(v, path + (k,))]


def _rebuild(tree: Dict, values: Dict[str, torch.Tensor], path=()) -> Dict:
    if isinstance(tree, torch.Tensor):
        return values[".".join(path)]
    return {k: _rebuild(v, values, path + (k,)) for k, v in tree.items()}


#: the head's product in float32 in the control too
F32 = _Ops("f32")


def _nll_sum(final, h, final_ln, head, targets, a):
    logits = final(F32, a, final_ln, head, h)
    return (torch.logsumexp(logits, -1) - logits.gather(-1, targets[:, None])[:, 0]).sum()


def row_loss_sum(fwd, ops: _Ops, a: Arch, w: Dict, tokens: torch.Tensor,
                 targets: torch.Tensor):
    """The summed token losses of one row (S,) of the batch, by the forward
    ``fwd`` (a ``model.Forward``)."""
    pos = torch.arange(tokens.numel(), device=tokens.device)
    x = fwd.embed(w, a, tokens)
    for li in range(a.n_layers):
        x = checkpoint(fwd.block, ops, a, _layer(w["layers"], li), x, pos, use_reentrant=False)
    head = head_of(w, a)
    total = 0.0
    for r in range(0, x.shape[0], LOSS_ROWS):
        sl = slice(r, r + LOSS_ROWS)
        total = total + checkpoint(_nll_sum, fwd.final, x[sl], w["final_ln"], head, targets[sl],
                                   a, use_reentrant=False)
    return total


def lr_at(opt: Dict, step: int) -> float:
    """The job's learning rate at ``step`` (1-based)."""
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    t = min(max((step - opt["warmup_steps"]) / max(opt["total_steps"] - opt["warmup_steps"], 1),
                0.0), 1.0)
    frac = opt["min_lr_frac"] + (1 - opt["min_lr_frac"]) * 0.5 * (1 + math.cos(math.pi * t))
    return opt["lr"] * warm * frac


def steps(weights: Dict, a: Arch, batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
          opt: Dict, *, precision: str = "f32") -> Dict:
    """Run len(batches) steps from ``weights``; batches are (tokens, targets),
    each (B, S) on the weights' device.  Returns {"loss": [...],
    "grad": {leaf: norm}, "change": {leaf: norm}}."""
    fwd = reference.forward(a.reference)
    ops = _Ops(precision)
    names = [n for n, _ in leaves(weights)]
    p0 = {n: t.detach().float() for n, t in leaves(weights)}
    p = {n: t.clone().requires_grad_(True) for n, t in p0.items()}
    m = {n: torch.zeros_like(t) for n, t in p0.items()}
    v = {n: torch.zeros_like(t) for n, t in p0.items()}
    out: Dict = {"loss": []}
    with exact_f32():
        for step, (tokens, targets) in enumerate(batches, start=1):
            w = _rebuild(weights, p)
            n_tok = tokens.numel()
            grads = {n: torch.zeros_like(t) for n, t in p0.items()}
            loss = 0.0
            for b in range(tokens.shape[0]):
                part = row_loss_sum(fwd, ops, a, w, tokens[b], targets[b]) / n_tok
                gs = torch.autograd.grad(part, [p[n] for n in names], allow_unused=True)
                for n, g in zip(names, gs):
                    if g is not None:
                        grads[n] += g
                loss += float(part.detach())
            out["loss"].append(loss)
            with torch.no_grad():
                gnorm = math.sqrt(sum(float((g * g).sum()) for g in grads.values()))
                scale = min(opt["clip_norm"] / (gnorm + 1e-9), 1.0)
                lr = lr_at(opt, step)
                b1c, b2c = 1 - opt["b1"] ** step, 1 - opt["b2"] ** step
                for n in names:
                    g = grads[n] * scale
                    m[n].mul_(opt["b1"]).add_(g, alpha=1 - opt["b1"])
                    v[n].mul_(opt["b2"]).add_(g * g, alpha=1 - opt["b2"])
                    delta = (m[n] / b1c) / (torch.sqrt(v[n] / b2c) + opt["eps"])
                    p[n].sub_(lr * (delta + opt["weight_decay"] * p[n]))
                if step == 1:
                    out["grad"] = {n: float(m[n].norm()) / (1 - opt["b1"]) for n in names}
            del grads
    with torch.no_grad():
        out["change"] = {n: float((p[n] - p0[n]).norm()) for n in names}
    return out
