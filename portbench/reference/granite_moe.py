"""The GraniteMoe reference (``GraniteMoeForCausalLM``; the keys of
``ibm-granite/granite-3.0-3b-a800m-base``'s ``config.json``): the shared
forward of ``model.py`` in plain float32, with the published model's four
multipliers where it applies them.

  x0 = embedding_multiplier * E[tok]
  a = softmax(q k^T * attention_multiplier, causal) v    (in place of 1 / sqrt(hd))
  x += residual_multiplier * attention(norm(x));  x += residual_multiplier * experts(norm(x))
  logits = head(norm(x)) / logits_scaling

One departure from the published model: the rotary is ``model.py``'s, over
interleaved (even, odd) channel pairs, where GraniteMoe rotates halves
(``rotate_half``).  So a configuration that names this reference lists
``"rotary": "interleaved"`` under ``departures`` (``arch.load`` refuses a
file that states no rotary, and ``"halves"`` here).

The router is the shared reference's: softmax, the top k by probability
(the lower expert first on ties), gates renormalised to sum to one, which
equals GraniteMoe's softmax over the top k router logits.  Every other
piece is ``model.py``'s, imported; the control (``precision="fp8"``) too.
With the four keys at their neutral values this is ``model.py`` bit for
bit.
"""
from __future__ import annotations

from typing import Dict

import torch

from portbench.arch import Arch
from portbench.reference import model
from portbench.reference.model import Forward, _norm, _Ops, attend, feed_forward


def neutral_keys(head_dim: int) -> Dict[str, float]:
    """The published keys this reference runs, each at the value under which
    it is the shared forward."""
    return {"embedding_multiplier": 1.0, "attention_multiplier": head_dim ** -0.5,
            "residual_multiplier": 1.0, "logits_scaling": 1.0}


def multipliers(a: Arch) -> Dict[str, float]:
    """The four multipliers of ``a``: the carried ones, the rest neutral."""
    return {k: a.key(k, v) for k, v in neutral_keys(a.head_dim).items()}


def embed(weights: Dict, a: Arch, tok: torch.Tensor) -> torch.Tensor:
    return model.embed(weights, a, tok) * multipliers(a)["embedding_multiplier"]


def block(ops: _Ops, a: Arch, lp: Dict, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    m = multipliers(a)
    r = m["residual_multiplier"]
    h = _norm(x, lp["ln1"], a.norm, a.norm_eps)
    x = x + attend(ops, a, lp["attn"], h, pos, scale=m["attention_multiplier"]) * r
    return x + feed_forward(ops, a, lp, _norm(x, lp["ln2"], a.norm, a.norm_eps)) * r


def final(ops: _Ops, a: Arch, final_ln: Dict, head: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return model.final(ops, a, final_ln, head, x) / multipliers(a)["logits_scaling"]


FORWARD = Forward(embed=embed, block=block, final=final)
logits = FORWARD.logits
