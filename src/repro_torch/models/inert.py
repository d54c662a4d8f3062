"""Seeded values for the leaves the reference's init leaves inert.

The reference's init sets RWKV6's token-shift mixes (``mu_*``), its decay
base ``w0``, the decay LoRA's second factor ``w_lora_b`` and the bonus
``u`` to zero, and Mamba2's ``A_log`` and ``dt_bias`` to zero.  With random
weights drawn by that rule, token shift, the data-dependent decay and the
bonus never run, and every Mamba2 head decays alike.  ``perturb_inert``
sets those leaves to seeded values, one rule for every comparison that
needs them to run: mixes in [0, 1]; ``w0`` over [-6, 2], whose decays
-exp(w0) reach both ends of the [-1.8, 0] clip; ``w_lora_b`` and ``u``
small normals; ``A_log`` over [-2, 1]; ``dt_bias`` standard normal.

It works on numpy arrays in the reference's layout (``params["layers"]``
of ``bridge.params_to_numpy``, or of the reference's own tree), so the
same seed gives the same values on every device.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

__all__ = ["inert_leaves", "perturb_inert"]


def inert_leaves(family: str, layers: Dict) -> List[Tuple[str, str]]:
    """(group, name) of each leaf of ``layers`` the rule sets, in the order
    it draws them; empty for a family without such leaves."""
    if family == "ssm":
        mixes = [(g, n) for g in ("tm", "cm") for n in sorted(layers[g]) if n.startswith("mu_")]
        return mixes + [("tm", "w0"), ("tm", "w_lora_b"), ("tm", "u")]
    if family == "hybrid":
        return [("mamba", "A_log"), ("mamba", "dt_bias")]
    return []


def perturb_inert(family: str, layers: Dict, seed: int) -> Dict:
    """Replace, in ``layers`` (nested dicts of numpy arrays), each leaf of
    ``inert_leaves`` with a float32 array drawn from ``seed``; returns
    ``layers``."""
    rng = np.random.default_rng(seed)
    for group, name in inert_leaves(family, layers):
        shape = np.shape(layers[group][name])
        if name.startswith("mu_"):
            a = rng.uniform(0, 1, shape)
        elif name == "w0":
            a = rng.uniform(-6, 2, shape)
        elif name == "A_log":
            a = rng.uniform(-2, 1, shape)
        elif name == "dt_bias":
            a = rng.normal(size=shape)
        else:
            a = rng.normal(size=shape) * {"w_lora_b": 0.1, "u": 0.3}[name]
        layers[group][name] = a.astype(np.float32)
    return layers
