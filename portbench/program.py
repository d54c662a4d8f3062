"""What the harness takes from the program (``repro_torch``, under the
checkout's ``src/``): its config type, its model and its serving engine.
Nothing here computes a result of its own.

The program's config is built from an :class:`~portbench.arch.Arch`: its
core fields, and each published key the ``Arch`` carries (``arch.py``)
through the ``ModelConfig`` field of the same name.  A carried key that has
no such field and is not at its neutral value is refused: the program does
not run it, and no cell may run it as a silent departure."""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

from portbench import reference
from portbench.arch import Arch, is_neutral

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"


def import_port():
    """``repro_torch``, from the checkout's ``src/`` (raises where it is absent)."""
    if not (SRC / "repro_torch").is_dir():
        raise ImportError(f"the program is not in this checkout: no {SRC / 'repro_torch'}")
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    import repro_torch
    return repro_torch


def port_config(a: Arch):
    """The program's ``ModelConfig`` for ``a``.  The program's norms take an
    epsilon of 1e-6 and no other: a configuration that states another
    raises.  Each carried key goes to the ``ModelConfig`` field of its name;
    one without a field raises unless it is at its neutral value."""
    import_port()
    from repro_torch.configs.base import ModelConfig
    if abs(a.norm_eps - 1e-6) > 1e-12:
        raise ValueError(f"{a.name}: the program's norms take eps 1e-6, not {a.norm_eps}")
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    neutral = reference.neutral_keys(a.reference, a.head_dim)
    carried = {}
    for key, value in a.keys:
        if key in fields:
            carried[key] = value
        elif not is_neutral(value, neutral[key]):
            raise ValueError(f"{a.name}: {key} = {value!r} is not run by the program "
                             f"(its ModelConfig has no field {key!r})")
    return ModelConfig(
        name=a.name, family=a.family, n_layers=a.n_layers, d_model=a.d_model,
        n_heads=a.n_heads, n_kv_heads=a.n_kv_heads, d_ff=a.d_ff, vocab_size=a.vocab_size,
        head_dim=a.head_dim, rope="rope", rope_theta=a.rope_theta, n_experts=a.n_experts,
        experts_per_tok=a.experts_per_tok, moe_capacity_factor=a.capacity_factor,
        activation="swiglu", norm=a.norm, tie_embeddings=a.tie_embeddings, dtype=a.dtype,
        kv_cache_dtype=a.dtype, **carried,
    )


def model(a: Arch, **kwargs):
    """The program's model object for ``a`` (``kwargs``: ``LM``'s
    ``attn_impl`` and ``remat``)."""
    import_port()
    from repro_torch.models.transformer import LM
    return LM(port_config(a), **kwargs)
