"""The harness's own weights: drawn on the device from the run's seed, in the
type they are served in, in one draw.

The tree has the program's layout (its parameter definitions give each
leaf's path, shape, whether it stays float32 and whether it starts at one
or zero), and the harness fills it by the configuration's rule: every
matrix and table N(0, initializer_range), one ``normal_`` call over a flat
buffer that the leaves are views of; norm scales one, biases zero.  Rows of
the embedding table (and columns of an untied head) past the real
vocabulary are zero, so no padded id is ever the argmax.  The same tensors
go to the program and, read only, to the reference.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch


def _walk(defs: Any, path: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], Any]]:
    if isinstance(defs, dict):
        return [leaf for k, v in defs.items() for leaf in _walk(v, path + (k,))]
    return [(path, defs)]


def _put(tree: Dict, path: Tuple[str, ...], value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def make(defs: Any, *, std: float, dtype: torch.dtype, vocab_size: int, seed: int,
         device) -> Dict:
    """The params tree for ``defs`` (a nested dict of leaves with ``shape``,
    ``init`` and ``f32``), drawn from ``seed`` on ``device``."""
    leaves = _walk(defs)
    drawn = [(p, d) for p, d in leaves if d.init not in ("ones", "zeros")]
    total = sum(int(torch.Size(d.shape).numel()) for _, d in drawn)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.empty(total, dtype=dtype, device=device).normal_(0.0, std, generator=gen)
    tree: Dict = {}
    off = 0
    for path, d in leaves:
        if d.init in ("ones", "zeros"):
            fill = torch.ones if d.init == "ones" else torch.zeros
            leaf = fill(d.shape, dtype=torch.float32 if d.f32 else dtype, device=device)
        else:
            n = int(torch.Size(d.shape).numel())
            leaf = flat[off:off + n].view(d.shape)
            off += n
            if d.f32:
                leaf = leaf.float()
        _put(tree, path, leaf)
    emb = tree["embed"]
    emb["tok"][vocab_size:].zero_()
    if "head" in emb:
        emb["head"][:, vocab_size:].zero_()
    return tree
