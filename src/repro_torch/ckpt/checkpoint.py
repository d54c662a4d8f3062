"""Atomic, resumable checkpoints, one ``.npy`` file per tree leaf, in the
reference's on-disk layout::

    <dir>/step_000123/
        manifest.json      # tree description, shapes, dtypes, "complete"
        leaf_00000.npy ... # one file per leaf, in JAX's flatten order

Protocol (the reference's):

* **atomic** — written to ``step_X.tmp`` then renamed; the manifest's
  ``complete: true`` flag is written last, so a crash mid-write can never be
  mistaken for a valid checkpoint.
* **resume** — ``latest_step`` scans for the highest complete step.
* **GC** — ``keep`` most recent checkpoints survive.

Leaves are saved whole from whatever device they live on (a DTensor is
gathered first, and only rank 0 of its process group writes) and restored
onto the device and dtype of the matching leaf of ``like``, then, given
``shardings``, distributed by them.  numpy has no
bfloat16 without ``ml_dtypes``, so a bf16 leaf is stored as its uint16 bits
with ``"bfloat16"`` in the manifest; checkpoints of float32 (and integer)
trees read the same in this package and in the reference.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.tree import flatten, leaves as tree_leaves, unflatten


def _to_numpy(leaf: torch.Tensor):
    """(array to save, dtype name for the manifest)."""
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def save(path: str, step: int, tree: Any, keep: int = 3) -> str:
    """Save a tree of tensors; returns the final directory.  With DTensor
    leaves every rank must call it (each leaf is gathered in turn); rank 0
    writes."""
    final = os.path.join(path, f"step_{step:08d}")
    tmp = final + ".tmp"
    leaves, treedef = flatten(tree)
    sharded = any(isinstance(leaf, DTensor) for leaf in leaves)
    writer = not sharded or dist.get_rank() == 0
    if writer:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)

    meta = {
        "step": step,
        "complete": False,
        "n_leaves": len(leaves),
        "treedef": repr(treedef),
        "leaves": [],
    }
    for i, leaf in enumerate(leaves):
        arr, dtype = _to_numpy(leaf)
        if writer:
            np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr)
        meta["leaves"].append({"shape": list(arr.shape), "dtype": dtype})
    if writer:
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(meta, f)
        # completeness flag last, then atomic rename
        meta["complete"] = True
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _gc(path, keep)
    if sharded:
        dist.barrier()
    return final


def _gc(path: str, keep: int) -> None:
    steps = sorted(
        d for d in os.listdir(path)
        if d.startswith("step_") and not d.endswith(".tmp")
    )
    for d in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(path, d))


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    best = None
    for d in os.listdir(path):
        if not d.startswith("step_") or d.endswith(".tmp"):
            continue
        mf = os.path.join(path, d, "manifest.json")
        try:
            with open(mf) as f:
                meta = json.load(f)
            if meta.get("complete"):
                best = max(best or -1, meta["step"])
        except (OSError, json.JSONDecodeError):
            continue
    return best


def _sharding_leaves(like: Any, shardings: Any) -> list:
    """One sharding (or None) per leaf of ``like``, in its flatten order."""
    if shardings is None:
        return [None] * len(tree_leaves(like))
    if isinstance(like, dict):
        if set(like) != set(shardings):
            raise ValueError(f"shardings keys {sorted(shardings)} != {sorted(like)}")
        return [s for k in sorted(like) for s in _sharding_leaves(like[k], shardings[k])]
    if isinstance(like, (tuple, list)):
        if len(like) != len(shardings):
            raise ValueError(f"{len(shardings)} shardings for {len(like)} subtrees")
        return [s for x, sh in zip(like, shardings) for s in _sharding_leaves(x, sh)]
    return [shardings]


def restore(path: str, step: int, like: Any, shardings: Any = None) -> Any:
    """Restore into the structure of ``like`` (a tree of tensors): each leaf
    takes the device and dtype of the matching leaf of ``like`` and, where
    ``shardings`` (a tree of ``dist.sharding.Sharding`` shaped like
    ``like``, ``None`` for a subtree left whole) is given, is distributed
    by its sharding."""
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        meta = json.load(f)
    if not meta["complete"]:
        raise ValueError(f"checkpoint {d} incomplete")
    leaves, treedef = flatten(like)
    if len(leaves) != meta["n_leaves"]:
        raise ValueError(f"leaf count mismatch: have {len(leaves)}, ckpt {meta['n_leaves']}")
    shard_leaves = _sharding_leaves(like, shardings)
    out = []
    for i, (ref, info, sh) in enumerate(zip(leaves, meta["leaves"], shard_leaves)):
        arr = np.load(os.path.join(d, f"leaf_{i:05d}.npy"))
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"leaf {i}: shape {arr.shape} != {tuple(ref.shape)}")
        if info["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        t = t.to(device=ref.device, dtype=ref.dtype)
        out.append(t if sh is None else distribute_tensor(t, sh.mesh, sh.placements))
    return unflatten(treedef, out)
