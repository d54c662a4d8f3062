"""Input builders for every (arch x shape) cell: the reference's batch layout.

``batch_shapes(cfg, shape)`` names each entry of a step function's
``batch`` with its shape and dtype; ``input_specs`` gives them as meta
tensors (no allocation, the counterpart of ``ShapeDtypeStruct``) and
``abstract_cache`` the decode cache the same way; ``make_batch`` builds a
batch from a numpy seed, the same arrays as the reference's ``make_batch``
bit for bit.  Modality frontends are stubs: [vlm] precomputed patch
embeddings spliced over the first positions, [audio] precomputed frame
embeddings.

``complete_batch`` is the port's own: it gives a trainer batch of
``data/pipeline.py:synth_batch`` what its config's train shape has and the
pipeline lacks (M-RoPE positions, patch and frame embeddings), so the vlm
and encdec families train on the pipeline's stream.  The reference feeds
them the bare pipeline batch and fails (ROADMAP.md, reference faults 7 and
8).  ``batch_shardings`` places a batch on a mesh: "batch" on dim 0, the
rest replicated.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, RunShape
from repro_torch.dist import sharding as shd

__all__ = ["N_PATCHES", "batch_shapes", "input_specs", "abstract_cache", "make_batch",
           "complete_batch", "batch_shardings"]

N_PATCHES = 256  # vlm stub: patch embeddings replace the first 256 positions


def _pos_shape(cfg: ModelConfig, B: int, S: int) -> Tuple[int, ...]:
    return (B, S, 3) if cfg.rope == "mrope" else (B, S)


def batch_shapes(cfg: ModelConfig, shape: RunShape) -> Dict[str, Any]:
    """Name -> (shape, dtype) for the step-function ``batch`` argument."""
    B = shape.global_batch
    S = 1 if shape.is_decode else shape.seq_len
    out: Dict[str, Any] = {
        "tokens": ((B, S), torch.int32),
        "positions": (_pos_shape(cfg, B, S), torch.int32),
    }
    if shape.mode == "train":
        out["targets"] = ((B, S), torch.int32)
        out["loss_mask"] = ((B, S), torch.float32)
    if cfg.frontend == "vision" and not shape.is_decode:
        out["patch_embeds"] = ((B, min(N_PATCHES, S), cfg.d_model), torch.bfloat16)
    if cfg.is_encdec and not shape.is_decode:
        out["enc_embeds"] = ((B, shape.seq_len, cfg.d_model), torch.bfloat16)
    return out


def input_specs(cfg: ModelConfig, shape: RunShape) -> Dict[str, torch.Tensor]:
    """Meta tensors of the batch's shapes and dtypes."""
    return {k: torch.empty(s, dtype=d, device="meta")
            for k, (s, d) in batch_shapes(cfg, shape).items()}


def abstract_cache(model, shape: RunShape):
    """The decode cache of one cell on the meta device (lengths are ints)."""
    B = shape.global_batch
    enc_len = shape.seq_len if model.cfg.is_encdec else 0
    return model.init_cache(B, shape.seq_len, enc_len=enc_len, device="meta")


def make_batch(
    cfg: ModelConfig, shape: RunShape, seed: int = 0, *, device="cuda"
) -> Dict[str, torch.Tensor]:
    """Concrete random batch on ``device``, drawn from
    ``np.random.default_rng(seed)`` in ``batch_shapes``' order.  The
    embeddings are drawn in float64 and rounded to bfloat16 through float32,
    as the reference's ``jnp.asarray`` does without 64-bit mode (the two
    roundings differ from one direct rounding where float32 lands on a
    bfloat16 tie)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for k, (s, d) in batch_shapes(cfg, shape).items():
        if k in ("tokens", "targets"):
            arr = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=s)).to(d)
        elif k == "positions":
            B, S = s[0], s[1]
            arr = torch.arange(S, dtype=d).expand(B, S)
            if len(s) == 3:
                arr = arr[..., None].expand(B, S, 3)
            arr = arr.contiguous()
        elif k == "loss_mask":
            arr = torch.ones(s, dtype=d)
        else:  # frontend embeddings
            arr = torch.from_numpy((rng.normal(size=s) * 0.02).astype(np.float32)).to(d)
        out[k] = arr.to(device)
    return out


def complete_batch(cfg: ModelConfig, data_seed: int, batch: Dict[str, np.ndarray],
                   step: int, dp_rank: int) -> Dict[str, np.ndarray]:
    """A trainer batch (``synth_batch``'s numpy arrays) completed for
    ``cfg``'s train shape: (B, S, 3) positions, t = h = w = index, for an
    ``mrope`` config; ``patch_embeds`` (B, min(256, S), d) for a vision
    frontend; ``enc_embeds`` (B, S, d) for encdec.  The embeddings are
    float32 normals x 0.02 (the model casts them to its dtype) from a
    generator seeded by (``data_seed``, ``step``, ``dp_rank``), so a
    resumed run sees the same batch.  Other configs get ``batch`` itself."""
    B, S = batch["tokens"].shape
    embeds = []
    if cfg.frontend == "vision":
        embeds.append(("patch_embeds", (B, min(N_PATCHES, S), cfg.d_model)))
    if cfg.is_encdec:
        embeds.append(("enc_embeds", (B, S, cfg.d_model)))
    if cfg.rope != "mrope" and not embeds:
        return batch
    out = dict(batch)
    if cfg.rope == "mrope":
        out["positions"] = np.repeat(batch["positions"][..., None], 3, axis=-1)
    if embeds:
        rng = np.random.default_rng(np.random.SeedSequence([data_seed, step, dp_rank, 1]))
        for k, s in embeds:
            out[k] = (rng.normal(size=s) * 0.02).astype(np.float32)
    return out


def batch_shardings(batch: Dict[str, torch.Tensor], mesh) -> Dict[str, shd.Sharding]:
    """"batch" on dim 0 of every entry, the rest replicated (the reference's
    ``launch/dryrun.py:_batch_shardings``)."""
    axes = {k: ("batch",) + (None,) * (v.dim() - 1) for k, v in batch.items()}
    return shd.axes_to_shardings(axes, batch, mesh)
