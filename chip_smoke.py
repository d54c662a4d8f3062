#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root (it puts ``src`` on ``sys.path`` itself).  It
builds the hand-written kernels from ``src/repro_torch/csrc`` into
``build/kernels/``, holds each against its plain PyTorch version on the
card, and drives the port's main paths with the launch counts zeroed just
before each and read just after:

* the bitmap-index query of ``examples/torch_pud_bitwise.py`` at 2**34 rows
  (2 GiB bitplanes) through the ``bulk_op`` kernel, held bit-exactly against
  its plain version;
* the full-width stablelm_1_6b (random weights from a seeded generator)
  served through ``ServeEngine`` with a fork part-way three times: eagerly
  (``jit=False``), through the decode step's CUDA graphs, and through the
  graphs with watermark maintenance, whose compaction passes move KV pages
  through the block-copy kernel; the generated ids must be equal across the
  three, and one graphed step at batch 8 bit-equal to eager;
* granite_34b at its full width (MQA: 48 query heads on one KV head of 128)
  and 8 of its 88 layers, served eagerly and through the CUDA graphs with
  equal ids: the paged kernel at a group of 48;
* granite_moe_3b_a800m at its full width and depth (32 layers of 40
  experts of d_ff 512, top-8) served eagerly and through the CUDA graphs
  with a fork, ids equal and one graphed step bit-equal: the MoE layer
  (routing, capacity buffer, expert products) on the serving main path,
  the paged kernel at a group of 3;
* qwen2_vl_72b at its full width (GQA 64/8 of 128, d_ff 29568, vocab
  152064, M-RoPE) and 16 of its 80 layers, served eagerly and through the
  CUDA graphs with a fork, ids equal and one graphed step bit-equal, every
  position (B, S, 3): the paged kernel at a group of 8 x 128; then
  evaluated and prefilled at 4 x 2048 tokens with 256 patch embeddings
  spliced in, through the flash kernel's ``wgmma`` path at 64 query heads
  over 8, held against the chunked path;
* seamless_m4t_medium unreduced (12 encoder and 12 decoder layers, d
  1024, 16 heads of 64): evaluated and prefilled at 4 x 2048 tokens over
  2048 encoder frames through the flash kernel's ``wgmma`` path (the
  bidirectional encoder, the causal decoder and its cross-attention: 36
  launches a forward) against the chunked path; decoded over 8 x 1024
  seeded frames, a 16-token prompt and 64 greedy steps on the split cache,
  the cross-attention of each step through the kernel at one query against
  the 1024 frames, held against ``prefill_logits`` at one decoder layer;
  and trained 5 steps (chunked attention, full remat);
* the full-width stablelm_1_6b trained for 20 steps by
  ``repro_torch.launch.train --full`` (chunked attention, full remat,
  AdamW, checkpointed), then evaluated and prefilled at 4 x 2048 tokens
  through the flash-attention kernel (``attn_impl="pallas"``), held against
  the chunked path on the same weights, in bf16 and then cast to f32 (the
  kernel's ``tf32x3`` path);
* distribution on a one-rank NCCL process group and a (1, 1) ("data",
  "model") mesh (phase ``[dist]``): the unreduced granite_moe_1b_a400m's
  MoE layer through its sharded path, and one train step with its params,
  moments and batch as DTensors, each against the same without the mesh;
  ``compressed_psum`` over NCCL;
* ``launch.train``'s trainer over the completed pipeline batches (phase
  ``[train-families]``): seamless_m4t_medium unreduced and qwen2_vl_72b at
  its full width cut to 2 of 80 layers, 5 steps each, then one more step
  split into forward, backward and AdamW with CUDA events and the memory
  after each;
* the full-width mistral_nemo_12b (GQA 32/8, head width 128; random
  weights from a seeded generator) evaluated and prefilled the same way,
  every flash launch on the kernel's ``wgmma`` path at D = 128;
* the full-width rwkv6_7b and zamba2_7b (random weights from a seeded
  generator, the leaves the reference's init leaves zero set to seeded
  nonzero values) served on their state path: ``decode_step`` over 8
  prompts of 1024 tokens through the decay-attention kernel, 32 greedy
  one-token steps (rwkv6's also as a CUDA graph from the same prompt cache,
  with equal ids), and ``prefill_logits`` at 4 x 2048, every launch on its
  family's tensor-core path (``scalar_tc`` for zamba2, ``vector_tc`` for
  rwkv6); the first layer held against the plain chunked math on both
  inputs, and the first layers' logits within the spread of the sequential
  oracle; then the same seeded weights cast to f32, ``prefill_logits`` at
  4 x 2048 through the kernel's f32 tensor-core paths (``vector_tc_f32``,
  ``scalar_tc_f32``) against the plain chunked math.

Phase ``[roofline]`` runs the compile-only launchers: the dry-run of three
production cells (stablelm_1_6b train and decode, granite_moe_1b_a400m
train) on fake 256-rank process groups over meta tensors, then one cell one
card holds, the full-width stablelm_1_6b's train step at 8 x 128,
predicted by the dry-run's recorder and run on the card (flops equal
``FlopCounterMode``'s, the peak within 2x, the measured share of the
H100's peak), and the roofline report's rows over its records.

It also runs the PUD host model (the quickstart's allocator table and the
paper's Figure 2, modelled DRAM times) and the GEMV offload model
(``trace/gemv.py``: the full-width stablelm_1_6b layer 0 placed with the
four allocators, its partitioned products on the card bit-equal to whole
ones; the trace and chaos runners' smoke records on the card equal to the
CPU's; the kernel-bench rows), holds the card's generated ids,
training losses and f32 flash forwards against the CPU at smoke size, and
times each kernel beside its bound.  Any failed check raises, so the script exits non-zero without
its last line; that line is ``{"ok": true, "device": {...}}``.  Without a
CUDA device it exits non-zero at once.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.kv_pool import KVPoolConfig  # noqa: E402
from repro_torch.configs.base import RunShape  # noqa: E402
from repro_torch.data.pipeline import DataConfig, synth_batch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decay_attention import ops as dc_ops  # noqa: E402
from repro_torch.kernels.decay_attention.ref import (  # noqa: E402
    CHUNK,
    chunked_decay_ref,
    decay_attention_ref,
)
from repro_torch.kernels.flash_attention import ops as fl_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa_ops  # noqa: E402
from repro_torch.kernels.paged_attention.ref import paged_attention_ref  # noqa: E402
from repro_torch.kernels.pud_bulk import ops as bc_ops  # noqa: E402
from repro_torch.kernels.pud_bulk.ref import block_copy_ref, bulk_op_ref  # noqa: E402
from repro_torch.models.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.models import inert  # noqa: E402
from repro_torch.models import mamba2 as M2  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import rwkv6 as R6  # noqa: E402
from repro_torch.models import layers as model_layers  # noqa: E402
from repro_torch.models.layers import pad_vocab  # noqa: E402
from repro_torch.models.params import count_params, spec_tree  # noqa: E402
from repro_torch.models.transformer import LM, layer_params  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.inputs import batch_shardings, complete_batch, make_batch  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, apply_updates, init_opt_state  # noqa: E402
from repro_torch.robustness import check_kv_pool  # noqa: E402
from repro_torch.graphs import decode_step_jit  # noqa: E402
from repro_torch.serve.engine import MaintenanceConfig, Request, ServeEngine  # noqa: E402
from repro_torch.serve.paged_runner import paged_decode_step, paged_decode_step_jit  # noqa: E402
from repro_torch.train.step import build_eval_step, build_train_step, value_and_grad  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from repro_torch.tree import flatten, leaves, tree_map, unflatten  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores
BF16_TC_FLOPS = 989e12         # H100 SXM bf16 tensor cores, dense
TF32_TC_FLOPS = 495e12         # H100 SXM TF32 tensor cores, dense
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # the reference's own tolerances
BF16_ULP = 2.0 ** -7           # bf16 cases also: within one ulp of the plain output
PAGED_LSE_TOL = 2e-5           # paged attention's LSE, of max(1, |lse|)
SOURCES = {
    "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention/kernel.py:74"),
    "block_copy": ("src/repro_torch/csrc/block_copy.cu",
                   "src/repro/kernels/pud_bulk/kernel.py:125"),
    "bulk_op": ("src/repro_torch/csrc/bulk_op.cu",
                "src/repro/kernels/pud_bulk/kernel.py:84"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:87"),
    "decay_attention": ("src/repro_torch/csrc/decay_attention.cu",
                        "src/repro/kernels/decay_attention/kernel.py:79"),
    # the same kernel's f32 paths, each a row of its own
    "decay_attention:vector_tc_f32": ("src/repro_torch/csrc/decay_attention.cu",
                                      "src/repro/kernels/decay_attention/kernel.py:79"),
    "decay_attention:scalar_tc_f32": ("src/repro_torch/csrc/decay_attention.cu",
                                      "src/repro/kernels/decay_attention/kernel.py:79"),
    # the paged kernel's grouped-query path (decode_attention.cuh), timed at
    # granite_moe_3b_a800m's group
    "paged_attention:group": ("src/repro_torch/csrc/paged_attention.cu",
                              "src/repro/kernels/paged_attention/kernel.py:74"),
}
# the kernels line's time and error rows of the path entries
PATH_ROWS = {"paged_attention:group": ("paged_attention:moe", "moe-bf16")}
# the full-width serving shapes (stablelm_1_6b, bf16)
N_LAYERS, HEADS, HEAD_DIM, BLOCK = 24, 32, 64, 16
NUM_BLOCKS, MAX_SEQS, MAX_BLOCKS = 2048, 8, 64
# the bitmap-index query: 2**34 rows, one bit per row in each uint8 bitplane
BITMAP_ROWS = 2 ** 34
BULK_OPS = {"zero": (bc_ops.pud_zero, 1), "copy": (bc_ops.pud_copy, 1),
            "not": (bc_ops.pud_not, 1), "and": (bc_ops.pud_and, 2),
            "or": (bc_ops.pud_or, 2), "xor": (bc_ops.pud_xor, 2),
            "maj": (bc_ops.pud_maj, 3)}
# the flash kernel's main shape: the full-width forward at 4 x 2048 tokens
FLASH_MAIN = dict(B=4, Hq=HEADS, Hkv=HEADS, Sq=2048, Sk=2048, D=HEAD_DIM, causal=True)
# and mistral_nemo_12b's at the same tokens: GQA 32/8 at head width 128
FLASH_D128 = dict(B=4, Hq=32, Hkv=8, Sq=2048, Sk=2048, D=128, causal=True)
# granite_34b served on the card: its full width (d, query heads, KV heads,
# head width, d_ff, vocab, activation, norm) at 8 of its 88 layers (the
# whole model, 68 GB in bf16, does not fit beside the rest of the script);
# 8 requests of 64-512 prompt tokens and 16 new tokens each
GRANITE_ARCH, GRANITE_LAYERS, GRANITE_SEED = "granite_34b", 8, 6
GRANITE_FULL = (6144, 48, 1, 128, 24576, 49152, "gelu", "layernorm")
GRANITE_REQUESTS, GRANITE_NEW = 8, 16
# the MoE serve: granite_moe_3b_a800m unreduced (layers, d, query heads, KV
# heads, head width, expert d_ff, vocab, experts, experts a token), 12
# requests of 64-512 seeded prompt tokens and 32 new tokens each
MOE_ARCH, MOE_SEED = "granite_moe_3b_a800m", 9
MOE_FULL = (32, 1536, 24, 8, 64, 512, 49155, 40, 8)
MOE_REQUESTS, MOE_NEW = 12, 32
# qwen2_vl_72b served and run forward on the card: its full width (d, query
# heads, KV heads, head width, d_ff, vocab, rope, M-RoPE sections) at 16 of
# its 80 layers (all 80 take 145 GB in bf16, the 16 about 33 GB); 10
# requests of 64-512 seeded prompt tokens and 16 new tokens each, one forked
VLM_ARCH, VLM_LAYERS, VLM_SEED = "qwen2_vl_72b", 16, 10
VLM_FULL = (8192, 64, 8, 128, 29568, 152064, "mrope", (16, 24, 24))
VLM_REQUESTS, VLM_NEW = 10, 16
# its flash shape at 4 x 2048 tokens: 64 query heads over 8 KV heads of 128
FLASH_VLM = dict(B=4, Hq=64, Hkv=8, Sq=2048, Sk=2048, D=128, causal=True)
# seamless_m4t_medium unreduced: encoder and decoder layers, d, query heads,
# KV heads, head width, d_ff, vocab, activation, norm, rope; its weights' seed
ENCDEC_ARCH, ENCDEC_SEED = "seamless_m4t_medium", 12
ENCDEC_FULL = (12, 12, 1024, 16, 16, 64, 4096, 256206, "gelu", "layernorm", "none")
# its decode: 8 sequences over 1024 seeded encoder frames each, a 16-token
# prompt on a recent ring of 16, then 64 greedy steps (a flush each 16)
ENCDEC_BATCH, ENCDEC_FRAMES, ENCDEC_PROMPT, ENCDEC_RING, ENCDEC_NEW = 8, 1024, 16, 16, 64
# its flash shapes: the encoder's and the cross-attention prefill's (4 x 2048
# tokens), and the cross-attention of a decode step (one query against the
# 1024 frames), all non-causal
FLASH_ENC = dict(B=4, Hq=16, Hkv=16, Sq=2048, Sk=2048, D=64, causal=False)
FLASH_XDEC = dict(B=ENCDEC_BATCH, Hq=16, Hkv=16, Sq=1, Sk=ENCDEC_FRAMES, D=64, causal=False)
# and its train steps (make_batch batches of 8 x 128 tokens over 128 frames)
ENCDEC_TRAIN_STEPS = 5
# the [dist] phase: granite_moe_1b_a400m unreduced (layers, d, query heads,
# KV heads, head width, expert d_ff, vocab, experts, experts a token) on a
# one-rank NCCL mesh (1, 1) ("data", "model"), its weights' seed; the train
# step's loss within DIST_LOSS_RTOL of the step without the mesh
DIST_ARCH, DIST_SEED = "granite_moe_1b_a400m", 15
DIST_FULL = (24, 1024, 16, 8, 64, 512, 49155, 32, 8)
DIST_LOSS_RTOL = 1e-5
# and the state path's blocks (port fault F14) on the same mesh: layer 0 of
# the unreduced rwkv6_7b (time mix) and zamba2_7b (Mamba2 block), seeded
# bf16 weights (the inert leaves set, as in the state phases), over
# STATE_BATCH x STATE_PROMPT activations from a zero state, then one decode
# step: bit-equal to the same calls without the mesh, each on its decay path
DIST_STATE = (("rwkv6_7b", "time mix", 17), ("zamba2_7b", "Mamba2 block", 18))
# the [train-families] phase: launch.train's trainer on the vlm and encdec
# families at full width (seamless_m4t_medium unreduced, qwen2_vl_72b cut to
# 2 of its 80 layers: its two 152064 x 8192 tables alone hold 2.49 B
# params), seq 128 x batch 8, remat full, 5 steps; the weights' seeds; the
# forms of the step split after it (the functional step of the [encdec]
# phase, and the trainer's donated one; the cut qwen2_vl_72b's functional
# step would hold a second 34 GB of moments)
TRAIN_FAMILIES = (("seamless_m4t_medium", None, 13, (False, True)),
                  ("qwen2_vl_72b", 2, 14, (True,)))
TRAIN_FAMILY_STEPS = 5
# the GQA forward's model, its full width (layers, d, heads, KV heads, head
# width, d_ff, vocab) and its weights' seed
GQA_ARCH, GQA_SEED = "mistral_nemo_12b", 5
GQA_FULL = (40, 5120, 32, 8, 128, 14336, 131072)
# the GEMV offload phase: the model whose full-width layer-0 matrices are
# placed and multiplied, the memory's seed, and the integer-valued data's
GEMV_ARCH, GEMV_MEM_SEED, GEMV_SEED = "stablelm_1_6b", 3, 7
GEMV_REPS = 20
# whole-model bf16 tolerances, flash path against chunked on the same weights:
# the two differ in where attention rounds (flash rounds P to bf16 before
# P.V), which bf16 layers carry to the loss and the logits
EVAL_LOSS_RTOL = 1e-2
LOGITS_TOL = 5e-2              # of the logits' largest magnitude
# the same check in f32 (the flash kernel's tf32x3 path against chunked
# f32): the first layer's logits within 1e-4 of their scale
LOGITS_TOL_F32 = 1e-4
# smoke training, card against CPU, f32: the first step's loss is one
# forward of the same weights; later steps follow AdamW, which moves every
# element by about lr whatever the size of its gradient, so float32
# rounding of near-zero gradients parts the runs a little more each step
SMALL_TRAIN_TOL = (1e-4, 1e-2)  # relative: step 1, steps 2-5
# decay attention: the reference's 2e-3 (f32); bf16 outputs within 2e-2 of
# max(1, max |plain|), the bf16 flash rows' rule
DECAY_TOL = 2e-3
DECAY_BF16_TOL = 2e-2
# the state-serving path of the ssm and hybrid families: 8 prompts of 1024
# tokens, 32 greedy steps; prefill_logits at 4 x 2048
STATE_BATCH, STATE_PROMPT, STATE_NEW = 8, 1024, 32
# the decay kernel's path on each family's main path (bf16), and in f32
STATE_PATH = {"rwkv6_7b": "vector_tc", "zamba2_7b": "scalar_tc"}
STATE_PATH_F32 = {arch: f"{path}_f32" for arch, path in STATE_PATH.items()}
# the state paths whose one-token step runs as a CUDA graph (zamba2's split
# attention cache takes host-int lengths: ROADMAP.md)
GRAPHED_STATE = ("rwkv6_7b",)
# the state path's whole-model check runs the first layers of the same
# weights, where the two plain paths still agree (the full-width models are
# chaotic in depth under the reference's init: ROADMAP.md, fault 4).  For
# zamba2 that is its first 5 Mamba layers: after the 6th the shared block
# already sets the plain paths 1.85 apart at a logits scale of 4.75
# (scripts/state_depth_spread.py shows the spread by depth).  The
# logits are bf16, so their differences come in steps of one bf16 ulp at
# the logits' scale: the kernel may exceed the oracle's spread by one step.
STATE_CHECK_DEPTH = {"rwkv6_7b": 4, "zamba2_7b": 5}
# smoke models, card against CPU (f32): logits within 1e-4 of their scale
SMOKE_LOGITS_TOL = 1e-4
# the [roofline] phase: (a) the dry-run's production cells on this
# machine's PyTorch (single pod, fake 16 x 16 ranks, 1 layer, each cell at
# its own accumulation), each with the argument bytes per device the CPU
# gives them (tests/test_torch_dryrun.py holds those against the
# reference's); then, without accumulation, its flops and peak a device
# against the reference's on the CPU (ROOFLINE_REF: its dry-run's records,
# taken without accumulation, which the same test holds these constants
# to), each ratio at most its bound: flops 1.3, peak 2 (train) and 1.5
# (decode); (b) one cell one card holds,
# predicted by the dry-run's recorder on meta tensors and then run:
# stablelm_1_6b at full width, launch.train's shape (8 x 128), remat full,
# chunked attention, AdamW in place, no mesh, seeded; ROOFLINE_WARMUP steps,
# then the median of ROOFLINE_REPS by CUDA events; the predicted peak within
# ROOFLINE_PEAK_RATIO of the measured either way
ROOFLINE_CELLS = (("stablelm_1_6b", "train_4k", 19_259_396),
                  ("stablelm_1_6b", "decode_32k", 154_632_264),
                  ("granite_moe_1b_a400m", "train_4k", 5_857_284))
ROOFLINE_REF = {("stablelm_1_6b", "train_4k"): (6840562745344.0, 8456063320),
                ("stablelm_1_6b", "decode_32k"): (583256704.0, 520948160),
                ("granite_moe_1b_a400m", "train_4k"): (2406889816064.0, 14378495688)}
ROOFLINE_MAX_FLOPS, ROOFLINE_MAX_PEAK = 1.3, {"train": 2.0, "decode": 1.5}
ROOFLINE_ARCH, ROOFLINE_SEED = "stablelm_1_6b", 16
ROOFLINE_SHAPE = RunShape("train", 128, 8, "train")
ROOFLINE_WARMUP, ROOFLINE_REPS, ROOFLINE_PEAK_RATIO = 2, 5, 2.0
# watermarks of tests/test_compaction.py's maintenance scenario
MAINTENANCE = MaintenanceConfig(free_low=0.9, frag_high=0.05, contig_low=0.999,
                                max_moves=64, every=2)


def log(*args) -> None:
    print(*args, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def load_script(relpath: str):
    """Import one of the repo's example/benchmark scripts as a module."""
    path = ROOT / relpath
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- phase 1 -----------------------------------------------------------------

def phase_device() -> str:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    log(f"[device] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)
    return name


# -- phase 2 -----------------------------------------------------------------

def phase_build() -> None:
    t0 = time.perf_counter()
    report = _build.build()
    log(f"[build] {time.perf_counter() - t0:.1f} s for {sorted(report) or 'nothing (cached)'}")
    for name, r in sorted(report.items()):
        info = [ln.strip() for ln in r["ptxas"].splitlines()
                if "registers" in ln or "spill" in ln]
        log(f"[build] {name}: {r['seconds']:.1f} s; " + " | ".join(info))


# -- phase 3 -----------------------------------------------------------------

def paged_case(gen, B, Hq, Hkv, D, lens, dtype, nb=NUM_BLOCKS, bs=BLOCK, maxb=MAX_BLOCKS):
    """Inputs at one shape: random pages, a table of distinct blocks padded
    with -1 beyond each sequence's pages."""
    dev = "cuda"
    q = torch.randn(B, Hq, D, generator=gen, device=dev).to(dtype)
    kp = torch.randn(nb, bs, Hkv, D, generator=gen, device=dev).to(dtype)
    vp = torch.randn(nb, bs, Hkv, D, generator=gen, device=dev).to(dtype)
    tbl = torch.full((B, maxb), -1, dtype=torch.int32)
    perm = torch.randperm(nb, generator=torch.Generator().manual_seed(B * Hkv + D))
    for b, n in enumerate(lens):
        need = -(-n // bs)
        tbl[b, :need] = perm[b * maxb:b * maxb + need].to(torch.int32)
    lens_t = torch.tensor(lens, dtype=torch.int32)
    return q, kp, vp, tbl.to(dev), lens_t.to(dev)


def paged_plain(q, kp, vp, tbl, lens):
    """The plain version: (out (B, Hq, D), lse (B, Hkv, group))."""
    B, Hq, D = q.shape
    qg = q.reshape(B, kp.shape[2], Hq // kp.shape[2], D)
    out, lse = paged_attention_ref(qg, kp, vp, tbl, lens, scale=D ** -0.5, return_lse=True)
    return out.reshape(q.shape), lse


def paged_lse_err(lse, plain_lse, name) -> float:
    """The kernel's LSE against the plain one: -inf at the same (length-0)
    rows, elsewhere within 2e-5 of max(1, |lse|)."""
    inf = torch.isneginf(plain_lse)
    check(torch.equal(torch.isneginf(lse), inf), f"paged_attention {name}: -inf LSE rows differ")
    if not bool((~inf).any()):
        return 0.0
    err = ((lse - plain_lse).abs() / plain_lse.abs().clamp_min(1.0))[~inf].max().item()
    check(err < PAGED_LSE_TOL, f"paged_attention {name}: LSE err {err} over tolerance")
    return err


def main_lens():
    return sorted(int(x) for x in np.random.default_rng(0).integers(64, 1025, size=MAX_SEQS))


def paged_path(group, D, dtype) -> str:
    """The path the paged kernel takes for q of ``dtype`` at this group and
    head width: its routing rule, read from the source (``route`` in
    ``paged_attention.cu``), so that the rule is written once."""
    return pa_ops.route(dtype, group, D)


# the group path's edges: lengths around its 64-token splits and 16-token pages
GROUP_LENS = [0, 1, 15, 16, 17, 63, 64, 65, 1024]


def paged_check(name, out, lse, args, dtype, tol) -> float:
    """The kernel's output and LSE against the plain version: within ``tol``,
    bf16 outputs within one bf16 ulp, length-0 rows zero."""
    plain, plain_lse = paged_plain(*args)
    diff = (out.float() - plain.float()).abs()
    err = diff.max().item()
    lse_err = paged_lse_err(lse, plain_lse, name)
    log(f"[kernels] paged_attention {name} ({pa_ops.last_path}): max_abs_err {err:.3e} (tol "
        f"{tol:g}), LSE {lse_err:.3e} of max(1, |lse|) (tol {PAGED_LSE_TOL:g})")
    check(out.dtype == args[0].dtype and out.shape == args[0].shape, f"{name}: output type/shape")
    check(err < tol, f"paged_attention {name}: err {err} over tolerance")
    if dtype == torch.bfloat16:
        # kernel and plain version round the same f32 result to bf16
        check(bool((diff <= BF16_ULP * plain.float().abs() + 1e-5).all()),
              f"paged_attention {name}: more than one bf16 ulp from the plain version")
    empty = args[4] <= 0
    check(bool((out[empty] == 0).all()), f"{name}: a length-0 row must give zeros")
    return err


def paged_group_cases(gen) -> dict:
    """The group path at granite_moe_3b_a800m's, qwen2_vl_72b's and
    granite_34b's groups (3 x 64, 8 x 128, 48 x 128), over bf16 and fp8
    pages, at the lengths of ``GROUP_LENS``; then one graphed call replayed
    twice with new lengths and tables (the path keeps no state between
    calls: its blocks merge in shared memory)."""
    errs = {}
    for Hq, Hkv, D in ((24, 8, 64), (64, 8, 128), (48, 1, 128)):
        for pages in ("bf16", "fp8"):
            args = list(paged_case(gen, len(GROUP_LENS), Hq, Hkv, D, GROUP_LENS, torch.bfloat16))
            if pages == "fp8":
                args[1], args[2] = args[1].to(torch.float8_e4m3fn), args[2].to(torch.float8_e4m3fn)
            out, lse = pa_ops.paged_attention(*args, return_lse=True)
            torch.cuda.synchronize()
            name = f"group {Hq // Hkv}x{D} {pages} pages, lens {GROUP_LENS}"
            check(pa_ops.last_path == "group", f"{name}: took the {pa_ops.last_path} path")
            errs[name] = paged_check(name, out, lse, args, torch.bfloat16, 2e-2)
    q, kp, vp, tbl, lens = paged_case(gen, MAX_SEQS, 64, 8, 128, main_lens(), torch.bfloat16)
    pa_ops.paged_attention(q, kp, vp, tbl, lens, return_lse=True)   # warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, lse = pa_ops.paged_attention(q, kp, vp, tbl, lens, return_lse=True)
    base_tbl, base_lens = tbl.clone(), lens.clone()
    for step, new_lens in enumerate(([1, 64, 65, 300, 500, 700, 900, 1000], main_lens()[::-1])):
        lens.copy_(torch.tensor(new_lens, dtype=torch.int32))
        # the pages for the new lengths: the table's rows reordered
        tbl.copy_(base_tbl[torch.argsort(base_lens, descending=step == 0)])
        graph.replay()
        torch.cuda.synchronize()
        name = f"group 8x128 graph replay {step + 1}, lens {new_lens}"
        errs[name] = paged_check(name, out, lse, (q, kp, vp, tbl, lens), torch.bfloat16, 2e-2)
    log("[kernels] paged_attention group path: one graph replayed twice with new lengths and "
        "tables, each against the plain version")
    del graph
    return errs


def phase_kernels() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {}
    cases = [
        ("main-bf16", dict(B=MAX_SEQS, Hq=HEADS, Hkv=HEADS, D=HEAD_DIM, lens=main_lens(), dtype=torch.bfloat16)),
        ("main-f32", dict(B=MAX_SEQS, Hq=HEADS, Hkv=HEADS, D=HEAD_DIM, lens=main_lens(), dtype=torch.float32)),
        ("gqa-bf16", dict(B=4, Hq=32, Hkv=8, D=128, lens=[0, 1, 300, 1024], dtype=torch.bfloat16)),
        ("gqa-f32", dict(B=4, Hq=32, Hkv=8, D=128, lens=[0, 17, 300, 1000], dtype=torch.float32)),
        # granite_34b's MQA group: 48 query heads on one KV head of 128
        ("mqa48-bf16", dict(B=MAX_SEQS, Hq=48, Hkv=1, D=128, lens=main_lens(), dtype=torch.bfloat16)),
        ("mqa48-f32", dict(B=MAX_SEQS, Hq=48, Hkv=1, D=128, lens=[0, 1, 63, 64, 65, 300, 1000, 1024],
                           dtype=torch.float32)),
        # granite_moe_3b_a800m's GQA group: 24 query heads on 8 KV heads of 64
        ("moe-bf16", dict(B=MAX_SEQS, Hq=24, Hkv=8, D=64, lens=main_lens(), dtype=torch.bfloat16)),
        ("moe-f32", dict(B=MAX_SEQS, Hq=24, Hkv=8, D=64, lens=[0, 1, 63, 64, 65, 300, 1000, 1024],
                         dtype=torch.float32)),
        # qwen2_vl_72b's GQA group: 64 query heads on 8 KV heads of 128
        ("vlm-bf16", dict(B=MAX_SEQS, Hq=64, Hkv=8, D=128, lens=main_lens(), dtype=torch.bfloat16)),
        ("vlm-f32", dict(B=MAX_SEQS, Hq=64, Hkv=8, D=128, lens=[0, 1, 63, 64, 65, 300, 1000, 1024],
                         dtype=torch.float32)),
    ]
    for name, kw in cases:
        args = paged_case(gen, **kw)
        out, lse = pa_ops.paged_attention(*args, return_lse=True)
        torch.cuda.synchronize()
        want = paged_path(kw["Hq"] // kw["Hkv"], kw["D"], kw["dtype"])
        check(pa_ops.last_path == want, f"{name}: took the {pa_ops.last_path} path, not {want}")
        errs[name] = paged_check(name, out, lse, args, kw["dtype"], TOL[kw["dtype"]])

    errs.update(paged_fp8_case(gen))
    errs.update(paged_group_cases(gen))
    errs.update(flash_cases())
    errs.update(decay_cases())

    pool, src, dst = block_copy_case()
    orig = pool.clone()
    plain = block_copy_ref(orig.clone(), torch.from_numpy(np.stack([src, dst], 1)))
    bc_ops.pool_block_copy(pool, src, dst)
    torch.cuda.synchronize()
    check(torch.equal(pool.view(torch.int16), plain.view(torch.int16)), "block_copy != plain version")
    changed = torch.nonzero((pool.view(torch.int16) != orig.view(torch.int16)).any(dim=1)).flatten()
    check(set(changed.tolist()) <= set(dst.tolist()), "block_copy touched an unlisted block")
    check(torch.equal(pool[torch.from_numpy(dst).cuda()], orig[torch.from_numpy(src).cuda()]),
          "block_copy destinations != sources")
    log(f"[kernels] block_copy bf16 pool {tuple(pool.shape)}, {len(src)} pairs: bit-exact, "
        f"{pool.shape[0] - len(dst)} unlisted blocks bit-identical")
    # a compaction pass may chain a move into a block another move empties
    chain_src, chain_dst = src[:8].copy(), dst[:8].copy()
    chain_src[0] = chain_dst[1]
    orig = pool.clone()
    plain = block_copy_ref(orig.clone(), torch.from_numpy(np.stack([chain_src, chain_dst], 1)))
    bc_ops.pool_block_copy(pool, chain_src, chain_dst)
    torch.cuda.synchronize()
    check(torch.equal(pool.view(torch.int16), plain.view(torch.int16)),
          "block_copy with a chained move != plain version")
    log("[kernels] block_copy with a chained move (a source that is another pair's "
        "destination): bit-exact, two launches")
    errs["block_copy"] = 0.0
    del pool, orig, plain
    torch.cuda.empty_cache()
    errs["bulk_op_cases"] = bulk_op_cases()
    return errs


def paged_fp8_case(gen) -> dict:
    """fp8 e4m3 K/V pages at the main serving shape, q in bf16 and f32, and
    at granite_34b's MQA group (48 query heads on one KV head of 128) and
    qwen2_vl_72b's GQA group (64 query heads on 8 KV heads of 128), q in
    bf16."""
    errs = {}
    for qdt, Hq, Hkv, D in ((torch.bfloat16, HEADS, HEADS, HEAD_DIM),
                            (torch.float32, HEADS, HEADS, HEAD_DIM),
                            (torch.bfloat16, 48, 1, 128),
                            (torch.bfloat16, 64, 8, 128)):
        q, kp, vp, tbl, lens = paged_case(gen, MAX_SEQS, Hq, Hkv, D, main_lens(), qdt)
        kp, vp = kp.to(torch.float8_e4m3fn), vp.to(torch.float8_e4m3fn)
        out, lse = pa_ops.paged_attention(q, kp, vp, tbl, lens, return_lse=True)
        torch.cuda.synchronize()
        plain, plain_lse = paged_plain(q, kp, vp, tbl, lens)
        err = (out.float() - plain.float()).abs().max().item()
        name = f"fp8-pages-{str(qdt).split('.')[-1]}" + {1: "-mqa48", 8: "-vlm"}.get(Hkv, "")
        want = paged_path(Hq // Hkv, D, qdt)
        check(pa_ops.last_path == want, f"{name}: took the {pa_ops.last_path} path, not {want}")
        errs[name] = err
        lse_err = paged_lse_err(lse, plain_lse, name)
        log(f"[kernels] paged_attention {name}: max_abs_err {err:.3e} (tol 2e-2), "
            f"LSE {lse_err:.3e} of max(1, |lse|) (tol {PAGED_LSE_TOL:g})")
        check(out.dtype == qdt and out.shape == q.shape, f"{name}: output type/shape")
        check(err < 2e-2, f"paged_attention {name}: err {err} over tolerance")
        if D == 128:   # as the bf16 rows: one bf16 ulp from the plain version
            diff = (out.float() - plain.float()).abs()
            check(bool((diff <= BF16_ULP * plain.float().abs() + 1e-5).all()),
                  f"paged_attention {name}: more than one bf16 ulp from the plain version")
    return errs


# tests/test_kernels.py's six shapes (B, Hq, Hkv, Sq, Sk, D, causal, dtype), then the main path's
FLASH_CASES = [
    (2, 4, 2, 64, 64, 32, True, torch.float32),
    (1, 8, 1, 100, 100, 64, True, torch.float32),
    (2, 4, 4, 32, 96, 80, False, torch.float32),
    (1, 2, 2, 1, 200, 128, False, torch.float32),
    (1, 4, 2, 128, 128, 64, True, torch.bfloat16),
    (1, 48, 1, 33, 33, 128, True, torch.float32),
    (4, 32, 32, 2048, 2048, 64, True, torch.bfloat16),    # main shape
    (4, 32, 32, 2048, 2048, 64, True, torch.float32),
    (2, 32, 8, 1024, 1024, 128, True, torch.bfloat16),    # GQA
    (2, 32, 8, 1024, 1024, 128, True, torch.float32),
    (2, 8, 4, 300, 1000, 64, False, torch.bfloat16),      # non-causal, Sq != Sk
    (2, 8, 4, 300, 1000, 64, False, torch.float32),
    # the wgmma path's edges (bf16, D = 64): one tile, ragged Sq and Sk,
    # Sq > Sk causal, Sk = 1, Sq = 1, GQA 32/8
    (1, 1, 1, 64, 64, 64, True, torch.bfloat16),
    (2, 4, 2, 200, 333, 64, True, torch.bfloat16),
    (2, 4, 2, 200, 333, 64, False, torch.bfloat16),
    (1, 4, 4, 300, 130, 64, True, torch.bfloat16),
    (2, 4, 4, 100, 1, 64, True, torch.bfloat16),
    (2, 4, 4, 1, 300, 64, False, torch.bfloat16),
    (2, 32, 8, 1024, 1024, 64, True, torch.bfloat16),
    # the same edges at D = 128 (the GQA 32/8 case above is one), MQA 48/1
    # (granite_34b's layout) and mistral_nemo_12b's forward
    (1, 1, 1, 128, 128, 128, True, torch.bfloat16),
    (2, 4, 2, 200, 333, 128, True, torch.bfloat16),
    (2, 4, 2, 200, 333, 128, False, torch.bfloat16),
    (1, 4, 4, 300, 130, 128, True, torch.bfloat16),
    (2, 4, 4, 100, 1, 128, True, torch.bfloat16),
    (2, 4, 4, 1, 300, 128, False, torch.bfloat16),
    (1, 48, 1, 512, 512, 128, True, torch.bfloat16),
    (4, 32, 8, 2048, 2048, 128, True, torch.bfloat16),
    # qwen2_vl_72b's forward (64 query heads over 8), causal and full
    (4, 64, 8, 2048, 2048, 128, True, torch.bfloat16),
    (2, 64, 8, 1024, 1024, 128, False, torch.bfloat16),
    # seamless_m4t_medium's: the encoder and cross-attention prefill, and a
    # decode step's cross-attention (one query against 1024 frames), both
    # non-causal, in bf16 and f32
    (4, 16, 16, 2048, 2048, 64, False, torch.bfloat16),
    (4, 16, 16, 2048, 2048, 64, False, torch.float32),
    (8, 16, 16, 1, 1024, 64, False, torch.bfloat16),
    (8, 16, 16, 1, 1024, 64, False, torch.float32),
]


def flash_path(D, dtype) -> str:
    """The kernel's routing rule for 16-byte aligned inputs (all of these)."""
    if dtype != torch.bfloat16:
        return "tf32x3" if D % 8 == 0 and D <= 128 else "simt"
    return "wgmma" if D in (64, 128) else "mma" if D % 16 == 0 else "simt"


def flash_inputs(gen, B, Hq, Hkv, Sq, Sk, D, dtype):
    return [torch.randn(*shape, generator=gen, device="cuda").to(dtype)
            for shape in ((B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D))]


def flash_cases() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(7)
    errs = {}
    # then the main path's layout: (B, S, H, D) tensors transposed to (B, H, S, D)
    transposed = [(2, 8, 2, 75, 75, D, True, torch.bfloat16, True) for D in (64, 128)]
    for B, Hq, Hkv, Sq, Sk, D, causal, dtype, *views in [*FLASH_CASES, *transposed]:
        q, k, v = flash_inputs(gen, B, Hq, Hkv, Sq, Sk, D, dtype)
        if views:
            q, k, v = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v)]
        out = fl_ops.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        path = fl_ops.last_path
        plain = attention_ref(q, k, v, causal=causal)
        err = (out.float() - plain.float()).abs().max().item()
        name = f"flash B{B} H{Hq}/{Hkv} S{Sq}x{Sk} D{D} {'causal' if causal else 'full'} " \
               f"{str(dtype).split('.')[-1]}{' transposed' if views else ''}"
        errs[name] = err
        log(f"[kernels] {name} ({path}): max_abs_err {err:.3e} (tol {TOL[dtype]:g})")
        check(out.dtype == dtype and out.shape == q.shape, f"{name}: output type/shape")
        check(path == flash_path(D, dtype), f"{name}: took the {path} path")
        check(err < TOL[dtype], f"{name}: err {err} over tolerance")
        del q, k, v, out, plain
    torch.cuda.empty_cache()
    q, k, v = flash_inputs(gen, 1, 2, 2, 16, 16, 64, torch.bfloat16)
    q.requires_grad_(True)
    before = kernels.launches["flash_attention"]
    try:
        fl_ops.flash_attention(q, k, v)
        raised = False
    except RuntimeError:
        raised = True
    check(raised and kernels.launches["flash_attention"] == before,
          "flash_attention must raise under autograd, before launching")
    log("[kernels] flash_attention raises under autograd (forward only, as the reference)")
    errs["flash_attention"] = errs[
        f"flash B4 H32/32 S2048x2048 D64 causal bfloat16"]
    return errs


# -- the decay-attention kernel against its plain version ----------------------

# tests/test_kernel_decay.py's shapes (B, S, H, dk, dv, bonus) and its
# three-chunk state carry (constant decay -0.05)
DECAY_CASES = [
    (2, 64, 2, 16, 16, False),
    (1, 100, 3, 32, 32, True),
    (2, 32, 1, 8, 24, True),
    (1, 33, 2, 64, 64, False),
    (1, 96, 1, 16, 16, "carry"),
]


def decay_inputs(B, S, H, dk, dv, bonus, seed=0):
    """The reference kernel test's inputs, made with numpy, on the card."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, dk))
    k = rng.normal(size=(B, S, H, dk)) * 0.3
    v = rng.normal(size=(B, S, H, dv))
    lw = (np.full((B, S, H, dk), -0.05) if bonus == "carry"
          else -np.abs(rng.normal(size=(B, S, H, dk))) * 0.3)
    u = rng.normal(size=(H, dk)) * 0.2 if bonus is True else None
    return [None if a is None else torch.from_numpy(a.astype(np.float32)).cuda()
            for a in (q, k, v, lw, u)]


def decay_check(name, q, k, v, lw, u=None, h0=None, oracle=False) -> float:
    """One launch against the plain chunked math on the same card inputs (and
    the sequential oracle where asked): the output within 2e-3 (f32) or 2e-2
    of the plain output's scale (bf16), the final state within 2e-3 of its
    scale; beside the oracle, the plain chunked math's own distance from it.
    Returns the output's max abs error."""
    y, hT = dc_ops.decay_attention(q, k, v, lw, bonus=u, initial_state=h0, return_state=True)
    torch.cuda.synchronize()
    path = dc_ops.last_path
    py, ph = chunked_decay_ref(q, k, v, lw, bonus=u, initial_state=h0, return_state=True)
    err = (y.float() - py.float()).abs().max().item()
    tol = DECAY_TOL if q.dtype == torch.float32 else DECAY_BF16_TOL * max(
        1.0, py.float().abs().max().item())
    serr = (hT - ph).abs().max().item()
    stol = DECAY_TOL * max(1.0, ph.abs().max().item())
    line = (f"[kernels] decay {name} ({path} path): max_abs_err {err:.3e} (tol {tol:.3g}), "
            f"state {serr:.3e} (tol {stol:.3g})")
    check(path == dc_ops.kernel_path(q, k, v, lw), f"decay {name}: took the {path} path")
    check(y.dtype == q.dtype and y.shape == v.shape and hT.dtype == torch.float32,
          f"decay {name}: output type/shape")
    check(err < tol and serr < stol, f"decay {name}: over tolerance")
    if oracle:
        oy, oh = decay_attention_ref(q, k, v, lw, bonus=u, initial_state=h0, return_state=True)
        oerr, oserr = (y - oy).abs().max().item(), (hT - oh).abs().max().item()
        perr, pserr = (py - oy).abs().max().item(), (ph - oh).abs().max().item()
        line += (f"; vs the sequential oracle {oerr:.3e}, state {oserr:.3e} (plain chunked "
                 f"{perr:.3e}, {pserr:.3e})")
        check(oerr < DECAY_TOL and oserr < DECAY_TOL, f"decay {name}: oracle over tolerance")
    log(line)
    return err


def decay_cases() -> dict:
    """The reference's five kernel shapes (against the plain chunked math and
    the sequential oracle), a nonzero initial state with the final state
    compared, Mamba2's stride-0 q/k/log_w at zamba2's width in f32 and in
    bf16 (C and B sliced from one 7296-wide row, as ``mamba2.py`` slices
    ``xBC``; an initial state), the rwkv6 serve shape in f32 and bf16 (log_w
    at the clip), a float32 view the 16-byte copies cannot read (``simt``),
    and the refusal under autograd.  The f32 cases take ``vector_tc_f32`` or
    ``scalar_tc_f32`` (the strided one ``simt``).  Each case prints the path
    it took."""
    errs = {}
    for case in DECAY_CASES:
        errs[f"decay {case}"] = decay_check("-".join(map(str, case)), *decay_inputs(*case),
                                            oracle=True)
    gen = torch.Generator(device="cuda").manual_seed(11)
    for bonus in (False, True):
        q, k, v, lw, u = decay_inputs(2, 70, 3, 32, 24, bonus, seed=1)
        h0 = torch.randn(2, 3, 32, 24, generator=gen, device="cuda")
        errs[f"decay h0 bonus={bonus}"] = decay_check(f"h0 bonus={bonus}", q, k, v, lw, u, h0,
                                                      oracle=True)
    # a float32 view whose d is not contiguous: the CUDA-core path
    q, k, v, lw, u = decay_inputs(1, 100, 3, 32, 32, True, seed=2)
    q2 = torch.empty(*q.shape[:3], 2 * q.shape[3], device="cuda")[..., ::2].copy_(q)
    check(dc_ops.kernel_path(q2, k, v, lw) == "simt", "a strided f32 view must take simt")
    errs["decay simt"] = decay_check("strided f32 q (1, 100, 3, 32/32), bonus", q2, k, v, lw, u,
                                     oracle=True)
    # Mamba2 at zamba2's width: C, B (B, S, 64) broadcast over 112 heads, the
    # per-head decay broadcast over the state dim, a ragged S
    B, S, H, ns, hd = 2, 300, 112, 64, 64
    xBC = torch.randn(B, S, 2 * ns, generator=gen, device="cuda")
    q = xBC[:, :, None, :ns].expand(B, S, H, ns)
    k = (xBC[..., ns:] * 0.3)[:, :, None].expand(B, S, H, ns)
    lw = (-torch.rand(B, S, H, generator=gen, device="cuda") * 2)[..., None].expand(B, S, H, ns)
    v = torch.randn(B, S, H, hd, generator=gen, device="cuda")
    check(q.stride(2) == 0 and k.stride(2) == 0 and lw.stride(3) == 0, "stride-0 views")
    errs["decay stride-0"] = decay_check("stride-0 q/k/log_w (2, 300, 112, 64/64) f32", q, k, v, lw)
    d_in = 7168
    xBC = torch.randn(B, S, d_in + 2 * ns, generator=gen, device="cuda")
    h0 = torch.randn(B, H, ns, hd, generator=gen, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        x = xBC.to(dtype)
        q = x[:, :, None, d_in + ns:].expand(B, S, H, ns)
        k = x[:, :, None, d_in:d_in + ns].expand(B, S, H, ns)
        name = f"stride-0 q/k/log_w of a 7296-wide row (2, 300, 112, 64/64) {_dt(dtype)}, h0"
        errs[f"decay stride-0 {_dt(dtype)}"] = decay_check(name, q, k, v.to(dtype), lw, h0=h0,
                                                           oracle=dtype == torch.float32)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, lw, u = decay_inputs(STATE_BATCH, STATE_PROMPT, 64, 64, 64, True, seed=3)
        h0 = torch.randn(STATE_BATCH, 64, 64, 64, generator=gen, device="cuda")
        lw = lw * 4     # reach the clip at -1.8
        name = f"rwkv6 serve shape (8, 1024, 64, 64/64) {_dt(dtype)}"
        errs[f"decay main {dtype}"] = decay_check(name, q.to(dtype), k.to(dtype), v.to(dtype),
                                                  lw, u, h0, oracle=dtype == torch.float32)
    q.requires_grad_(True)
    before = kernels.launches["decay_attention"]
    try:
        dc_ops.decay_attention(q, k, v, lw, bonus=u)
        raised = False
    except RuntimeError:
        raised = True
    check(raised and kernels.launches["decay_attention"] == before,
          "decay_attention must raise under autograd, before launching")
    log("[kernels] decay_attention raises under autograd (forward only, as the reference)")
    errs["decay_attention"] = errs[f"decay main {torch.bfloat16}"]
    errs["decay_attention:vector_tc_f32"] = errs[f"decay main {torch.float32}"]
    errs["decay_attention:scalar_tc_f32"] = errs["decay stride-0 float32"]
    del q, k, v, lw, h0, xBC, x
    torch.cuda.empty_cache()
    return errs


def _dt(dtype) -> str:
    return str(dtype).split(".")[-1]


def bulk_inputs(gen, shape, dtype, n):
    """``n`` operands of random bits (random 0/1 for bool), made on the card."""
    if dtype == torch.bool:
        return [torch.randint(0, 2, shape, generator=gen, device="cuda").bool() for _ in range(n)]
    numel = math.prod(shape)
    return [torch.randint(0, 256, (numel * dtype.itemsize,), generator=gen, device="cuda",
                          dtype=torch.uint8).view(dtype).view(shape) for _ in range(n)]


def bulk_check(op, xs, what) -> None:
    """One op, kernel against plain version on the same card inputs, bit-exact."""
    fn, arity = BULK_OPS[op]
    out = fn(*xs[:arity])
    torch.cuda.synchronize()
    plain = bulk_op_ref(*xs[:arity], op=op).contiguous()
    check(out.shape == xs[0].shape and out.dtype == xs[0].dtype, f"bulk_op {op} {what}: type/shape")
    check(torch.equal(out.view(torch.uint8), plain.view(torch.uint8)),
          f"bulk_op {op} {what}: differs from the plain version")


def bulk_op_cases() -> int:
    """The reference's test shapes x dtypes, a bool case, and views 1 byte
    off a 16-byte boundary (the kernel's byte path), every op."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    n = 0
    for dtype in (torch.int32, torch.uint32, torch.int8, torch.uint8):
        for shape in ((8, 128), (100,), (3, 5, 7), (1000, 3)):
            xs = bulk_inputs(gen, shape, dtype, 3)
            for op in BULK_OPS:
                bulk_check(op, xs, f"{tuple(shape)} {dtype}")
                n += 1
    xs = bulk_inputs(gen, (4097,), torch.bool, 3)
    for op in BULK_OPS:
        bulk_check(op, xs, "bool")
        n += 1
    not_bool = bc_ops.pud_not(xs[0])
    check(bool((not_bool == ~xs[0]).all()) and int(not_bool.view(torch.uint8).max()) <= 1,
          "bulk_op not on bool is not a logical not")
    base = bulk_inputs(gen, (3, 1 << 20), torch.uint8, 1)[0]
    xs = [base[i, 1:] for i in range(3)]
    check(all(x.data_ptr() % 16 for x in xs), "the unaligned case is aligned")
    for op in BULK_OPS:
        bulk_check(op, xs, "1-byte offset view")
        n += 1
    log(f"[kernels] bulk_op: {n} cases (4 shapes x int32/uint32/int8/uint8, bool, "
        f"1-byte offset view; 7 ops) bit-exact")
    return n


# -- phase 3b: the bitmap-index query at full size -----------------------------

def bitmap_planes(seed: int = 5) -> dict:
    """Four packed bitplanes of 2**34 rows (2 GiB of uint8 each), random bits
    from a seeded generator on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return {name: torch.randint(0, 256, (BITMAP_ROWS // 8,), generator=gen, device="cuda",
                                dtype=torch.uint8)
            for name in ("age_lo", "age_hi", "active", "vip")}


def popcount(x: torch.Tensor) -> int:
    return sum(int(((x >> k) & 1).sum(dtype=torch.int64)) for k in range(8))


def phase_bitmap() -> dict:
    """The bitmap-index query of examples/torch_pud_bitwise.py at 2**34 rows
    through ``bulk_op``, with the launch counts zeroed just before it and
    read just after; held bit-exactly against the plain version."""
    example = load_script("examples/torch_pud_bitwise.py")
    small = {dev: example.main(["--device", dev, "--rows", "65536"]) for dev in ("cuda", "cpu")}
    check(small["cuda"] == small["cpu"], f"bitwise example: card {small['cuda']} != CPU {small['cpu']}")
    planes = bitmap_planes()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = example.bitmap_query(planes)
    torch.cuda.synchronize()
    query_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    check(launches["bulk_op"] == 3, f"bitmap query: {launches['bulk_op']} bulk_op launches, not 3")
    p0 = bulk_op_ref(planes["age_lo"], planes["age_hi"], op="and")
    p1 = bulk_op_ref(p0, planes["active"], op="and")
    del p0
    plain = bulk_op_ref(p1, planes["vip"], op="or")
    del p1
    check(res.shape == (BITMAP_ROWS // 8,) and res.dtype == torch.uint8, "bitmap result shape")
    check(torch.equal(res, plain), "bitmap query: kernel result != plain version")
    matches = popcount(res)
    # independent bits: P((a & b & c) | d) = 1/2 + 1/2 * 1/8
    frac = matches / BITMAP_ROWS
    check(abs(frac - 0.5625) < 1e-4, f"bitmap query: match fraction {frac}")
    log(f"[bitmap] (age_lo AND age_hi AND active) OR vip over {BITMAP_ROWS} rows "
        f"({BITMAP_ROWS // 8 / 2**30:.0f} GiB per plane): {matches} matches "
        f"({frac:.6f} of rows), bit-exact vs plain; {launches['bulk_op']} bulk_op launches, "
        f"{query_s * 1e3:.2f} ms host time; example at 65536 rows: {small['cuda']} matches "
        f"on the card and on the CPU")
    del planes, res, plain
    torch.cuda.empty_cache()
    return {"launches": launches, "matches": matches, "max_abs_err": 0.0}


# -- phase 3c: the PUD host model ----------------------------------------------

def phase_pud_host() -> None:
    """The quickstart's allocator table and Figure 2 on the paper geometry:
    modelled DRAM times from the PUD cost model, not times of the card."""
    rows = load_script("examples/torch_quickstart.py").main()
    check(rows["PUMA"]["pud_fraction"] == 1.0 and rows["malloc"]["pud_fraction"] == 0.0,
          f"quickstart PUD fractions {rows}")
    check(rows["PUMA"]["t_ns"] < rows["malloc"]["t_ns"], "PUMA not faster in the model")
    bench = load_script("benchmarks/torch_microbench.py")
    table = bench.run(lambda *_: None)
    bench.print_table(table)
    for op, row in table.items():
        speedups = [row[b] for b in bench.SIZES_BITS]
        check(all(s >= 1.0 for s in speedups) and speedups[-1] > 2.0,
              f"Figure 2 {op}: {speedups}")


# -- phase 3d: the GEMV offload model and the evaluation runners ---------------

def phase_gemv() -> dict:
    """(a) The full-width layer 0 of ``GEMV_ARCH`` (``trace/gemv.py``'s seven
    decode matrices, weights and accumulators 411 MB) placed with each of
    the four allocators on the modelled 8 GB memory, and each matrix's
    partitioned ``gemv_execute`` on the card held bit-equal to one whole
    ``torch.mv`` on the card and to the CPU's result (integer-valued f32:
    every sum is exact); each allocator's in-PUD row share, and the
    partitioned calls' time against the whole products' and the byte bound.
    ``lm_head`` is left out: it and its accumulator (2 x 822 MB) do not fit
    PUMA's 512 huge pages.  (b) The trace and chaos runners at smoke size
    on the card, their records equal to the CPU's outside the wall-clock
    fields, the trace records also to the committed ``BENCH_trace.json``.
    (c) The kernel-bench rows on the card, each kernel within its tolerance
    of its plain version."""
    from repro_torch.core import pud
    from repro_torch.core.allocators import HUGE_PAGE, PhysicalMemory
    from repro_torch.core.dram import AddressMap
    from repro_torch.trace import gemv

    shapes = {n: s for n, s in gemv.weight_shapes(get_config(GEMV_ARCH)).items()
              if n.startswith("L0/")}
    w_bytes = sum(o * i * gemv.ITEMSIZE for o, i in shapes.values())
    # weights and accumulators, in whole huge pages: the PUD pool's size
    n_huge = -(-2 * w_bytes // HUGE_PAGE)
    rng = np.random.default_rng(GEMV_SEED)
    ws = {n: rng.integers(-8, 8, size=s).astype(np.float32) for n, s in shapes.items()}
    xs = {n: rng.integers(-8, 8, size=(s[1],)).astype(np.float32) for n, s in shapes.items()}
    wc = {n: torch.from_numpy(w).cuda() for n, w in ws.items()}
    xc = {n: torch.from_numpy(x).cuda() for n, x in xs.items()}
    whole = {n: torch.mv(wc[n], xc[n]) for n in shapes}
    io_bytes = sum(o * i * 4 + i * 4 + o * 4 for o, i in shapes.values())
    res = {"bound_ms": io_bytes / HBM_BYTES_PER_S * 1e3, "n_huge": n_huge, "share": {},
           "ms": {}}
    res["mv_ms"] = time_ms(lambda: [torch.mv(wc[n], xc[n]) for n in shapes], GEMV_REPS)
    log(f"[gemv] {GEMV_ARCH} layer 0 at full width: {len(shapes)} matrices, "
        f"{w_bytes / 1e6:.1f} MB f32 weights (+ accumulators), PUMA pool {n_huge} of 512 huge "
        f"pages; lm_head left out (it and its accumulator, 2 x "
        f"{get_config(GEMV_ARCH).vocab_size * get_config(GEMV_ARCH).d_model * 4 / 1e6:.0f} MB, "
        f"do not fit the modelled memory's 512 huge pages)")
    for al in gemv.ALLOCATORS:
        amap = AddressMap()
        placement = gemv.build_placement(shapes, al, PhysicalMemory(amap, seed=GEMV_MEM_SEED),
                                         prealloc_huge=n_huge)
        rows = rows_pud = 0
        for n in shapes:
            plan = pud.plan_rows("mac", list(placement[n]), amap)
            rows, rows_pud = rows + plan.n_rows, rows_pud + sum(plan.in_pud)
            y = gemv.gemv_execute(wc[n], xc[n], *placement[n], amap)
            check(y.device == wc[n].device and torch.equal(y, whole[n]),
                  f"[gemv] {al} {n}: the partitioned product on the card differs from torch.mv")
            y_cpu = gemv.gemv_execute(ws[n], xs[n], *placement[n], amap)
            check(np.array_equal(y.cpu().numpy(), y_cpu),
                  f"[gemv] {al} {n}: the card's partitioned product differs from the CPU's")
        res["share"][al] = rows_pud / rows
        res["ms"][al] = time_ms(lambda: [gemv.gemv_execute(wc[n], xc[n], *placement[n], amap)
                                         for n in shapes], GEMV_REPS)
        log(f"[gemv] {al:<14} in-PUD rows {rows_pud}/{rows} ({res['share'][al]:.4f}); "
            f"partitioned {res['ms'][al]:.4f} ms, whole torch.mv {res['mv_ms']:.4f} ms, "
            f"bound {res['bound_ms']:.4f} ms (bytes); bit-equal on the card and to the CPU")
    check(res["share"]["malloc"] == 0.0 and res["share"]["posix_memalign"] == 0.0,
          f"[gemv] base-page placements offload rows: {res['share']}")

    trace_bench = load_script("benchmarks/torch_trace_bench.py")
    chaos_bench = load_script("benchmarks/torch_chaos_bench.py")
    records = trace_bench.torch_records
    card, _ = trace_bench.bench(smoke=True, device="cuda")
    host, _ = trace_bench.bench(smoke=True, device="cpu")
    check(records.differing(card, host, trace_bench.WALL_CLOCK) == [],
          "[gemv] trace records on the card differ from the CPU's")
    committed = json.loads((ROOT / "BENCH_trace.json").read_text())
    bad = records.differing(card, committed, trace_bench.WALL_CLOCK, skip=("determinism",))
    check(bad == [], f"[gemv] trace records differ from BENCH_trace.json in {bad}")
    card = chaos_bench.bench(smoke=True, device="cuda")
    host = chaos_bench.bench(smoke=True, device="cpu")
    bad = records.differing(card, host, chaos_bench.WALL_CLOCK)
    check(bad == [], f"[gemv] chaos records on the card differ from the CPU's in {bad}")
    chaos_bench.check(card)
    log("[gemv] torch_trace_bench and torch_chaos_bench at smoke size: the card's records "
        "equal the CPU's; the trace records equal BENCH_trace.json")

    kernel_bench = load_script("benchmarks/torch_kernel_bench.py")
    rows = {}

    def emit(name, us, derived):
        rows[name] = derived
        log(f"[gemv] kernel bench {name},{us:.1f},{derived}")

    kernel_bench.run(emit, device="cuda")
    kernel_bench.check(rows)
    del wc, xc, whole
    torch.cuda.empty_cache()
    return res


def block_copy_case():
    """The fork of a 512-token sequence on the full-width pool, layer dim
    folded into the block index: (24 * 2048, 16 * 32 * 64) bf16."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    pool = torch.randn(N_LAYERS * NUM_BLOCKS, BLOCK * HEADS * HEAD_DIM,
                       generator=gen, device="cuda").to(torch.bfloat16)
    rng = np.random.default_rng(2)
    blocks = rng.choice(NUM_BLOCKS, size=64, replace=False)
    src, dst = blocks[:32], blocks[32:]
    offs = (np.arange(N_LAYERS) * NUM_BLOCKS)[:, None]
    return pool, (src[None] + offs).reshape(-1), (dst[None] + offs).reshape(-1)


# -- phase 4 -----------------------------------------------------------------

def full_width_engine(n_requests: int, max_new: int, seed: int = 0,
                      maintenance: MaintenanceConfig = None, jit: bool = True) -> ServeEngine:
    """The full-width stablelm_1_6b serve on the card: random weights from a
    seeded generator, the main-path pool, and ``n_requests`` submitted
    requests with seeded prompts of 64-512 tokens; ``jit`` is the engine's
    (decode through CUDA graphs, or eagerly).  Phase 4 drives it;
    ``scripts/torch_decode_profile.py`` profiles the same serve."""
    cfg = get_config("stablelm_1_6b")
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.hd, cfg.d_ff, cfg.vocab_size)
          == (N_LAYERS, 2048, HEADS, HEAD_DIM, 5632, 100352), "stablelm_1_6b is not at full width")
    model = LM(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    torch.cuda.synchronize()
    log(f"[serve] {cfg.name}: {count_params(params) / 1e9:.3f} B params ({cfg.dtype}) in "
        f"{time.perf_counter() - t0:.1f} s")
    pool_cfg = KVPoolConfig(
        num_blocks=NUM_BLOCKS, block_size=BLOCK, kv_heads=cfg.n_kv_heads,
        head_dim=cfg.hd, n_layers=cfg.n_layers, max_seqs=MAX_SEQS,
        max_blocks_per_seq=MAX_BLOCKS, blocks_per_arena=64, dtype=cfg.kv_cache_dtype,
    )
    engine = ServeEngine(model, params, pool_cfg, device="cuda", maintenance=maintenance, jit=jit)
    log(f"[serve] K+V pool {2 * engine.pool.k.numel() * engine.pool.k.element_size() / 1e9:.2f} GB")
    rng = np.random.default_rng(seed)
    for rid in range(n_requests):
        n = int(rng.integers(64, 513))
        engine.submit(Request(rid=rid, prompt=rng.integers(0, cfg.vocab_size, n).tolist(),
                              max_new=max_new))
    return engine


def phase_serve(maintenance: MaintenanceConfig = None, jit: bool = True) -> dict:
    """Serve 12 requests at full width with a fork part-way, the launch
    counts zeroed just before and read just after; ``jit`` decodes through
    the engine's CUDA graphs (one capture per batch size), else eagerly.
    With ``maintenance``, every compaction pass is checked as it happens:
    the pool's invariants hold and every live sequence's K/V pages moved
    bit-exactly.  Graphed, the first step with a full batch is also run
    eagerly from the same state and held bit-equal (``graph_step_check``).
    Decode timing leaves out steps that prefill, compact or capture."""
    max_new = 32
    engine = full_width_engine(12, max_new, maintenance=maintenance, jit=jit)
    model, params, cfg = engine.model, engine.params, engine.cfg
    tag = "[serve " + ("graph" if jit else "eager") + ("+maint]" if maintenance else "]")
    contig = []
    engine.step_hooks.append(lambda eng, s: contig.append(s["contiguity"]) if s["live"] else None)
    passes = watch_compaction(engine) if maintenance else []

    kernels.reset_launches()
    decode_s, decode_tok, step_ms, fork, step_check = 0.0, 0, [], None, None
    t_run = time.perf_counter()
    alive = True
    while alive:
        if jit and step_check is None and len(engine.live) == MAX_SEQS:
            step_check = graph_step_check(engine, tag)
        pre_tok, pre_fill = engine.tokens_decoded, engine.tokens_prefilled
        pre_passes = engine.compaction_passes
        pre_captures = engine.graphs.captures if jit else 0
        t0 = time.perf_counter()
        alive = engine.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if (engine.tokens_prefilled == pre_fill and engine.tokens_decoded > pre_tok
                and engine.compaction_passes == pre_passes
                and (engine.graphs.captures if jit else 0) == pre_captures):
            decode_s += dt
            decode_tok += engine.tokens_decoded - pre_tok
            step_ms.append(dt * 1e3)
        # fork part-way, as soon as a sequence slot is free for the child
        if fork is None and engine.live and engine.pool.occupancy()["free_slots"]:
            fork = fork_and_check(engine)
        check(engine.clock < 10_000, "serving did not finish")
    run_s = time.perf_counter() - t_run
    launches = dict(kernels.launches)

    done = sorted(engine.done, key=lambda r: r.rid)
    check(len(done) == 12 and not engine.rejected and not engine.cancelled,
          f"served {len(done)} of 12 (rejected {len(engine.rejected)})")
    vocab = pad_vocab(cfg)
    for r in done:
        check(len(r.out) == max_new and all(0 <= t < vocab for t in r.out),
              f"request {r.rid}: {len(r.out)} ids")
    check(launches["paged_attention"] == cfg.n_layers * engine.steps,
          f"paged_attention launches {launches['paged_attention']} != 24 x {engine.steps} steps")
    m = engine.metrics()
    check(len(passes) == m["compaction_passes"], "a compaction pass went unchecked")
    check(launches["block_copy"] == 2 + 2 * len(passes),
          f"block_copy launches {launches['block_copy']} != 2 (fork) + 2 x {len(passes)} passes")
    if maintenance:
        check(m["compaction_passes"] > 0 and m["blocks_migrated"] > 0,
              f"no compaction at these watermarks: {m['compaction_passes']} passes")
    if jit:
        check(step_check is not None and engine.graphs.captures > 0,
              "the graphed serve never decoded a full batch through a graph")
    # one more full-width forward, to check the logits themselves
    logits = model.prefill_logits(params, {
        "tokens": torch.tensor([done[0].prompt[:64]], device="cuda"),
        "positions": torch.arange(64, device="cuda")[None]})
    check(tuple(logits.shape) == (1, vocab) and bool(torch.isfinite(logits).all()),
          "full-width logits not finite")
    out = {
        "requests_done": len(done), "steps": engine.steps, "clock": engine.clock,
        "tokens_decoded": engine.tokens_decoded, "tokens_prefilled": engine.tokens_prefilled,
        "decode_steps_timed": len(step_ms), "decode_tokens_per_s": decode_tok / decode_s,
        "mean_decode_step_ms": statistics.mean(step_ms),
        "run_s": run_s, "tokens_per_s_incl_prefill": engine.tokens_decoded / run_s,
        "launches": launches,
        "mean_live_contiguity": statistics.mean(contig), "final_metrics_contiguity":
            m["mean_contiguous_fraction"], "align_hits": m["align_hits"],
        "align_misses": m["align_misses"], "preemptions": m["preemptions"],
        "compaction_passes": m["compaction_passes"], "blocks_migrated": m["blocks_migrated"],
        "maintenance_ns_modelled": m["maintenance_ns"], "compaction_ms": [p["ms"] for p in passes],
        "fork": fork, "jit": jit,
        "captures": engine.graphs.captures if jit else 0,
        "capture_ms": engine.graphs.capture_ms if jit else 0.0, "graph_step_check": step_check,
    }
    for k, v in out.items():
        log(f"{tag} {k}: {v}")
    out["ids"] = {r.rid: list(r.out) for r in done}
    if maintenance:
        del engine.pool.compact   # watch_compaction's wrapper holds the pool: a cycle
    del engine, params
    torch.cuda.empty_cache()
    return out


def graph_step_check(engine, tag: str) -> dict:
    """The next decode step of the live batch through the engine's graph and
    eagerly, from the same state and without advancing it: logits, new_k
    and new_v bit-equal.  The comparison's launches are taken back out of
    the counts."""
    counts = dict(kernels.launches)
    slots = sorted(engine.live)
    lens = engine.pool.seq_lens()
    pos = np.array([[lens[s] - 1] for s in slots], np.int64)
    if engine.cfg.rope == "mrope":          # (B, 1, 3), as the engine's step
        pos = np.repeat(pos[..., None], 3, axis=-1)
    host = (np.array([[engine.live[s].out[-1]] for s in slots], np.int64), pos,
            engine.pool.block_table()[slots], lens[slots])
    k, v = engine.pool.k, engine.pool.v
    got = [t.clone() for t in paged_decode_step_jit(engine.params, engine.cfg, host[0], host[1],
                                                    k, v, host[2], host[3], graphs=engine.graphs)]
    dev = [torch.from_numpy(a).cuda() for a in host]
    with torch.no_grad():
        want = paged_decode_step(engine.params, engine.cfg, dev[0], dev[1], k, v, dev[2], dev[3])
    for name, g, w in zip(("logits", "new_k", "new_v"), got, want):
        check(torch.equal(g, w), f"{tag} graphed step: {name} differs from eager by "
              f"{(g.float() - w.float()).abs().max().item():.3e}")
    kernels.launches.update(counts)
    log(f"{tag} one decode step at B = {len(slots)}, graphed and eager from the same state: "
        f"logits {tuple(got[0].shape)}, new_k/new_v {tuple(got[1].shape)} bit-equal")
    return {"batch": len(slots), "bit_equal": True}


def watch_compaction(engine) -> list:
    """Wrap ``engine.pool.compact``: around each pass, snapshot every live
    sequence's K/V pages, then check the pool's invariants and that each
    sequence's pages now at its new blocks equal the snapshot.  Returns the
    list the passes are recorded in."""
    pool, passes = engine.pool, []
    compact = pool.compact

    def checked(*args, **kwargs):
        live = {slot: list(h.tiles) for slot, (h, _) in pool._seqs.items()}
        snap = {slot: (pool.k[:, t].clone(), pool.v[:, t].clone()) for slot, t in live.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        report = compact(*args, **kwargs)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        check_kv_pool(pool).assert_ok()
        moved = 0
        for slot, (k, v) in snap.items():
            now = list(pool._seqs[slot][0].tiles)
            moved += sum(a != b for a, b in zip(live[slot], now))
            for name, old in (("k", k), ("v", v)):
                check(torch.equal(getattr(pool, name)[:, now].view(torch.int16), old.view(torch.int16)),
                      f"compaction moved {name} pages of slot {slot} wrongly")
        if report is not None and report.executed:
            check(moved == report.executed, f"compaction: {moved} live blocks moved, "
                  f"report says {report.executed}")
            passes.append({"moves": report.executed, "ms": ms})
        return report

    pool.compact = checked
    return passes


def fork_and_check(engine) -> dict:
    slot = min(engine.live)
    new = engine.pool.fork(slot)
    check(new is not None, "fork failed")
    tbl = engine.pool.block_table()
    pb, fb = tbl[slot][tbl[slot] >= 0], tbl[new][tbl[new] >= 0]
    check(len(pb) == len(fb) and list(pb) != list(fb), "fork tables")
    pbt, fbt = torch.from_numpy(pb).cuda().long(), torch.from_numpy(fb).cuda().long()
    for name in ("k", "v"):
        t = getattr(engine.pool, name)
        check(torch.equal(t[:, pbt].view(torch.int16), t[:, fbt].view(torch.int16)),
              f"forked {name} pages differ from the parent's")
    engine.pool.release(new)
    info = {"parent_slot": slot, "blocks": int(len(pb)),
            "same_arena": float(np.mean(pb // 64 == fb // 64))}
    log(f"[serve] fork of slot {slot} at step {engine.steps}: {len(pb)} blocks x "
        f"{engine.cfg.n_layers} layers, "
        f"pages equal; {info['same_arena']:.2f} of blocks in the parent's arena")
    return info


# -- phase 4b: granite_34b's MQA group through the paged kernel ---------------

def drive(engine, tag: str, jit: bool, fork: bool = False):
    """Step ``engine`` until it is idle: graphed, the first step with a full
    batch is also held bit-equal to eager (``graph_step_check``); with
    ``fork``, a live sequence is forked as soon as a slot is free for the
    child (``fork_and_check``), and a fork that never found a slot fails.
    Returns the host ms of each step that neither prefills nor captures,
    and the step check."""
    step_ms, step_check, forked = [], None, None
    alive = True
    while alive:
        if jit and step_check is None and len(engine.live) == MAX_SEQS:
            step_check = graph_step_check(engine, tag)
        pre_tok, pre_fill = engine.tokens_decoded, engine.tokens_prefilled
        pre_captures = engine.graphs.captures if jit else 0
        t0 = time.perf_counter()
        alive = engine.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if (engine.tokens_prefilled == pre_fill and engine.tokens_decoded > pre_tok
                and (engine.graphs.captures if jit else 0) == pre_captures):
            step_ms.append(dt * 1e3)
        if fork and forked is None and engine.live and engine.pool.occupancy()["free_slots"]:
            forked = fork_and_check(engine)
        check(engine.clock < 10_000, f"{tag} serving did not finish")
    check(not fork or forked is not None, f"{tag} no slot was ever free for the fork")
    return step_ms, step_check


def check_served(engine, tag: str, jit: bool, launches: dict, n_requests: int, n_new: int,
                 step_check, forked: bool = False) -> list:
    """The checks every serve phase makes once ``drive`` returns: every
    request done with ``n_new`` ids in the vocab and none rejected or
    cancelled, one paged-attention launch a layer a step, the fork's block
    copies (``forked``), and a full batch decoded through a graph (with
    ``jit``).  Returns the done requests by rid."""
    cfg = engine.cfg
    done = sorted(engine.done, key=lambda r: r.rid)
    check(len(done) == n_requests and not engine.rejected and not engine.cancelled,
          f"{tag} served {len(done)} of {n_requests} (rejected {len(engine.rejected)})")
    vocab = pad_vocab(cfg)
    for r in done:
        check(len(r.out) == n_new and all(0 <= t < vocab for t in r.out),
              f"{tag} request {r.rid}: {len(r.out)} ids")
    check(launches["paged_attention"] == cfg.n_layers * engine.steps and engine.steps > 0,
          f"{tag} paged_attention launches {launches['paged_attention']} != "
          f"{cfg.n_layers} x {engine.steps} steps")
    path = paged_path(cfg.n_heads // cfg.n_kv_heads, cfg.hd, getattr(torch, cfg.dtype))
    check(launches[f"paged_attention:{path}"] == launches["paged_attention"],
          f"{tag} {launches[f'paged_attention:{path}']} of {launches['paged_attention']} "
          f"paged_attention launches on the {path} path")
    if forked:
        check(launches["block_copy"] > 0,
              f"{tag} the fork launched {launches['block_copy']} block copies")
    if jit:
        check(step_check is not None and engine.graphs.captures > 0,
              f"{tag} never decoded a full batch through a graph")
    return done


def granite_engine(jit: bool):
    """granite_34b at its full width and 8 of its 88 layers on the card:
    random bf16 weights from a seeded generator, the main path's pool shape
    with one KV head of 128, and 8 submitted requests of 64-512 seeded
    prompt tokens and 16 new tokens each."""
    cfg = dataclasses.replace(get_config(GRANITE_ARCH), n_layers=GRANITE_LAYERS)
    check((cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff, cfg.vocab_size,
           cfg.activation, cfg.norm) == GRANITE_FULL, f"{GRANITE_ARCH} is not at full width")
    model = LM(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(GRANITE_SEED), device="cuda")
    torch.cuda.synchronize()
    log(f"[granite] {GRANITE_ARCH} at full width, reduced to {GRANITE_LAYERS} of 88 layers (the "
        f"only cut: all 88 take 68 GB in bf16): {count_params(params) / 1e9:.3f} B params "
        f"({cfg.dtype}) in {time.perf_counter() - t0:.1f} s")
    pool_cfg = KVPoolConfig(
        num_blocks=NUM_BLOCKS, block_size=BLOCK, kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
        n_layers=cfg.n_layers, max_seqs=MAX_SEQS, max_blocks_per_seq=MAX_BLOCKS,
        blocks_per_arena=64, dtype=cfg.kv_cache_dtype,
    )
    engine = ServeEngine(model, params, pool_cfg, device="cuda", jit=jit)
    rng = np.random.default_rng(GRANITE_SEED)
    for rid in range(GRANITE_REQUESTS):
        n = int(rng.integers(64, 513))
        engine.submit(Request(rid=rid, prompt=rng.integers(0, cfg.vocab_size, n).tolist(),
                              max_new=GRANITE_NEW))
    return engine


def phase_granite_serve() -> dict:
    """The granite_34b serve eagerly and through the decode step's CUDA
    graphs, the launch counts zeroed just before each and read just after:
    every decode step's attention runs the paged kernel at a group of 48
    (48 x 128 values a group).  The ids must be equal between the two, and
    one graphed step at batch 8 bit-equal to eager (``graph_step_check``)."""
    res = {}
    for jit in (False, True):
        tag = "[granite " + ("graph" if jit else "eager") + "]"
        engine = granite_engine(jit)
        kernels.reset_launches()
        step_ms, step_check = drive(engine, tag, jit)
        launches = dict(kernels.launches)
        cfg = engine.cfg
        done = check_served(engine, tag, jit, launches, GRANITE_REQUESTS, GRANITE_NEW, step_check)
        key = "graph" if jit else "eager"
        res[key] = {"ids": {r.rid: list(r.out) for r in done}, "steps": engine.steps,
                    "mean_decode_step_ms": statistics.mean(step_ms),
                    "decode_steps_timed": len(step_ms),
                    "paged_launches": launches["paged_attention"],
                    "group_launches": launches["paged_attention:group"]}
        log(f"{tag} {GRANITE_REQUESTS} requests x {GRANITE_NEW} ids in {engine.steps} steps: mean "
            f"decode step {res[key]['mean_decode_step_ms']:.2f} ms over {len(step_ms)} steps (host "
            f"clock incl. sync; steps that prefill or capture left out); {launches['paged_attention']} "
            f"paged_attention launches, each at a group of {cfg.n_heads // cfg.n_kv_heads} x "
            f"{cfg.hd}" + (f"; {engine.graphs.captures} captures" if jit else ""))
        del engine
        torch.cuda.empty_cache()
    check(res["graph"]["ids"] == res["eager"]["ids"], "granite: graphed ids differ from eager")
    log(f"[granite] ids equal eager and graphed; decode step eager "
        f"{res['eager']['mean_decode_step_ms']:.2f} ms, graphed {res['graph']['mean_decode_step_ms']:.2f} ms")
    return res


# -- phase 4c: the MoE family on the serving main path ------------------------

def moe_engine(jit: bool, n_requests: int = MOE_REQUESTS, max_new: int = MOE_NEW,
               seed: int = MOE_SEED) -> ServeEngine:
    """granite_moe_3b_a800m at its full width and depth on the card: random
    bf16 weights from a seeded generator, the main path's pool shape with 8
    KV heads of 64, and ``n_requests`` submitted requests of 64-512 seeded
    prompt tokens and ``max_new`` new tokens each.  ``phase_moe_serve``
    drives it; ``scripts/torch_decode_profile.py --arch granite_moe_3b_a800m``
    profiles the same serve."""
    cfg = get_config(MOE_ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff,
           cfg.vocab_size, cfg.n_experts, cfg.experts_per_tok) == MOE_FULL,
          f"{MOE_ARCH} is not at full width and depth")
    model = LM(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    torch.cuda.synchronize()
    log(f"[moe] {MOE_ARCH} unreduced: {count_params(params) / 1e9:.3f} B params ({cfg.dtype}, "
        f"the vocab padded to {pad_vocab(cfg)}; the config's own count {cfg.n_params() / 1e9:.3f} "
        f"B) in {time.perf_counter() - t0:.1f} s")
    pool_cfg = KVPoolConfig(
        num_blocks=NUM_BLOCKS, block_size=BLOCK, kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
        n_layers=cfg.n_layers, max_seqs=MAX_SEQS, max_blocks_per_seq=MAX_BLOCKS,
        blocks_per_arena=64, dtype=cfg.kv_cache_dtype,
    )
    engine = ServeEngine(model, params, pool_cfg, device="cuda", jit=jit)
    log(f"[moe] K+V pool {2 * engine.pool.k.numel() * engine.pool.k.element_size() / 1e9:.2f} GB")
    rng = np.random.default_rng(seed)
    for rid in range(n_requests):
        n = int(rng.integers(64, 513))
        engine.submit(Request(rid=rid, prompt=rng.integers(0, cfg.vocab_size, n).tolist(),
                              max_new=max_new))
    return engine


def phase_moe_serve() -> dict:
    """The granite_moe_3b_a800m serve eagerly and through the decode step's
    CUDA graphs, with a fork part-way, the launch counts zeroed just before
    each and read just after: every layer runs the paged kernel at a group
    of 3 and the MoE block (routing, one scatter into the capacity buffer,
    three batched expert products, one gather).  The ids must be equal
    between the two, one graphed step at batch 8 bit-equal to eager, and no
    request rejected.  Each prompt's prefill is timed on its own.  The eager
    serve also counts the slots dropped over capacity, in prefill and in
    decode (at 8 slots every expert takes 8, more than a step can send it,
    so decode drops none); graphed, a count would be taken once, at capture."""
    res = {}
    for jit in (False, True):
        tag = "[moe " + ("graph" if jit else "eager") + "]"
        engine = moe_engine(jit)
        cfg = engine.cfg
        weight_bytes = sum(t.numel() * t.element_size() for t in leaves(engine.params))
        drops = {"prefill": [], "decode": []}
        phase, prefill_ms = ["decode"], []
        prefill, route = engine._prefill, MOE._route

        def timed_prefill(req):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            phase[0] = "prefill"
            try:
                return prefill(req)
            finally:
                phase[0] = "decode"
                torch.cuda.synchronize()
                prefill_ms.append((time.perf_counter() - t0) * 1e3)

        def counted(xt, router, cfg_):
            out = route(xt, router, cfg_)
            C = MOE.capacity(cfg_, xt.shape[0])
            drops[phase[0]].append((out[3] == cfg_.n_experts * C).sum())
            return out

        engine._prefill = timed_prefill
        if not jit:
            MOE._route = counted
        kernels.reset_launches()
        try:
            step_ms, step_check = drive(engine, tag, jit, fork=True)
        finally:
            MOE._route = route
            del engine._prefill
        launches = dict(kernels.launches)
        done = check_served(engine, tag, jit, launches, MOE_REQUESTS, MOE_NEW, step_check,
                            forked=True)
        key = "graph" if jit else "eager"
        res[key] = {"ids": {r.rid: list(r.out) for r in done}, "steps": engine.steps,
                    "mean_decode_step_ms": statistics.mean(step_ms),
                    "decode_steps_timed": len(step_ms),
                    "mean_prefill_ms": statistics.mean(prefill_ms), "prefills": len(prefill_ms),
                    "paged_launches": launches["paged_attention"],
                    "group_launches": launches["paged_attention:group"],
                    "block_copy_launches": launches["block_copy"],
                    "captures": engine.graphs.captures if jit else 0}
        log(f"{tag} {MOE_REQUESTS} requests x {MOE_NEW} ids in {engine.steps} steps: mean decode "
            f"step {res[key]['mean_decode_step_ms']:.2f} ms over {len(step_ms)} steps (host clock "
            f"incl. sync; steps that prefill or capture left out); mean prefill "
            f"{res[key]['mean_prefill_ms']:.2f} ms per prompt over {len(prefill_ms)} prompts; "
            f"{launches['paged_attention']} paged_attention launches at a group of "
            f"{cfg.n_heads // cfg.n_kv_heads} x {cfg.hd}, {launches['block_copy']} block_copy"
            + (f"; {engine.graphs.captures} captures" if jit else ""))
        if not jit:
            n_drop = {k: int(torch.stack(v).sum()) if v else 0 for k, v in drops.items()}
            calls = {k: len(v) for k, v in drops.items()}
            res["dropped"] = n_drop
            log(f"{tag} slots dropped over capacity: prefill {n_drop['prefill']} over "
                f"{calls['prefill']} layer calls (C = 1.25 x S x {cfg.experts_per_tok} / "
                f"{cfg.n_experts} for a prompt of S), decode {n_drop['decode']} over "
                f"{calls['decode']} (C = {MOE.capacity(cfg, MAX_SEQS)} at {MAX_SEQS} slots)")
            check(n_drop["decode"] == 0, f"{tag} decode dropped {n_drop['decode']} slots")
            res["floor_ms"] = weight_bytes / HBM_BYTES_PER_S * 1e3
            log(f"[moe] floor of the reference's math: the capacity buffer runs every expert, so "
                f"each decode step reads all {weight_bytes / 1e9:.2f} GB of weights: "
                f"{res['floor_ms']:.3f} ms at 3.35 TB/s")
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    check(res["graph"]["ids"] == res["eager"]["ids"], "moe: graphed ids differ from eager")
    check(res["graph"]["steps"] == res["eager"]["steps"], "moe: the graph changed the schedule")
    log(f"[moe] ids equal eager and graphed; decode step eager "
        f"{res['eager']['mean_decode_step_ms']:.2f} ms, graphed "
        f"{res['graph']['mean_decode_step_ms']:.2f} ms (floor {res['floor_ms']:.3f} ms)")
    return res


# -- phase 4d: the vlm family on the serving main path and in eval/prefill -----

def vlm_config():
    """qwen2_vl_72b at its full width, cut to ``VLM_LAYERS`` layers."""
    cfg = dataclasses.replace(get_config(VLM_ARCH), n_layers=VLM_LAYERS)
    check((cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff, cfg.vocab_size,
           cfg.rope, cfg.mrope_sections) == VLM_FULL, f"{VLM_ARCH} is not at full width")
    return cfg


def vlm_params(cfg, seed: int = VLM_SEED):
    t0 = time.perf_counter()
    params = LM(cfg).init(torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    torch.cuda.synchronize()
    log(f"[vlm] {VLM_ARCH} at full width, reduced to {cfg.n_layers} of 80 layers (the only cut: "
        f"all 80 take 145 GB in bf16): {count_params(params) / 1e9:.3f} B params ({cfg.dtype}; "
        f"the config's own count {cfg.n_params() / 1e9:.3f} B) in {time.perf_counter() - t0:.1f} s")
    return params


def vlm_engine(jit: bool, n_requests: int = VLM_REQUESTS, max_new: int = VLM_NEW,
               seed: int = VLM_SEED, params=None) -> ServeEngine:
    """qwen2_vl_72b at its full width and ``VLM_LAYERS`` layers on the card:
    ``params`` (or random bf16 weights from a seeded generator), the main
    path's pool shape with 8 KV heads of 128, and ``n_requests`` submitted
    requests of 64-512 seeded prompt tokens and ``max_new`` new tokens each.
    The engine gives every token (B, S, 3) M-RoPE positions.
    ``phase_vlm`` drives it; ``scripts/torch_decode_profile.py --arch
    qwen2_vl_72b`` profiles the same serve."""
    cfg = vlm_config()
    model = LM(cfg)
    if params is None:
        params = vlm_params(cfg, seed)
    pool_cfg = KVPoolConfig(
        num_blocks=NUM_BLOCKS, block_size=BLOCK, kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
        n_layers=cfg.n_layers, max_seqs=MAX_SEQS, max_blocks_per_seq=MAX_BLOCKS,
        blocks_per_arena=64, dtype=cfg.kv_cache_dtype,
    )
    engine = ServeEngine(model, params, pool_cfg, device="cuda", jit=jit)
    log(f"[vlm] K+V pool {2 * engine.pool.k.numel() * engine.pool.k.element_size() / 1e9:.2f} GB")
    rng = np.random.default_rng(seed)
    for rid in range(n_requests):
        n = int(rng.integers(64, 513))
        engine.submit(Request(rid=rid, prompt=rng.integers(0, cfg.vocab_size, n).tolist(),
                              max_new=max_new))
    return engine


def phase_vlm() -> dict:
    """qwen2_vl_72b at full width and ``VLM_LAYERS`` layers, one set of
    seeded weights for both parts, freed when the phase ends.

    (a) The serve eagerly and through the decode step's CUDA graphs, with a
    fork part-way, the launch counts zeroed just before each and read just
    after: every decode step's attention runs the paged kernel at a group
    of 8 x 128, on (B, 1, 3) positions.  The ids must be equal between the
    two, one graphed step at batch 8 bit-equal to eager, and paged launches
    layers x steps.  Each prompt's prefill is timed on its own.

    (b) ``phase_flash_forward`` on the same weights: eval and prefill at 4 x
    2048 tokens from ``make_batch`` (256 patch embeddings spliced over the
    first positions, (B, S, 3) positions), through the flash kernel's
    ``wgmma`` path at 64 query heads over 8 against the chunked path."""
    cfg = vlm_config()
    params = vlm_params(cfg)
    res = {}
    try:
        for jit in (False, True):
            tag = "[vlm " + ("graph" if jit else "eager") + "]"
            engine = vlm_engine(jit, params=params)
            prefill, prefill_ms = engine._prefill, []

            def timed_prefill(req):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                try:
                    return prefill(req)
                finally:
                    torch.cuda.synchronize()
                    prefill_ms.append((time.perf_counter() - t0) * 1e3)

            engine._prefill = timed_prefill
            kernels.reset_launches()
            try:
                step_ms, step_check = drive(engine, tag, jit, fork=True)
            finally:
                # the wrapper holds the engine's own bound method: a cycle
                # that would keep the engine (and the weights) until a
                # cycle collection
                del engine._prefill
            launches = dict(kernels.launches)
            done = check_served(engine, tag, jit, launches, VLM_REQUESTS, VLM_NEW, step_check,
                                forked=True)
            key = "graph" if jit else "eager"
            res[key] = {"ids": {r.rid: list(r.out) for r in done}, "steps": engine.steps,
                        "mean_decode_step_ms": statistics.mean(step_ms),
                        "decode_steps_timed": len(step_ms),
                        "mean_prefill_ms": statistics.mean(prefill_ms),
                        "mean_prompt_tokens": statistics.mean(len(r.prompt) for r in done),
                        "paged_launches": launches["paged_attention"],
                        "group_launches": launches["paged_attention:group"],
                        "block_copy_launches": launches["block_copy"],
                        "captures": engine.graphs.captures if jit else 0}
            log(f"{tag} {VLM_REQUESTS} requests x {VLM_NEW} ids in {engine.steps} steps: mean "
                f"decode step {res[key]['mean_decode_step_ms']:.2f} ms over {len(step_ms)} steps "
                f"(host clock incl. sync; steps that prefill or capture left out); mean prefill "
                f"{res[key]['mean_prefill_ms']:.2f} ms per prompt of "
                f"{res[key]['mean_prompt_tokens']:.0f} tokens on average; "
                f"{launches['paged_attention']} paged_attention launches at a group of "
                f"{cfg.n_heads // cfg.n_kv_heads} x {cfg.hd}, {launches['block_copy']} block_copy"
                + (f"; {engine.graphs.captures} captures" if jit else ""))
            del engine
            gc.collect()
            torch.cuda.empty_cache()
        check(res["graph"]["ids"] == res["eager"]["ids"], "vlm: graphed ids differ from eager")
        check(res["graph"]["steps"] == res["eager"]["steps"], "vlm: the graph changed the schedule")
        weight_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
        res["floor_ms"] = weight_bytes / HBM_BYTES_PER_S * 1e3
        log(f"[vlm] ids equal eager and graphed; decode step eager "
            f"{res['eager']['mean_decode_step_ms']:.2f} ms, graphed "
            f"{res['graph']['mean_decode_step_ms']:.2f} ms (floor {res['floor_ms']:.3f} ms: the "
            f"{weight_bytes / 1e9:.2f} GB of weights read once at 3.35 TB/s)")
        res["forward"] = phase_flash_forward(VLM_ARCH, params, n_layers=cfg.n_layers)
    finally:
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return res


# -- phase 4e: the encdec family at full width ----------------------------------

def encdec_decode(model, params, enc, tokens):
    """``decode_step`` as tests/test_split_cache.py drives the family: the
    encoder once over ``enc`` (B, Se, d), each decoder layer's cross K/V of
    its output written into the cache, the prompt ``tokens`` (B, P) through
    one step on the recent ring, then ``ENCDEC_NEW`` greedy one-token steps,
    the ring flushed whenever it is full.  The launch counts are zeroed just
    before the encoder and read after it and after the last step.  Returns
    the fed tokens (B, P + NEW), the last logits, the flushes, the
    encoder's and the steps' launches, and the host ms of the encoder, the
    prompt and each one-token step (each with ``synchronize``)."""
    B, P = tokens.shape
    cache = model.init_cache(B, P + ENCDEC_NEW, enc_len=enc.shape[1], recent_size=ENCDEC_RING,
                             device="cuda")
    ms, fed, flushes = {"steps": []}, [tokens], 0

    def step(tok, pos):
        nonlocal cache, flushes
        t0 = time.perf_counter()
        logits, cache = model.decode_step(params, {"tokens": tok, "positions": pos}, cache)
        if cache["len_rec"] == ENCDEC_RING:
            cache = model.flush_cache(cache)
            flushes += 1
        torch.cuda.synchronize()
        return logits, 1e3 * (time.perf_counter() - t0)

    torch.cuda.synchronize()
    kernels.reset_launches()
    with torch.no_grad():
        t0 = time.perf_counter()
        enc_out = model._run_encoder(params, enc)
        ck, cv = cache["layers"]["cross"]
        for li in range(model.cfg.n_layers):
            ck[li], cv[li] = model._encoder_kv(
                {k: t[li] for k, t in params["decoder"]["xattn"].items()}, enc_out)
        torch.cuda.synchronize()
        ms["encoder"] = 1e3 * (time.perf_counter() - t0)
        enc_launches = dict(kernels.launches)
        logits, ms["prompt"] = step(tokens, torch.arange(P, device="cuda").expand(B, P))
        for t in range(ENCDEC_NEW):
            fed.append(logits.argmax(-1)[:, None])
            logits, dt = step(fed[-1], torch.full((B, 1), P + t, device="cuda"))
            ms["steps"].append(dt)
    step_launches = {k: v - enc_launches[k] for k, v in kernels.launches.items()}
    return torch.cat(fed, 1), logits, flushes, enc_launches, step_launches, ms


def phase_encdec() -> dict:
    """seamless_m4t_medium unreduced (12 encoder and 12 decoder layers, d
    1024, 16 heads of 64, vocab 256206 padded to 258048), random bf16
    weights from a seeded generator, freed when the phase ends.

    (a) ``phase_flash_forward``: eval and ``prefill_logits`` at 4 x 2048
    tokens over 2048 frames from ``make_batch``, through the flash kernel
    (12 encoder, 12 causal decoder and 12 cross-attention launches a
    forward, each on the ``wgmma`` path) against the chunked path; and the
    encoder alone after its first layer, flash against chunked, within
    ``LOGITS_TOL`` of its scale.

    (b) ``encdec_decode`` over 8 sequences of 1024 seeded frames (numpy
    normal x 0.02, as tests/test_split_cache.py makes them), a 16-token
    prompt and 64 greedy steps through the flash kernel: the encoder's 12
    launches at 8 x 1024, then 12 a decode step (cross-attention, one
    query against the 1024 frames; the self-attention runs over the split
    cache, no kernel).  The last logits against ``prefill_logits`` over the
    same tokens at one decoder layer, within ``LOGITS_TOL`` of their scale
    (the split cache and the flash kernel round bf16 in different places),
    and the same with the weights cast to f32 (the kernel's ``tf32x3``
    path) within ``LOGITS_TOL_F32``; fault 4 makes the full-depth gap
    chaotic: printed only.

    (c) ``ENCDEC_TRAIN_STEPS`` steps of ``build_train_step`` (chunked
    attention, remat full, AdamW) on ``make_batch`` batches of 8 x 128
    tokens over 128 frames: every loss finite."""
    cfg = get_config(ENCDEC_ARCH)
    check((cfg.enc_layers, cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
           cfg.d_ff, cfg.vocab_size, cfg.activation, cfg.norm, cfg.rope) == ENCDEC_FULL,
          f"{ENCDEC_ARCH} is not at full width")
    t0 = time.perf_counter()
    params = LM(cfg).init(torch.Generator(device="cuda").manual_seed(ENCDEC_SEED), device="cuda")
    torch.cuda.synchronize()
    weight_gb = sum(t.numel() * t.element_size() for t in leaves(params)) / 1e9
    log(f"[encdec] {ENCDEC_ARCH} unreduced ({cfg.enc_layers} encoder + {cfg.n_layers} decoder "
        f"layers): {count_params(params) / 1e9:.3f} B params, {weight_gb:.2f} GB ({cfg.dtype}; "
        f"the vocab padded to {pad_vocab(cfg)}; the config's own count "
        f"{cfg.n_params() / 1e9:.3f} B) in {time.perf_counter() - t0:.1f} s")
    res = {"weight_gb": weight_gb}
    try:
        res["forward"] = phase_flash_forward(ENCDEC_ARCH, params)
        cfg1, params1 = _first_layers(cfg, params, 1)
        enc = make_batch(cfg, RunShape("prefill", 2048, 4, "prefill"), seed=1)["enc_embeds"]
        with torch.no_grad():
            e = {impl: LM(cfg1, attn_impl=impl)._run_encoder(params1, enc).float()
                 for impl in ("pallas", "chunked")}
        err, scale = (e["pallas"] - e["chunked"]).abs().max().item(), e["chunked"].abs().max().item()
        log(f"[encdec] encoder output after its first layer (4 x 2048 frames): flash vs chunked "
            f"max abs diff {err:.4f} of scale {scale:.3f} (tol {LOGITS_TOL:g} of scale)")
        check(err < LOGITS_TOL * scale, "encdec first encoder layer: flash vs chunked over tolerance")
        res["encoder_layer1"] = {"err": err, "scale": scale}

        rng = np.random.default_rng(ENCDEC_SEED)
        frames = rng.normal(size=(ENCDEC_BATCH, ENCDEC_FRAMES, cfg.d_model)) * 0.02
        frames = torch.from_numpy(frames.astype(np.float32)).to("cuda", torch.bfloat16)
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (ENCDEC_BATCH, ENCDEC_PROMPT)))
        prompt = prompt.cuda()
        res["decode"] = {}
        for depth, dtype in ((1, "bfloat16"), (1, "float32"), (cfg.n_layers, "bfloat16")):
            cfg_d, params_d = _first_layers(cfg, params, depth, encoder=False)
            if dtype == "float32":
                cfg_d = dataclasses.replace(cfg_d, dtype=dtype, kv_cache_dtype=dtype)
                params_d = tree_map(lambda t: t.float(), params_d)
            path = "wgmma" if dtype == "bfloat16" else "tf32x3"
            model = LM(cfg_d, attn_impl="pallas")
            fed, logits, flushes, enc_l, step_l, ms = encdec_decode(model, params_d, frames, prompt)
            n_steps = ENCDEC_NEW + 1
            check(flushes >= 2, f"encdec decode at {depth} layers: {flushes} flushes")
            check(enc_l["flash_attention"] == enc_l[f"flash_attention:{path}"] == cfg.enc_layers,
                  f"encdec encoder: {enc_l['flash_attention']} flash launches "
                  f"({enc_l[f'flash_attention:{path}']} {path}), not {cfg.enc_layers}")
            check(step_l["flash_attention"] == step_l[f"flash_attention:{path}"] == depth * n_steps,
                  f"encdec decode: {step_l['flash_attention']} flash launches "
                  f"({step_l[f'flash_attention:{path}']} {path}) in {n_steps} steps, not {depth} "
                  f"a step")
            check(bool(torch.isfinite(logits).all()), "encdec decode logits not finite")
            with torch.no_grad():
                full = model.prefill_logits(params_d, {
                    "tokens": fed, "enc_embeds": frames,
                    "positions": torch.arange(fed.shape[1], device="cuda").expand(fed.shape)})
            gap, scale = (logits.float() - full.float()).abs().max().item(), full.float().abs().max().item()
            tol = None if depth > 1 else LOGITS_TOL if dtype == "bfloat16" else LOGITS_TOL_F32
            r = res["decode"][depth, dtype] = {
                "gap": gap, "scale": scale, "tol": tol, "flushes": flushes, "ms": ms,
                "enc_launches": enc_l["flash_attention"],
                "step_launches": step_l["flash_attention"],
                "argmax_equal": int((logits.argmax(-1) == full.argmax(-1)).sum())}
            log(f"[encdec decode] {depth} decoder layer(s), {dtype}, {ENCDEC_BATCH} sequences over "
                f"{ENCDEC_FRAMES} frames: encoder {ms['encoder']:.1f} ms ({enc_l['flash_attention']}"
                f" flash launches), prompt of {ENCDEC_PROMPT} {ms['prompt']:.1f} ms, mean decode "
                f"step {statistics.mean(ms['steps']):.2f} ms over {ENCDEC_NEW} steps (host clock "
                f"incl. sync, eager), {flushes} flushes, {step_l['flash_attention']} flash launches "
                f"in {n_steps} steps (all {path}); last logits vs prefill_logits over the same "
                f"{fed.shape[1]} tokens: max abs diff {gap:.3e} of scale {scale:.3f}, argmax equal "
                f"{r['argmax_equal']}/{ENCDEC_BATCH}"
                + (f" (tol {tol:g} of scale)" if tol else " (reported only)"))
            check(tol is None or gap < tol * scale,
                  f"encdec decode at one decoder layer ({dtype}): last logits vs prefill over "
                  f"tolerance")
            del params_d, model
            torch.cuda.empty_cache()

        model = LM(cfg, attn_impl="chunked", remat="full")
        step_fn = build_train_step(model, AdamWConfig(lr=3e-3, warmup_steps=2,
                                                      total_steps=ENCDEC_TRAIN_STEPS))
        opt_state = init_opt_state(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        losses, step_ms = [], []
        for i in range(ENCDEC_TRAIN_STEPS):
            batch = make_batch(cfg, RunShape("train", 128, 8, "train"), seed=i)
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            losses.append(float(metrics["loss"]))
            step_ms.append(1e3 * (time.perf_counter() - t0))
            check(math.isfinite(losses[-1]) and math.isfinite(float(metrics["grad_norm"])),
                  f"encdec train step {i}: loss {losses[-1]}")
        check(kernels.launches["flash_attention"] == 0, "encdec training launched flash")
        res["train"] = {"losses": losses, "step_ms": step_ms,
                        "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        fw = res["forward"]
        d = res["decode"][cfg.n_layers, "bfloat16"]
        log(f"[encdec train] {ENCDEC_TRAIN_STEPS} steps (8 x 128 tokens over 128 frames, bf16, "
            f"chunked attention, remat full, AdamW): losses {' '.join(f'{x:.4f}' for x in losses)}; "
            f"step ms {' '.join(f'{x:.1f}' for x in step_ms)} (host clock incl. the loss's "
            f"sync; step 0 includes warm-up); peak {res['train']['peak_gb']:.1f} GB")
        log(f"[encdec] summary: eval {fw['eval_pallas_ms']:.1f} ms flash / "
            f"{fw['eval_chunked_ms']:.1f} chunked, prefill {fw['prefill_pallas_ms']:.1f} / "
            f"{fw['prefill_chunked_ms']:.1f} at 4 x 2048; encoder {d['ms']['encoder']:.1f} ms at "
            f"{ENCDEC_BATCH} x {ENCDEC_FRAMES}; prompt {d['ms']['prompt']:.1f} ms; decode step "
            f"{statistics.mean(d['ms']['steps']):.2f} ms; train step "
            f"{statistics.mean(step_ms[1:]):.1f} ms (steps 1-{ENCDEC_TRAIN_STEPS - 1}); "
            f"flash launches: {fw['launches_total']} in eval + prefill, {d['enc_launches']} "
            f"encoder + {d['step_launches']} decode, all on wgmma")
        res["enc_launches"], res["step_launches"] = d["enc_launches"], d["step_launches"]
        res["launches_total"] = fw["launches_total"] + d["enc_launches"] + d["step_launches"]
    finally:
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return res


# -- phase 5 -----------------------------------------------------------------

def phase_small_vs_cpu() -> None:
    """The smoke stablelm_1_6b and granite_moe_1b_a400m (f32) served on the
    card and on the CPU from the same weights: 6 requests x 8 ids, equal."""
    for arch in ("stablelm_1_6b", "granite_moe_1b_a400m"):
        cfg = get_config(arch).smoke()
        model = LM(cfg)
        tree = params_to_numpy(model.init(torch.Generator().manual_seed(1), device="cpu"))
        rng = np.random.default_rng(3)
        prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(4, 40))).tolist()
                   for _ in range(6)]
        outs = {}
        for dev in ("cuda", "cpu"):
            pool_cfg = KVPoolConfig(
                num_blocks=64, block_size=8, kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                n_layers=cfg.n_layers, max_seqs=3, max_blocks_per_seq=16,
                blocks_per_arena=16, dtype="float32")
            eng = ServeEngine(model, params_from_numpy(model, tree, device=dev), pool_cfg,
                              device=dev)
            for rid, p in enumerate(prompts):
                eng.submit(Request(rid=rid, prompt=p, max_new=8))
            outs[dev] = {r.rid: r.out for r in eng.run()}
        check(len(outs["cuda"]) == 6 and outs["cuda"] == outs["cpu"],
              f"{arch} smoke: card and CPU ids differ: {outs}")
        log(f"[small] {arch} smoke config, 6 requests x 8 ids: card ids == CPU ids")


def phase_smoke_flash_vs_cpu() -> dict:
    """stablelm_1_6b and granite_34b at ``.smoke()`` (f32, head width 32;
    granite's heads MQA 4/1) through the flash kernel (``attn_impl="pallas"``):
    the eval loss (``build_eval_step``) and ``prefill_logits`` at 2 x 96
    tokens on the card against the same calls on the CPU (the kernel's plain
    version), from the same weights, within ``SMOKE_LOGITS_TOL`` of their
    scale, the launch counts zeroed just before each call: one flash launch
    a layer on the card, each on the ``tf32x3`` path, none on the CPU.  The
    same calls through ``attn_impl="chunked"`` (no kernel) on both are
    reported beside them: the card's own float32 rounding, the control."""
    res = {}
    for arch in ("stablelm_1_6b", "granite_34b"):
        cfg = get_config(arch).smoke()
        check(cfg.dtype == "float32" and cfg.hd % 8 == 0, f"{arch} smoke: {cfg.dtype}, hd {cfg.hd}")
        tree = params_to_numpy(LM(cfg).init(torch.Generator().manual_seed(7), device="cpu"))
        batch = synth_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=96, batch_per_shard=2),
                            0, 0)
        out = {}
        for impl in ("pallas", "chunked"):
            model = LM(cfg, attn_impl=impl)
            for dev in ("cuda", "cpu"):
                params = params_from_numpy(model, tree, device=dev)
                full = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
                prompts = {k: full[k] for k in ("tokens", "positions")}
                for what, fn, arg in (("eval loss", build_eval_step(model), full),
                                      ("prefill logits", model.prefill_logits, prompts)):
                    kernels.reset_launches()
                    with torch.no_grad():
                        y = fn(params, arg)
                    n = kernels.launches["flash_attention"]
                    on_path = kernels.launches["flash_attention:tf32x3"]
                    want = cfg.n_layers if (dev, impl) == ("cuda", "pallas") else 0
                    check(n == want and on_path == want, f"{arch} smoke {what} ({impl}) on {dev}: "
                          f"{n} flash launches ({on_path} tf32x3), not {want}")
                    out[impl, dev, what] = y.float().cpu()
        for what in ("eval loss", "prefill logits"):
            a, b = out["pallas", "cuda", what], out["pallas", "cpu", what]
            check(a.shape == b.shape and bool(torch.isfinite(a).all()), f"{arch} smoke {what}")
            err, scale = (a - b).abs().max().item(), b.abs().max().item()
            ctrl = (out["chunked", "cuda", what] - out["chunked", "cpu", what]).abs().max().item()
            res[f"{arch} {what}"] = err
            log(f"[smoke-flash] {arch} smoke (MQA {cfg.n_heads}/{cfg.n_kv_heads}, head width "
                f"{cfg.hd}, f32) {what}, flash kernel (tf32x3) on the card vs the CPU: max abs diff "
                f"{err:.3e} of scale {scale:.3f} (tol {SMOKE_LOGITS_TOL:g} of max(1, scale)); "
                f"chunked on the card vs the CPU {ctrl:.3e}; {cfg.n_layers} launches a forward")
            check(err < SMOKE_LOGITS_TOL * max(1.0, scale), f"{arch} smoke {what}: over tolerance")
    return res


# -- phase 5b: the training path at full width -------------------------------

def phase_train(ckpt_root: str) -> dict:
    """``python -m repro_torch.launch.train --arch stablelm_1_6b --steps 20
    --full`` in-process: the full-width model, bf16, remat="full", chunked
    attention, seq 128 x batch 8, lr 3e-3, warmup 5; the trainer writes its
    final checkpoint (params and AdamW moments) under ``ckpt_root``."""
    cfg = get_config("stablelm_1_6b")
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.hd, cfg.d_ff, cfg.vocab_size)
          == (N_LAYERS, 2048, HEADS, HEAD_DIM, 5632, 100352), "stablelm_1_6b is not at full width")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = launch_train.main(["--arch", "stablelm_1_6b", "--full", "--steps", "20",
                             "--ckpt-dir", ckpt_root])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    hist = out["history"]
    check([s for s, _ in hist] == list(range(20)), f"trained steps {[s for s, _ in hist]}")
    for s, m in hist:
        check(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]),
              f"step {s}: loss {m['loss']} grad norm {m['grad_norm']}")
    losses = [m["loss"] for _, m in hist]
    step_s = [m["step_time"] for _, m in hist[1:]]      # step 0 includes warm-up
    ckpt_dir = Path(ckpt_root) / "stablelm_1_6b" / "step_00000020"
    ckpt_gb = sum(f.stat().st_size for f in ckpt_dir.iterdir()) / 1e9
    check((ckpt_dir / "manifest.json").exists() and ckpt_gb > 15, f"final checkpoint {ckpt_gb} GB")
    res = {
        "losses": losses, "grad_norms": [m["grad_norm"] for _, m in hist],
        "mean_step_ms": 1e3 * statistics.mean(step_s),
        "tokens_per_s": 128 * 8 / statistics.mean(step_s),
        "run_s": run_s, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "checkpoint_gb": ckpt_gb, "launches": launches,
    }
    log(f"[train] loss curve: {' '.join(f'{x:.4f}' for x in losses)}")
    lrs = " ".join(f"{m['lr']:.2e}" for _, m in hist)
    log(f"[train] lr: {lrs}")
    log(f"[train] grad norms: {' '.join(f'{x:.3f}' for x in res['grad_norms'])}")
    log(f"[train] 20 full-width steps (seq 128 x batch 8, bf16, remat full): mean step "
        f"{res['mean_step_ms']:.1f} ms (steps 1-19, host clock incl. sync), "
        f"{res['tokens_per_s']:.0f} tokens/s; peak {res['peak_gb']:.1f} GB; run {run_s:.1f} s "
        f"incl. init and a {ckpt_gb:.1f} GB final checkpoint; kernel launches {launches}")
    res["params"] = out["params"]
    return res


def _forward(model, what, params, arg):
    """One no-grad forward (``eval`` or ``prefill``), timed on the host clock
    with ``synchronize``, the launch counts zeroed just before it; returns
    (output, ms, flash launches)."""
    fn = build_eval_step(model) if what == "eval" else model.prefill_logits
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        y = fn(params, arg)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    check(bool(torch.isfinite(y).all()), f"{what} ({model.attn_impl}): not finite")
    return y, ms, kernels.launches["flash_attention"]


def _first_layers(cfg, params, n, encoder: bool = True):
    """The model of the first ``n`` layers of ``params`` (views, no copy); in
    the encdec family the first ``n`` decoder layers and, with ``encoder``,
    the first ``n`` encoder layers."""
    cut = {"layers", "decoder"} | ({"encoder"} if encoder else set())
    params = dict(params, **{g: tree_map(lambda t: t[:n], params[g]) for g in cut & set(params)})
    cfg = dataclasses.replace(cfg, n_layers=n)
    if cfg.is_encdec and encoder:
        cfg = dataclasses.replace(cfg, enc_layers=n)
    return cfg, params


def flash_per_forward(cfg) -> int:
    """Flash launches in one forward with ``attn_impl="pallas"``: one a
    layer, and in the encdec family one an encoder layer and two (self and
    cross) a decoder layer."""
    return cfg.enc_layers + 2 * cfg.n_layers if cfg.is_encdec else cfg.n_layers


def phase_flash_forward(arch: str, params, dtype: str = "bfloat16",
                        n_layers: int = None) -> dict:
    """The full-width weights of ``arch`` evaluated (``build_eval_step``)
    and prefilled (``prefill_logits``) at 4 x 2048 tokens through the flash
    kernel (``attn_impl="pallas"``), each forward with the launch counts
    zeroed just before it and read just after (one launch a layer, each on
    the path of ``dtype``: ``wgmma`` in bf16, ``tf32x3`` in f32, where the
    config's dtype is set to float32 and ``params`` are f32); held against
    ``attn_impl="chunked"`` on the same weights.

    Under the reference's init rule the full-width models are chaotic in
    depth: two plain attention paths that differ only in float rounding give
    full-depth prefill logits O(1) apart (the reference too: ROADMAP.md,
    faults).  So the full-depth eval loss, an average over 8192 positions,
    is held to ``EVAL_LOSS_RTOL``; the prefill logits of the first layer of
    the same weights, where rounding is not yet amplified, to ``LOGITS_TOL``
    of their scale; and the logits after 4 layers and at full depth are
    reported beside the spread of the two plain paths (naive against
    chunked).  In f32 the first layer's logits are held to
    ``LOGITS_TOL_F32`` of their scale.  ``n_layers`` cuts the config to the
    depth of ``params``.  The batches are ``synth_batch``'s, or for a vision
    config ``make_batch``'s (patch embeddings over the first 256 positions,
    M-RoPE positions (B, S, 3)), and for an encdec config ``make_batch``'s
    (frame embeddings (B, S, d); a depth cut cuts the encoder and the
    decoder alike)."""
    cfg = dataclasses.replace(get_config(arch), dtype=dtype)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    path = "wgmma" if dtype == "bfloat16" else "tf32x3"
    logits_tol = LOGITS_TOL if dtype == "bfloat16" else LOGITS_TOL_F32
    tag = f"[flash-path {arch}" + ("" if dtype == "bfloat16" else f" {dtype}") + "]"
    B, S = FLASH_MAIN["B"], FLASH_MAIN["Sq"]
    if cfg.frontend == "vision" or cfg.is_encdec:
        batch = make_batch(cfg, RunShape("eval", S, B, "train"), seed=0)
        prompts = make_batch(cfg, RunShape("prefill", S, B, "prefill"), seed=1)
        if cfg.is_encdec:
            check(tuple(batch["enc_embeds"].shape) == tuple(prompts["enc_embeds"].shape)
                  == (B, S, cfg.d_model), "encdec batch layout")
        else:
            check(tuple(batch["patch_embeds"].shape) == (B, 256, cfg.d_model)
                  and tuple(batch["positions"].shape) == (B, S, 3), "vlm batch layout")
    else:
        data = DataConfig(vocab_size=cfg.vocab_size, seq_len=S, batch_per_shard=B)
        batch = {k: torch.from_numpy(v).cuda() for k, v in synth_batch(data, 0, 0).items()}
        prompts = {"tokens": torch.from_numpy(synth_batch(data, 1, 0)["tokens"]).cuda(),
                   "positions": batch["positions"]}
    res = {"launches": {}, "prefill": {}}
    loss = {}

    def launched(what, impl, n, layers):
        want = layers if impl == "pallas" else 0
        on_path = kernels.launches[f"flash_attention:{path}"]
        check(n == want and on_path == want,
              f"{what} ({impl}): {n} flash_attention launches ({on_path} {path}), not {want}")

    for impl in ("pallas", "chunked"):
        y, res[f"eval_{impl}_ms"], n = _forward(LM(cfg, attn_impl=impl), "eval", params, batch)
        launched("eval", impl, n, flash_per_forward(cfg))
        res["launches"][f"eval_{impl}"] = n
        loss[impl] = float(y)
    res["eval_loss"] = {**loss, "rel_diff": abs(loss["pallas"] - loss["chunked"]) / abs(loss["chunked"])}
    for depth in (1, 4, cfg.n_layers):
        cfg_d, params_d = _first_layers(cfg, params, depth)
        z = {}
        for impl in ("pallas", "chunked", "naive"):
            y, ms, n = _forward(LM(cfg_d, attn_impl=impl), "prefill", params_d, prompts)
            launched(f"prefill, {depth} layers", impl, n, flash_per_forward(cfg_d))
            check(tuple(y.shape) == (FLASH_MAIN["B"], pad_vocab(cfg)), f"prefill logits {tuple(y.shape)}")
            z[impl] = y.float()
            if depth == cfg.n_layers:
                res[f"prefill_{impl}_ms"] = ms
                res["launches"][f"prefill_{impl}"] = n
        res["prefill"][depth] = {
            "flash_vs_chunked": (z["pallas"] - z["chunked"]).abs().max().item(),
            "naive_vs_chunked": (z["naive"] - z["chunked"]).abs().max().item(),
            "scale": z["chunked"].abs().max().item(),
            "argmax_equal": int((z["pallas"].argmax(-1) == z["chunked"].argmax(-1)).sum()),
        }
    el, pf = res["eval_loss"], res["prefill"]
    log(f"{tag} eval loss at 4 x 2048 ({cfg.n_layers} layers): flash {el['pallas']:.5f}, "
        f"chunked {el['chunked']:.5f} (rel diff {el['rel_diff']:.2e}, tol {EVAL_LOSS_RTOL:g}); "
        f"{flash_per_forward(cfg)} flash launches per forward, all on the {path} path")
    for depth, r in pf.items():
        log(f"{tag} prefill logits after {depth} layer(s): flash vs chunked max abs diff "
            f"{r['flash_vs_chunked']:.4f}, naive vs chunked {r['naive_vs_chunked']:.4f}, of scale "
            f"{r['scale']:.3f}; argmax equal {r['argmax_equal']}/{FLASH_MAIN['B']}"
            + (f" (tol {logits_tol:g} of scale)" if depth == 1 else ""))
    log(f"{tag} forward ms (host clock incl. sync): eval flash {res['eval_pallas_ms']:.1f}, "
        f"chunked {res['eval_chunked_ms']:.1f}; prefill flash {res['prefill_pallas_ms']:.1f}, "
        f"chunked {res['prefill_chunked_ms']:.1f}, naive {res['prefill_naive_ms']:.1f}")
    check(el["rel_diff"] < EVAL_LOSS_RTOL, f"{arch} eval loss: flash vs chunked over tolerance")
    check(pf[1]["flash_vs_chunked"] < logits_tol * pf[1]["scale"],
          f"{arch} 1-layer prefill logits: flash vs chunked over tolerance")
    res["launches_total"] = res["launches"]["eval_pallas"] + res["launches"]["prefill_pallas"]
    return res


def phase_gqa_forward() -> dict:
    """``phase_flash_forward`` on the full-width mistral_nemo_12b (GQA 32/8,
    head width 128: the flash kernel's D = 128 instance), its weights drawn
    on the card from a seeded generator and freed when the phase ends."""
    cfg = get_config(GQA_ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff, cfg.vocab_size)
          == GQA_FULL, f"{GQA_ARCH} is not at full width")
    t0 = time.perf_counter()
    params = LM(cfg).init(torch.Generator(device="cuda").manual_seed(GQA_SEED), device="cuda")
    torch.cuda.synchronize()
    log(f"[{GQA_ARCH}] {count_params(params) / 1e9:.3f} B params ({cfg.dtype}) in "
        f"{time.perf_counter() - t0:.1f} s")
    try:
        return phase_flash_forward(GQA_ARCH, params)
    finally:
        del params
        torch.cuda.empty_cache()


def phase_small_train_vs_cpu(ckpt_root: str) -> dict:
    """5 steps of the smoke config through the ``Trainer`` on the card and on
    the CPU from the same weights (drawn once, bridged to each device), f32;
    the card's run also checkpoints at step 3 and a second trainer resumes
    from it."""
    cfg = get_config("stablelm_1_6b").smoke()
    model = LM(cfg, attn_impl="chunked", remat=None)
    tree = params_to_numpy(model.init(torch.Generator().manual_seed(2), device="cpu"))
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=128, batch_per_shard=8)
    ocfg = AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=20)
    losses = {}
    for dev in ("cuda", "cpu"):
        tcfg = TrainerConfig(total_steps=5, ckpt_every=3, ckpt_dir=f"{ckpt_root}/small-{dev}",
                             log_every=1000)
        out = Trainer(model, data, ocfg, tcfg, device=dev, log=lambda s: None,
                      init_params=lambda: params_from_numpy(model, tree, device=dev)).run()
        losses[dev] = [m["loss"] for _, m in out["history"]]
    tcfg = TrainerConfig(total_steps=7, ckpt_every=100, ckpt_dir=f"{ckpt_root}/small-cuda",
                         log_every=1000)
    resumed = Trainer(model, data, ocfg, tcfg, device="cuda", log=lambda s: None,
                      init_params=lambda: params_from_numpy(model, tree, device="cuda")).run()
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"])]
    log(f"[small-train] smoke config, 5 steps: card {['%.6f' % x for x in losses['cuda']]}, "
        f"CPU {['%.6f' % x for x in losses['cpu']]}; relative diffs {['%.1e' % x for x in rel]} "
        f"(tol {SMALL_TRAIN_TOL[0]:g} at step 1, {SMALL_TRAIN_TOL[1]:g} after); resumed at step 5 "
        f"to 7 on the card: steps {[s for s, _ in resumed['history']]}")
    check(len(rel) == 5 and rel[0] < SMALL_TRAIN_TOL[0] and max(rel[1:]) < SMALL_TRAIN_TOL[1],
          f"smoke training: card and CPU losses differ {rel}")
    check([s for s, _ in resumed["history"]] == [5, 6], "the card trainer did not resume at step 5")
    return {"card": losses["cuda"], "cpu": losses["cpu"], "rel": rel}


# -- phase 5d: distribution on a one-rank NCCL mesh at full width --------------

def step_close(g_mesh, g, p_mesh, p, lr: float, wd: float) -> dict:
    """tests/test_torch_dist.py's rule for one step under a mesh against one
    without: each gradient within 1e-3 of its leaf's largest; the params
    after the step within 1e-3 of their leaf's largest where the gradient is
    resolved (at least 1e-3 of its leaf's largest), within 2 lr (1 + wd)
    elsewhere (AdamW's first step moves an element by about lr whatever its
    gradient's size).  Returns the worst of each, relative."""
    worst = {"grad": 0.0, "param_resolved": 0.0, "param_abs": 0.0}
    for gm, gl, pm, pl in zip(leaves(g_mesh), leaves(g), leaves(p_mesh), leaves(p), strict=True):
        gm, gl, pm, pl = (t.full_tensor() if hasattr(t, "full_tensor") else t
                          for t in (gm, gl, pm, pl))
        gl, gm, pl, pm = gl.float(), gm.float(), pl.float(), pm.float()
        g_max = max(gl.abs().max().item(), 1e-3)
        worst["grad"] = max(worst["grad"], (gm - gl).abs().max().item() / g_max)
        diff = (pm - pl).abs()
        resolved = gl.abs() >= 1e-3 * g_max
        if resolved.any():
            worst["param_resolved"] = max(worst["param_resolved"], diff[resolved].max().item()
                                          / max(pl.abs().max().item(), 1e-3))
        worst["param_abs"] = max(worst["param_abs"], diff.max().item())
    check(worst["grad"] <= 1e-3 and worst["param_resolved"] <= 1e-3
          and worst["param_abs"] <= 2 * lr * (1 + wd), f"mesh step vs no mesh: {worst}")
    return worst


def timed_step(step_fn, params, batch, reps: int) -> list:
    """Host ms of ``reps`` steps of ``step_fn`` from the same params and a
    fresh optimizer state (the step is functional), each synchronised."""
    out = []
    for _ in range(reps):
        opt = init_opt_state(params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_fn(params, opt, batch)
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def phase_dist() -> dict:
    """The port's distribution on DTensor at full width on one card: a
    one-rank NCCL process group (rendezvous file under ``build/``, no
    network) and a (1, 1) ("data", "model") mesh.  granite_moe_1b_a400m
    unreduced, seeded bf16 weights: (a) layer 0's MoE layer through its
    sharded path (shard_map, FSDP gather, the "model" psum) against the
    local path on the same 8 x 128 tokens; (b) one train step (chunked
    attention, remat full, AdamW) on launch.train's completed batch of 8 x
    128 tokens with the params, moments and batch as DTensors, against the
    same step without the mesh, from the same weights: the loss within
    DIST_LOSS_RTOL, gradients and params by ``step_close``; the collectives
    of one step counted by ``CommDebugMode``; (c) ``compressed_psum`` over
    NCCL within 1/100 of the input's largest value.  The group is destroyed
    when the phase ends, whether its checks pass or not."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh_compat

    rdv = ROOT / "build" / f"dist_rdv_{os.getpid()}"
    rdv.parent.mkdir(exist_ok=True)
    rdv.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{rdv}", rank=0, world_size=1)
    try:
        return _dist_checks(make_mesh_compat((1, 1), ("data", "model"), "cuda"))
    finally:
        dist.destroy_process_group()
        rdv.unlink(missing_ok=True)


def _dist_checks(mesh) -> dict:
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.dist import sharding as shd
    from repro_torch.optim.compression import compressed_psum

    cfg = get_config(DIST_ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff,
           cfg.vocab_size, cfg.n_experts, cfg.experts_per_tok) == DIST_FULL,
          f"{DIST_ARCH} is not unreduced")
    model = LM(cfg, attn_impl="chunked", remat="full")
    gen = torch.Generator(device="cuda").manual_seed(DIST_SEED)
    params = model.init(gen, device="cuda")
    res = {"params_b": count_params(params) / 1e9}
    log(f"[dist] {DIST_ARCH} unreduced: {res['params_b']:.3f} B params ({cfg.dtype}); mesh "
        f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} on NCCL, world size 1")
    try:
        # (a) the MoE layer
        lp = layer_params(params["layers"], 0)["moe"]
        x = torch.randn(8, 128, cfg.d_model, generator=gen, device="cuda").to(model.dtype)
        with torch.no_grad():
            out_l, aux_l = MOE.apply_moe(lp, cfg, x)
            specs = spec_tree(MOE.moe_defs(cfg))
            with shd.use_mesh(mesh), shd.spmd():
                lp_m = shd.device_put(lp, shd.shardings_for(specs, lp, mesh))
                x_m = distribute_tensor(x, mesh, shd.placements_for(shd.P("data"), mesh))
                out_m, aux_m = MOE.apply_moe(lp_m, cfg, x_m)
                out_m, aux_m = out_m.full_tensor(), aux_m.full_tensor()
        err = (out_m.float() - out_l.float()).abs().max().item()
        scale = out_l.float().abs().max().item()
        res["moe"] = {"bit_equal": bool(torch.equal(out_m, out_l) and torch.equal(aux_m, aux_l)),
                      "max_abs_err": err, "aux_err": abs(aux_m.item() - aux_l.item())}
        log(f"[dist] layer 0's MoE layer (8 x 128 tokens, {cfg.n_experts} experts, top-"
            f"{cfg.experts_per_tok}) under the mesh vs local: bit-equal {res['moe']['bit_equal']}, "
            f"max abs diff {err:.3e} of scale {scale:.3f}, aux diff {res['moe']['aux_err']:.3e} "
            f"(tol 1e-5 of max(1, scale))")
        check(err <= 1e-5 * max(1.0, scale) and res["moe"]["aux_err"] <= 1e-5,
              "the MoE layer under the mesh differs from the local path")

        # (b) one train step with the mesh and without
        data = DataConfig(vocab_size=cfg.vocab_size, seq_len=128, batch_per_shard=8)
        batch = {k: torch.from_numpy(v).cuda() for k, v in complete_batch(
            cfg, data.seed, synth_batch(data, 0, 0), 0, 0).items()}
        ocfg = AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=10)
        step_fn = build_train_step(model, ocfg)
        loss_l, grads_l = value_and_grad(model.train_loss, params, batch)
        after_l, _, _ = step_fn(params, init_opt_state(params), batch)
        ms_l = timed_step(step_fn, params, batch, 3)
        del grads_l
        with shd.use_mesh(mesh):
            params_m = shd.device_put(params, shd.shardings_for(model.param_specs(), params, mesh))
            batch_m = shd.device_put(batch, batch_shardings(batch, mesh))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with shd.spmd():
                loss_m, grads_m = value_and_grad(model.train_loss, params_m, batch_m)
            with CommDebugMode() as comm:
                after_m, _, metrics = step_fn(params_m, init_opt_state(params_m), batch_m)
            ms_m = timed_step(step_fn, params_m, batch_m, 3)
            peak = torch.cuda.max_memory_allocated() / 1e9
        check(all(isinstance(t, DTensor) for t in leaves(after_m)), "mesh step left plain tensors")
        loss_l, loss_m = loss_l.item(), loss_m.full_tensor().item()
        rel = abs(loss_m - loss_l) / abs(loss_l)
        check(math.isfinite(loss_m) and rel <= DIST_LOSS_RTOL,
              f"mesh loss {loss_m} vs {loss_l} without (relative {rel:.2e})")
        _, grads_l = value_and_grad(model.train_loss, params, batch)
        worst = step_close(grads_m, grads_l, after_m, after_l, ocfg.lr, ocfg.weight_decay)
        counts = {str(k).split(".")[-1]: v for k, v in comm.get_comm_counts().items()}
        res["step"] = {"loss": loss_l, "loss_mesh": loss_m, "rel": rel, "worst": worst,
                       "ms": ms_l, "ms_mesh": ms_m, "peak_gb": peak,
                       "collectives": comm.get_total_counts(), "by_op": counts}
        log(f"[dist] train step (8 x 128 tokens, chunked attention, remat full, AdamW): loss "
            f"{loss_m:.6f} under the mesh vs {loss_l:.6f} without (relative {rel:.2e}, tol "
            f"{DIST_LOSS_RTOL:g}; bit-equal {loss_m == loss_l}); gradients within "
            f"{worst['grad']:.2e} of each leaf's largest, params after the step within {worst['param_resolved']:.2e} where resolved and "
            f"{worst['param_abs']:.2e} abs anywhere")
        log(f"[dist] step ms: {' '.join(f'{t:.1f}' for t in ms_l)} without the mesh, "
            f"{' '.join(f'{t:.1f}' for t in ms_m)} with it (host clock, synchronised; the "
            f"first step of each warmed up before); collectives in one mesh step "
            f"(CommDebugMode): {res['step']['collectives']} {counts}; peak {peak:.1f} GB over "
            f"the mesh part (both copies of the weights held)")
        del grads_m, grads_l, after_m, after_l, params_m

        # (c) compressed_psum over NCCL
        xs = torch.randn(8, 128, generator=gen, device="cuda")
        with shd.use_mesh(mesh):
            ys = compressed_psum(xs, "data")
        perr, bound = (ys - xs).abs().max().item(), xs.abs().max().item() / 100
        res["compressed_psum"] = {"err": perr, "bound": bound}
        log(f"[dist] compressed_psum over NCCL: max abs diff {perr:.3e} (bound {bound:.3e}, "
            f"1/100 of the input's largest)")
        check(perr < bound, "compressed_psum over NCCL is off")
    finally:
        del params
        gc.collect()
        torch.cuda.empty_cache()
    # (d) the state path's blocks
    res["state"] = {arch: _dist_state_check(mesh, arch, what, seed)
                    for arch, what, seed in DIST_STATE}
    return res


def _dist_state_check(mesh, arch: str, what: str, seed: int) -> dict:
    """Layer 0's block of ``arch`` at full width over STATE_BATCH x
    STATE_PROMPT bf16 activations from a zero state (the chunked form with
    a state: one decay launch), then one decode step from the state it
    leaves (the step form), without the mesh and under it (params, x and
    the state as DTensors): outputs and states bit-equal, each launch on
    the family's path (STATE_PATH) both ways."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    from repro_torch.dist import sharding as shd
    from repro_torch.models.params import init_params

    cfg = get_config(arch)
    check((cfg.d_model, cfg.ssm_head_dim, cfg.ssm_state) == {"rwkv6_7b": (4096, 64, 0),
                                                             "zamba2_7b": (3584, 64, 64)}[arch],
          f"{arch} is not at full width")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if arch == "rwkv6_7b":
        defs, groups, init = R6.time_mix_defs(cfg), ("tm", "cm"), R6.init_rwkv_state
    else:
        defs, groups, init = M2.mamba_defs(cfg), ("mamba",), M2.init_mamba_state
    p = init_params(defs, dtype=torch.bfloat16, generator=gen, device="cuda")
    # the block's leaves under the group names the inert rule reads (the
    # ssm family's "cm", the channel mix, not drawn here, stays empty)
    sub = {g: {} for g in groups}
    names = inert.inert_leaves(cfg.family, {g: p if g == groups[0] else {} for g in groups})
    for g, n in names:
        sub[g][n] = p[n]
    drawn = inert.perturb_inert(cfg.family, params_to_numpy(sub), seed)
    for g, n in names:
        p[n].copy_(torch.from_numpy(drawn[g][n]))
    x = (torch.randn(STATE_BATCH, STATE_PROMPT, cfg.d_model, generator=gen, device="cuda")
         .to(torch.bfloat16))
    x1 = torch.randn(STATE_BATCH, 1, cfg.d_model, generator=gen, device="cuda").to(torch.bfloat16)
    state = init(cfg, STATE_BATCH, torch.bfloat16, device="cuda")

    def block(p, x, state):
        if arch == "rwkv6_7b":
            y, (shift, wkv) = R6.apply_time_mix(p, cfg, x, state)
            return y, state._replace(shift_tm=shift, wkv=wkv)
        return M2.apply_mamba(p, cfg, x, state)

    def run(p, x, x1, state):
        """(prompt output, its state, step output, its state, the paths of
        the launches of each call)"""
        out, paths = [], []
        for xi in (x, x1):
            kernels.reset_launches()
            y, state = block(p, xi, state)
            out += [y, state]
            paths.append({k.split(":")[1]: n for k, n in kernels.launches.items()
                          if k.startswith("decay_attention:") and n})
        return out, paths

    def full(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    with torch.no_grad():
        plain, plain_paths = run(p, x, x1, state)
        with shd.use_mesh(mesh), shd.spmd():
            p_m = shd.device_put(p, shd.shardings_for(spec_tree(defs), p, mesh))
            batch = shd.placements_for(shd.P("data"), mesh)
            x_m, x1_m = (distribute_tensor(t, mesh, batch) for t in (x, x1))
            state_m = type(state)(*(distribute_tensor(t, mesh, batch) for t in state))
            meshed, mesh_paths = run(p_m, x_m, x1_m, state_m)
    flat = []
    for name, a, b in zip(("prompt", "prompt state", "step", "step state"), meshed, plain):
        pairs = [("out", a, b)] if isinstance(b, torch.Tensor) else zip(b._fields, a, b)
        flat += [(f"{name} {field}", full(ta), tb) for field, ta, tb in pairs]
    equal = {name: bool(torch.equal(a, b)) for name, a, b in flat}
    worst = max(float((a.float() - b.float()).abs().max()) for _, a, b in flat)
    log(f"[dist] state path, {arch} layer 0's {what} at full width ({STATE_BATCH} x "
        f"{STATE_PROMPT} from a zero state, then one decode step), bf16: decay launches by "
        f"path prompt / step without the mesh {plain_paths[0]} / {plain_paths[1]}, under it "
        f"{mesh_paths[0]} / {mesh_paths[1]}; bit-equal {all(equal.values())} "
        f"({sum(equal.values())} of {len(equal)} outputs and state tensors), max abs diff "
        f"{worst:.3e}")
    check(plain_paths == mesh_paths == [{STATE_PATH[arch]: 1}, {}],
          f"[dist] {arch}: decay paths {plain_paths} without the mesh, {mesh_paths} under it")
    check(all(equal.values()), f"[dist] {arch}: under the mesh not bit-equal: {equal}")
    del p, p_m, plain, meshed
    torch.cuda.empty_cache()
    return {"paths": plain_paths, "mesh_paths": mesh_paths, "bit_equal": equal}


# -- phase 5e: launch.train's trainer on the vlm and encdec families ----------------

class _NoFinalCheckpoint(Trainer):
    """``launch.train``'s trainer without its checkpoints: for these models
    they would hold tens of GB (the cut qwen2_vl_72b's params and moments
    are 42.7 GB); phase 5b writes one at full width."""

    def _save(self, step, params, opt_state):
        pass


def split_step(model, params, opt_state, batch, ocfg, donate: bool) -> dict:
    """One more train step split into forward, backward and AdamW, in place
    as the trainer takes it (``donate``) or functional as ``build_train_step``
    is by default (its new params and moments dropped): each part timed
    with CUDA events, and ``memory_allocated`` / ``max_memory_allocated``
    (GB, peak reset before the step) read after each; also what a cycle
    collection frees before the step (garbage that held memory)."""
    flat, tdef = flatten(params)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    gc.collect()
    garbage = (held - torch.cuda.memory_allocated()) / 1e9
    torch.cuda.reset_peak_memory_stats()
    gb = lambda: (torch.cuda.memory_allocated() / 1e9, torch.cuda.max_memory_allocated() / 1e9)
    mem = {"start": gb()}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    with torch.enable_grad():
        xs = [p.detach().requires_grad_(True) for p in flat]
        loss = model.train_loss(unflatten(tdef, xs), batch)
        ev[1].record()
        torch.cuda.synchronize()
        mem["forward"] = gb()
        grads = torch.autograd.grad(loss, xs)
    ev[2].record()
    torch.cuda.synchronize()
    mem["backward"] = gb()
    del xs, loss
    new = apply_updates(params, unflatten(tdef, list(grads)), opt_state, ocfg, donate=donate)
    ev[3].record()
    torch.cuda.synchronize()
    mem["adamw"] = gb()
    del grads, new
    ms = {name: ev[i].elapsed_time(ev[i + 1])
          for i, name in enumerate(("forward", "backward", "adamw"))}
    return {"ms": ms, "gb": mem, "garbage_gb": garbage}


def phase_train_families() -> dict:
    """``launch.train``'s path, the ``Trainer`` over the completed
    ``synth_batch`` stream (``launch/inputs.py:complete_batch``: M-RoPE
    positions, patch or frame embeddings), remat full, chunked attention,
    seq 128 x batch 8, lr 3e-3, warmup 5, TRAIN_FAMILY_STEPS steps, at full
    width: seamless_m4t_medium unreduced and qwen2_vl_72b cut in depth
    (TRAIN_FAMILIES), seeded bf16 weights.  Each loss finite, no flash
    launch; the mean step of steps 1-4 and tokens/s, the peak GB; then one
    more step split by ``split_step``, functional and donated where
    TRAIN_FAMILIES asks."""
    res = {}
    ckpt_root = tempfile.mkdtemp(prefix="chip_smoke_families_")
    try:
        for arch, depth, seed, forms in TRAIN_FAMILIES:
            full = get_config(arch)
            cfg = full if depth is None else dataclasses.replace(full, n_layers=depth)
            if arch == VLM_ARCH:
                check((cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff, cfg.vocab_size,
                       cfg.rope, cfg.mrope_sections) == VLM_FULL, f"{arch} is not at full width")
            else:
                check((cfg.enc_layers, cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.hd, cfg.d_ff, cfg.vocab_size, cfg.activation, cfg.norm, cfg.rope)
                      == ENCDEC_FULL, f"{arch} is not unreduced")
            res[arch] = train_family(cfg, seed, f"{ckpt_root}/{arch}", forms)
            r = res[arch]
            log(f"[train-families] {arch} ({cfg.n_layers} of {full.n_layers} layers"
                f"{', encoder ' + str(cfg.enc_layers) if cfg.is_encdec else ''}; "
                f"{r['params_b']:.3f} B params, {cfg.dtype}): {TRAIN_FAMILY_STEPS} trainer steps "
                f"of 8 x 128 tokens, losses {' '.join(f'{x:.4f}' for x in r['losses'])}; mean "
                f"step {r['mean_step_ms']:.1f} ms (steps 1-{TRAIN_FAMILY_STEPS - 1}, host clock "
                f"incl. the loss's sync), {r['tokens_per_s']:.0f} tokens/s; peak "
                f"{r['peak_gb']:.1f} GB")
            for form, sp in r["split"].items():
                log(f"[train-families] {arch} step split, {form} AdamW (CUDA events): forward "
                    f"{sp['ms']['forward']:.1f} ms, backward {sp['ms']['backward']:.1f}, AdamW "
                    f"{sp['ms']['adamw']:.1f}; GB allocated / peak: start "
                    f"{sp['gb']['start'][0]:.2f} ({sp['garbage_gb']:.2f} freed by a cycle "
                    f"collection first), after forward {sp['gb']['forward'][0]:.2f} / "
                    f"{sp['gb']['forward'][1]:.2f}, after backward {sp['gb']['backward'][0]:.2f} "
                    f"/ {sp['gb']['backward'][1]:.2f}, after AdamW {sp['gb']['adamw'][0]:.2f} / "
                    f"{sp['gb']['adamw'][1]:.2f}")
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    return res


def train_family(cfg, seed: int, ckpt_dir: str, forms) -> dict:
    model = LM(cfg, attn_impl="chunked", remat="full")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=128, batch_per_shard=8)
    ocfg = AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=TRAIN_FAMILY_STEPS)
    tcfg = TrainerConfig(total_steps=TRAIN_FAMILY_STEPS, ckpt_every=TRAIN_FAMILY_STEPS + 1,
                         ckpt_dir=ckpt_dir, log_every=1000)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    trainer = _NoFinalCheckpoint(model, data, ocfg, tcfg, device="cuda", log=lambda s: None,
                                 init_params=lambda: model.init(gen, device="cuda"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    out = trainer.run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    hist = out["history"]
    check([s for s, _ in hist] == list(range(TRAIN_FAMILY_STEPS)) and out["recoveries"] == 0,
          f"{cfg.name}: trained steps {[s for s, _ in hist]}, {out['recoveries']} recoveries")
    for s, m in hist:
        check(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]),
              f"{cfg.name} step {s}: loss {m['loss']} grad norm {m['grad_norm']}")
    check(kernels.launches["flash_attention"] == 0, f"{cfg.name} training launched flash")
    step_s = [m["step_time"] for _, m in hist[1:]]
    res = {"losses": [m["loss"] for _, m in hist], "params_b": count_params(out["params"]) / 1e9,
           "mean_step_ms": 1e3 * statistics.mean(step_s),
           "tokens_per_s": 128 * 8 / statistics.mean(step_s), "peak_gb": peak}
    batch = trainer._to_device(TRAIN_FAMILY_STEPS, synth_batch(data, TRAIN_FAMILY_STEPS, 0))
    res["split"] = {"donated" if donate else "functional":
                    split_step(model, out["params"], out["opt"], batch, ocfg, donate)
                    for donate in forms}
    del out, trainer, batch
    gc.collect()
    torch.cuda.empty_cache()
    return res


# -- phase 5c: the ssm and hybrid families at full width ---------------------------

def perturb_inert(model, params, seed: int) -> None:
    """Set, in place, the leaves the reference's init leaves zero (else token
    shift, the data-dependent decay and the bonus never run) by the port's
    one numpy rule (``repro_torch.models.inert``), drawn from ``seed``."""
    layers = params["layers"]
    names = inert.inert_leaves(model.family, layers)
    sub = {g: {} for g, _ in names}
    for g, n in names:
        sub[g][n] = layers[g][n]
    sub = inert.perturb_inert(model.family, params_to_numpy(sub), seed)
    for g, n in names:
        layers[g][n].copy_(torch.from_numpy(sub[g][n]))


@contextlib.contextmanager
def scan_impl(fn):
    """Route the blocks' chunked form through ``fn`` (a plain version), for a
    comparison run; the kernel is the default on the card."""
    saved = R6.chunked_decay_attention, M2.chunked_decay_attention
    R6.chunked_decay_attention = M2.chunked_decay_attention = fn
    try:
        yield
    finally:
        R6.chunked_decay_attention, M2.chunked_decay_attention = saved


def state_prompt(model, params, tokens, recent_size):
    """``decode_step`` over the whole prompt from a fresh cache; for split
    caches, then ``flush_cache``.  Returns (logits, cache, ms)."""
    B, S = tokens.shape
    cache = model.init_cache(B, S + STATE_NEW, recent_size=recent_size, device="cuda")
    batch = {"tokens": tokens, "positions": torch.arange(S, device="cuda")[None].expand(B, S)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, cache = model.decode_step(params, batch, cache)
        cache = model.flush_cache(cache)
    torch.cuda.synchronize()
    return logits, cache, 1e3 * (time.perf_counter() - t0)


def state_setup(arch: str, seed: int):
    """The full-width model with seeded weights (inert leaves set), its
    8 x 1024 prompts and its 4 x 2048 ``prefill_logits`` batch."""
    cfg = get_config(arch)
    full = {"rwkv6_7b": (32, 4096, 14336, 65536, 64, 0),
            "zamba2_7b": (81, 3584, 14336, 32000, 64, 64)}[arch]
    check((cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.ssm_head_dim, cfg.ssm_state)
          == full, f"{arch} is not at full width")
    model = LM(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    perturb_inert(model, params, seed)
    torch.cuda.synchronize()
    log(f"[{arch}] {count_params(params) / 1e9:.3f} B params ({cfg.dtype}) in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(seed)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (STATE_BATCH, STATE_PROMPT))).cuda()
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=2048, batch_per_shard=4)
    pbatch = {k: torch.from_numpy(v).cuda() for k, v in synth_batch(data, 2, 0).items()
              if k in ("tokens", "positions")}
    return model, params, prompts, pbatch


def phase_state_model(arch: str, seed: int) -> dict:
    """One full-width model of the ssm or hybrid family on its state path,
    the launch counts zeroed just before each driven part and read just after:
    the prompt through ``decode_step`` (the chunked form with a state: one
    kernel launch per layer), 32 greedy one-token steps, ``prefill_logits`` at
    4 x 2048 (one launch per layer, no state).  Then, on the same weights:
    the first layer's block on each of the two inputs through the kernel
    against the plain chunked math (``layer_check``), and the logits of the
    first layers through the kernel, the plain chunked math and the
    sequential oracle (``shallow_check``)."""
    model, params, prompts, pbatch = state_setup(arch, seed)
    cfg, tag, vocab = model.cfg, f"[{arch}]", pad_vocab(model.cfg)
    recent = STATE_PROMPT + STATE_NEW

    # the prompt through the kernel, then greedy steps (the one-step form)
    kernels.reset_launches()
    logits, cache, prompt_ms = state_prompt(model, params, prompts, recent)
    n_prompt = kernels.launches["decay_attention"]
    path = STATE_PATH[arch]
    check(n_prompt == cfg.n_layers, f"{tag} prompt: {n_prompt} decay launches, not {cfg.n_layers}")
    check(kernels.launches[f"decay_attention:{path}"] == n_prompt,
          f"{tag} prompt: not every decay launch took the {path} path")
    check(tuple(logits.shape) == (STATE_BATCH, vocab) and bool(torch.isfinite(logits).all()),
          f"{tag} prompt logits")
    if "len_rec" in cache:
        check(cache["len"] == STATE_PROMPT and cache["len_rec"] == 0, f"{tag} flush lengths")
    kernels.reset_launches()
    graph = arch in GRAPHED_STATE
    if graph:
        # eager from a copy of the prompt cache, then graphed from the cache
        layers = cache["layers"]
        copy = {"layers": type(layers)(*(t.clone() for t in layers)), "len": cache["len"]}
        ids, step_ms, _ = greedy_steps(lambda b, c: model.decode_step(params, b, c), copy, logits)
        del copy
        g_ids, g_step_ms, logits = greedy_steps(
            lambda b, c: decode_step_jit(model, params, b, c), cache, logits)
        check(g_ids == ids, f"{tag} graphed greedy ids differ from eager")
        graphs = model._cuda_graphs
        check(graphs.captures == 1, f"{tag} {graphs.captures} captures, not 1")
    else:
        ids, step_ms, logits = greedy_steps(lambda b, c: model.decode_step(params, b, c), cache,
                                            logits)
    check(kernels.launches["decay_attention"] == 0, f"{tag} one-token steps launched the kernel")
    check(bool(torch.isfinite(logits).all()) and all(0 <= i < vocab for r in ids for i in r),
          f"{tag} decode")
    del cache, logits
    # prefill_logits at 4 x 2048
    y, prefill_ms, _ = _forward(model, "prefill", params, pbatch)
    n_prefill = kernels.launches["decay_attention"]
    check(n_prefill == cfg.n_layers, f"{tag} prefill_logits: {n_prefill} decay launches")
    check(kernels.launches[f"decay_attention:{path}"] == n_prefill,
          f"{tag} prefill_logits: not every decay launch took the {path} path")
    check(tuple(y.shape) == (4, vocab), f"{tag} prefill logits {tuple(y.shape)}")
    del y
    torch.cuda.empty_cache()

    layer = {"prompt": layer_check(model, params, prompts, with_state=True),
             "prefill": layer_check(model, params, pbatch["tokens"], with_state=False)}
    depth = STATE_CHECK_DEPTH[arch]
    shallow = shallow_check(model, params, depth, prompts, pbatch)
    res = {"prompt_ms": prompt_ms, "decode_step_ms": statistics.mean(step_ms[1:]),
           "decode_tokens_per_s": STATE_BATCH * (STATE_NEW - 1) / (sum(step_ms[1:]) / 1e3),
           "prefill_4x2048_ms": prefill_ms, "launches": n_prompt + n_prefill,
           "layer": layer, "shallow": shallow}
    if graph:
        res.update(graph_decode_step_ms=statistics.mean(g_step_ms[1:]),
                   graph_decode_tokens_per_s=STATE_BATCH * (STATE_NEW - 1) / (sum(g_step_ms[1:])
                                                                              / 1e3),
                   captures=graphs.captures, capture_ms=graphs.capture_ms)
        log(f"{tag} {STATE_NEW} greedy steps from the same prompt cache, eager and as a CUDA "
            f"graph: ids equal; mean step (steps 2-{STATE_NEW}) eager {res['decode_step_ms']:.2f} "
            f"ms, graphed {res['graph_decode_step_ms']:.2f} ms ({res['decode_tokens_per_s']:.1f} "
            f"and {res['graph_decode_tokens_per_s']:.1f} tokens/s); {graphs.captures} capture, "
            f"{graphs.capture_ms:.1f} ms (the first graphed step, not in the mean)")
    log(f"{tag} prompt {STATE_BATCH} x {STATE_PROMPT} through decode_step: {prompt_ms:.1f} ms, "
        f"{n_prompt} decay launches ({path}); {STATE_NEW} greedy steps: mean "
        f"{res['decode_step_ms']:.2f} ms "
        f"per step (steps 2-{STATE_NEW}, host clock incl. sync), {res['decode_tokens_per_s']:.1f} "
        f"tokens/s over {STATE_BATCH} sequences; "
        f"prefill_logits 4 x 2048: {prefill_ms:.1f} ms, {n_prefill} decay launches ({path})")
    for path, r in layer.items():
        log(f"{tag} first layer on the {path} input {r['shape']}, kernel vs plain chunked: output "
            f"{r['out_err']:.3e} of scale {r['out_scale']:.3f} (tol {DECAY_BF16_TOL:g} of scale)"
            + (f", final state {r['state_err']:.3e} of scale {r['state_scale']:.3f} "
               f"(tol {DECAY_TOL:g} of scale)" if "state_err" in r else ""))
        check(r["out_err"] < DECAY_BF16_TOL * max(1.0, r["out_scale"]),
              f"{tag} first layer ({path}): kernel vs plain output over tolerance")
        check(r.get("state_err", 0.0) < DECAY_TOL * max(1.0, r.get("state_scale", 0.0)),
              f"{tag} first layer ({path}): kernel vs plain state over tolerance")
    for path, r in shallow.items():
        log(f"{tag} {path} logits after the first {depth} layers: kernel vs plain chunked "
            f"{r['kernel_vs_chunked']:.4f}, sequential oracle vs plain chunked "
            f"{r['oracle_vs_chunked']:.4f}, kernel vs oracle {r['kernel_vs_oracle']:.4f}, scale "
            f"{r['scale']:.3f} (tol: the oracle's spread + {bf16_ulp(r['scale']):g}, one bf16 ulp "
            f"of the scale); argmax equal {r['argmax_equal']}")
        check(r["oracle_vs_chunked"] < LOGITS_TOL * r["scale"],
              f"{tag} {path}: the plain paths disagree after {depth} layers")
        check(r["kernel_vs_chunked"] <= r["oracle_vs_chunked"] + bf16_ulp(r["scale"]),
              f"{tag} {path} logits: kernel vs plain outside the oracle's spread")
    del params
    torch.cuda.empty_cache()
    return res


def phase_state_f32(arch: str, seed: int) -> dict:
    """The full-width model of ``arch`` with ``state_setup``'s seeded weights
    cast to f32 (the config's dtype float32; the bf16 weights freed):
    ``prefill_logits`` at 4 x 2048 through the decay kernel, the launch
    counts zeroed just before and read just after (one launch a layer, each
    on the family's f32 tensor-core path), and through the plain chunked
    math on the same weights, both timed.  Then the first layer's block,
    kernel against plain chunked (output and final state within 2e-3 of
    their scale), and the logits of the first ``STATE_CHECK_DEPTH`` layers
    through the kernel, the plain chunked math and the sequential oracle:
    the kernel within the spread of the two plain forms, no further from one
    of them than they are from each other.  (In bf16 the kernel is held to
    the oracle's spread around plain chunked; in f32 the sequential oracle
    is itself a float32 evaluation, as far from the truth as the others --
    the furthest of the three at rwkv6_7b, the nearest to the kernel at
    zamba2_7b -- so the kernel is held not to be the outlier.)"""
    model, params, _, pbatch = state_setup(arch, seed)
    params = tree_map(lambda t: t.float(), params)
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(model.cfg, dtype="float32")
    model = LM(cfg)
    tag, path, vocab = f"[state-f32 {arch}]", STATE_PATH_F32[arch], pad_vocab(cfg)
    y, prefill_ms, _ = _forward(model, "prefill", params, pbatch)
    n = kernels.launches["decay_attention"]
    check(n == cfg.n_layers and kernels.launches[f"decay_attention:{path}"] == n,
          f"{tag} prefill_logits: {n} decay launches, "
          f"{kernels.launches[f'decay_attention:{path}']} on {path}, not {cfg.n_layers}")
    check(tuple(y.shape) == (4, vocab) and y.dtype == torch.float32, f"{tag} prefill logits")
    with scan_impl(chunked_decay_ref):
        y_plain, plain_ms, _ = _forward(model, "prefill", params, pbatch)
    check(kernels.launches["decay_attention"] == 0, f"{tag} plain forward launched the kernel")
    full = {"kernel_vs_chunked": (y - y_plain).abs().max().item(),
            "scale": y_plain.abs().max().item()}
    del y, y_plain
    layer = layer_check(model, params, pbatch["tokens"], with_state=True)
    depth = STATE_CHECK_DEPTH[arch]
    shallow = shallow_check(model, params, depth, None, pbatch, paths=("prefill",))["prefill"]
    log(f"{tag} prefill_logits 4 x 2048 in f32: kernel {prefill_ms:.1f} ms ({n} decay launches, "
        f"all {path}), plain chunked {plain_ms:.1f} ms; full depth kernel vs plain "
        f"{full['kernel_vs_chunked']:.4f} of scale {full['scale']:.3f} (not held: chaotic in "
        f"depth, ROADMAP.md fault 4)")
    log(f"{tag} first layer on {layer['shape']}, kernel vs plain chunked: output "
        f"{layer['out_err']:.3e} of scale {layer['out_scale']:.3f}, final state "
        f"{layer['state_err']:.3e} of scale {layer['state_scale']:.3f} (tol {DECAY_TOL:g} of "
        f"scale)")
    log(f"{tag} prefill logits after the first {depth} layers: kernel vs plain chunked "
        f"{shallow['kernel_vs_chunked']:.3e}, kernel vs oracle {shallow['kernel_vs_oracle']:.3e}, "
        f"sequential oracle vs plain chunked {shallow['oracle_vs_chunked']:.3e} (tol: the kernel "
        f"no further from one plain form than they are apart), scale {shallow['scale']:.3f}; "
        f"argmax equal {shallow['argmax_equal']}")
    check(layer["out_err"] < DECAY_TOL * max(1.0, layer["out_scale"]),
          f"{tag} first layer: kernel vs plain output over tolerance")
    check(layer["state_err"] < DECAY_TOL * max(1.0, layer["state_scale"]),
          f"{tag} first layer: kernel vs plain state over tolerance")
    check(shallow["oracle_vs_chunked"] < LOGITS_TOL * shallow["scale"],
          f"{tag}: the plain paths disagree after {depth} layers")
    check(min(shallow["kernel_vs_chunked"], shallow["kernel_vs_oracle"])
          <= shallow["oracle_vs_chunked"],
          f"{tag}: logits after {depth} layers outside the spread of the two plain forms")
    del params
    torch.cuda.empty_cache()
    return {"prefill_ms": prefill_ms, "plain_ms": plain_ms, "launches": n, "layer": layer,
            "shallow": shallow, "full": full}


def greedy_steps(step, cache, logits):
    """``STATE_NEW`` greedy one-token steps of ``step(batch, cache)`` from
    the prompt's ``logits``; returns (ids, host ms per step, last logits)."""
    ids, step_ms = [], []
    tok = logits.argmax(-1)
    with torch.no_grad():
        for t in range(STATE_NEW):
            pos = torch.full((STATE_BATCH, 1), STATE_PROMPT + t, device="cuda")
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            logits, cache = step({"tokens": tok[:, None], "positions": pos}, cache)
            tok = logits.argmax(-1)
            ids.append(tok.tolist())
            step_ms.append(1e3 * (time.perf_counter() - t1))
    return ids, step_ms, logits


def bf16_ulp(x: float) -> float:
    """The spacing of bfloat16 values at magnitude ``x`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def layer_check(model, params, tokens, with_state: bool) -> dict:
    """The first layer's time-mix (rwkv6) or Mamba block (zamba2) on the
    normed embeddings of ``tokens``, kernel against plain chunked: with a
    zero state, as ``decode_step`` runs the prompt (output and final state),
    or without one, as ``prefill_logits`` runs (output)."""
    cfg = model.cfg
    first = lambda tree: {k: v[0] for k, v in tree.items()}  # noqa: E731
    B = tokens.shape[0]
    with torch.no_grad():
        x = model_layers.embed_tokens(params["embed"], tokens, model.dtype)
        out, state = {}, {}
        for name in ("kernel", "plain"):
            ctx = scan_impl(chunked_decay_ref) if name == "plain" else contextlib.nullcontext()
            kernels.reset_launches()
            with ctx:
                if model.family == "ssm":
                    h = model_layers.apply_norm(first(params["layers"]["ln1"]), x)
                    st = R6.init_rwkv_state(cfg, B, model.dtype, device="cuda") if with_state else None
                    out[name], new = R6.apply_time_mix(first(params["layers"]["tm"]), cfg, h, st)
                    state[name] = new[1] if with_state else None
                else:
                    h = model_layers.apply_norm(first(params["layers"]["ln"]), x)
                    st = M2.init_mamba_state(cfg, B, model.dtype, device="cuda") if with_state else None
                    out[name], new = M2.apply_mamba(first(params["layers"]["mamba"]), cfg, h, st)
                    state[name] = new.ssd if with_state else None
            check(kernels.launches["decay_attention"] == int(name == "kernel"),
                  f"layer check ({name}): {kernels.launches['decay_attention']} launches")
    res = {"shape": tuple(tokens.shape),
           "out_err": (out["kernel"].float() - out["plain"].float()).abs().max().item(),
           "out_scale": out["plain"].float().abs().max().item()}
    if with_state:
        res.update(state_err=(state["kernel"] - state["plain"]).abs().max().item(),
                   state_scale=state["plain"].abs().max().item())
    return res


def shallow_check(model, params, depth: int, prompts, pbatch,
                  paths=("prompt", "prefill")) -> dict:
    """The first ``depth`` layers of the same weights, where the plain paths
    still agree (``STATE_CHECK_DEPTH``): the
    prompt logits through ``decode_step`` (with ``flush_cache``) and the
    ``prefill_logits`` at 4 x 2048 (or those of ``paths``), each through
    the kernel, the plain chunked math and the sequential oracle."""
    cfg_d, params_d = _first_layers(model.cfg, params, depth)
    m = LM(cfg_d)
    res = {}
    for path in paths:
        z = {}
        for name, fn in (("kernel", None), ("chunked", chunked_decay_ref),
                         ("oracle", decay_attention_ref)):
            kernels.reset_launches()
            with scan_impl(fn) if fn else contextlib.nullcontext(), torch.no_grad():
                if path == "prompt":
                    y = state_prompt(m, params_d, prompts, STATE_PROMPT + STATE_NEW)[0]
                else:
                    y = m.prefill_logits(params_d, pbatch)
            n = kernels.launches["decay_attention"]
            check(n == (depth if fn is None else 0), f"{path} ({name}, {depth} layers): {n} launches")
            check(bool(torch.isfinite(y).all()), f"{path} ({name}, {depth} layers): not finite")
            z[name] = y.float()
        res[path] = {
            "kernel_vs_chunked": (z["kernel"] - z["chunked"]).abs().max().item(),
            "oracle_vs_chunked": (z["oracle"] - z["chunked"]).abs().max().item(),
            "kernel_vs_oracle": (z["kernel"] - z["oracle"]).abs().max().item(),
            "scale": z["chunked"].abs().max().item(),
            "argmax_equal": f"{int((z['kernel'].argmax(-1) == z['chunked'].argmax(-1)).sum())}"
                            f"/{z['kernel'].shape[0]}",
        }
    return res


def phase_state_small_vs_cpu() -> dict:
    """Both families at ``.smoke()``: weights drawn once on the CPU (inert
    leaves set as above) and bridged to the card; 3 prompts of 40 tokens
    through ``decode_step`` (and ``flush_cache``), then 8 greedy steps, on the
    card (through the kernel: the smoke models are f32, so every launch on
    the family's f32 tensor-core path) and on the CPU (plain).  Ids must be
    equal, logits within ``SMOKE_LOGITS_TOL`` of their scale."""
    res = {}
    for arch in ("rwkv6_7b", "zamba2_7b"):
        cfg = get_config(arch).smoke()
        model = LM(cfg)
        tree = params_to_numpy(model.init(torch.Generator().manual_seed(5), device="cpu"))
        inert.perturb_inert(model.family, tree["layers"], 5)
        toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (3, 40))
        out = {}
        for dev in ("cuda", "cpu"):
            params = params_from_numpy(model, tree, device=dev)
            cache = model.init_cache(3, 48, recent_size=48, device=dev)
            kernels.reset_launches()
            with torch.no_grad():
                logits, cache = model.decode_step(params, {
                    "tokens": torch.from_numpy(toks).to(dev),
                    "positions": torch.arange(40, device=dev)[None].expand(3, 40)}, cache)
                cache = model.flush_cache(cache)
                zs, ids = [logits.float().cpu()], []
                for t in range(8):
                    tok = logits.argmax(-1)
                    ids.append(tok.tolist())
                    logits, cache = model.decode_step(params, {
                        "tokens": tok[:, None],
                        "positions": torch.full((3, 1), 40 + t, device=dev)}, cache)
                    zs.append(logits.float().cpu())
            n = kernels.launches["decay_attention"]
            on_path = kernels.launches[f"decay_attention:{STATE_PATH_F32[arch]}"]
            check(n == (cfg.n_layers if dev == "cuda" else 0) and on_path == n,
                  f"smoke {arch} {dev}: {n} launches, {on_path} on {STATE_PATH_F32[arch]}")
            out[dev] = (ids, torch.stack(zs))
        err = (out["cuda"][1] - out["cpu"][1]).abs().max().item()
        scale = out["cpu"][1].abs().max().item()
        log(f"[state-small] {arch} smoke, 3 prompts x 40 + 8 greedy ids: card ids "
            f"{'==' if out['cuda'][0] == out['cpu'][0] else '!='} CPU ids; logits max abs diff "
            f"{err:.3e} of scale {scale:.3f} (tol {SMOKE_LOGITS_TOL:g} of scale)")
        check(out["cuda"][0] == out["cpu"][0], f"smoke {arch}: card and CPU ids differ")
        check(err < SMOKE_LOGITS_TOL * max(1.0, scale), f"smoke {arch}: logits over tolerance")
        res[arch] = err
    return res


# -- phase [roofline]: the compile-only launchers -----------------------------------

def roofline_cells() -> dict:
    """(a): each of ROOFLINE_CELLS through ``dryrun.run_cell`` (its own
    fake process group, started and destroyed) at its own accumulation
    (``auto_accum``: the microbatch loop under the production mesh),
    status ok and the CPU's argument bytes; then, without accumulation as
    the reference's records were taken, its flops and peak a device over
    the reference's (ROOFLINE_REF) within ROOFLINE_MAX_FLOPS /
    ROOFLINE_MAX_PEAK."""
    from repro_torch.launch import dryrun

    def line(arch, shape, rec, t0):
        pd = rec["per_device"]
        log(f"[roofline] {arch} {shape} on {rec['mesh']} fake ranks, 1 layer, accum "
            f"{rec['accum_steps']}, torch {torch.__version__}: {time.perf_counter() - t0:.1f} s "
            f"(build {rec['lower_s']} s, traced step {rec['compile_s']} s); per device "
            + ", ".join(f"{k} {v:.6g}" for k, v in pd.items()) + "; collectives "
            + ", ".join(f"{k} {v['count']}" for k, v in rec["collectives"].items()))

    out = {}
    for arch, shape, arg_bytes in ROOFLINE_CELLS:
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch, shape, False, n_layers=1)
        pd = rec["per_device"]
        check(rec["status"] == "ok" and pd["argument_bytes"] == arg_bytes,
              f"[roofline] {arch} {shape}: argument bytes {pd['argument_bytes']}, the CPU's "
              f"{arg_bytes}")
        line(arch, shape, rec, t0)
        out[f"{arch}|{shape}"] = rec
        if rec["accum_steps"] != 1:
            t0 = time.perf_counter()
            rec = dryrun.run_cell(arch, shape, False, n_layers=1, accum_steps=1)
            pd = rec["per_device"]
            check(rec["status"] == "ok" and pd["argument_bytes"] == arg_bytes,
                  f"[roofline] {arch} {shape} accum 1: argument bytes {pd['argument_bytes']}")
            line(arch, shape, rec, t0)
            out[f"{arch}|{shape}|accum1"] = rec
        ref_flops, ref_peak = ROOFLINE_REF[(arch, shape)]
        flops_ratio, peak_ratio = pd["flops"] / ref_flops, pd["peak_bytes"] / ref_peak
        max_peak = ROOFLINE_MAX_PEAK[rec["mode"]]
        log(f"[roofline] {arch} {shape} a device, accum 1: flops {pd['flops']:.6g} against the "
            f"reference's {ref_flops:.6g} on the CPU ({flops_ratio:.4f}, bound "
            f"{ROOFLINE_MAX_FLOPS}); peak {pd['peak_bytes'] / 1e9:.4f} GB against "
            f"{ref_peak / 1e9:.4f} ({peak_ratio:.4f}, bound {max_peak})")
        check(flops_ratio <= ROOFLINE_MAX_FLOPS and peak_ratio <= max_peak,
              f"[roofline] {arch} {shape}: flops {flops_ratio:.4f}, peak {peak_ratio:.4f} of "
              f"the reference's")
    return out


def roofline_predict() -> dict:
    """(b)'s prediction: the one-card cell traced on meta tensors."""
    from repro_torch.launch import dryrun
    from repro_torch.launch import roofline as RL

    cfg = get_config(ROOFLINE_ARCH)
    fn, args, _ = dryrun.build_cell(cfg, ROOFLINE_SHAPE, None, attn_impl="chunked",
                                    remat="full", accum_steps=1)
    pd = dryrun.trace_step(fn, args, dryrun.DONATED["train"])["per_device"]
    terms = RL.terms(pd)
    tokens = ROOFLINE_SHAPE.global_batch * ROOFLINE_SHAPE.seq_len
    return {"per_device": pd, "terms": terms, "bound_s": max(terms.values()),
            "dominant": max(terms, key=terms.get),
            "model_flops": 6 * cfg.n_active_params() * tokens}


def roofline_rows(records: dict) -> list:
    """(c): ``benchmarks/torch_roofline_report.py`` over ``records`` written
    as ``experiments/torch_roofline_results.json`` in a temporary directory."""
    report = load_script("benchmarks/torch_roofline_report.py")
    rows, cwd = [], os.getcwd()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_roofline_") as d:
        os.makedirs(f"{d}/experiments")
        with open(f"{d}/experiments/torch_roofline_results.json", "w") as f:
            json.dump(records, f)
        os.chdir(d)
        try:
            report.run(lambda name, us, derived: rows.append((name, us, derived)))
        finally:
            os.chdir(cwd)
    return rows


def phase_roofline() -> dict:
    """The compile-only launchers (``repro_torch.launch.dryrun``,
    ``roofline``; no kernel on their path).  (a) ``roofline_cells``; (b) the
    one-card cell predicted (``roofline_predict``: flops, fused bytes,
    bytes accessed, peak bytes, the roofline terms at the H100's peaks),
    then run on the card from seeded weights: the predicted flops equal
    ``FlopCounterMode``'s count of the real step, the predicted argument
    bytes the real arguments', the predicted peak within ROOFLINE_PEAK_RATIO
    of ``max_memory_allocated`` (reset after the warm-up) less what was
    allocated when the phase began; the step's measured share of the
    peak, model flops / 989e12 / step s, and the bound's share, bound s /
    step s; (c) ``roofline_rows`` over a ``roofline_cell`` record of
    stablelm_1_6b decode_32k (256 fake ranks) and (b)'s prediction."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import roofline as RL

    res = {"cells": roofline_cells()}
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    pred = roofline_predict()
    ppd = pred["per_device"]
    log(f"[roofline] predicted, {ROOFLINE_ARCH} at full width, train {ROOFLINE_SHAPE.global_batch}"
        f" x {ROOFLINE_SHAPE.seq_len}, remat full, chunked, one card: flops {ppd['flops']:.6g}, "
        f"fused_bytes {ppd['fused_bytes']:.6g}, bytes_accessed {ppd['bytes_accessed']:.6g}, "
        f"argument_bytes {ppd['argument_bytes']}, peak_bytes {ppd['peak_bytes']}; at "
        f"{RL.CARD}: compute {pred['terms']['compute_s'] * 1e3:.4f} ms, memory "
        f"{pred['terms']['memory_s'] * 1e3:.4f} ms, bound {pred['bound_s'] * 1e3:.4f} ms "
        f"({pred['dominant']}); model flops {pred['model_flops']:.6g}")
    cfg = get_config(ROOFLINE_ARCH)
    model = LM(cfg, attn_impl="chunked", remat="full")
    params = model.init(ROOFLINE_SEED, device="cuda")
    opt = init_opt_state(params)
    batch = make_batch(cfg, ROOFLINE_SHAPE, ROOFLINE_SEED, device="cuda")
    real_args = sum(t.numel() * t.element_size() for t in leaves((params, opt, batch)))
    check(real_args == ppd["argument_bytes"],
          f"[roofline] argument bytes {real_args}, predicted {ppd['argument_bytes']}")
    step = build_train_step(model, AdamWConfig(), donate=True)
    with FlopCounterMode(display=False) as fc:
        params, opt, metrics = step(params, opt, batch)
    check(fc.get_total_flops() == ppd["flops"],
          f"[roofline] FlopCounterMode counts {fc.get_total_flops()}, predicted {ppd['flops']}")
    for _ in range(ROOFLINE_WARMUP - 1):
        params, opt, metrics = step(params, opt, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, losses = [], []
    for _ in range(ROOFLINE_REPS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        params, opt, metrics = step(params, opt, batch)
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
        losses.append(float(metrics["loss"]))
    peak = torch.cuda.max_memory_allocated() - base
    check(all(math.isfinite(x) for x in losses), f"[roofline] losses {losses}")
    step_s = statistics.median(ms) / 1e3
    ratio = ppd["peak_bytes"] / peak
    res.update(step_ms=statistics.median(ms), all_ms=ms, peak_bytes=peak, peak_ratio=ratio,
               share=pred["model_flops"] / RL.PEAK_FLOPS / step_s,
               bound_share=pred["bound_s"] / step_s, predicted=pred)
    log(f"[roofline] measured: step {res['step_ms']:.3f} ms (median of {ROOFLINE_REPS} by CUDA "
        f"events after {ROOFLINE_WARMUP} warm-up; all {' '.join(f'{x:.3f}' for x in ms)}); "
        f"flops {fc.get_total_flops():.6g} = predicted; peak {peak / 1e9:.4f} GB against "
        f"predicted {ppd['peak_bytes'] / 1e9:.4f} (predicted / measured {ratio:.4f}); measured "
        f"share of the card's peak (model flops / 989e12 / step s) {res['share']:.5f}; the "
        f"bound's share (bound s / step s) {res['bound_share']:.5f}; losses "
        f"{' '.join(f'{x:.4f}' for x in losses)}")
    check(1 / ROOFLINE_PEAK_RATIO <= ratio <= ROOFLINE_PEAK_RATIO,
          f"[roofline] predicted peak {ppd['peak_bytes']} against measured {peak}")
    del params, opt, batch, metrics, step, model
    gc.collect()
    torch.cuda.empty_cache()

    one_card = {"arch": ROOFLINE_ARCH, "shape": "launch.train 8x128 (one card)", **pred["terms"],
                "roofline_fraction": pred["model_flops"] / RL.PEAK_FLOPS / pred["bound_s"]}
    records = {"stablelm_1_6b|decode_32k|chunked": RL.roofline_cell("stablelm_1_6b",
                                                                     "decode_32k"),
               f"{ROOFLINE_ARCH}|train_128x8|chunked": one_card}
    log(f"[roofline] card of the records: {records['stablelm_1_6b|decode_32k|chunked']['card']}")
    res["rows"] = roofline_rows(records)
    check(len(res["rows"]) == 2 and all(math.isfinite(r[1]) and r[1] > 0 for r in res["rows"]),
          f"[roofline] report rows {res['rows']}")
    for name, us, derived in res["rows"]:
        log(f"[roofline] report row {name}: bound {us} us a step, roofline fraction {derived}")
    return res


# -- phase 6 -----------------------------------------------------------------

def time_ms(fn, reps: int) -> float:
    """Median device time of one call, with the 50 MB L2 flushed before each
    (the main path finds every layer's pages cold).  The card then waits
    (``torch.cuda._sleep``, ~0.5 ms) while the host enqueues the call, so
    that a slow enqueue (after the profiler has run: 20-60 us) is not timed."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def device_launches(fn) -> int:
    """Kernels the device ran for one call of ``fn`` (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)


def phase_times() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    lens = main_lens()
    q, kp, vp, tbl, lens_t = paged_case(gen, MAX_SEQS, HEADS, HEADS, HEAD_DIM, lens, torch.bfloat16)
    qg = q.reshape(MAX_SEQS, HEADS, 1, HEAD_DIM)
    scale = HEAD_DIM ** -0.5
    item = q.element_size()
    # the kernel reads each sequence's len K and V rows (none past the end),
    # the ceil(len / bs) table entries that list them, the lengths, q and out
    pages_read = sum(-(-n // BLOCK) for n in lens)
    pa_bytes = (2 * sum(lens) * HEADS * HEAD_DIM * item + 2 * q.numel() * item
                + pages_read * 4 + lens_t.numel() * 4)
    pa_ops_count = 4 * HEADS * HEAD_DIM * sum(lens)
    times = {"paged_attention": {
        "ms": time_ms(lambda: pa_ops._launch(qg, kp, vp, tbl, lens_t, scale), 50),
        "plain_ms": time_ms(lambda: paged_attention_ref(qg, kp, vp, tbl, lens_t, scale=scale), 10),
        "bytes_ms": pa_bytes / HBM_BYTES_PER_S * 1e3,
        "ops_ms": pa_ops_count / F32_FLOPS * 1e3,
        "library_ms": None,
        "shape": f"B={MAX_SEQS} Hq=Hkv={HEADS} D={HEAD_DIM} bs={BLOCK} lens={lens} bf16",
    }}
    pool, src, dst = block_copy_case()
    sd = torch.from_numpy(np.stack([src, dst], 1).astype(np.int32)).cuda()
    sd_long = sd.long()
    block_bytes = pool.shape[1] * pool.element_size()

    def library():
        pool[sd_long[:, 1]] = pool[sd_long[:, 0]]

    times["block_copy"] = {
        "ms": time_ms(lambda: bc_ops._launch(pool, sd), 50),
        "plain_ms": time_ms(lambda: block_copy_ref(pool, sd), 20),
        "bytes_ms": (2 * len(src) * block_bytes + sd.numel() * 4) / HBM_BYTES_PER_S * 1e3,
        "ops_ms": 0.0,
        "library_ms": time_ms(library, 20),
        "shape": f"pool {tuple(pool.shape)} bf16, {len(src)} pairs of {block_bytes} B",
    }
    del pool
    torch.cuda.empty_cache()
    times.update(bulk_op_times())
    times.update(flash_times())
    times.update(paged_fp8_times())
    times.update(paged_group_times())
    times.update(decay_times())
    # after every timing: the profiler slows the host's launches once it has run
    per_call = device_launches(lambda: pa_ops._launch(qg, kp, vp, tbl, lens_t, scale))
    times["paged_attention"]["shape"] += f", {per_call} CUDA launches a call"
    for name, t in times.items():
        t["bound_ms"] = max(t["bytes_ms"], t["ops_ms"])
        t["bound_by"] = "bytes" if t["bytes_ms"] >= t["ops_ms"] else "operations"
        log(f"[times] {name} ({t['shape']}): kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
            f"library {t['library_ms']}, bound {t['bound_ms']:.4f} ms ({t['bound_by']}), "
            f"kernel at {100 * t['bound_ms'] / t['ms']:.1f}% of bound")
        check(t["ms"] >= t["bound_ms"], f"{name}: {t['ms']} ms is under its bound {t['bound_ms']} ms")
    return times


def flash_flops(B, Hq, Sq, Sk, D, causal) -> float:
    """Multiply-adds of q.k and p.v (2 flops each) over the (query, key)
    pairs the mask leaves visible."""
    if causal:
        pairs = sum(min(i + 1, Sk) for i in range(Sq))
    else:
        pairs = Sq * Sk
    return 4.0 * B * Hq * D * pairs


def op_ms(flops: float, dtype) -> float:
    """The least time of ``flops`` of products on the card.  bf16 at the bf16
    tensor cores' rate.  f32 has to hold the plain f32 form's precision
    (flash attention's 2e-5; the decay kernel's oracle check), which one
    TF32 product misses, and so do three bf16 products for the decay
    kernel: the least time of any design that holds it, the smaller of the
    operations in float32 on CUDA cores (67 TFLOP/s) and three TF32 products
    each (3xTF32: scripts/flash_precision.py, scripts/decay_precision.py
    --dtype float32) at the TF32 tensor cores' 495 TFLOP/s."""
    if dtype == torch.bfloat16:
        return flops / BF16_TC_FLOPS * 1e3
    return min(flops / F32_FLOPS, 3 * flops / TF32_TC_FLOPS) * 1e3


def flash_times() -> dict:
    """The flash kernel at its main shape (4 x 32 heads x 2048 x 64, causal)
    in bf16 (the main path's type) and f32 (``"flash_attention:f32"``), at
    mistral_nemo_12b's (q 4 x 32 heads x 2048 x 128 against k, v of 8
    heads, causal) in bf16 (``"flash_attention:d128"``) and f32
    (``"flash_attention:f32_d128"``), at qwen2_vl_72b's (q 4 x 64 heads
    x 2048 x 128 against k, v of 8 heads, causal) in bf16
    (``"flash_attention:vlm"``), and at seamless_m4t_medium's, non-causal in
    bf16: its encoder's and cross-attention prefill's (4 x 16 heads x 2048 x
    64, ``"flash_attention:encdec"``) and a decode step's cross-attention (q
    8 x 16 heads x 1 x 64 against k, v of 8 x 16 x 1024 x 64,
    ``"flash_attention:xdec"``).  The bound counts q, k, v read once and
    the output written once, each by its own size, and the visible pairs'
    operations (``op_ms``).  The library call is
    ``scaled_dot_product_attention`` with the same mask (``enable_gqa``
    where Hkv < Hq), a yardstick the port never calls."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    times = {}
    for m, dtype, key in ((FLASH_MAIN, torch.bfloat16, "flash_attention"),
                          (FLASH_MAIN, torch.float32, "flash_attention:f32"),
                          (FLASH_D128, torch.bfloat16, "flash_attention:d128"),
                          (FLASH_D128, torch.float32, "flash_attention:f32_d128"),
                          (FLASH_VLM, torch.bfloat16, "flash_attention:vlm"),
                          (FLASH_ENC, torch.bfloat16, "flash_attention:encdec"),
                          (FLASH_XDEC, torch.bfloat16, "flash_attention:xdec")):
        q, k, v = flash_inputs(gen, m["B"], m["Hq"], m["Hkv"], m["Sq"], m["Sk"], m["D"], dtype)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        gqa = {"enable_gqa": True} if m["Hkv"] < m["Hq"] else {}
        sdpa = torch.nn.functional.scaled_dot_product_attention
        causal = m["causal"]
        times[key] = {
            "ms": time_ms(lambda: fl_ops._launch(q, k, v, causal, m["D"] ** -0.5), 20),
            "plain_ms": time_ms(lambda: attention_ref(q, k, v, causal=causal), 5),
            "library_ms": time_ms(lambda: sdpa(q, k, v, is_causal=causal, **gqa), 20),
            "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "ops_ms": op_ms(flash_flops(m["B"], m["Hq"], m["Sq"], m["Sk"], m["D"], causal), dtype),
            "shape": f"q ({m['B']}, {m['Hq']}, {m['Sq']}, {m['D']}), k/v ({m['B']}, {m['Hkv']}, "
                     f"{m['Sk']}, {m['D']}) {'causal' if causal else 'full'} "
                     f"{str(dtype).split('.')[-1]}, {fl_ops.last_path} path",
        }
        check(fl_ops.last_path == flash_path(m["D"], dtype), f"{key}: took the {fl_ops.last_path} path")
        del q, k, v
    torch.cuda.empty_cache()
    return times


def paged_group_times() -> dict:
    """Paged attention at the decode shapes of the other served models, 8
    sequences of the main path's lengths on bf16 pages: granite_34b's (48
    query heads on one KV head of 128, ``"paged_attention:mqa48"``),
    granite_moe_3b_a800m's (24 on 8 KV heads of 64, ``":moe"``) and
    qwen2_vl_72b's (64 on 8 KV heads of 128, ``":vlm"``).  The bound counts
    what the main shape's counts: each sequence's K and V rows once, its
    table entries, the lengths, q and out; the products (q.k and p.v, 2
    flops a multiply-add) at the bf16 tensor cores' rate, where the group
    path runs them (its P V as two bf16 products, which the bound does not
    count: the least time of any design, as ``op_ms``)."""
    lens = main_lens()
    pages_read = sum(-(-n // BLOCK) for n in lens)
    times = {}
    for key, Hq, Hkv, D, arch in (("mqa48", 48, 1, 128, "granite_34b"),
                                  ("moe", 24, 8, 64, "granite_moe_3b_a800m"),
                                  ("vlm", 64, 8, 128, "qwen2_vl_72b")):
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, kp, vp, tbl, lens_t = paged_case(gen, MAX_SEQS, Hq, Hkv, D, lens, torch.bfloat16)
        qg = q.reshape(MAX_SEQS, Hkv, Hq // Hkv, D)
        scale = D ** -0.5
        item = q.element_size()
        nbytes = (2 * sum(lens) * Hkv * D * item + 2 * q.numel() * item + pages_read * 4
                  + lens_t.numel() * 4)
        times[f"paged_attention:{key}"] = {
            "ms": time_ms(lambda: pa_ops._launch(qg, kp, vp, tbl, lens_t, scale), 50),
            "plain_ms": time_ms(lambda: paged_attention_ref(qg, kp, vp, tbl, lens_t, scale=scale),
                                10),
            "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "ops_ms": op_ms(4 * Hq * D * sum(lens), torch.bfloat16),
            "library_ms": None,
            "shape": f"B={MAX_SEQS} Hq={Hq} Hkv={Hkv} D={D} bs={BLOCK} lens={lens} bf16 "
                     f"({arch} decode), {pa_ops.last_path} path",
        }
        check(pa_ops.last_path == paged_path(Hq // Hkv, D, torch.bfloat16),
              f"paged_attention:{key}: took the {pa_ops.last_path} path")
        del q, kp, vp
    torch.cuda.empty_cache()
    return times


def paged_fp8_times() -> dict:
    """Paged attention over fp8 pages at the main serving shape, q bf16: the
    bound counts one byte per K/V element."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    lens = main_lens()
    q, kp, vp, tbl, lens_t = paged_case(gen, MAX_SEQS, HEADS, HEADS, HEAD_DIM, lens, torch.bfloat16)
    kp, vp = kp.to(torch.float8_e4m3fn), vp.to(torch.float8_e4m3fn)
    qg = q.reshape(MAX_SEQS, HEADS, 1, HEAD_DIM)
    scale = HEAD_DIM ** -0.5
    pages_read = sum(-(-n // BLOCK) for n in lens)
    nbytes = (2 * sum(lens) * HEADS * HEAD_DIM + 2 * q.numel() * q.element_size()
              + pages_read * 4 + lens_t.numel() * 4)
    return {"paged_attention:fp8": {
        "ms": time_ms(lambda: pa_ops._launch(qg, kp, vp, tbl, lens_t, scale), 50),
        "plain_ms": time_ms(lambda: paged_attention_ref(qg, kp, vp, tbl, lens_t, scale=scale), 10),
        "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "ops_ms": 4 * HEADS * HEAD_DIM * sum(lens) / F32_FLOPS * 1e3,
        "library_ms": None,
        "shape": f"B={MAX_SEQS} Hq=Hkv={HEADS} D={HEAD_DIM} bs={BLOCK} q bf16, fp8 e4m3 pages",
    }}


def decay_flops(B, S, H, dk, dv, bonus: bool, shared_qk: bool = False) -> float:
    """The products the function needs, 2 flops a multiply-add, counted as
    ``flash_flops`` counts attention: in each 32-token chunk, q.k and A.v
    over the (query, key) pairs the mask leaves visible (strict with the
    bonus, which adds its diagonal term, dk + dv per token; inclusive
    without), then qs.state and the state update, dk dv per token each.
    With q and k shared by every head (stride 0, Mamba2's C and B), q.k is
    made once per batch row and pair, and each head only scales it by its
    decay (one flop per pair)."""
    lens = [min(CHUNK, S - s) for s in range(0, S, CHUNK)]
    pairs = sum(n * (n - 1) // 2 if bonus else n * (n + 1) // 2 for n in lens)
    per_head = pairs * dv + 2 * S * dk * dv + (S * (dk + dv) if bonus else 0)
    if shared_qk:
        return 2.0 * B * (pairs * dk + H * per_head) + B * H * pairs
    return 2.0 * B * H * (pairs * dk + per_head)


def decay_times() -> dict:
    """The decay kernel by path at the shapes the main path gives it: the
    rwkv6 serve shape (B 8, S 1024, H 64, 64/64, log_w f32, the bonus, h0
    and hT) in bf16 (``vector_tc``, key ``decay_attention``) and in f32
    (``vector_tc_f32``), and the zamba2 ``prefill_logits`` shape (B 4, S
    2048, H 112, state 64, head 64; C and B sliced from one 7296-wide row as
    ``mamba2.py`` slices ``xBC`` and broadcast over heads, the decay over the
    state, no h0, hT written) in bf16 (``scalar_tc``, key
    ``decay_attention:zamba2``) and in f32 (``scalar_tc_f32``).  The bound
    counts each distinct input byte read once (a stride-0 input once) and
    each output written once, and the visible pairs' products
    (``decay_flops``) at the least time of a design that holds the
    tolerance (``op_ms``: bf16 tensor cores; in f32 3xTF32 or CUDA cores).
    No library call computes this function."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    B, S, H, d = STATE_BATCH, STATE_PROMPT, 64, 64
    q, k, v = (torch.randn(B, S, H, d, generator=gen, device="cuda").bfloat16() for _ in range(3))
    lw = -torch.rand(B, S, H, d, generator=gen, device="cuda") * 2
    u = torch.randn(H, d, generator=gen, device="cuda") * 0.3
    h0 = torch.randn(B, H, d, d, generator=gen, device="cuda")
    n = B * S * H * d
    times = {}
    for key, dtype in (("decay_attention", torch.bfloat16),
                       ("decay_attention:vector_tc_f32", torch.float32)):
        qt, kt, vt = q.to(dtype), k.to(dtype), v.to(dtype)
        path = dc_ops.kernel_path(qt, kt, vt, lw)
        times[key] = {
            "ms": time_ms(lambda: dc_ops._launch(qt, kt, vt, lw, u, h0, True), 20),
            "plain_ms": time_ms(lambda: chunked_decay_ref(qt, kt, vt, lw, bonus=u,
                                                          initial_state=h0, return_state=True), 5),
            "bytes_ms": (4 * n * dtype.itemsize + n * 4 + 2 * B * H * d * d * 4 + H * d * 4)
                        / HBM_BYTES_PER_S * 1e3,
            "ops_ms": op_ms(decay_flops(B, S, H, d, d, bonus=True), dtype),
            "library_ms": None,
            "shape": f"rwkv6 serve: q/k/v ({B}, {S}, {H}, {d}) {_dt(dtype)}, "
                     f"log_w f32, bonus, h0 and hT; {path} path",
        }
        check(dc_ops.last_path == path, f"{key}: took the {dc_ops.last_path} path")
        del qt, kt, vt
    del q, k, v, lw, h0
    B, S, H, ns, hd, d_in = 4, 2048, 112, 64, 64, 7168
    xBC = torch.randn(B, S, d_in + 2 * ns, generator=gen, device="cuda")
    lw = (-torch.rand(B, S, H, generator=gen, device="cuda") * 2)[..., None].expand(B, S, H, ns)
    v32 = torch.randn(B, S, H, hd, generator=gen, device="cuda")
    for key, dtype in (("decay_attention:zamba2", torch.bfloat16),
                       ("decay_attention:scalar_tc_f32", torch.float32)):
        x = xBC.to(dtype)
        q = x[:, :, None, d_in + ns:].expand(B, S, H, ns)
        k = x[:, :, None, d_in:d_in + ns].expand(B, S, H, ns)
        v = v32.to(dtype)
        item = dtype.itemsize
        path = dc_ops.kernel_path(q, k, v, lw)
        times[key] = {
            "ms": time_ms(lambda: dc_ops._launch(q, k, v, lw, None, None, True), 20),
            "plain_ms": time_ms(lambda: chunked_decay_ref(q, k, v, lw, return_state=True), 5),
            "bytes_ms": (2 * B * S * ns * item + B * S * H * 4 + 2 * B * S * H * hd * item
                         + B * H * ns * hd * 4) / HBM_BYTES_PER_S * 1e3,
            "ops_ms": op_ms(decay_flops(B, S, H, ns, hd, bonus=False, shared_qk=True), dtype),
            "library_ms": None,
            "shape": f"zamba2 prefill: C/B ({B}, {S}, {ns}) {_dt(dtype)} of a {d_in + 2 * ns}-wide "
                     f"row, stride 0 over {H} heads, log_w stride 0 over the state, v ({B}, {S}, "
                     f"{H}, {hd}) {_dt(dtype)}, hT; {path} path",
        }
        check(dc_ops.last_path == path, f"{key}: took the {dc_ops.last_path} path")
        del x, q, k, v
    del xBC, lw, v32
    torch.cuda.empty_cache()
    return times


def bulk_op_times() -> dict:
    """``bulk_op`` at the bitmap query's shape (2 GiB uint8 operands) for
    and, or, not, maj and zero.  The bound counts each operand read once and
    the output written once; operations are 32-bit logic ops at the float32
    rate outside the tensor cores.  The library call is one PyTorch call of
    the same function: for and, or and not that is the plain version's own
    call (``torch.bitwise_*``), so its one time stands for both; ``zero_``
    for zero; none for maj."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    n = BITMAP_ROWS // 8
    xs = [torch.randint(0, 256, (n,), generator=gen, device="cuda", dtype=torch.uint8)
          for _ in range(3)]
    out = torch.empty_like(xs[0])
    word_ops = {"and": 1, "or": 1, "not": 1, "maj": 5, "zero": 0}
    times = {}
    for op, per_word in word_ops.items():
        code, arity = bc_ops._BULK_OPS[op]
        ins = xs[:arity]
        plain_ms = time_ms(lambda: bulk_op_ref(*(ins or xs[:1]), op=op), 20)
        if op == "zero":
            library_ms = time_ms(out.zero_, 20)
        else:
            library_ms = plain_ms if op in ("and", "or", "not") else None
        times[f"bulk_op:{op}"] = {
            "ms": time_ms(lambda: bc_ops._launch_bulk(code, out, ins, 0xFF), 50),
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bytes_ms": (arity + 1) * n / HBM_BYTES_PER_S * 1e3,
            "ops_ms": per_word * (n // 4) / F32_FLOPS * 1e3,
            "shape": f"{arity} x {n} B uint8 in, {n} B out"
                     + (" (library = plain, same call)" if op in ("and", "or", "not") else ""),
        }
    del xs, out
    torch.cuda.empty_cache()
    return times


def main() -> None:
    name = phase_device()
    phase_build()
    errs = phase_kernels()
    bitmap = phase_bitmap()
    phase_pud_host()
    phase_gemv()
    serve_eager = phase_serve(jit=False)
    serve = phase_serve()
    serve_maint = phase_serve(MAINTENANCE)
    check(serve["ids"] == serve_eager["ids"], "the graphed serve's ids differ from the eager serve's")
    check(serve_maint["ids"] == serve["ids"],
          "generated ids differ with compaction from the run without it")
    for run, what in ((serve, "the graph"), (serve_maint, "maintenance")):
        check(run["steps"] == serve_eager["steps"] and run["launches"]["paged_attention"]
              == serve_eager["launches"]["paged_attention"], f"{what} changed the schedule")
    log(f"[serve graph+maint] {serve_maint['compaction_passes']} compaction passes moved "
        f"{serve_maint['blocks_migrated']} blocks; ids identical to the eager and graphed serves")
    for key in ("decode_tokens_per_s", "mean_decode_step_ms", "decode_steps_timed", "captures",
                "capture_ms"):
        log(f"[serve] {key}: eager {serve_eager[key]}, graphed {serve[key]}, "
            f"graphed+maint {serve_maint[key]}")
    granite = phase_granite_serve()
    moe = phase_moe_serve()
    vlm = phase_vlm()
    encdec = phase_encdec()
    phase_small_vs_cpu()
    phase_smoke_flash_vs_cpu()
    ckpt_root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        train = phase_train(ckpt_root)
        params = train.pop("params")
        flash = phase_flash_forward("stablelm_1_6b", params)
        # the same trained weights in f32: the flash kernel's tf32x3 path
        params = tree_map(lambda t: t.float(), params)
        flash32 = phase_flash_forward("stablelm_1_6b", params, dtype="float32")
        del params
        torch.cuda.empty_cache()
        phase_small_train_vs_cpu(ckpt_root)
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    phase_dist()
    phase_train_families()
    gqa = phase_gqa_forward()
    state = {arch: phase_state_model(arch, seed) for arch, seed in (("rwkv6_7b", 3),
                                                                     ("zamba2_7b", 4))}
    state32 = {arch: phase_state_f32(arch, seed) for arch, seed in (("rwkv6_7b", 3),
                                                                    ("zamba2_7b", 4))}
    phase_state_small_vs_cpu()
    phase_roofline()
    times = phase_times()
    log(f"[times] paged_attention:moe launches on the graphed MoE serve: "
        f"{moe['graph']['paged_launches']}")
    log(f"[times] paged_attention:vlm launches on the graphed vlm serve: "
        f"{vlm['graph']['paged_launches']}; flash_attention:vlm launches in its eval and "
        f"prefill: {vlm['forward']['launches_total']}")
    log(f"[times] flash_attention:encdec launches in seamless_m4t_medium's eval and prefill "
        f"and its decode's encoder: {encdec['forward']['launches_total']} + "
        f"{encdec['enc_launches']}; flash_attention:xdec launches in its decode steps: "
        f"{encdec['step_launches']}")
    log(f"[times] paged_attention:group launches on the graphed granite, MoE and vlm serves: "
        f"{granite['graph']['group_launches']} + {moe['graph']['group_launches']} + "
        f"{vlm['graph']['group_launches']}")
    launches = {"paged_attention": (serve_maint["launches"]["paged_attention"]
                                    + granite["graph"]["paged_launches"]
                                    + moe["graph"]["paged_launches"]
                                    + vlm["graph"]["paged_launches"]),
                "block_copy": (serve_maint["launches"]["block_copy"]
                               + moe["graph"]["block_copy_launches"]
                               + vlm["graph"]["block_copy_launches"]),
                "bulk_op": bitmap["launches"]["bulk_op"],
                "flash_attention": (flash["launches_total"] + gqa["launches_total"]
                                    + flash32["launches_total"]
                                    + vlm["forward"]["launches_total"]
                                    + encdec["launches_total"]),
                "decay_attention": sum(r["launches"] for r in state.values()),
                "decay_attention:vector_tc_f32": state32["rwkv6_7b"]["launches"],
                "decay_attention:scalar_tc_f32": state32["zamba2_7b"]["launches"],
                "paged_attention:group": (granite["graph"]["group_launches"]
                                          + moe["graph"]["group_launches"]
                                          + vlm["graph"]["group_launches"])}
    errs["bulk_op"] = bitmap["max_abs_err"]
    times["bulk_op"] = times["bulk_op:and"]
    for k, (time_row, err_row) in PATH_ROWS.items():
        times[k], errs[k] = times[time_row], errs[err_row]
    line = {"kernels": []}
    for k, (source, replaces) in SOURCES.items():
        t = times[k]
        line["kernels"].append({
            "name": k, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[k],
            "max_abs_err": errs["main-bf16"] if k == "paged_attention" else errs[k],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
        check(all(math.isfinite(t[x]) for x in ("ms", "plain_ms", "bound_ms")), f"{k} times")
        check(launches[k] > 0, f"{k}: no launch on the main path")
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
