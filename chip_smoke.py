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
  served through ``ServeEngine`` with a fork part-way, once as it is and
  once with watermark maintenance, whose compaction passes move KV pages
  through the block-copy kernel and must leave the generated ids unchanged;
* the full-width stablelm_1_6b trained for 20 steps by
  ``repro_torch.launch.train --full`` (chunked attention, full remat,
  AdamW, checkpointed), then evaluated and prefilled at 4 x 2048 tokens
  through the flash-attention kernel (``attn_impl="pallas"``), held against
  the chunked path on the same weights.

It also runs the PUD host model (the quickstart's allocator table and the
paper's Figure 2, modelled DRAM times), holds the card's generated ids and
training losses against the CPU at smoke size, and times each kernel beside
its bound.  Any failed check raises, so the script exits non-zero without
its last line; that line is ``{"ok": true, "device": {...}}``.  Without a
CUDA device it exits non-zero at once.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
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
from repro_torch.data.pipeline import DataConfig, synth_batch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fl_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa_ops  # noqa: E402
from repro_torch.kernels.paged_attention.ref import paged_attention_ref  # noqa: E402
from repro_torch.kernels.pud_bulk import ops as bc_ops  # noqa: E402
from repro_torch.kernels.pud_bulk.ref import block_copy_ref, bulk_op_ref  # noqa: E402
from repro_torch.models.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.models.layers import pad_vocab  # noqa: E402
from repro_torch.models.params import count_params  # noqa: E402
from repro_torch.models.transformer import LM  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.robustness import check_kv_pool  # noqa: E402
from repro_torch.serve.engine import MaintenanceConfig, Request, ServeEngine  # noqa: E402
from repro_torch.train.step import build_eval_step  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores
BF16_TC_FLOPS = 989e12         # H100 SXM bf16 tensor cores, dense
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # the reference's own tolerances
BF16_ULP = 2.0 ** -7           # bf16 cases also: within one ulp of the plain output
SOURCES = {
    "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention/kernel.py:74"),
    "block_copy": ("src/repro_torch/csrc/block_copy.cu",
                   "src/repro/kernels/pud_bulk/kernel.py:125"),
    "bulk_op": ("src/repro_torch/csrc/bulk_op.cu",
                "src/repro/kernels/pud_bulk/kernel.py:84"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:87"),
}
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
# whole-model bf16 tolerances, flash path against chunked on the same weights:
# the two differ in where attention rounds (flash rounds P to bf16 before
# P.V), which bf16 layers carry to the loss and the logits
EVAL_LOSS_RTOL = 1e-2
LOGITS_TOL = 5e-2              # of the logits' largest magnitude
# smoke training, card against CPU, f32: the first step's loss is one
# forward of the same weights; later steps follow AdamW, which moves every
# element by about lr whatever the size of its gradient, so float32
# rounding of near-zero gradients parts the runs a little more each step
SMALL_TRAIN_TOL = (1e-4, 1e-2)  # relative: step 1, steps 2-5
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
    B, Hq, D = q.shape
    qg = q.reshape(B, kp.shape[2], Hq // kp.shape[2], D)
    return paged_attention_ref(qg, kp, vp, tbl, lens, scale=D ** -0.5).reshape(q.shape)


def main_lens():
    return sorted(int(x) for x in np.random.default_rng(0).integers(64, 1025, size=MAX_SEQS))


def phase_kernels() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {}
    cases = [
        ("main-bf16", dict(B=MAX_SEQS, Hq=HEADS, Hkv=HEADS, D=HEAD_DIM, lens=main_lens(), dtype=torch.bfloat16)),
        ("main-f32", dict(B=MAX_SEQS, Hq=HEADS, Hkv=HEADS, D=HEAD_DIM, lens=main_lens(), dtype=torch.float32)),
        ("gqa-bf16", dict(B=4, Hq=32, Hkv=8, D=128, lens=[0, 1, 300, 1024], dtype=torch.bfloat16)),
        ("gqa-f32", dict(B=4, Hq=32, Hkv=8, D=128, lens=[0, 17, 300, 1000], dtype=torch.float32)),
    ]
    for name, kw in cases:
        args = paged_case(gen, **kw)
        out = pa_ops.paged_attention(*args)
        torch.cuda.synchronize()
        plain = paged_plain(*args)
        diff = (out.float() - plain.float()).abs()
        err = diff.max().item()
        errs[name] = err
        log(f"[kernels] paged_attention {name}: max_abs_err {err:.3e} (tol {TOL[kw['dtype']]:g})")
        check(out.dtype == kw["dtype"] and out.shape == args[0].shape, f"{name}: output type/shape")
        check(err < TOL[kw["dtype"]], f"paged_attention {name}: err {err} over tolerance")
        if kw["dtype"] == torch.bfloat16:
            # kernel and plain version round the same f32 result to bf16
            check(bool((diff <= BF16_ULP * plain.float().abs() + 1e-5).all()),
                  f"paged_attention {name}: more than one bf16 ulp from the plain version")
        if kw["lens"][0] == 0:
            check(bool((out[0] == 0).all()), f"{name}: a length-0 row must give zeros")

    errs.update(paged_fp8_case(gen))
    errs.update(flash_cases())

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
    """fp8 e4m3 K/V pages at the main serving shape, q in bf16 and f32."""
    errs = {}
    for qdt in (torch.bfloat16, torch.float32):
        q, kp, vp, tbl, lens = paged_case(gen, MAX_SEQS, HEADS, HEADS, HEAD_DIM, main_lens(), qdt)
        kp, vp = kp.to(torch.float8_e4m3fn), vp.to(torch.float8_e4m3fn)
        out = pa_ops.paged_attention(q, kp, vp, tbl, lens)
        torch.cuda.synchronize()
        plain = paged_plain(q, kp, vp, tbl, lens)
        err = (out.float() - plain.float()).abs().max().item()
        name = f"fp8-pages-{str(qdt).split('.')[-1]}"
        errs[name] = err
        log(f"[kernels] paged_attention {name}: max_abs_err {err:.3e} (tol 2e-2)")
        check(out.dtype == qdt and out.shape == q.shape, f"{name}: output type/shape")
        check(err < 2e-2, f"paged_attention {name}: err {err} over tolerance")
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
]


def flash_inputs(gen, B, Hq, Hkv, Sq, Sk, D, dtype):
    return [torch.randn(*shape, generator=gen, device="cuda").to(dtype)
            for shape in ((B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D))]


def flash_cases() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(7)
    errs = {}
    for B, Hq, Hkv, Sq, Sk, D, causal, dtype in FLASH_CASES:
        q, k, v = flash_inputs(gen, B, Hq, Hkv, Sq, Sk, D, dtype)
        out = fl_ops.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        path = fl_ops.last_path
        plain = attention_ref(q, k, v, causal=causal)
        err = (out.float() - plain.float()).abs().max().item()
        name = f"flash B{B} H{Hq}/{Hkv} S{Sq}x{Sk} D{D} {'causal' if causal else 'full'} " \
               f"{str(dtype).split('.')[-1]}"
        errs[name] = err
        log(f"[kernels] {name} ({path}): max_abs_err {err:.3e} (tol {TOL[dtype]:g})")
        check(out.dtype == dtype and out.shape == q.shape, f"{name}: output type/shape")
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
                      maintenance: MaintenanceConfig = None) -> ServeEngine:
    """The full-width stablelm_1_6b serve on the card: random weights from a
    seeded generator, the main-path pool, and ``n_requests`` submitted
    requests with seeded prompts of 64-512 tokens.  Phase 4 drives it;
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
    engine = ServeEngine(model, params, pool_cfg, device="cuda", maintenance=maintenance)
    log(f"[serve] K+V pool {2 * engine.pool.k.numel() * engine.pool.k.element_size() / 1e9:.2f} GB")
    rng = np.random.default_rng(seed)
    for rid in range(n_requests):
        n = int(rng.integers(64, 513))
        engine.submit(Request(rid=rid, prompt=rng.integers(0, cfg.vocab_size, n).tolist(),
                              max_new=max_new))
    return engine


def phase_serve(maintenance: MaintenanceConfig = None) -> dict:
    """Serve 12 requests at full width with a fork part-way, the launch
    counts zeroed just before and read just after.  With ``maintenance``,
    every compaction pass is checked as it happens: the pool's invariants
    hold and every live sequence's K/V pages moved bit-exactly."""
    max_new = 32
    engine = full_width_engine(12, max_new, maintenance=maintenance)
    model, params, cfg = engine.model, engine.params, engine.cfg
    tag = "[serve+maint]" if maintenance else "[serve]"
    contig = []
    engine.step_hooks.append(lambda eng, s: contig.append(s["contiguity"]) if s["live"] else None)
    passes = watch_compaction(engine) if maintenance else []

    kernels.reset_launches()
    decode_s, decode_tok, step_ms, fork = 0.0, 0, [], None
    t_run = time.perf_counter()
    alive = True
    while alive:
        pre_tok, pre_fill = engine.tokens_decoded, engine.tokens_prefilled
        pre_passes = engine.compaction_passes
        t0 = time.perf_counter()
        alive = engine.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if (engine.tokens_prefilled == pre_fill and engine.tokens_decoded > pre_tok
                and engine.compaction_passes == pre_passes):
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
        "fork": fork,
    }
    for k, v in out.items():
        log(f"{tag} {k}: {v}")
    out["ids"] = {r.rid: list(r.out) for r in done}
    del engine, params
    torch.cuda.empty_cache()
    return out


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
    log(f"[serve] fork of slot {slot} at step {engine.steps}: {len(pb)} blocks x 24 layers, "
        f"pages equal; {info['same_arena']:.2f} of blocks in the parent's arena")
    return info


# -- phase 5 -----------------------------------------------------------------

def phase_small_vs_cpu() -> None:
    cfg = get_config("stablelm_1_6b").smoke()
    model = LM(cfg)
    tree = params_to_numpy(model.init(torch.Generator().manual_seed(1), device="cpu"))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(4, 40))).tolist() for _ in range(6)]
    outs = {}
    for dev in ("cuda", "cpu"):
        pool_cfg = KVPoolConfig(
            num_blocks=64, block_size=8, kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
            n_layers=cfg.n_layers, max_seqs=3, max_blocks_per_seq=16,
            blocks_per_arena=16, dtype="float32")
        eng = ServeEngine(model, params_from_numpy(model, tree, device=dev), pool_cfg, device=dev)
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=p, max_new=8))
        outs[dev] = {r.rid: r.out for r in eng.run()}
    check(len(outs["cuda"]) == 6 and outs["cuda"] == outs["cpu"],
          f"card and CPU ids differ: {outs}")
    log(f"[small] smoke config, 6 requests x 8 ids: card ids == CPU ids")


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


def _first_layers(cfg, params, n):
    """The model of the first ``n`` layers of ``params`` (views, no copy)."""
    layers = {k: {kk: t[:n] for kk, t in v.items()} for k, v in params["layers"].items()}
    return dataclasses.replace(cfg, n_layers=n), dict(params, layers=layers)


def phase_flash_forward(params) -> dict:
    """The trained full-width weights evaluated (``build_eval_step``) and
    prefilled (``prefill_logits``) at 4 x 2048 tokens through the flash
    kernel (``attn_impl="pallas"``), each forward with the launch counts
    zeroed just before it and read just after (24 launches each); held
    against ``attn_impl="chunked"`` on the same weights.

    Under the reference's init rule the full-width model is chaotic in
    depth: two plain attention paths that differ only in float rounding give
    24-layer prefill logits O(1) apart (the reference too: ROADMAP.md,
    faults).  So the 24-layer eval loss, an average over 8192 positions, is
    held to ``EVAL_LOSS_RTOL``; the prefill logits of the first layer of the
    same weights, where rounding is not yet amplified, to ``LOGITS_TOL`` of
    their scale; and the logits after 4 and 24 layers are reported beside
    the spread of the two plain paths (naive against chunked)."""
    cfg = get_config("stablelm_1_6b")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=FLASH_MAIN["Sq"],
                      batch_per_shard=FLASH_MAIN["B"])
    batch = {k: torch.from_numpy(v).cuda() for k, v in synth_batch(data, 0, 0).items()}
    prompts = {"tokens": torch.from_numpy(synth_batch(data, 1, 0)["tokens"]).cuda(),
               "positions": batch["positions"]}
    res = {"launches": {}, "prefill": {}}
    loss = {}
    for impl in ("pallas", "chunked"):
        y, res[f"eval_{impl}_ms"], n = _forward(LM(cfg, attn_impl=impl), "eval", params, batch)
        check(n == (cfg.n_layers if impl == "pallas" else 0),
              f"eval ({impl}): {n} flash_attention launches, not {cfg.n_layers}")
        res["launches"][f"eval_{impl}"] = n
        loss[impl] = float(y)
    res["eval_loss"] = {**loss, "rel_diff": abs(loss["pallas"] - loss["chunked"]) / abs(loss["chunked"])}
    for depth in (1, 4, cfg.n_layers):
        cfg_d, params_d = _first_layers(cfg, params, depth)
        z = {}
        for impl in ("pallas", "chunked", "naive"):
            y, ms, n = _forward(LM(cfg_d, attn_impl=impl), "prefill", params_d, prompts)
            check(n == (depth if impl == "pallas" else 0),
                  f"prefill ({impl}, {depth} layers): {n} flash_attention launches, not {depth}")
            if impl == "pallas":
                check(fl_ops.last_path == "mma", f"the bf16 forward took the {fl_ops.last_path} path")
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
    log(f"[flash-path] eval loss at 4 x 2048 ({cfg.n_layers} layers): flash {el['pallas']:.5f}, "
        f"chunked {el['chunked']:.5f} (rel diff {el['rel_diff']:.2e}, tol {EVAL_LOSS_RTOL:g}); "
        f"{cfg.n_layers} flash launches per forward")
    for depth, r in pf.items():
        log(f"[flash-path] prefill logits after {depth} layer(s): flash vs chunked max abs diff "
            f"{r['flash_vs_chunked']:.4f}, naive vs chunked {r['naive_vs_chunked']:.4f}, of scale "
            f"{r['scale']:.3f}; argmax equal {r['argmax_equal']}/{FLASH_MAIN['B']}"
            + (f" (tol {LOGITS_TOL:g} of scale)" if depth == 1 else ""))
    log(f"[flash-path] forward ms (host clock incl. sync): eval flash {res['eval_pallas_ms']:.1f}, "
        f"chunked {res['eval_chunked_ms']:.1f}; prefill flash {res['prefill_pallas_ms']:.1f}, "
        f"chunked {res['prefill_chunked_ms']:.1f}, naive {res['prefill_naive_ms']:.1f}")
    check(el["rel_diff"] < EVAL_LOSS_RTOL, "eval loss: flash vs chunked over tolerance")
    check(pf[1]["flash_vs_chunked"] < LOGITS_TOL * pf[1]["scale"],
          "1-layer prefill logits: flash vs chunked over tolerance")
    res["launches_total"] = res["launches"]["eval_pallas"] + res["launches"]["prefill_pallas"]
    return res


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


# -- phase 6 -----------------------------------------------------------------

def time_ms(fn, reps: int) -> float:
    """Median device time of one call, with the 50 MB L2 flushed before each
    (the main path finds every layer's pages cold)."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


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
    del q, kp, vp
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
    for name, t in times.items():
        t["bound_ms"] = max(t["bytes_ms"], t["ops_ms"])
        t["bound_by"] = "bytes" if t["bytes_ms"] >= t["ops_ms"] else "operations"
        log(f"[times] {name} ({t['shape']}): kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
            f"library {t['library_ms']}, bound {t['bound_ms']:.4f} ms ({t['bound_by']}), "
            f"kernel at {100 * t['bound_ms'] / t['ms']:.1f}% of bound")
    return times


def flash_flops(B, Hq, Sq, Sk, D, causal) -> float:
    """Multiply-adds of q.k and p.v (2 flops each) over the (query, key)
    pairs the mask leaves visible."""
    if causal:
        pairs = sum(min(i + 1, Sk) for i in range(Sq))
    else:
        pairs = Sq * Sk
    return 4.0 * B * Hq * D * pairs


def flash_times() -> dict:
    """The flash kernel at its main shape (4 x 32 heads x 2048 x 64, causal),
    bf16 (the main path's type: tensor cores) and f32 (CUDA cores).  The
    bound counts q, k, v read once and the output written once, and the
    visible pairs' operations at the type's peak rate.  The library call is
    ``scaled_dot_product_attention(is_causal=True)``, a yardstick the port
    never calls."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    m = FLASH_MAIN
    times = {}
    for dtype, peak, key in ((torch.bfloat16, BF16_TC_FLOPS, "flash_attention"),
                             (torch.float32, F32_FLOPS, "flash_attention:f32")):
        q, k, v = flash_inputs(gen, m["B"], m["Hq"], m["Hkv"], m["Sq"], m["Sk"], m["D"], dtype)
        nbytes = 4 * q.numel() * q.element_size()
        sdpa = torch.nn.functional.scaled_dot_product_attention
        times[key] = {
            "ms": time_ms(lambda: fl_ops._launch(q, k, v, True, m["D"] ** -0.5), 20),
            "plain_ms": time_ms(lambda: attention_ref(q, k, v, causal=True), 5),
            "library_ms": time_ms(lambda: sdpa(q, k, v, is_causal=True), 20),
            "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "ops_ms": flash_flops(m["B"], m["Hq"], m["Sq"], m["Sk"], m["D"], True) / peak * 1e3,
            "shape": f"q/k/v ({m['B']}, {m['Hq']}, {m['Sq']}, {m['D']}) causal "
                     f"{str(dtype).split('.')[-1]}, {fl_ops.last_path} path",
        }
        del q, k, v
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
    serve = phase_serve()
    serve_maint = phase_serve(MAINTENANCE)
    check(serve_maint["ids"] == serve["ids"],
          "generated ids differ with compaction from the run without it")
    check(serve_maint["steps"] == serve["steps"]
          and serve_maint["launches"]["paged_attention"] == serve["launches"]["paged_attention"],
          "maintenance changed the schedule")
    log(f"[serve+maint] {serve_maint['compaction_passes']} compaction passes moved "
        f"{serve_maint['blocks_migrated']} blocks; ids identical to the run without maintenance")
    phase_small_vs_cpu()
    ckpt_root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        train = phase_train(ckpt_root)
        flash = phase_flash_forward(train.pop("params"))
        torch.cuda.empty_cache()
        phase_small_train_vs_cpu(ckpt_root)
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    times = phase_times()
    launches = {"paged_attention": serve_maint["launches"]["paged_attention"],
                "block_copy": serve_maint["launches"]["block_copy"],
                "bulk_op": bitmap["launches"]["bulk_op"],
                "flash_attention": flash["launches_total"]}
    errs["bulk_op"] = bitmap["max_abs_err"]
    times["bulk_op"] = times["bulk_op:and"]
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
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
