#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root (it puts ``src`` on ``sys.path`` itself).  It
builds the hand-written kernels from ``src/repro_torch/csrc`` into
``build/kernels/``, holds each against its plain PyTorch version on the
card, serves the full-width stablelm_1_6b (random weights from a seeded
generator) through ``ServeEngine`` with a fork part-way, checks that the
kernels carried that run, holds the card's generated ids against the CPU at
smoke size, and times each kernel beside its bound.  Any failed check
raises, so the script exits non-zero without its last line; that line is
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits non-zero
at once.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.kv_pool import KVPoolConfig  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa_ops  # noqa: E402
from repro_torch.kernels.paged_attention.ref import paged_attention_ref  # noqa: E402
from repro_torch.kernels.pud_bulk import ops as bc_ops  # noqa: E402
from repro_torch.kernels.pud_bulk.ref import block_copy_ref  # noqa: E402
from repro_torch.models.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.models.layers import pad_vocab  # noqa: E402
from repro_torch.models.params import count_params  # noqa: E402
from repro_torch.models.transformer import LM  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # the reference's own tolerances
BF16_ULP = 2.0 ** -7           # bf16 cases also: within one ulp of the plain output
SOURCES = {
    "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention/kernel.py:74"),
    "block_copy": ("src/repro_torch/csrc/block_copy.cu",
                   "src/repro/kernels/pud_bulk/kernel.py:125"),
}
# the full-width serving shapes (stablelm_1_6b, bf16)
N_LAYERS, HEADS, HEAD_DIM, BLOCK = 24, 32, 64, 16
NUM_BLOCKS, MAX_SEQS, MAX_BLOCKS = 2048, 8, 64


def log(*args) -> None:
    print(*args, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


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
    errs["block_copy"] = 0.0
    del pool, orig, plain
    torch.cuda.empty_cache()
    return errs


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

def full_width_engine(n_requests: int, max_new: int, seed: int = 0) -> ServeEngine:
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
    engine = ServeEngine(model, params, pool_cfg, device="cuda")
    log(f"[serve] K+V pool {2 * engine.pool.k.numel() * engine.pool.k.element_size() / 1e9:.2f} GB")
    rng = np.random.default_rng(seed)
    for rid in range(n_requests):
        n = int(rng.integers(64, 513))
        engine.submit(Request(rid=rid, prompt=rng.integers(0, cfg.vocab_size, n).tolist(),
                              max_new=max_new))
    return engine


def phase_serve() -> dict:
    max_new = 32
    engine = full_width_engine(12, max_new)
    model, params, cfg = engine.model, engine.params, engine.cfg
    contig = []
    engine.step_hooks.append(lambda eng, s: contig.append(s["contiguity"]) if s["live"] else None)

    kernels.reset_launches()
    decode_s, decode_tok, step_ms, fork = 0.0, 0, [], None
    t_run = time.perf_counter()
    alive = True
    while alive:
        pre_tok, pre_fill = engine.tokens_decoded, engine.tokens_prefilled
        t0 = time.perf_counter()
        alive = engine.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if engine.tokens_prefilled == pre_fill and engine.tokens_decoded > pre_tok:
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
    check(launches["block_copy"] == 2, f"block_copy launches {launches['block_copy']} != 2 (K, V)")
    m = engine.metrics()
    # one more full-width forward, to check the logits themselves
    logits = model.prefill_logits(params, {
        "tokens": torch.tensor([done[0].prompt[:64]], device="cuda"),
        "positions": torch.arange(64, device="cuda")[None]})
    check(tuple(logits.shape) == (1, vocab) and bool(torch.isfinite(logits).all()),
          "full-width logits not finite")
    out = {
        "requests_done": len(done), "steps": engine.steps,
        "tokens_decoded": engine.tokens_decoded, "tokens_prefilled": engine.tokens_prefilled,
        "decode_steps_timed": len(step_ms), "decode_tokens_per_s": decode_tok / decode_s,
        "mean_decode_step_ms": statistics.mean(step_ms),
        "run_s": run_s, "tokens_per_s_incl_prefill": engine.tokens_decoded / run_s,
        "launches": launches,
        "mean_live_contiguity": statistics.mean(contig), "final_metrics_contiguity":
            m["mean_contiguous_fraction"], "align_hits": m["align_hits"],
        "align_misses": m["align_misses"], "preemptions": m["preemptions"],
        "fork": fork,
    }
    for k, v in out.items():
        log(f"[serve] {k}: {v}")
    del engine, params
    torch.cuda.empty_cache()
    return out


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
    for name, t in times.items():
        t["bound_ms"] = max(t["bytes_ms"], t["ops_ms"])
        t["bound_by"] = "bytes" if t["bytes_ms"] >= t["ops_ms"] else "operations"
        log(f"[times] {name} ({t['shape']}): kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
            f"library {t['library_ms']}, bound {t['bound_ms']:.4f} ms ({t['bound_by']}), "
            f"kernel at {100 * t['bound_ms'] / t['ms']:.1f}% of bound")
    del pool
    torch.cuda.empty_cache()
    return times


def main() -> None:
    name = phase_device()
    phase_build()
    errs = phase_kernels()
    serve = phase_serve()
    phase_small_vs_cpu()
    times = phase_times()
    line = {"kernels": []}
    for k, (source, replaces) in SOURCES.items():
        t = times[k]
        line["kernels"].append({
            "name": k, "route": "cuda", "source": source, "replaces": replaces,
            "launches": serve["launches"][k],
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
