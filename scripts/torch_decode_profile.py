#!/usr/bin/env python3
"""Where a decode step of the PyTorch/CUDA port spends its time, eager and
as a CUDA graph, in one call.

    python3 scripts/torch_decode_profile.py [--arch stablelm_1_6b] [--steps 5] [--out build/profile]

``--arch stablelm_1_6b`` (the default) serves the full-width model (random
weights from a seeded generator) through ``ServeEngine``, built as
``chip_smoke.py`` builds its serve (``full_width_engine``), with 8 requests
of 64-512 prompt tokens, twice: with ``jit=False`` (eager) and with
``jit=True`` (the decode step replays a CUDA graph).  In each, one step
admits and prefills all of them, a few decode steps warm up (and capture the
graph), then ``--steps`` pure decode steps run with the profiler off and
``--steps`` more under ``torch.profiler``.

``--arch granite_moe_3b_a800m`` serves the full-width MoE model the same
way, built as ``chip_smoke.py``'s MoE phase builds it (``moe_engine``), and
then times each piece of the MoE layer at the decode shape (8 tokens), for
all 32 layers' weights in one CUDA graph: routing (router product, softmax,
sort, positions), dispatch (the index add into the capacity buffer), the
expert products, combine (the gather and the gate-weighted sum), and the
whole block with its aux loss.

``--arch qwen2_vl_72b`` serves the full-width vlm model cut to 16 of its 80
layers the same way, built as ``chip_smoke.py``'s vlm phase builds it
(``vlm_engine``; (B, 1, 3) M-RoPE positions in every decode step).

``--arch rwkv6_7b`` or ``zamba2_7b`` drives the state path of
``chip_smoke.py``'s ``phase_state_model`` (the same seeded weights, inert
leaves set): 8 prompts of 1024 tokens through ``decode_step`` (and
``flush_cache``), once to warm up and then profiled as a window of its own
(2 prompts off, 2 on), then greedy one-token steps as above from a fresh
prompt cache: eager, and for rwkv6 also as a CUDA graph
(``repro_torch.graphs.decode_step_jit``; zamba2's step is not captured).

For each window it prints the step time with the profiler off (host clock
around the step and a synchronize), the device-busy time per step (union
of kernel and copy intervals on the device), the device idle share against
the unprofiled step time, device events and host launch calls per step
(``cudaLaunchKernel``, ``cudaGraphLaunch``, copies), the device time by
kind of kernel (``CATEGORIES``: by name), and the top kernels by device time
and operators by host time.  Writes the summary as JSON and
the Chrome trace under ``--out``.  Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402  (puts src on sys.path)
from chip_smoke import (MAX_SEQS, MOE_ARCH, STATE_BATCH, STATE_PROMPT, VLM_ARCH,  # noqa: E402
                        full_width_engine, moe_engine, vlm_engine)
from repro_torch.graphs import decode_step_jit  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models.transformer import layer_params  # noqa: E402

STATE_ARCHS = ("rwkv6_7b", "zamba2_7b")
# a step's device time by kind of kernel: the first kind whose pattern is in
# a kernel's name takes it (the rest is "other")
CATEGORIES = (
    ("paged attention", ("paged_",)),
    ("copies", ("Memcpy", "Memset", "copy_kernel")),
    ("sort, searchsorted", ("sort", "Sort", "searchsorted")),
    ("index add", ("index_add", "indexFunc")),
    ("gather, index", ("index_elementwise", "gather", "Gather")),
    ("matmuls", ("nvjet", "gemm", "gemv", "cutlass", "xmma", "splitK", "Kernel2")),
    ("reductions", ("reduce_kernel",)),
    ("elementwise", ("elementwise_kernel",)),
)
# the host's runtime calls that start device work, counted per step
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaGraphLaunch", "cudaMemcpyAsync",
                "cudaMemsetAsync")


def summarize(prof, n: int, plain_ms, host_ms) -> dict:
    """Device busy time, idle share and the top kernels and operators of a
    profiled window of ``n`` steps."""
    # device time from the device's own events (kernels, copies, memsets),
    # merged into busy intervals; per-operator rows would count it twice
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    by_kernel = {}
    for e in dev:
        t, c = by_kernel.get(e.name, (0.0, 0))
        by_kernel[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    by_kind = {}
    for name, (t, _) in by_kernel.items():
        kind = next((k for k, pats in CATEGORIES if any(p in name for p in pats)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + t / 1e3 / n
    host = prof.key_averages()
    calls = {e.key: e.count / n for e in host if e.key in LAUNCH_CALLS}
    return {
        "steps": n,
        "step_ms_profiler_off": float(np.mean(plain_ms)),
        "step_ms_profiler_on": float(np.mean(host_ms)),
        "device_busy_ms_per_step": busy_us / 1e3 / n,
        "device_idle_share_profiler_off": 1.0 - (busy_us / 1e3 / n) / float(np.mean(plain_ms)),
        "device_events_per_step": len(dev) / n,
        "host_launch_calls_per_step": calls,
        "device_ms_per_step_by_kind": dict(sorted(by_kind.items(), key=lambda r: -r[1])),
        "top_device": sorted(((k[:100], t / 1e3 / n, c / n) for k, (t, c) in by_kernel.items()),
                             key=lambda r: -r[1])[:16],
        "top_host": [(e.key, e.self_cpu_time_total / 1e3 / n, e.count / n) for e in
                     sorted(host, key=lambda e: e.self_cpu_time_total, reverse=True)[:12]],
    }


def profile_window(step, n: int):
    """``n`` calls of ``step`` with the profiler off, ``n`` under it."""
    def timed() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    plain_ms = [timed() for _ in range(n)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        host_ms = [timed() for _ in range(n)]
    return summarize(prof, n, plain_ms, host_ms), prof


def graph_ms(fn, reps: int) -> float:
    """Device ms of one call of ``fn``, captured as a CUDA graph and replayed
    ``reps`` times between two CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                 # warm up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def moe_pieces(params, cfg, reps: int = 20) -> dict:
    """Device ms a decode step of each piece of the MoE layer at 8 tokens,
    over every layer's weights (each piece one graph of 32 calls)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    xt = torch.randn(MAX_SEQS, cfg.d_model, generator=gen, device="cuda").to(torch.bfloat16)
    layers = [layer_params(params["layers"], li)["moe"] for li in range(cfg.n_layers)]
    E, C = cfg.n_experts, MOE.capacity(cfg, MAX_SEQS)
    with torch.no_grad():
        routed = [MOE._route(xt, p["router"], cfg) for p in layers]
        bufs = [MOE._dispatch(xt, r[3], E, C) for r in routed]
        outs = [MOE._experts(b, p["wg"], p["wu"], p["wo"]) for b, p in zip(bufs, layers)]
        pieces = {
            "route": lambda: [MOE._route(xt, p["router"], cfg) for p in layers],
            "dispatch": lambda: [MOE._dispatch(xt, r[3], E, C) for r in routed],
            "expert products": lambda: [MOE._experts(b, p["wg"], p["wu"], p["wo"])
                                        for b, p in zip(bufs, layers)],
            "combine": lambda: [MOE._combine(eo, r[3], r[1]) for eo, r in zip(outs, routed)],
            "whole block (_moe_math, with the aux loss)": lambda: [
                MOE._moe_math(xt, p["router"], p["wg"], p["wu"], p["wo"], cfg) for p in layers],
        }
        times = {name: graph_ms(fn, reps) for name, fn in pieces.items()}
    expert_bytes = sum(p[w].numel() * p[w].element_size() for p in layers for w in ("wg", "wu", "wo"))
    times["expert weights' byte bound"] = expert_bytes / chip_smoke.HBM_BYTES_PER_S * 1e3
    return times


def engine_windows(args) -> dict:
    windows = {}
    make = {MOE_ARCH: moe_engine, VLM_ARCH: vlm_engine}.get(args.arch) or (
        lambda jit, n_requests, max_new, seed: full_width_engine(n_requests, max_new, seed, jit=jit))
    for jit in (False, True):
        engine = make(jit=jit, n_requests=MAX_SEQS, max_new=2 * args.steps + 8, seed=args.seed)
        for _ in range(4):                   # admit + prefill, then warm decode (and capture)
            engine.step()
        torch.cuda.synchronize()
        check_live = len(engine.live)
        summary, prof = profile_window(engine.step, args.steps)
        if check_live != MAX_SEQS or len(engine.live) != MAX_SEQS:
            raise SystemExit(f"expected 8 live sequences in the window, had {check_live}")
        summary["batch"] = check_live
        if jit:
            summary["captures"] = engine.graphs.captures
            summary["capture_ms"] = engine.graphs.capture_ms
        windows["decode_graph" if jit else "decode_eager"] = (summary, prof)
        if jit and args.arch == MOE_ARCH:
            summary["moe_pieces_device_ms_per_step"] = moe_pieces(engine.params, engine.cfg)
        del engine
        torch.cuda.empty_cache()
    return windows


def state_windows(args) -> dict:
    model, params, prompts, _ = chip_smoke.state_setup(args.arch, args.seed)
    state = {}

    def prompt():
        state["logits"], state["cache"], _ = chip_smoke.state_prompt(
            model, params, prompts, STATE_PROMPT + chip_smoke.STATE_NEW)

    prompt()                                 # warm-up
    windows = {"prompt": profile_window(prompt, 2)}
    if 3 + 2 * args.steps > chip_smoke.STATE_NEW:
        raise SystemExit(f"--steps {args.steps}: the cache holds {chip_smoke.STATE_NEW} new tokens")
    modes = {"decode_eager": model.decode_step}
    if args.arch in chip_smoke.GRAPHED_STATE:
        modes["decode_graph"] = lambda p, b, c: decode_step_jit(model, p, b, c)
    for name, step in modes.items():
        prompt()                             # a fresh prompt cache for each mode
        pos = [STATE_PROMPT]

        def decode():
            with torch.no_grad():
                tok = state["logits"].argmax(-1)[:, None]
                p = torch.full((STATE_BATCH, 1), pos[0], device="cuda")
                state["logits"], state["cache"] = step(
                    params, {"tokens": tok, "positions": p}, state["cache"])
            pos[0] += 1

        for _ in range(3):                   # warm up (and capture)
            decode()
        windows[name] = profile_window(decode, args.steps)
    for summary, _ in windows.values():
        summary["batch"] = STATE_BATCH
    graphs = getattr(model, "_cuda_graphs", None)
    if graphs is not None:
        windows["decode_graph"][0].update(captures=graphs.captures, capture_ms=graphs.capture_ms)
    return windows


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm_1_6b",
                    choices=("stablelm_1_6b", MOE_ARCH, VLM_ARCH) + STATE_ARCHS)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=None,
                    help="weights' seed (default: chip_smoke.py's for the arch)")
    ap.add_argument("--out", default="build/profile")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_decode_profile: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    if args.seed is None:
        args.seed = {MOE_ARCH: chip_smoke.MOE_SEED, VLM_ARCH: chip_smoke.VLM_SEED}.get(args.arch, 0)
    windows = state_windows(args) if args.arch in STATE_ARCHS else engine_windows(args)
    out = ROOT / args.out
    out.mkdir(parents=True, exist_ok=True)
    for name, (summary, prof) in windows.items():
        summary = {"device": smi, "arch": args.arch, "window": name, **summary}
        stem = f"{args.arch}_{name}_profile"
        (out / f"{stem}.json").write_text(json.dumps(summary, indent=1))
        prof.export_chrome_trace(str(out / f"{stem}.trace.json"))
        print(f"== {args.arch}, {name} window")
        for key in ("step_ms_profiler_off", "step_ms_profiler_on", "device_busy_ms_per_step",
                    "device_idle_share_profiler_off", "device_events_per_step",
                    "host_launch_calls_per_step", "captures", "capture_ms",
                    "device_ms_per_step_by_kind", "moe_pieces_device_ms_per_step"):
            if key in summary:
                print(f"{key}: {summary[key]}")
        print("top device kernels/copies by ms per step (name, ms, count per step):")
        for row in summary["top_device"]:
            print("  ", row)
        print("top operators by host self ms per step (name, ms, calls per step):")
        for row in summary["top_host"]:
            print("  ", row)


if __name__ == "__main__":
    main()
