#!/usr/bin/env python3
"""Where a decode step of the PyTorch/CUDA port spends its time.

    python3 scripts/torch_decode_profile.py [--arch stablelm_1_6b] [--steps 5] [--out build/profile]

``--arch stablelm_1_6b`` (the default) serves the full-width model (random
weights from a seeded generator) through ``ServeEngine``, built as
``chip_smoke.py`` builds its serve (``full_width_engine``), with 8 requests
of 64-512 prompt tokens: one step admits and prefills all of them, a few
plain decode steps warm up, then ``--steps`` pure decode steps run with the
profiler off and ``--steps`` more under ``torch.profiler``.

``--arch rwkv6_7b`` or ``zamba2_7b`` drives the state path of
``chip_smoke.py``'s ``phase_state_model`` (the same seeded weights, inert
leaves set): 8 prompts of 1024 tokens through ``decode_step`` (and
``flush_cache``), once to warm up and then profiled as a window of its own
(2 prompts off, 2 on), then greedy one-token steps as above.

For each window it prints the step time with the profiler off and on, the
device-busy time per step (union of kernel and copy intervals on the
device), the device idle share against the unprofiled step time, device
events per step, and the top kernels by device time and operators by host
time.  Writes the summary as JSON and the Chrome trace under ``--out``.
Needs one CUDA device.
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
from chip_smoke import MAX_SEQS, STATE_BATCH, STATE_PROMPT, full_width_engine  # noqa: E402

STATE_ARCHS = ("rwkv6_7b", "zamba2_7b")


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
    host = prof.key_averages()
    return {
        "steps": n,
        "step_ms_profiler_off": float(np.mean(plain_ms)),
        "step_ms_profiler_on": float(np.mean(host_ms)),
        "device_busy_ms_per_step": busy_us / 1e3 / n,
        "device_idle_share_profiler_off": 1.0 - (busy_us / 1e3 / n) / float(np.mean(plain_ms)),
        "device_events_per_step": len(dev) / n,
        "top_device": sorted(((k[:100], t / 1e3 / n, c / n) for k, (t, c) in by_kernel.items()),
                             key=lambda r: -r[1])[:12],
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


def engine_windows(args) -> dict:
    engine = full_width_engine(MAX_SEQS, max_new=2 * args.steps + 8, seed=args.seed)
    for _ in range(4):                       # admit + prefill, then warm decode
        engine.step()
    torch.cuda.synchronize()
    check_live = len(engine.live)
    summary, prof = profile_window(engine.step, args.steps)
    if check_live != MAX_SEQS or len(engine.live) != MAX_SEQS:
        raise SystemExit(f"expected 8 live sequences in the window, had {check_live}")
    summary["batch"] = check_live
    return {"decode": (summary, prof)}


def state_windows(args) -> dict:
    model, params, prompts, _ = chip_smoke.state_setup(args.arch, args.seed)
    state = {}

    def prompt():
        state["logits"], state["cache"], _ = chip_smoke.state_prompt(
            model, params, prompts, STATE_PROMPT + chip_smoke.STATE_NEW)

    prompt()                                 # warm-up
    windows = {"prompt": profile_window(prompt, 2)}
    pos = [STATE_PROMPT]

    def decode():
        with torch.no_grad():
            tok = state["logits"].argmax(-1)[:, None]
            p = torch.full((STATE_BATCH, 1), pos[0], device="cuda")
            state["logits"], state["cache"] = model.decode_step(
                params, {"tokens": tok, "positions": p}, state["cache"])
        pos[0] += 1

    if 3 + 2 * args.steps > chip_smoke.STATE_NEW:
        raise SystemExit(f"--steps {args.steps}: the cache holds {chip_smoke.STATE_NEW} new tokens")
    for _ in range(3):
        decode()
    windows["decode"] = profile_window(decode, args.steps)
    for summary, _ in windows.values():
        summary["batch"] = STATE_BATCH
    return windows


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm_1_6b", choices=("stablelm_1_6b",) + STATE_ARCHS)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="build/profile")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_decode_profile: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    windows = state_windows(args) if args.arch in STATE_ARCHS else engine_windows(args)
    out = ROOT / args.out
    out.mkdir(parents=True, exist_ok=True)
    for name, (summary, prof) in windows.items():
        summary = {"device": smi, "arch": args.arch, "window": name, **summary}
        stem = f"{args.arch}_{name}_profile" if args.arch in STATE_ARCHS else "decode_profile"
        (out / f"{stem}.json").write_text(json.dumps(summary, indent=1))
        prof.export_chrome_trace(str(out / f"{stem}.trace.json"))
        print(f"== {args.arch}, {name} window")
        for key in ("step_ms_profiler_off", "step_ms_profiler_on", "device_busy_ms_per_step",
                    "device_idle_share_profiler_off", "device_events_per_step"):
            print(f"{key}: {summary[key]}")
        print("top device kernels/copies by ms per step (name, ms, count per step):")
        for row in summary["top_device"]:
            print("  ", row)
        print("top operators by host self ms per step (name, ms, calls per step):")
        for row in summary["top_host"]:
            print("  ", row)


if __name__ == "__main__":
    main()
