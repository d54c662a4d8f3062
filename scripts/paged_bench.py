#!/usr/bin/env python3
"""Time the paged-attention kernel at the serve's main shape on the card.

    python3 scripts/paged_bench.py [--root DIR ...] [--rounds N]

For each checkout root (default: this repository) it builds that tree's
``csrc/paged_attention.cu`` and, at the shape the full-width stablelm_1_6b
decode step gives the kernel (q (8, 32, 64) bf16, pools (2048, 16, 32, 64),
the block table and lengths of ``chip_smoke.main_lens()``), checks it
against the plain version (the output within 2e-2 and one bf16 ulp; the LSE
within 2e-5 of max(1, |lse|) where the tree returns one) and times it with
``chip_smoke.time_ms`` (CUDA events, L2 flushed, median of 50), over bf16
pages and over fp8 e4m3 pages.  The bound is the tree-independent byte
count ``chip_smoke.phase_times`` uses: the K and V rows the lengths need,
the table entries that list them, q, the output and the lengths.

With ``--detail`` it also gives, per tree and page type, the device time
of each kernel of one call (``torch.profiler`` over 20 calls, each after the
same L2 flush) and the call's time when the flush leaves L2 clean (a read
of the 256 MB buffer, where ``time_ms`` writes it and leaves L2 full of
dirty lines that the kernel's misses must write back first), and its time
with no flush at all (the 25.5 MB of bf16 K/V then sits in L2), and the
host time of one call (the wrapper's Python and the launches; median and
least of 15 batches of 100 calls enqueued while the card sleeps, 30 of 10
for the layer below).  Those
three hold the card back with a sleep kernel before each call, so the
host's enqueue is not timed; ``*_ms`` itself is ``chip_smoke.time_ms``.
It also times one layer of the decode step's attention over bf16 pages
(the tree's own ``paged_runner._paged_attention_with_current``: the call
and the current token's merge, with whatever that tree runs for the past
log-sum-exp), its ``layer_ms`` and its host time.

Each root runs in a process of its own, the roots in turn for ``--rounds``
rounds, so that two versions (an unpacked parent and this tree, say)
compare inside one run on one card.  Prints the card's name and power
limit, then one JSON line per root and round.
"""
from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_CHILD = r"""
import json, sys
root, detail = sys.argv[1], sys.argv[2] == "1"
sys.path.insert(0, root)
import chip_smoke as c
import torch
gen = torch.Generator(device="cuda").manual_seed(0)
lens = c.main_lens()
B, H, D, bs = c.MAX_SEQS, c.HEADS, c.HEAD_DIM, c.BLOCK
q, kp, vp, tbl, lens_t = c.paged_case(gen, B, H, H, D, lens, torch.bfloat16)
qg = q.reshape(B, H, 1, D)
scale = D ** -0.5
pages_read = sum(-(-n // bs) for n in lens)
res = {"root": root, "lens": lens}
flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")


def kernel_us(fn, n=20):
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and "paged" in e.name:
            name = e.name.split("<")[0].split("::")[-1]
            by[name] = by.get(name, 0.0) + e.time_range.elapsed_us() / n
    return by


def host_us(fn, batches=15, n=100):
    # host time of one call: the card is held back by a sleep kernel (~50
    # ms) while the host enqueues n calls; the median and the least of the
    # batches' means (the host's clock is shared, so single batches vary).
    # n calls' launches must fit the launch queue (~1000), or the host
    # waits for the card and times its sleep
    import statistics, time
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(batches):
        torch.cuda._sleep(100_000_000)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        per.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return statistics.median(per), min(per)


def clean_l2_ms(fn, reps=50, flush_l2=True):
    import statistics
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(reps):
        if flush_l2:
            flush.sum()
        torch.cuda._sleep(1_000_000)   # the host enqueues the call while the card waits
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


ok = True
pool_sets = (("bf16", (kp, vp)), ("fp8", (kp.to(torch.float8_e4m3fn), vp.to(torch.float8_e4m3fn))))
for key, pools in pool_sets:
    got = c.pa_ops._launch(qg, *pools, tbl, lens_t, scale)
    torch.cuda.synchronize()
    out, lse = got if isinstance(got, tuple) else (got, None)
    kw = {"return_lse": True} if lse is not None else {}
    plain = c.paged_attention_ref(qg, *pools, tbl, lens_t, scale=scale, **kw)
    plain, plain_lse = plain if lse is not None else (plain, None)
    diff = (out.float() - plain.float()).abs()
    res[f"{key}_err"] = diff.max().item()
    good = res[f"{key}_err"] < 2e-2 and bool((diff <= 2.0 ** -7 * plain.float().abs() + 1e-5).all())
    if lse is not None:
        res[f"{key}_lse_err"] = ((lse - plain_lse).abs() / plain_lse.abs().clamp_min(1.0)).max().item()
        good = good and res[f"{key}_lse_err"] < 2e-5
    res[f"{key}_ok"] = good
    ok = ok and good
    item = pools[0].element_size()
    nbytes = (2 * sum(lens) * H * D * item + 2 * q.numel() * q.element_size()
              + pages_read * 4 + lens_t.numel() * 4)
    res[f"{key}_bound_ms"] = nbytes / c.HBM_BYTES_PER_S * 1e3
    call = lambda: c.pa_ops._launch(qg, *pools, tbl, lens_t, scale)  # noqa: E731
    res[f"{key}_ms"] = c.time_ms(call, 50)
    if detail:   # the profiler last: once it has run, the host's launches are slower
        res[f"{key}_clean_l2_ms"] = clean_l2_ms(call)
        res[f"{key}_warm_l2_ms"] = clean_l2_ms(call, flush_l2=False)
        res[f"{key}_host_us"], res[f"{key}_host_us_min"] = host_us(call)
if detail:   # one layer of the decode step: the call, then the current token merged
    from repro_torch.serve import paged_runner
    k_cur, v_cur = (torch.randn(B, H, D, generator=gen, device="cuda").to(torch.bfloat16)
                    for _ in range(2))
    seq_lens = lens_t + 1
    layer = lambda: paged_runner._paged_attention_with_current(  # noqa: E731
        q, kp, vp, tbl, seq_lens, k_cur, v_cur)
    res["layer_ms"] = c.time_ms(layer, 50)
    res["layer_host_us"], res["layer_host_us_min"] = host_us(layer, batches=30, n=10)
    for key, pools in pool_sets:
        res[f"{key}_kernel_us"] = kernel_us(lambda: c.pa_ops._launch(qg, *pools, tbl, lens_t, scale))
print(json.dumps(res), flush=True)
sys.exit(0 if ok else 1)
"""


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", default=None,
                    help="checkout root to time (repeatable; default: this repository)")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--detail", action="store_true",
                    help="also each kernel's device time and the time with a clean L2")
    args = ap.parse_args()
    roots = [str(Path(r).resolve()) for r in (args.root or [ROOT])]
    if shutil.which("nvidia-smi") is None:
        sys.exit("paged_bench: no NVIDIA card here (nvidia-smi not found)")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    failed = False
    for _ in range(args.rounds):
        for root in roots:
            r = subprocess.run([sys.executable, "-c", _CHILD, root, str(int(args.detail))], cwd=root)
            failed |= r.returncode != 0
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
