#!/usr/bin/env python3
"""Time the flash-attention kernel at the main shapes on the card.

    python3 scripts/flash_bench.py [--root DIR ...] [--rounds N] [--forward N]
                                   [--dtype bfloat16|float32]
                                   [--shape causal|full|d128|xdec|enc|vlm ...] [--detail]

For each checkout root (default: this repository) it builds that tree's
``csrc/flash_attention.cu``, checks the kernel against the plain version and
times it with ``chip_smoke.time_ms`` (CUDA events, L2 flushed, median of 20)
beside ``scaled_dot_product_attention`` on the same inputs, at each
``--shape`` (default: all the type takes): stablelm_1_6b's q/k/v (4, 32,
2048, 64), causal and (bf16 only) full (``causal_*``, ``full_*``),
mistral_nemo_12b's q (4, 32, 2048, 128) against k/v (4, 8, 2048, 128),
causal (``d128_*``; the library with ``enable_gqa``, and also on k/v
repeated to 32 heads beforehand, ``d128_sdpa_expanded_ms``), and (bf16
only) seamless_m4t_medium's cross-attention decode, q (8, 16, 1, 64) against
k/v (8, 16, 1024, 64), full (``xdec_*``, ``chip_smoke.FLASH_XDEC``), its
encoder and cross-attention prefill, q/k/v (4, 16, 2048, 64), full
(``enc_*``, ``chip_smoke.FLASH_ENC``), and qwen2_vl_72b's q (4, 64, 2048,
128) against k/v (4, 8, 2048, 128), causal (``vlm_*``, ``chip_smoke.FLASH_VLM``;
the library with ``enable_gqa``, and on k/v repeated beforehand), in
``--dtype`` (bfloat16 by default; float32 times the f32 path, ``tf32x3`` in
this tree and ``simt`` before it).  Each output is held to the plain version
first (2e-2 bf16, 2e-5 f32; a miss is timed all the same and fails the run
at its end), and ``*_bound_ms`` is the least time of the visible pairs'
operations: bf16 at 989 TFLOP/s, f32 the smaller of 67 TFLOP/s on CUDA cores
and three TF32 products at 495 TFLOP/s (as ``chip_smoke.op_ms``), or of q, k,
v read and the output written once at 3.35 TB/s where that is longer.  The
shapes and rates are written here, not read from the root, so an older tree
times at both.
Each root runs in a process of its own, the roots in turn for ``--rounds``
rounds, so that two versions (an unpacked parent and this tree, say) compare
inside one run on one card.  With ``--forward N`` it also times N eval
(``build_eval_step``) and N ``prefill_logits`` forwards at 4 x 2048 through
the flash kernel, as ``chip_smoke.phase_flash_forward`` does once, of the
full-width stablelm_1_6b and then mistral_nemo_12b (``<arch>_eval_ms``,
``<arch>_prefill_ms``), each with random weights from a seed, freed before
the next.  With ``--detail`` it also gives, at each shape, the device time of
the kernel's own launches (``*_kernel_us``: ``torch.profiler`` over 20
calls, each after the L2 flush) and the call's and the library's times with
the card held back by a sleep before each call, so that the host's enqueue
is not timed (``*_clean_l2_ms``, ``*_sdpa_clean_l2_ms``: L2 left clean by a
read of the flush buffer).  Prints one JSON line per root and round.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_CHILD = r"""
import json, sys
root, forward, dtype, wanted = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4].split(",")
detail = sys.argv[5] == "1"
sys.path.insert(0, root)
import chip_smoke as c
import torch
dt = getattr(torch, dtype)
tol = 2e-2 if dt == torch.bfloat16 else 2e-5
gen = torch.Generator(device="cuda").manual_seed(8)
sdpa = torch.nn.functional.scaled_dot_product_attention
res = {"root": root, "dtype": dtype}
failed = False
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
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "flash" in e.name) / n


def clean_l2_ms(fn, reps=50):
    import statistics
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(reps):
        flush.sum()
        torch.cuda._sleep(1_000_000)   # the host enqueues the call while the card waits
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


# (key, B, Hq, Hkv, Sq, Sk, D, causal)
shapes = [("causal", 4, 32, 32, 2048, 2048, 64, True), ("full", 4, 32, 32, 2048, 2048, 64, False),
          ("d128", 4, 32, 8, 2048, 2048, 128, True), ("xdec", 8, 16, 16, 1, 1024, 64, False),
          ("enc", 4, 16, 16, 2048, 2048, 64, False), ("vlm", 4, 64, 8, 2048, 2048, 128, True)]
for key, B, Hq, Hkv, Sq, Sk, D, causal in shapes:
    if key not in wanted or (dt != torch.bfloat16 and key in ("full", "xdec", "enc", "vlm")):
        continue
    q, k, v = c.flash_inputs(gen, B, Hq, Hkv, Sq, Sk, D, dt)
    scale = D ** -0.5
    out = c.fl_ops._launch(q, k, v, causal, scale)
    torch.cuda.synchronize()
    res[f"{key}_path"] = c.fl_ops.last_path
    res[f"{key}_err"] = (out.float() - c.attention_ref(q, k, v, causal=causal).float()).abs().max().item()
    if not res[f"{key}_err"] < tol:   # timed all the same; the run fails at its end
        print(f"{root} {key} {dtype}: err {res[key + '_err']} over {tol}", file=sys.stderr)
        failed = True
    res[f"{key}_ms"] = c.time_ms(lambda: c.fl_ops._launch(q, k, v, causal, scale), 20)
    gqa = {"enable_gqa": True} if Hkv < Hq else {}
    res[f"{key}_sdpa_ms"] = c.time_ms(lambda: sdpa(q, k, v, is_causal=causal, **gqa), 20)
    if detail:
        call = lambda: c.fl_ops._launch(q, k, v, causal, scale)  # noqa: E731
        res[f"{key}_clean_l2_ms"] = clean_l2_ms(call)
        res[f"{key}_sdpa_clean_l2_ms"] = clean_l2_ms(lambda: sdpa(q, k, v, is_causal=causal, **gqa))
        res[f"{key}_kernel_us"] = kernel_us(call)
    if Hkv < Hq:
        ke, ve = (t.repeat_interleave(Hq // Hkv, 1) for t in (k, v))
        res[f"{key}_sdpa_expanded_ms"] = c.time_ms(lambda: sdpa(q, ke, ve, is_causal=causal), 20)
        del ke, ve
    flops = c.flash_flops(B, Hq, Sq, Sk, D, causal)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    res[f"{key}_bound_ms"] = max(flops / 989e12 if dt == torch.bfloat16
                                 else min(flops / 67e12, 3 * flops / 495e12),
                                 nbytes / 3.35e12) * 1e3
    del q, k, v, out
for arch in ("stablelm_1_6b", "mistral_nemo_12b") if forward else ():
    cfg = c.get_config(arch)
    params = c.LM(cfg).init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    data = c.DataConfig(vocab_size=cfg.vocab_size, seq_len=2048, batch_per_shard=4)
    batch = {n: torch.from_numpy(a).cuda() for n, a in c.synth_batch(data, 0, 0).items()}
    prompts = {"tokens": torch.from_numpy(c.synth_batch(data, 1, 0)["tokens"]).cuda(),
               "positions": batch["positions"]}
    model = c.LM(cfg, attn_impl="pallas")
    res[f"{arch}_eval_ms"], res[f"{arch}_prefill_ms"] = [], []
    for _ in range(forward):
        res[f"{arch}_eval_ms"].append(c._forward(model, "eval", params, batch)[1])
        res[f"{arch}_prefill_ms"].append(c._forward(model, "prefill", params, prompts)[1])
    res[f"{arch}_flash_path"] = c.fl_ops.last_path
    del params, batch, prompts
    torch.cuda.empty_cache()
print(json.dumps(res), flush=True)
sys.exit(1 if failed else 0)
"""


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", default=None,
                    help="checkout root to time (repeatable; default: this repository)")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--forward", type=int, default=0,
                    help="also time this many eval and prefill forwards at 4 x 2048")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16",
                    help="the kernels' input type (default bfloat16)")
    ap.add_argument("--shape", action="append",
                    choices=("causal", "full", "d128", "xdec", "enc", "vlm"),
                    help="shape to time (repeatable; default: every shape of the type)")
    ap.add_argument("--detail", action="store_true",
                    help="also the kernel's device time and the times with the host's enqueue "
                         "left out")
    args = ap.parse_args()
    roots = [str(Path(r).resolve()) for r in (args.root or [ROOT])]
    if shutil.which("nvidia-smi") is None:
        sys.exit("flash_bench: no NVIDIA card here (nvidia-smi not found)")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    failed = False
    for _ in range(args.rounds):
        for root in roots:
            r = subprocess.run([sys.executable, "-c", _CHILD, root, str(args.forward), args.dtype,
                                ",".join(args.shape or ("causal", "full", "d128", "xdec", "enc",
                                                        "vlm")),
                                str(int(args.detail))],
                               cwd=root)
            failed |= r.returncode != 0
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
