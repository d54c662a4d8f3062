#!/usr/bin/env python3
"""Time the decay-attention kernel at both main shapes on the card.

    python3 scripts/decay_bench.py [--root DIR ...] [--rounds N] [--forward N]
                                   [--dtype bfloat16|float32]

For each checkout root (default: this repository) it builds that tree's
``csrc/decay_attention.cu`` and, at the two shapes the main path gives the
kernel, checks it against the plain chunked math (``chunked_decay_ref``:
the output within 2e-2 of its scale in bf16 and within 2e-3 in f32, the
final state within 2e-3 of its scale) and times it with
``chip_smoke.time_ms`` (CUDA events, L2 flushed, median of 20), with q, k
and v (C, B and v) in ``--dtype``: bfloat16 (the model path's type, by
default) or float32, which takes ``vector_tc_f32`` / ``scalar_tc_f32`` in a
tree that has them and ``simt`` in one before them:

* rwkv6_7b's serve shape: q/k/v (8, 1024, 64, 64) bf16, log_w f32, the
  bonus, an initial and a final state;
* zamba2_7b's ``prefill_logits`` shape: C and B (4, 2048, 64) bf16 sliced
  from a 7296-wide row as ``mamba2.py`` slices ``xBC``, broadcast over 112
  heads, the per-head f32 decay broadcast over the state, v (4, 2048, 112,
  64) bf16, the final state.

Each root runs in a process of its own, the roots in turn for ``--rounds``
rounds, so that two versions (an unpacked parent and this tree, say)
compare inside one run on one card.  With ``--forward N`` it also times N
prompts (``decode_step`` over 8 x 1024 tokens, then the flush) and N
``prefill_logits`` forwards at 4 x 2048 of the full-width rwkv6_7b and
zamba2_7b, as ``chip_smoke.phase_state_model`` does once, with the same
seeded weights (bf16 only).  Prints one JSON line per root and round, each
shape's path, error and ms.
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
root, forward, dtype = sys.argv[1], int(sys.argv[2]), sys.argv[3]
sys.path.insert(0, root)
import chip_smoke as c
import torch
dt = getattr(torch, dtype)
gen = torch.Generator(device="cuda").manual_seed(12)
res = {"root": root, "dtype": dtype}


def run(key, q, k, v, lw, u, h0):
    y, hT = c.dc_ops._launch(q, k, v, lw, u, h0, True)
    torch.cuda.synchronize()
    res[f"{key}_path"] = getattr(c.dc_ops, "last_path", None)
    py, ph = c.chunked_decay_ref(q, k, v, lw, bonus=u, initial_state=h0, return_state=True)
    yscale = max(1.0, py.float().abs().max().item()) if dt == torch.bfloat16 else 1.0
    sscale = max(1.0, ph.abs().max().item())
    res[f"{key}_err"] = (y.float() - py.float()).abs().max().item() / yscale
    res[f"{key}_state_err"] = (hT - ph).abs().max().item() / sscale
    res[f"{key}_ok"] = (res[f"{key}_err"] < (2e-2 if dt == torch.bfloat16 else 2e-3)
                        and res[f"{key}_state_err"] < 2e-3)
    res[f"{key}_ms"] = c.time_ms(lambda: c.dc_ops._launch(q, k, v, lw, u, h0, True), 20)


B, S, H, d = 8, 1024, 64, 64
q, k, v = (torch.randn(B, S, H, d, generator=gen, device="cuda").to(dt) for _ in range(3))
lw = -torch.rand(B, S, H, d, generator=gen, device="cuda") * 2
u = torch.randn(H, d, generator=gen, device="cuda") * 0.3
h0 = torch.randn(B, H, d, d, generator=gen, device="cuda")
run("rwkv6", q, k, v, lw, u, h0)
del q, k, v, lw, h0
B, S, H, ns, hd, d_in = 4, 2048, 112, 64, 64, 7168
xBC = torch.randn(B, S, d_in + 2 * ns, generator=gen, device="cuda").to(dt)
q = xBC[:, :, None, d_in + ns:].expand(B, S, H, ns)
k = xBC[:, :, None, d_in:d_in + ns].expand(B, S, H, ns)
lw = (-torch.rand(B, S, H, generator=gen, device="cuda") * 2)[..., None].expand(B, S, H, ns)
v = torch.randn(B, S, H, hd, generator=gen, device="cuda").to(dt)
run("zamba2", q, k, v, lw, None, None)
del xBC, q, k, v, lw
torch.cuda.empty_cache()
for arch, seed in (("rwkv6_7b", 3), ("zamba2_7b", 4)) if forward else ():
    model, params, prompts, pbatch = c.state_setup(arch, seed)
    recent = c.STATE_PROMPT + c.STATE_NEW
    res[f"{arch}_prompt_ms"], res[f"{arch}_prefill_ms"] = [], []
    for _ in range(forward):
        _, cache, ms = c.state_prompt(model, params, prompts, recent)
        del cache
        res[f"{arch}_prompt_ms"].append(ms)
        res[f"{arch}_prefill_ms"].append(c._forward(model, "prefill", params, pbatch)[1])
    del model, params
    torch.cuda.empty_cache()
print(json.dumps(res), flush=True)
sys.exit(0 if res["rwkv6_ok"] and res["zamba2_ok"] else 1)
"""


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", default=None,
                    help="checkout root to time (repeatable; default: this repository)")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--forward", type=int, default=0,
                    help="also time this many prompts and prefills of both full-width models")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16",
                    help="the type of q, k and v (default bfloat16)")
    args = ap.parse_args()
    roots = [str(Path(r).resolve()) for r in (args.root or [ROOT])]
    if shutil.which("nvidia-smi") is None:
        sys.exit("decay_bench: no NVIDIA card here (nvidia-smi not found)")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    failed = False
    for _ in range(args.rounds):
        for root in roots:
            r = subprocess.run([sys.executable, "-c", _CHILD, root, str(args.forward), args.dtype],
                               cwd=root)
            failed |= r.returncode != 0
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
