#!/usr/bin/env python3
"""Which bf16 split the decay-attention kernel's tensor-core paths need (CPU).

    PYTHONPATH=src python scripts/decay_precision.py [--seq N]

The bf16 kernel paths take their chunk products on tensor cores, whose
operands are bf16 and whose sums are float32.  An operand that is not
bf16-exact (a float32 factor: the masked, decayed scores, the state, the
decayed q and k) is rounded there.  This script emulates each candidate
rounding in plain torch, the products then taken in float64, and holds the
result against a float64 sequential oracle of the same recurrence (the
plain ``decay_attention_ref``'s loop, in float64).  Candidates, applied to
every float32 operand:

* ``bf16``: rounded to bf16, one product;
* ``tf32``: rounded to TF32 (a 10-bit mantissa), one product;
* ``bf16x2``: split into hi + lo bf16 halves, two products against the
  other operand's hi half (exact when that operand is bf16, as q, k and v
  are on the model path);
* ``bf16x3``: hi.hi + hi.lo + lo.hi, for two float32 factors.

Two formulations, as the kernel's two paths compute the chunk:

* ``scalar`` (Mamba2: one decay per head, no factoring): A = (C.B^T) o
  e^(cum_i - cum_j), y = A v + e^cum (C S), S <- e^total S + v^T (w o B)
  with w = e^(total - cum); C.B^T of bf16 inputs is exact, so the float32
  operands are A, S and w o B;
* ``vector`` (RWKV6: a decay per channel, the bonus): qs = q e^(ecum),
  ks = k e^(-cum) (factors up to e^(+-57.6) at the clip), A = qs ks^T,
  y = A v + qs S, S <- S e^total + (k e^(total - cum))^T v; the float32
  operands are qs, ks, A, S and the decayed k.

Inputs (numpy seeds; q, k, v rounded to bf16 as the model path gives them):
Mamba2's statistics as ``chip_smoke.decay_times`` draws them at zamba2's
width (C and B shared by the heads, a per-head decay), RWKV6's with the
bonus and an initial state, each of them with the log-decay pinned at the
clip (-1.8 at every step, so |cum| reaches 57.6 in a chunk), and
``chip_smoke.decay_cases``' ``lw * 4`` case.  Printed: for each input and
candidate, the output's error over max(1, max |y|), before and after the
kernel's bf16 rounding of the output (the latter against 2e-2; the former
is the products' own share), and the final state's over max(1, max |S|)
against 2e-3.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.kernels.decay_attention.ref import CHUNK, MIN_LOG_DECAY

OUT_TOL, STATE_TOL = 2e-2, 2e-3
SCHEMES = ("bf16", "tf32", "bf16x2", "bf16x3")
F64 = torch.float64


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).to(torch.bfloat16).to(F64)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round a float32 value to TF32's 10-bit mantissa (to nearest, ties away)."""
    i = x.to(torch.float32).view(torch.int32)
    i = (i + 0x1000) & ~0x1FFF
    return i.view(torch.float32).to(F64)


def parts(x: torch.Tensor, scheme: str):
    """The bf16 (or TF32) terms the kernel would hold for float32 operand x."""
    x = x.to(torch.float32).to(F64)      # the kernel holds the factor in float32
    if scheme == "bf16":
        return [bf16(x)]
    if scheme == "tf32":
        return [tf32(x)]
    hi = bf16(x)
    return [hi, bf16(x - hi)]


def product(eq: str, x, y, scheme: str, x_exact=False, y_exact=False) -> torch.Tensor:
    """einsum(eq, x, y) as the tensor cores take it: each float32 operand in
    its ``scheme`` terms, a bf16-exact operand as it is; float64 sums."""
    xs = [x] if x_exact else parts(x, scheme)
    ys = [y] if y_exact else parts(y, scheme)
    if len(xs) == 1 or len(ys) == 1:
        return sum(torch.einsum(eq, a, b) for a in xs for b in ys)
    out = torch.einsum(eq, xs[0], ys[0]) + torch.einsum(eq, xs[1], ys[0])
    if scheme == "bf16x3":
        out = out + torch.einsum(eq, xs[0], ys[1])
    return out


def emulate(q, k, v, lw, u, h0, scheme: str, form: str):
    """The chunked recurrence as the kernel's ``form`` path computes it, with
    every float32 operand of a product rounded per ``scheme``."""
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    lw = lw.clamp(MIN_LOG_DECAY, 0.0)
    state = torch.zeros(B, H, dk, dv, dtype=F64) if h0 is None else h0.clone()
    ys = []
    idx = torch.arange(CHUNK)
    mask = idx[None, :] < idx[:, None] if u is not None else idx[None, :] <= idx[:, None]
    for s0 in range(0, S, CHUNK):
        qc, kc, vc, lc = (t[:, s0:s0 + CHUNK] for t in (q, k, v, lw))
        n = qc.shape[1]
        m = mask[:n, :n]
        cum = lc.cumsum(1)                                  # (B, n, H, dk)
        total = cum[:, -1]                                  # (B, H, dk)
        qcum = cum - lc if u is not None else cum
        diag = ((qc * u[None, None]) * kc).sum(-1) if u is not None else None   # (B, n, H)
        if form == "scalar":
            c, t = cum[..., 0], total[..., 0]               # one decay per head
            qc0 = qcum[..., 0]
            g = torch.einsum("bihc,bjhc->bhij", qc, kc)     # exact: bf16 inputs
            a = g * torch.exp(qc0.permute(0, 2, 1)[..., :, None] - c.permute(0, 2, 1)[..., None, :])
            a = torch.where(m, a, 0.0)
            if diag is not None:
                a = a + torch.diag_embed(diag.permute(0, 2, 1))
            y = product("bhij,bjhv->bihv", a, vc, scheme, y_exact=True)
            y = y + torch.exp(qc0)[..., None] * product("bihc,bhcv->bihv", qc, state, scheme,
                                                      x_exact=True)
            wb = kc * torch.exp(t[:, None] - c)[..., None]  # w o B, <= |B|
            state = state * torch.exp(t)[..., None, None] + product(
                "bihc,bihv->bhcv", wb, vc, scheme, y_exact=True)
        else:
            qs = qc * torch.exp(qcum)
            ks = kc * torch.exp(-cum)
            a = product("bihc,bjhc->bhij", qs, ks, scheme)
            a = torch.where(m, a, 0.0)
            if diag is not None:
                a = a + torch.diag_embed(diag.permute(0, 2, 1))
            y = product("bhij,bjhv->bihv", a, vc, scheme, y_exact=True)
            y = y + product("bihc,bhcv->bihv", qs, state, scheme)
            kend = kc * torch.exp(total[:, None] - cum)
            state = state * torch.exp(total)[..., None] + product(
                "bihc,bihv->bhcv", kend, vc, scheme, y_exact=True)
        ys.append(y)
    return torch.cat(ys, 1), state


def oracle(q, k, v, lw, u, h0):
    """The sequential recurrence (``decay_attention_ref``'s loop) in float64."""
    B, S, H, dk = q.shape
    state = torch.zeros(B, H, dk, v.shape[-1], dtype=F64) if h0 is None else h0.clone()
    w = torch.exp(lw.clamp(MIN_LOG_DECAY, 0.0))
    ys = []
    for t in range(S):
        kv = torch.einsum("bhk,bhv->bhkv", k[:, t], v[:, t])
        if u is None:
            state = state * w[:, t, ..., None] + kv
            ys.append(torch.einsum("bhk,bhkv->bhv", q[:, t], state))
        else:
            ys.append(torch.einsum("bhk,bhkv->bhv", q[:, t], state)
                      + ((q[:, t] * u[None]) * k[:, t]).sum(-1)[..., None] * v[:, t])
            state = state * w[:, t, ..., None] + kv
    return torch.stack(ys, 1), state


def inputs(family: str, S: int, seed: int, pinned=False, times4=False):
    """(q, k, v, log_w, u, h0) in float64, q/k/v bf16-exact."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.float64))   # noqa: E731
    if family == "mamba2":     # zamba2's width: C, B shared by 8 heads, state 64, head 64
        B, H, ns, hd = 1, 8, 64, 64
        xbc = rng.normal(size=(B, S, 1, 2 * ns))
        q = bf16(t(np.broadcast_to(xbc[..., :ns], (B, S, H, ns))))
        k = bf16(t(np.broadcast_to(xbc[..., ns:], (B, S, H, ns))))
        lw = -rng.random((B, S, H, 1)) * 2
        lw = t(np.broadcast_to(np.full_like(lw, MIN_LOG_DECAY) if pinned else lw, (B, S, H, ns)))
        v = bf16(t(rng.normal(size=(B, S, H, hd))))
        return q, k, v, lw, None, None
    B, H, d = 1, 8, 64           # rwkv6's heads: 64 wide, the bonus, an initial state
    q, k, v = (bf16(t(rng.normal(size=(B, S, H, d)))) for _ in range(3))
    lw = -rng.random((B, S, H, d)) * 2
    if times4:                 # chip_smoke.decay_cases: reference statistics, lw * 4
        k = bf16(k * 0.3)
        lw = -np.abs(rng.normal(size=(B, S, H, d))) * 0.3 * 4
    if pinned:
        lw = np.full_like(lw, MIN_LOG_DECAY)
    u = t(rng.normal(size=(H, d)) * 0.3).to(torch.float32).to(F64)
    h0 = t(rng.normal(size=(B, H, d, d))).to(torch.float32).to(F64)
    return q, k, v, t(lw), u, h0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seq", type=int, default=1024, help="tokens per input (default 1024)")
    args = ap.parse_args()
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    S = args.seq
    cases = [
        ("mamba2 stats", "scalar", inputs("mamba2", S, 1)),
        ("mamba2, log_w at the clip", "scalar", inputs("mamba2", S, 2, pinned=True)),
        ("rwkv6 stats, bonus, h0", "vector", inputs("rwkv6", S, 3)),
        ("rwkv6, log_w at the clip", "vector", inputs("rwkv6", S, 4, pinned=True)),
        ("rwkv6, chip_smoke lw * 4", "vector", inputs("rwkv6", S, 5, times4=True)),
    ]
    print(f"S = {S}, chunk {CHUNK}; errors over max(1, max |ref|) against the float64 "
          f"sequential oracle; tolerances: output {OUT_TOL:g} (bf16 output), state {STATE_TOL:g}")
    print(f"| input | path | {' | '.join(SCHEMES)} |")
    print("| --- | --- |" + " --- |" * len(SCHEMES))
    worst = {(f, s): [0.0, 0.0] for f in ("scalar", "vector") for s in SCHEMES}
    for name, form, (q, k, v, lw, u, h0) in cases:
        oy, os_ = oracle(q, k, v, lw, u, h0)
        oscale = max(1.0, oy.abs().max().item())
        sscale = max(1.0, os_.abs().max().item())
        cells = []
        for scheme in SCHEMES:
            y, st = emulate(q, k, v, lw, u, h0, scheme, form)
            pe = (y - oy).abs().max().item() / oscale
            ye = (bf16(y) - oy).abs().max().item() / oscale
            se = (st - os_).abs().max().item() / sscale
            w = worst[(form, scheme)]
            w[0], w[1] = max(w[0], ye), max(w[1], se)
            ok = "ok" if ye < OUT_TOL and se < STATE_TOL else "FAILS"
            cells.append(f"{pe:.1e} / {ye:.2e} / {se:.2e} {ok}")
        print(f"| {name} | {form} | {' | '.join(cells)} |")
    print("cells: output error before / after the bf16 rounding of the output / state error")
    for form in ("scalar", "vector"):
        passing = [s for s in SCHEMES if worst[(form, s)][0] < OUT_TOL
                   and worst[(form, s)][1] < STATE_TOL]
        print(f"{form}: within both tolerances on every input: {', '.join(passing) or 'none'}; "
              + "; ".join(f"{s} worst {worst[(form, s)][0]:.2e} / {worst[(form, s)][1]:.2e}"
                          for s in SCHEMES))
    print(f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
