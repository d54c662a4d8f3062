#!/usr/bin/env python3
"""Which split the decay-attention kernel's tensor-core paths need (CPU).

    PYTHONPATH=src python scripts/decay_precision.py [--seq N] [--dtype float32]

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

With ``--dtype float32`` the inputs are float32 (q, k and v not rounded to
bf16), so no operand is exact any more: C.B^T, v, C and B take the split
too, every product three products.  Candidates there:

* ``f32 chunked``: the plain chunked form in float32 (``chunked_decay_ref``:
  what the CUDA-core ``simt`` path computes, in another sum order);
* ``f32 sequential``: the sequential oracle in float32
  (``decay_attention_ref``), the control that ``chip_smoke.shallow_check``
  holds the kernel's logits to;
* ``bf16x3``: every product hi.hi + hi.lo + lo.hi of bf16 halves;
* ``3xtf32``: every product hi.hi + hi.lo + lo.hi of TF32 halves, hi
  rounded to nearest (``cvt.rna``), lo = x - hi read as the tensor core
  reads it (its top 19 bits);

the emulated paths keep the state and the output in float32 between chunks.
The f32 table prints, per input, the output's and the final state's error
against the float64 oracle, each over max(1, max |ref|); a design holds the
checks if it stays near ``f32 chunked`` and under ``f32 sequential``.

Inputs (numpy seeds; in the bf16 mode q, k, v rounded to bf16 as the model
path gives them):
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

from repro_torch.kernels.decay_attention.ref import (
    CHUNK,
    MIN_LOG_DECAY,
    chunked_decay_ref,
    decay_attention_ref,
)

OUT_TOL, STATE_TOL = 2e-2, 2e-3
SCHEMES = ("bf16", "tf32", "bf16x2", "bf16x3")
F32_SCHEMES = ("f32 chunked", "f32 sequential", "bf16x3", "3xtf32")
F32_TOL = 2e-3          # the reference's decay tolerance, output and state
F64 = torch.float64
LOG2E = 1.4426950408889634


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).to(torch.bfloat16).to(F64)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round a float32 value to TF32's 10-bit mantissa (to nearest, ties away)."""
    i = x.to(torch.float32).contiguous().view(torch.int32)
    i = (i + 0x1000) & ~0x1FFF
    return i.view(torch.float32).to(F64)


def tf32_raw(x: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of a float32 operand: its top 19 bits."""
    i = x.to(torch.float32).contiguous().view(torch.int32)
    return (i & ~0x1FFF).view(torch.float32).to(F64)


def f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).to(F64)


def parts(x: torch.Tensor, scheme: str):
    """The bf16 (or TF32) terms the kernel would hold for float32 operand x."""
    x = x.to(torch.float32).to(F64)      # the kernel holds the factor in float32
    if scheme == "bf16":
        return [bf16(x)]
    if scheme == "tf32":
        return [tf32(x)]
    if scheme == "3xtf32":
        hi = tf32(x)
        return [hi, tf32_raw(x - hi)]
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
    if scheme in ("bf16x3", "3xtf32"):
        out = out + torch.einsum(eq, xs[0], ys[1])
    return out


def emulate(q, k, v, lw, u, h0, scheme: str, form: str, exact_inputs: bool = True):
    """The chunked recurrence as the kernel's ``form`` path computes it, with
    every float32 operand of a product rounded per ``scheme``.  With
    ``exact_inputs`` q, k and v are bf16-exact (one term each); else they
    are float32 operands like the rest, and the state and the output are
    held in float32 between chunks, as the kernel holds them."""
    ex = exact_inputs
    hold = (lambda t: t) if ex else f32   # noqa: E731
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
        if ex:
            cum = lc.cumsum(1)                              # (B, n, H, dk)
            ex2 = torch.exp
        else:      # as the kernel: a float64 scan, 2^x as 2^rint(x) 2^frac in float32
            cum, lc = lc.cumsum(1) * LOG2E, lc * LOG2E
            ex2 = lambda x: f32(torch.exp2(f32(x - torch.round(x)))) * torch.exp2(torch.round(x))  # noqa: E731
        total = cum[:, -1]                                  # (B, H, dk)
        qcum = cum - lc if u is not None else cum
        diag = ((qc * u[None, None]) * kc).sum(-1) if u is not None else None   # (B, n, H)
        if form == "scalar":
            c, t = cum[..., 0], total[..., 0]               # one decay per head
            qc0 = qcum[..., 0]
            if ex:
                g = torch.einsum("bihc,bjhc->bhij", qc, kc)     # exact: bf16 inputs
                a = g * torch.exp(qc0.permute(0, 2, 1)[..., :, None]
                                  - c.permute(0, 2, 1)[..., None, :])
                wf = torch.exp(t[:, None] - c)              # w = e^(total - cum)
            else:
                g = f32(product("bihc,bjhc->bhij", qc, kc, scheme))
                eq, ek = ex2(qc0).permute(0, 2, 1), ex2(-c).permute(0, 2, 1)
                a = f32(f32(g * eq[..., :, None]) * ek[..., None, :])
                wf = f32(ex2(t)[:, None] * ex2(-c))
            a = torch.where(m, a, 0.0)
            if diag is not None:
                a = a + torch.diag_embed(diag.permute(0, 2, 1))
            y = product("bhij,bjhv->bihv", a, vc, scheme, y_exact=ex)
            y = y + ex2(qc0)[..., None] * product("bihc,bhcv->bihv", qc, state, scheme,
                                                 x_exact=ex)
            wb = kc * wf[..., None]                         # w o B, <= |B|
            state = hold(state * ex2(t)[..., None, None] + product(
                "bihc,bihv->bhcv", wb, vc, scheme, y_exact=ex))
        else:
            qs = qc * ex2(qcum)
            ks = kc * ex2(-cum)
            a = product("bihc,bjhc->bhij", qs, ks, scheme)
            a = torch.where(m, a, 0.0)
            if diag is not None:
                a = a + torch.diag_embed(diag.permute(0, 2, 1))
            y = product("bhij,bjhv->bihv", a, vc, scheme, y_exact=ex)
            y = y + product("bihc,bhcv->bihv", qs, state, scheme)
            kend = kc * (torch.exp(total[:, None] - cum) if ex
                         else f32(ex2(total)[:, None] * ex2(-cum)))
            state = hold(state * ex2(total)[..., None] + product(
                "bihc,bihv->bhcv", kend, vc, scheme, y_exact=ex))
        ys.append(hold(y))
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


def inputs(family: str, S: int, seed: int, pinned=False, times4=False, exact=True):
    """(q, k, v, log_w, u, h0) in float64, q/k/v bf16-exact (``exact``) or
    float32 values."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.float64))   # noqa: E731
    bf16_ = bf16 if exact else f32
    lw_ = (lambda a: a) if exact else f32   # noqa: E731
    if family == "mamba2":     # zamba2's width: C, B shared by 8 heads, state 64, head 64
        B, H, ns, hd = 1, 8, 64, 64
        xbc = rng.normal(size=(B, S, 1, 2 * ns))
        q = bf16_(t(np.broadcast_to(xbc[..., :ns], (B, S, H, ns))))
        k = bf16_(t(np.broadcast_to(xbc[..., ns:], (B, S, H, ns))))
        lw = -rng.random((B, S, H, 1)) * 2
        lw = lw_(t(np.broadcast_to(np.full_like(lw, MIN_LOG_DECAY) if pinned else lw,
                                   (B, S, H, ns))))
        v = bf16_(t(rng.normal(size=(B, S, H, hd))))
        return q, k, v, lw, None, None
    B, H, d = 1, 8, 64           # rwkv6's heads: 64 wide, the bonus, an initial state
    q, k, v = (bf16_(t(rng.normal(size=(B, S, H, d)))) for _ in range(3))
    lw = -rng.random((B, S, H, d)) * 2
    if times4:                 # chip_smoke.decay_cases: reference statistics, lw * 4
        k = bf16_(k * 0.3)
        lw = -np.abs(rng.normal(size=(B, S, H, d))) * 0.3 * 4
    if pinned:
        lw = np.full_like(lw, MIN_LOG_DECAY)
    u = t(rng.normal(size=(H, d)) * 0.3).to(torch.float32).to(F64)
    h0 = t(rng.normal(size=(B, H, d, d))).to(torch.float32).to(F64)
    return q, k, v, lw_(t(lw)), u, h0


def plain_f32(q, k, v, lw, u, h0, scheme: str):
    """The port's plain float32 forms on the float32 inputs."""
    fn = chunked_decay_ref if scheme == "f32 chunked" else decay_attention_ref
    f = lambda x: None if x is None else x.to(torch.float32)   # noqa: E731
    y, st = fn(f(q), f(k), f(v), f(lw), bonus=f(u), initial_state=f(h0), return_state=True)
    return y.to(F64), st.to(F64)


def cases(S: int, exact: bool):
    return [
        ("mamba2 stats", "scalar", inputs("mamba2", S, 1, exact=exact)),
        ("mamba2, log_w at the clip", "scalar", inputs("mamba2", S, 2, pinned=True, exact=exact)),
        ("rwkv6 stats, bonus, h0", "vector", inputs("rwkv6", S, 3, exact=exact)),
        ("rwkv6, log_w at the clip", "vector", inputs("rwkv6", S, 4, pinned=True, exact=exact)),
        ("rwkv6, chip_smoke lw * 4", "vector", inputs("rwkv6", S, 5, times4=True, exact=exact)),
    ]


def main_f32(S: int) -> None:
    """The float32 table: each candidate's output and state error."""
    print(f"float32 inputs, S = {S}, chunk {CHUNK}; errors over max(1, max |ref|) against the "
          f"float64 sequential oracle (output / state); tolerance {F32_TOL:g} each")
    print(f"| input | path | {' | '.join(F32_SCHEMES)} |")
    print("| --- | --- |" + " --- |" * len(F32_SCHEMES))
    worst = {(f, s): [0.0, 0.0] for f in ("scalar", "vector") for s in F32_SCHEMES}
    spread = {}
    for name, form, (q, k, v, lw, u, h0) in cases(S, exact=False):
        oy, os_ = oracle(q, k, v, lw, u, h0)
        oscale = max(1.0, oy.abs().max().item())
        sscale = max(1.0, os_.abs().max().item())
        cells, outs = [], {}
        for scheme in F32_SCHEMES:
            if scheme.startswith("f32"):
                y, st = plain_f32(q, k, v, lw, u, h0, scheme)
            else:
                y, st = emulate(q, k, v, lw, u, h0, scheme, form, exact_inputs=False)
            outs[scheme] = y
            ye = (y - oy).abs().max().item() / oscale
            se = (st - os_).abs().max().item() / sscale
            w = worst[(form, scheme)]
            w[0], w[1] = max(w[0], ye), max(w[1], se)
            cells.append(f"{ye:.2e} / {se:.2e}")
        print(f"| {name} | {form} | {' | '.join(cells)} |")
        spread[name] = {f"{s} vs {r}": (outs[s] - outs[r]).abs().max().item() / oscale
                        for r in ("f32 chunked", "f32 sequential") for s in F32_SCHEMES
                        if s != r and not (r == "f32 sequential" and s == "f32 chunked")}
    for form in ("scalar", "vector"):
        print(f"{form}: worst " + "; ".join(
            f"{s} {worst[(form, s)][0]:.2e} / {worst[(form, s)][1]:.2e}" for s in F32_SCHEMES))
    print("output's distance from f32 chunked and from f32 sequential (what "
          "chip_smoke.shallow_check compares), over max(1, max |ref|):")
    cols = list(next(iter(spread.values())))
    print(f"| input | {' | '.join(cols)} |")
    print("| --- |" + " --- |" * len(cols))
    for name, row in spread.items():
        print(f"| {name} | {' | '.join(f'{row[c]:.2e}' for c in cols)} |")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seq", type=int, default=1024, help="tokens per input (default 1024)")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16",
                    help="the inputs' type (default bfloat16: the bf16 paths' table)")
    args = ap.parse_args()
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    S = args.seq
    if args.dtype == "float32":
        main_f32(S)
        print(f"{time.perf_counter() - t0:.1f} s")
        return
    print(f"S = {S}, chunk {CHUNK}; errors over max(1, max |ref|) against the float64 "
          f"sequential oracle; tolerances: output {OUT_TOL:g} (bf16 output), state {STATE_TOL:g}")
    print(f"| input | path | {' | '.join(SCHEMES)} |")
    print("| --- | --- |" + " --- |" * len(SCHEMES))
    worst = {(f, s): [0.0, 0.0] for f in ("scalar", "vector") for s in SCHEMES}
    for name, form, (q, k, v, lw, u, h0) in cases(S, exact=True):
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
