#!/usr/bin/env python3
"""Which TF32 split and accumulation the f32 flash-attention kernel needs (CPU).

    PYTHONPATH=src python scripts/flash_precision.py [--quick]

The f32 flash path takes S = Q K^T and O = P V on TF32 tensor cores
(``mma.sync.m16n8k8 ... tf32``), whose operands keep 10 of float32's 23
mantissa bits and whose sums are float32.  The reference holds f32 flash
attention to 2e-5 (``tests/test_kernels.py``).  This script emulates the
kernel's arithmetic in plain torch and holds it against a float64 oracle
(softmax of the float64 scores, masked as the kernel masks them).

What it emulates, as the kernel computes it:

* q is scaled by scale x log2(e) in float32 once (the softmax is base 2);
* each operand of a product is split as it is loaded into a fragment:
  ``hi = cvt.rna.tf32.f32(x)`` (round to nearest, ties away), ``lo = x - hi``
  in float32, then ``lo`` itself rounded the same way (``rna``), or passed
  as it is, which the tensor core reads as truncated to TF32 (``raw``);
* per 8-wide k-step the three products lo.hi, hi.lo and hi.hi, each one
  m16n8k8 step through the tensor core's adder as Fasi et al. measured it
  on earlier NVIDIA parts (products exact, aligned to the largest term
  with 3 bits to spare, the rest and the sum's own tail cut off), into
  one accumulator, or hi.hi and the two small products apart (``split``),
  or every two k-steps from zero, added in float32 (``fresh``); for O
  also each key tile's P V from zero, added to the rescaled O in one
  float32 FMA (``tile``);
* the online softmax over key tiles of 64: a float32 running max, the
  exponentials ``ex2.approx`` of float32 differences, modelled as exact
  2^x rounded to float32 times (1 + e) with e of magnitude 2^-22 and a
  seeded random sign, the row sum and the rescale of O in float32;
* P split as q and k are, and the output O / l in float32.

Candidates (``CANDIDATES``): ``f32`` (float32 FMAs, the CUDA-core path),
``tf32`` (one product hi.hi), and 3xTF32 with the split and the
accumulation named.  The kernel takes ``3xtf32 split S, tile O``.  Shapes:
the reference's f32 flash test shapes and the main shape cut in batch and
heads, q/k/v (1, 2, 2048, 64) causal, and mistral_nemo_12b's layout cut
likewise, q (1, 4, 2048, 128) against k/v of 1 head; then two shapes at
scale 2.5, where the scores reach about 30.  Printed: each candidate's
max abs error against the oracle and its margin to 2e-5 (tolerance over
error).  About ten minutes on four CPU threads; ``--quick`` skips the
2048-token shapes.
"""
from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

TOL = 2e-5
KEY_TILE = 64
LOG2E = 1.4426950408889634
EX2_REL = 2.0 ** -22
TC_EXTRA_BITS = 3
# candidate: (split, where S's products accumulate, where O's do); see product()
CANDIDATES = {
    "f32": ("f32", None, None),
    "tf32": ("tf32", "one", "one"),
    "3xtf32-rna one": ("3xtf32-rna", "one", "one"),
    "3xtf32 one": ("3xtf32-raw", "one", "one"),
    "3xtf32 split S": ("3xtf32-raw", "split", "one"),
    "3xtf32 split S, O": ("3xtf32-raw", "split", "split"),
    "3xtf32 fresh S": ("3xtf32-raw", "fresh", "one"),
    "3xtf32 split S, tile O": ("3xtf32-raw", "split", "tile"),
    "3xtf32-trunc split S, tile O": ("3xtf32-trunc", "split", "tile"),
}
F32, F64 = torch.float32, torch.float64

# (B, Hq, Hkv, Sq, Sk, D, causal): tests/test_kernels.py's f32 shapes, then
# the main shape and mistral_nemo_12b's cut in batch and heads
SHAPES = [
    (2, 4, 2, 64, 64, 32, True),
    (1, 8, 1, 100, 100, 64, True),
    (2, 4, 4, 32, 96, 80, False),
    (1, 2, 2, 1, 200, 128, False),
    (1, 48, 1, 33, 33, 128, True),
    (1, 2, 2, 2048, 2048, 64, True),
    (1, 4, 1, 2048, 2048, 128, True),
]


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: float32 to its 10-bit mantissa, to nearest, ties away."""
    i = x.to(F32).contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(F32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of a float32 operand: the top 19 bits."""
    i = x.to(F32).contiguous().view(torch.int32)
    return (i & ~0x1FFF).view(F32)


def split(x: torch.Tensor, scheme: str):
    """The TF32 terms a fragment holds for float32 ``x``: [hi] or [hi, lo]."""
    if scheme == "f32":
        return [x]
    hi = tf32_trunc(x) if scheme == "3xtf32-trunc" else tf32_rna(x)
    if scheme == "tf32":
        return [hi]
    lo = x - hi                                   # exact in float32
    return [hi, tf32_rna(lo) if scheme == "3xtf32-rna" else tf32_trunc(lo)]


def rz_f32(x: torch.Tensor) -> torch.Tensor:
    """float64 to float32 rounded toward zero (24 significant bits)."""
    mag = x.abs()
    e = torch.floor(torch.log2(torch.where(mag > 0, mag, torch.ones_like(mag))))
    q = torch.exp2(e - 23)
    return (torch.trunc(x / q) * q).to(F32)


def mma(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor, tc: bool) -> torch.Tensor:
    """One m16n8k8 step, ``acc + a @ b`` over 8 products.  ``tc``: the
    tensor core's own adder as measured on earlier NVIDIA parts (Fasi et al.,
    "Numerical behavior of NVIDIA tensor cores", 2021): the products exact,
    aligned with ``acc`` to the largest of them with TC_EXTRA_BITS bits below
    its 24, the rest cut off, the sum cut to 24 bits (toward zero).  Else
    each product is added to ``acc`` with float32's round to nearest."""
    if not tc:
        for k in range(a.shape[-1]):
            acc = (acc.to(F64) + a[..., k:k + 1].to(F64) * b[..., k:k + 1, :].to(F64)).to(F32)
        return acc
    prods = a.to(F64)[..., :, :, None] * b.to(F64)[..., None, :, :]      # (..., M, 8, N)
    terms = torch.cat([acc.to(F64)[..., :, None, :], prods], -2)
    mag = terms.abs().amax(-2, keepdim=True)
    e = torch.floor(torch.log2(torch.where(mag > 0, mag, torch.ones_like(mag))))
    q = torch.exp2(e - 23 - TC_EXTRA_BITS)
    return rz_f32((torch.trunc(terms / q) * q).sum(-2))


def product(a: torch.Tensor, b: torch.Tensor, scheme: str, acc=None, small=None,
            layout: str = "one") -> torch.Tensor:
    """``acc + a @ b`` (..., M, K) x (..., K, N) as the kernel's fragments
    take it, 8-wide k-steps: float32 FMAs for ``f32``; else the TF32
    products of the split, through the tensor core's adder.  ``layout`` says
    where the three products go: ``one`` accumulator (lo.hi, hi.lo, hi.hi in
    turn); ``split``, hi.hi into ``acc`` and the two small products into
    ``small`` (returned too, for the caller to add); ``fresh``, all three of
    every two k-steps into a zeroed accumulator, added to ``acc`` in float32."""
    if acc is None:
        acc = torch.zeros(*a.shape[:-1], b.shape[-1], dtype=F32)
    if scheme == "f32":
        return mma(acc, a, b, tc=False)
    pa, pb = split(a, scheme), split(b, scheme)
    if len(pa) == 1:
        for k0 in range(0, a.shape[-1], 8):
            acc = mma(acc, pa[0][..., k0:k0 + 8], pb[0][..., k0:k0 + 8, :], tc=True)
        return acc
    terms = [(1, 0), (0, 1), (0, 0)]
    if layout == "split" and small is None:
        small = torch.zeros_like(acc)
    fresh = None
    for k0 in range(0, a.shape[-1], 8):
        for i, j in terms:
            x, y = pa[i][..., k0:k0 + 8], pb[j][..., k0:k0 + 8, :]
            if layout == "one":
                acc = mma(acc, x, y, tc=True)
            elif layout == "split":
                if (i, j) == (0, 0):
                    acc = mma(acc, x, y, tc=True)
                else:
                    small = mma(small, x, y, tc=True)
            else:
                fresh = mma(torch.zeros_like(acc) if fresh is None else fresh, x, y, tc=True)
        if layout == "fresh" and (k0 // 8 % 2 == 1 or k0 + 8 >= a.shape[-1]):
            acc = (acc.to(F64) + fresh.to(F64)).to(F32)
            fresh = None
    return (acc, small) if layout == "split" else acc


def mask_of(Sq: int, Sk: int, k0: int, n: int, causal: bool, r0: int = 0) -> torch.Tensor:
    qpos = torch.arange(r0, Sq)[:, None]
    kpos = torch.arange(k0, k0 + n)[None, :]
    return (qpos >= kpos) if causal else torch.ones(Sq - r0, n, dtype=torch.bool)


def emulate(q, k, v, causal: bool, cand: str, scale=None, seed: int = 0) -> torch.Tensor:
    """The kernel's forward on float32 q (Hq, Sq, D), k, v (Hkv, Sk, D) under
    candidate ``cand`` (see CANDIDATES)."""
    scheme, s_layout, o_layout = CANDIDATES[cand]
    Hq, Sq, D = q.shape
    Hkv, Sk, _ = k.shape
    group = Hq // Hkv
    gen = torch.Generator().manual_seed(seed)
    scale2 = np.float32((D ** -0.5 if scale is None else scale) * LOG2E)
    out = torch.zeros(Hq, Sq, D, dtype=F32)
    neg = torch.tensor(-1e30, dtype=F32)
    for h in range(Hq):
        qs = (q[h] * torch.tensor(scale2)).to(F32)                 # q scaled once, f32
        kh, vh = k[h // group], v[h // group]
        m = torch.full((Sq, 1), -1e30, dtype=F32)
        l = torch.zeros(Sq, 1, dtype=F32)
        o = torch.zeros(Sq, D, dtype=F32)
        o_small = torch.zeros(Sq, D, dtype=F32)
        for k0 in range(0, Sk, KEY_TILE):
            n = min(KEY_TILE, Sk - k0)
            r0 = min(k0, Sq) if causal else 0            # rows before k0 see none of the tile
            if r0 >= Sq:
                break
            vis = mask_of(Sq, Sk, k0, n, causal, r0)
            kt = kh[k0:k0 + n].T.contiguous()
            if s_layout == "split":
                big, small = product(qs[r0:], kt, scheme, layout="split")
                s = (big.to(F64) + small.to(F64)).to(F32)
            else:
                s = product(qs[r0:], kt, scheme, layout=s_layout or "one")
            s = torch.where(vis, s, neg)
            mn = torch.maximum(m[r0:], s.max(-1, keepdim=True).values)
            ex = torch.exp2((s - mn).to(F64)).to(F32)
            sign = torch.randint(0, 2, ex.shape, generator=gen).to(F64) * 2 - 1
            ex = (ex.to(F64) * (1 + EX2_REL * sign)).to(F32)
            p = torch.where(vis, ex, torch.zeros((), dtype=F32))
            alpha = torch.exp2((m[r0:] - mn).to(F64)).to(F32)
            l[r0:] = (alpha * l[r0:] + p.sum(-1, keepdim=True)).to(F32)
            if o_layout == "split":
                o[r0:], o_small[r0:] = product(p, vh[k0:k0 + n], scheme, acc=(alpha * o[r0:]).to(F32),
                                               small=(alpha * o_small[r0:]).to(F32), layout="split")
            elif o_layout == "tile":     # the tile's P V from zero, then o * alpha + it (one FMA)
                pv = product(p, vh[k0:k0 + n], scheme, layout="one")
                o[r0:] = (o[r0:].to(F64) * alpha.to(F64) + pv.to(F64)).to(F32)
            else:
                o[r0:] = product(p, vh[k0:k0 + n], scheme, acc=(alpha * o[r0:]).to(F32),
                                 layout=o_layout or "one")
            m[r0:] = mn
        if o_layout == "split":
            o = (o.to(F64) + o_small.to(F64)).to(F32)
        out[h] = o / torch.where(l == 0, torch.ones_like(l), l)
    return out


def oracle(q, k, v, causal: bool, scale=None) -> torch.Tensor:
    """Float64 softmax attention of the same inputs; fully masked rows give 0."""
    Hq, Sq, D = q.shape
    Hkv, Sk, _ = k.shape
    group = Hq // Hkv
    kk = k.to(F64).repeat_interleave(group, 0)
    vv = v.to(F64).repeat_interleave(group, 0)
    s = q.to(F64) @ kk.transpose(1, 2) * (D ** -0.5 if scale is None else scale)
    vis = mask_of(Sq, Sk, 0, Sk, causal)
    s = s.masked_fill(~vis, float("-inf"))
    p = torch.softmax(s, -1)
    p = torch.where(torch.isnan(p), 0.0, p)
    return p @ vv


def inputs(shape, seed: int):
    """Standard normal q, k, v as the reference's kernel test draws them."""
    B, Hq, Hkv, Sq, Sk, D, _ = shape
    rng = np.random.default_rng(seed)
    t = lambda s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    return t((B, Hq, Sq, D)), t((B, Hkv, Sk, D)), t((B, Hkv, Sk, D))


def errors(shape, cands=tuple(CANDIDATES), scale=None, seed: int = 0) -> dict:
    """{candidate: max abs error against the float64 oracle} at one shape."""
    q, k, v = inputs(shape, seed)
    causal = shape[-1]
    res = {}
    for b in range(q.shape[0]):
        want = oracle(q[b], k[b], v[b], causal, scale)
        for cand in cands:
            got = emulate(q[b], k[b], v[b], causal, cand, scale, seed=seed + b)
            err = (got.to(F64) - want).abs().max().item()
            res[cand] = max(res.get(cand, 0.0), err)
    return res


def table(shapes, scale, cands) -> dict:
    """Print one table of errors; return each candidate's worst."""
    label = "D^-0.5" if scale is None else f"{scale:g}"
    print(f"\nscale {label}: max abs error against a float64 oracle (tolerance {TOL:g}); "
          f"cells: error (tolerance / error)")
    print("| B, Hq, Hkv, Sq, Sk, D, causal | " + " | ".join(cands) + " |")
    print("| --- |" + " --- |" * len(cands))
    worst = dict.fromkeys(cands, 0.0)
    for shape in shapes:
        errs = errors(shape, cands, scale)
        for c, e in errs.items():
            worst[c] = max(worst[c], e)
        cells = [f"{errs[c]:.2e} ({TOL / errs[c]:.1f}x)" if errs[c] else "0" for c in cands]
        print(f"| {', '.join(map(str, shape))} | " + " | ".join(cells) + " |", flush=True)
    for c in cands:
        verdict = "within" if worst[c] < TOL else "OVER"
        margin = TOL / worst[c] if worst[c] else math.inf
        print(f"{c}: worst {worst[c]:.2e}, {verdict} {TOL:g} (margin {margin:.1f}x)")
    return worst


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="the reference's test shapes only (skip the 2048-token ones)")
    args = ap.parse_args()
    torch.set_num_threads(4)
    t0 = time.perf_counter()
    shapes = [s for s in SHAPES if not (args.quick and s[3] >= 2048)]
    table(shapes, None, tuple(CANDIDATES))
    # logits 20x the usual scale: where the adder's cut-off bits show
    table([(2, 4, 2, 200, 333, 64, True), (2, 4, 2, 200, 333, 128, True)], 2.5,
          tuple(CANDIDATES))
    print(f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
