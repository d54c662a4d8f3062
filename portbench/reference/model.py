"""The plain reference: the configuration's forward pass over one whole
sequence, in float32 with TF32 off, layer by layer.

It reads the harness's weights (the tree both sides are given) by their
paths and an :class:`~portbench.arch.Arch`, and imports nothing of the
program.  What the program derives it works out again: rotary angles,
routing, every product.  No cache, no batching, no kernels.

The equations, per layer (pre-norm residual):

  h = norm(x);  q, k, v = h Wq, h Wk, h Wv (per head);  q, k rotated by
  position over interleaved (even, odd) channel pairs;  a = softmax(q k^T /
  sqrt(hd), causal) v (query head i reads KV head i // group);  x += a Wo;
  h = norm(x);  x += silu(h Wg) * (h Wu) Wo, or for experts: router
  softmax, the top k by probability (the lower expert first on ties),
  gates renormalised to sum to one, x += sum_k gate_k expert_k(h).

Then the final norm and the head (or the tied table) over the real
vocabulary.  ``precision="fp8"`` is the control: every product's two
operands rounded through float8 e4m3 with one scale per operand (its
largest magnitude to 448), the rest as in float32.

The forward is four pieces (``embed``, ``block``, ``final``, and the
sublayers ``attend`` and ``feed_forward`` that ``block`` adds to the
residual stream), gathered in :data:`FORWARD`.  A reference of its own
(``reference/<name>.py``) reuses them and gives a ``Forward`` of its own;
``logits`` and ``train.steps`` run whichever a configuration names.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import torch

from portbench.arch import Arch

F8_MAX = 448.0


@contextlib.contextmanager
def exact_f32():
    """float32 products without TF32, restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` through float8 e4m3 with one scale (largest magnitude to 448)."""
    scale = t.abs().amax().clamp(min=1e-30) / F8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class _RoundFP8(torch.autograd.Function):
    """``round_fp8`` forward; the gradient passes through unchanged (the
    backward's products then take the rounded operands autograd saved)."""

    @staticmethod
    def forward(ctx, t):
        return round_fp8(t.detach())

    @staticmethod
    def backward(ctx, g):
        return g


class _Ops:
    def __init__(self, precision: str):
        if precision not in ("f32", "fp8"):
            raise ValueError(precision)
        self.r = _RoundFP8.apply if precision == "fp8" else (lambda t: t)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.r(a) @ self.r(b)

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.einsum(eq, self.r(a), self.r(b))


def _norm(x: torch.Tensor, p: Dict, kind: str, eps: float) -> torch.Tensor:
    if kind == "layernorm":
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + eps) * p["scale"].float() + p["bias"].float()
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * p["scale"].float()


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, hd) rotated over interleaved pairs at positions pos (S,)."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
    ang = pos.float()[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).reshape(x.shape)


def _attention(ops: _Ops, q, k, v, heads_per_chunk: int = 8,
               scale: Optional[float] = None) -> torch.Tensor:
    """Causal attention, q (S, H, hd), k/v (S, KV, hd) -> (S, H, hd), the
    scores scaled by ``scale`` (1 / sqrt(hd) where None)."""
    S, H, hd = q.shape
    scale = hd ** -0.5 if scale is None else scale
    KV = k.shape[1]
    g = H // KV
    qg = q.view(S, KV, g, hd)
    keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    out = torch.empty_like(qg)
    step = max(1, heads_per_chunk // g)
    for c in range(0, KV, step):
        s = ops.einsum("qkgd,skd->kgqs", qg[:, c:c + step], k[:, c:c + step]) * scale
        p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
        del s
        out[:, c:c + step] = ops.einsum("kgqs,skd->qkgd", p, v[:, c:c + step])
        del p
    return out.view(S, H, hd)


def _moe(ops: _Ops, a: Arch, h: torch.Tensor, p: Dict) -> torch.Tensor:
    probs = torch.softmax(ops.mm(h, p["router"].float()), dim=-1)          # (S, E)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[:, :a.experts_per_tok], idx[:, :a.experts_per_tok]
    gate = gate / gate.sum(-1, keepdim=True)
    out = torch.zeros_like(h)
    for e in range(a.n_experts):
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        x = h[rows]
        y = torch.nn.functional.silu(ops.mm(x, p["wg"][e].float())) * ops.mm(x, p["wu"][e].float())
        y = ops.mm(y, p["wo"][e].float())
        out.index_add_(0, rows, y * gate[rows, slot, None])
    return out


def _layer(w: Dict, li: int) -> Dict:
    if isinstance(w, torch.Tensor):
        return w[li]
    return {k: _layer(v, li) for k, v in w.items()}


def attend(ops: _Ops, a: Arch, at: Dict, h: torch.Tensor, pos: torch.Tensor,
           scale: Optional[float] = None) -> torch.Tensor:
    """The attention sublayer's output over h (S, d), before the residual
    add; the scores scaled by ``scale`` (1 / sqrt(hd) where None)."""
    S = h.shape[0]
    H, KV, hd = a.n_heads, a.n_kv_heads, a.head_dim
    q = ops.mm(h, at["wq"].float().reshape(a.d_model, H * hd)).view(S, H, hd)
    k = ops.mm(h, at["wk"].float().reshape(a.d_model, KV * hd)).view(S, KV, hd)
    v = ops.mm(h, at["wv"].float().reshape(a.d_model, KV * hd)).view(S, KV, hd)
    q, k = _rope(q, pos, a.rope_theta), _rope(k, pos, a.rope_theta)
    o = _attention(ops, q, k, v, scale=scale)
    return ops.mm(o.reshape(S, H * hd), at["wo"].float().reshape(H * hd, a.d_model))


def feed_forward(ops: _Ops, a: Arch, lp: Dict, h: torch.Tensor) -> torch.Tensor:
    """The MLP's (or the experts') output over h (S, d), before the residual
    add."""
    if a.n_experts:
        return _moe(ops, a, h, lp["moe"])
    m = lp["mlp"]
    u = torch.nn.functional.silu(ops.mm(h, m["wg"].float())) * ops.mm(h, m["wu"].float())
    return ops.mm(u, m["wo"].float())


def block(ops: _Ops, a: Arch, lp: Dict, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """One layer over one sequence, x (S, d) float32 -> (S, d)."""
    x = x + attend(ops, a, lp["attn"], _norm(x, lp["ln1"], a.norm, a.norm_eps), pos)
    return x + feed_forward(ops, a, lp, _norm(x, lp["ln2"], a.norm, a.norm_eps))


def embed(weights: Dict, a: Arch, tok: torch.Tensor) -> torch.Tensor:
    """The residual stream's start, (S, d) float32, for the ids ``tok``."""
    return weights["embed"]["tok"][tok].float()


def final(ops: _Ops, a: Arch, final_ln: Dict, head: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Logits from the residual stream x (rows, d): the final norm, then the
    head (d, vocab)."""
    return ops.mm(_norm(x, final_ln, a.norm, a.norm_eps), head.float())


@dataclasses.dataclass(frozen=True)
class Forward:
    """A reference's forward, by its pieces: ``embed(weights, a, tok)``,
    ``block(ops, a, layer, x, pos)``, ``final(ops, a, final_ln, head, x)``."""
    embed: Callable
    block: Callable
    final: Callable

    def logits(self, weights: Dict, a: Arch, tokens: Sequence[int], rows: Sequence[int], *,
               precision: str = "f32") -> torch.Tensor:
        """Logits over the real vocabulary, (len(rows), vocab_size) float32,
        at the given positions of ``tokens``, with the harness's ``weights``
        on their device."""
        ops = _Ops(precision)
        dev = weights["embed"]["tok"].device
        with torch.no_grad(), exact_f32():
            tok = torch.tensor(list(tokens), dtype=torch.long, device=dev)
            pos = torch.arange(tok.numel(), device=dev)
            x = self.embed(weights, a, tok)
            for li in range(a.n_layers):
                x = self.block(ops, a, _layer(weights["layers"], li), x, pos)
            sel = x[torch.tensor(list(rows), dtype=torch.long, device=dev)]
            return self.final(ops, a, weights["final_ln"], head_of(weights, a), sel)


def head_of(weights: Dict, a: Arch) -> torch.Tensor:
    """The output head over the real vocabulary, (d, vocab_size)."""
    emb = weights["embed"]
    return emb["head"][:, :a.vocab_size] if "head" in emb else emb["tok"][:a.vocab_size].T


FORWARD = Forward(embed=embed, block=block, final=final)
logits = FORWARD.logits


def served_gaps(ref: torch.Tensor, served: Sequence[int]) -> List[float]:
    """For each row, how far the served token's reference logit lies below
    the reference's best (infinite for an id outside the vocabulary)."""
    best = ref.max(dim=-1).values
    out = []
    for i, t in enumerate(served):
        out.append(float("inf") if not 0 <= t < ref.shape[1] else float(best[i] - ref[i, t]))
    return out


def control_gaps(ref: torch.Tensor, control: torch.Tensor) -> List[float]:
    """For each row, how far the token the control puts first lies below
    the reference's best, by the reference's logits."""
    return served_gaps(ref, control.argmax(dim=-1).tolist())
