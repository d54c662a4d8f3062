"""Operations and bytes the measured work needs, from shapes alone.

Model flops count two operations per multiply-add of every weight a token
passes through (the attention projections, the MLP or the experts it is
routed to and the router, the output head over the real vocabulary; the
embedding lookup is no product), and the attention's two products over the
keys the token attends to, itself included: the counting of
``repro_torch/launch/roofline.py``'s ``model_flops_per_device`` (2 x
active parameters a token), with the attention's products added and the
embedding table left out.  Recompute, padding and dropped work are never
counted.
"""
from __future__ import annotations

from typing import Iterable

from portbench.arch import Arch


def layer_weights(a: Arch) -> int:
    """Weights of one layer that a token multiplies through."""
    attn = a.d_model * a.n_heads * a.head_dim * 2 + 2 * a.d_model * a.n_kv_heads * a.head_dim
    if a.n_experts:
        mlp = a.d_model * a.n_experts + a.experts_per_tok * 3 * a.d_model * a.d_ff
    else:
        mlp = 3 * a.d_model * a.d_ff
    return attn + mlp


def attention_flops(a: Arch, keys: int) -> int:
    """One query's two attention products over ``keys`` keys, every layer."""
    return a.n_layers * 4 * a.n_heads * a.head_dim * keys


def decode_token_flops(a: Arch, keys: int) -> int:
    """One decoded token that attends to ``keys`` keys (itself included):
    every layer's weights, the head, and the attention."""
    return 2 * (a.n_layers * layer_weights(a) + a.d_model * a.vocab_size) + attention_flops(a, keys)


def prefill_flops(a: Arch, n: int) -> int:
    """A prompt of ``n`` tokens: every layer's weights for each token, causal
    attention (token i attends to i + 1 keys), and the head at the last
    position only (the program's prefill returns the last logits)."""
    return (2 * n * a.n_layers * layer_weights(a) + 2 * a.d_model * a.vocab_size
            + attention_flops(a, n * (n + 1) // 2))


def paged_call_bytes(a: Arch, past_lens: Iterable[int], block_size: int,
                     page_bytes: int = 2, q_bytes: int = 2) -> int:
    """Bytes one paged-attention call (one layer) needs: each sequence's
    cached K and V tokens read once, its block-table entries and length,
    q read once, and the output and the f32 log-sum-exp written once."""
    past = list(past_lens)
    b = len(past)
    kv = sum(past) * 2 * a.n_kv_heads * a.head_dim * page_bytes
    table = sum(-(-n // block_size) for n in past) * 4 + b * 4
    q_out = 2 * b * a.n_heads * a.head_dim * q_bytes
    lse = b * a.n_heads * 4
    return kv + table + q_out + lse


def train_step_flops(a: Arch, batch: int, seq: int) -> int:
    """One training step over ``batch`` rows of ``seq`` tokens: three times
    the forward's model flops (the forward, and the backward's two products
    for each of the forward's), with the head at every position and causal
    attention; the recompute of rematerialisation is not counted."""
    forward = (2 * seq * (a.n_layers * layer_weights(a) + a.d_model * a.vocab_size)
               + attention_flops(a, seq * (seq + 1) // 2))
    return 3 * batch * forward
