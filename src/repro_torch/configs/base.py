"""Config schema for architectures and run shapes.

One :class:`ModelConfig` per assigned architecture lives in
``repro/configs/<id>.py``; ``smoke()`` derives the reduced-config variant
used by per-arch CPU smoke tests.  Run shapes (the assigned seq/batch cells)
are :class:`RunShape` instances in ``SHAPES``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ModelConfig", "RunShape", "SHAPES"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    # positional encoding
    rope: str = "rope"                      # rope | rope2d | mrope | none
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)  # t/h/w split of half-dims
    # MoE
    n_experts: int = 0
    experts_per_tok: int = 0
    moe_capacity_factor: float = 1.25
    # SSM (mamba2) / linear attention (rwkv6)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    # hybrid (zamba2-style): one shared attention block applied every k layers
    attn_every: int = 0
    # encoder-decoder
    enc_layers: int = 0                     # >0 => enc-dec; n_layers = decoder
    cross_attention: bool = False
    # misc
    activation: str = "swiglu"              # swiglu | gelu
    norm: str = "rmsnorm"                   # rmsnorm | layernorm
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    kv_cache_dtype: str = "bfloat16"   # "float8_e4m3fn" = quantized KV pages
    # frontends ([audio]/[vlm]): backbone consumes precomputed embeddings
    frontend: Optional[str] = None          # None | audio | vision
    notes: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run the long_500k cell? (SSM/hybrid/linear-attn)"""
        return self.family in ("ssm", "hybrid")

    def n_params(self) -> int:
        """Analytic parameter count (embeddings included once)."""
        d, f, L = self.d_model, self.d_ff, self.n_layers
        hd, H, KV = self.hd, self.n_heads, self.n_kv_heads
        attn = d * H * hd + 2 * d * KV * hd + H * hd * d
        if self.activation == "swiglu":
            mlp = 3 * d * f
        else:
            mlp = 2 * d * f
        if self.n_experts:
            mlp = self.n_experts * (3 * d * f) + d * self.n_experts
        if self.family == "ssm":  # rwkv6-style block
            att_d = d
            attn = 4 * d * att_d + att_d * d + 6 * d * 32 * 2  # rkvg + out + lora-ish mixers
        per_layer = attn + mlp + 2 * d
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total = L * per_layer + emb
        if self.is_encdec:
            enc_per = attn + mlp + 2 * d
            total += self.enc_layers * enc_per + L * attn  # cross-attn
        if self.family == "hybrid":
            d_in = self.ssm_expand * d
            nh = d_in // self.ssm_head_dim
            mamba = d * (2 * d_in + 2 * nh) + d_in * d + nh * self.ssm_state * 0
            total = L * (mamba + 2 * d) + emb
            # shared attention block (counted once - weights shared)
            total += attn + 3 * d * f
        return int(total)

    def n_active_params(self) -> int:
        """Active params per token (MoE: only routed experts)."""
        if not self.n_experts:
            return self.n_params()
        d, f, L = self.d_model, self.d_ff, self.n_layers
        hd, H, KV = self.hd, self.n_heads, self.n_kv_heads
        attn = d * H * hd + 2 * d * KV * hd + H * hd * d
        mlp_active = self.experts_per_tok * (3 * d * f) + d * self.n_experts
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return int(L * (attn + mlp_active + 2 * d) + emb)

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=max(2, min(3, self.n_layers)),
            d_model=128,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)) if self.n_kv_heads < self.n_heads else 4,
            head_dim=32,
            d_ff=64 if self.n_experts else 256,
            vocab_size=512,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            experts_per_tok=min(self.experts_per_tok, 2) if self.n_experts else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            enc_layers=2 if self.enc_layers else 0,
            attn_every=2 if self.attn_every else 0,
            mrope_sections=(4, 6, 6),
            dtype="float32",
            kv_cache_dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class RunShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str            # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.mode == "decode"


SHAPES = {
    "train_4k": RunShape("train_4k", 4096, 256, "train"),
    "prefill_32k": RunShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": RunShape("decode_32k", 32768, 128, "decode"),
    "long_500k": RunShape("long_500k", 524288, 1, "decode"),
}
