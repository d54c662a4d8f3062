"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) d_ff=512,
vocab 49155, 40 experts top-8.  [hf:ibm-granite/granite-3.0-*; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    n_experts=40,
    experts_per_tok=8,
    rope="rope",
    tie_embeddings=True,
    notes="granite MoE: per-expert SwiGLU d_ff=512; expert-TP sharding",
)
