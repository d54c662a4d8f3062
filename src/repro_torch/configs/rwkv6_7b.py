"""rwkv6-7b "Finch" [ssm]: 32L d_model=4096 attention-free, d_ff=14336
vocab=65536 — data-dependent per-channel decay.  [arXiv:2404.05892; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,            # wkv heads = d_model / ssm_head_dim
    n_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    ssm_head_dim=64,
    rope="none",
)
