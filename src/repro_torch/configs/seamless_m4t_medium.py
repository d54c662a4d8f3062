"""seamless-m4t-medium [audio]: enc-dec, 12L each, d_model=1024 16H (kv=16)
d_ff=4096 vocab=256206.  Audio frontend is a STUB: input_specs() provides
precomputed frame embeddings.  [arXiv:2308.11596; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,
    enc_layers=12,
    cross_attention=True,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    rope="none",
    activation="gelu",
    norm="layernorm",
    frontend="audio",
)
