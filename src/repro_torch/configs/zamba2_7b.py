"""zamba2-7b [hybrid]: 81L d_model=3584 Mamba2 backbone (ssm_state=64) with a
shared attention block (32H, GQA kv=32, d_ff=14336) every 6 layers.
[arXiv:2411.15242; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    attn_every=6,
    rope="rope",
    notes="shared-weight attn block every 6 mamba layers; simplified input "
          "(no concat-with-embedding, see DESIGN.md)",
)
