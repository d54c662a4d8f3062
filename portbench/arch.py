"""A configuration file (``configs/<name>.json``: the published ``config.json``
keys, and under ``departures`` the keys the program runs otherwise, laid
over them) read into the plain description both sides share.

The harness builds the program's config from an :class:`Arch`
(``program.port_config``); the reference reads the same :class:`Arch` and
never the program's.  ``smoke()`` shrinks every width for the CPU rehearsal
and the tests; the cells always run the file as it stands.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path


@dataclasses.dataclass(frozen=True)
class Arch:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    norm: str                      # "layernorm" | "rmsnorm"
    norm_eps: float
    rope_theta: float
    tie_embeddings: bool
    dtype: str                     # the served type, "bfloat16"
    init_std: float
    n_experts: int = 0
    experts_per_tok: int = 0
    capacity_factor: float = 1.25
    max_positions: int = 0

    @property
    def family(self) -> str:
        return "moe" if self.n_experts else "dense"

    def smoke(self) -> "Arch":
        """The same family at CPU size: every width cut, two layers."""
        grouped = self.n_kv_heads < self.n_heads
        return dataclasses.replace(
            self, name=self.name + "-smoke", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2 if grouped else 4, head_dim=16, d_ff=32 if self.n_experts else 128,
            vocab_size=500 if self.vocab_size % 2048 else 2048,
            n_experts=min(self.n_experts, 8), experts_per_tok=min(self.experts_per_tok, 2),
            capacity_factor=(min(self.n_experts, 8) / min(self.experts_per_tok, 2)
                             if self.n_experts else self.capacity_factor),
            max_positions=0,
            # the same scale of activations as at full width
            init_std=self.init_std * (self.d_model / 64) ** 0.5,
        )


def load(path: Path) -> Arch:
    """The configuration file at ``path`` as an :class:`Arch`."""
    c = json.loads(Path(path).read_text())
    c = {**c, **c.get("departures", {})}
    heads = c["num_attention_heads"]
    hd = c.get("head_dim") or c["hidden_size"] // heads
    eps = c.get("layer_norm_eps", c.get("rms_norm_eps"))
    experts = c.get("num_local_experts", 0)
    if c.get("rotary", "interleaved") != "interleaved" or c.get("partial_rotary_factor", 1.0) != 1.0:
        raise ValueError(f"{path}: only a whole-head interleaved rotary is supported")
    for key, neutral in (("embedding_multiplier", 1.0), ("residual_multiplier", 1.0),
                         ("logits_scaling", 1.0), ("attention_multiplier", hd ** -0.5)):
        if key in c and abs(c[key] - neutral) > 1e-12:
            raise ValueError(f"{path}: {key} = {c[key]} is not run by the program")
    if c.get("use_qkv_bias") or c.get("attention_bias"):
        raise ValueError(f"{path}: attention biases are not run by the program")
    return Arch(
        name=Path(path).stem, n_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
        n_heads=heads, n_kv_heads=c.get("num_key_value_heads", heads), head_dim=hd,
        d_ff=c["intermediate_size"], vocab_size=c["vocab_size"], norm=c["norm"], norm_eps=eps,
        rope_theta=float(c.get("rope_theta", 10000.0)),
        tie_embeddings=bool(c.get("tie_word_embeddings", False)), dtype=c["torch_dtype"],
        init_std=float(c["initializer_range"]), n_experts=experts,
        experts_per_tok=c.get("num_experts_per_tok", 0),
        capacity_factor=float(c.get("moe_capacity_factor", 1.25)),
        max_positions=int(c.get("max_position_embeddings", 0)),
    )

