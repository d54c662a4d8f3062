"""A configuration file (``configs/<name>.json``: the published ``config.json``
keys, and under ``departures`` the keys the program runs otherwise, laid
over them) read into the plain description both sides share.

The file may name its reference by the harness key ``"reference"``
(``reference/<name>.py``; ``model`` where it names none), and it states how
the model rotates by the harness key ``"rotary"`` (a published
``config.json`` holds none): ``"interleaved"``, (even, odd) channel pairs,
what the shared forward runs, or ``"halves"``, ``rotate_half``'s.

One table, :func:`forward_keys`, holds the published keys known to change
the forward beyond the core fields of :class:`Arch`, each at the value
under which the shared forward is what the model runs.  The named
reference (and only it) is imported; it declares the keys it runs
(``neutral_keys``), at the table's neutral value where the table has the
key (a reference that declares another is refused).  Such a key travels on
the ``Arch`` (``keys``); any other key of the table or of the reference's
declaration has to hold its neutral value, or the load raises, naming the
key and the reference.  A carried key holds a number, a string or a truth
value.  The carried keys reach the program only through a ``ModelConfig``
field of the same name (``program.port_config``), which refuses one it has
no field for.  A published key that is in no table is not seen.

The harness builds the program's config from an :class:`Arch`
(``program.port_config``); the reference reads the same :class:`Arch` and
never the program's.  ``smoke()`` shrinks every width for the CPU rehearsal
and the tests, and keeps the reference and the carried keys; the cells
always run the file as it stands.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

from portbench import reference


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
    reference: str = "model"       # the module of reference/ that runs this configuration
    keys: Tuple[Tuple[str, Any], ...] = ()   # published keys the reference runs, by name

    def key(self, name: str, default: Any = None) -> Any:
        """The carried published key ``name`` (``default`` where the file
        states none)."""
        return dict(self.keys).get(name, default)

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


def is_neutral(value: Any, neutral: Any) -> bool:
    """Whether a key's ``value`` is its ``neutral`` one (numbers within 1e-12)."""
    if isinstance(neutral, float) and isinstance(value, (int, float)):
        return abs(value - neutral) <= 1e-12
    return value == neutral


def forward_keys(head_dim: int) -> Dict[str, Any]:
    """The published keys known to change the forward beyond the core fields
    of :class:`Arch`, each at its neutral value (None: the key unset)."""
    return {
        # rotary and attention
        "rotary": "interleaved", "partial_rotary_factor": 1.0, "rope_scaling": None,
        "sliding_window": None, "use_qkv_bias": False, "attention_bias": False,
        "qk_layernorm": False, "attention_multiplier": head_dim ** -0.5,
        # the block and its MLP
        "use_parallel_residual": False, "hidden_act": "silu", "mlp_bias": False,
        "residual_multiplier": 1.0,
        # the embedding and the head
        "embedding_multiplier": 1.0, "logits_scaling": 1.0,
    }


def load(path: Path, root: Optional[Path] = None) -> Arch:
    """The configuration file at ``path`` as an :class:`Arch`; its reference
    is found as ``reference.module`` finds it under ``root``."""
    c = json.loads(Path(path).read_text())
    c = {**c, **c.get("departures", {})}
    ref = c.get("reference", "model")
    heads = c["num_attention_heads"]
    hd = c.get("head_dim") or c["hidden_size"] // heads
    eps = c.get("layer_norm_eps", c.get("rms_norm_eps"))
    experts = c.get("num_local_experts", 0)
    if "rotary" not in c:
        raise ValueError(f"{path}: states no \"rotary\" (\"interleaved\" or \"halves\"), "
                         f"the harness key for how the model rotates")
    table = forward_keys(hd)
    runs = reference.neutral_keys(ref, hd, root)
    for key, neutral in runs.items():
        if key in table and not is_neutral(neutral, table[key]):
            raise ValueError(f"reference/{ref}.py declares {key} neutral at {neutral!r}, "
                             f"the harness at {table[key]!r}")
    table.update(runs)
    carried = {}
    for key, neutral in table.items():
        if c.get(key) is None:
            continue
        if key not in runs:
            if not is_neutral(c[key], neutral):
                raise ValueError(f"{path}: {key} = {c[key]!r} is not run by the reference "
                                 f"{ref!r} (reference/{ref}.py declares no {key!r})")
        elif not isinstance(c[key], (bool, int, float, str)):
            raise ValueError(f"{path}: {key} = {c[key]!r}: a carried key holds a number, "
                             f"a string or a truth value")
        else:
            carried[key] = c[key]
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
        reference=ref, keys=tuple(sorted(carried.items())),
    )
