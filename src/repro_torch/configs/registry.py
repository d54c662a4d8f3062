"""Architecture registry: ``get_config(name)`` / ``ARCHS`` (all assigned).

``puma_paper`` is the one non-LM entry: ``get_config("puma_paper")``
returns a :class:`repro_torch.configs.puma_paper.PumaPaperConfig` — the
paper's DRAM organization (channel/bank/subarray counts) validated against
``DramGeometry`` and both interleave schemes at construction.  Use
``.geometry()`` / ``.address_map()`` on it; ``lm_archs()`` excludes it."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig, RunShape, SHAPES

ARCHS: List[str] = [
    "granite_moe_3b_a800m",
    "granite_moe_1b_a400m",
    "zamba2_7b",
    "seamless_m4t_medium",
    "granite_34b",
    "stablelm_1_6b",
    "mistral_nemo_12b",
    "chatglm3_6b",
    "qwen2_vl_72b",
    "rwkv6_7b",
    "puma_paper",          # the paper's own PUD micro-benchmark "arch"
]


def get_config(name: str) -> ModelConfig:
    name = name.replace("-", "_")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.CONFIG


def lm_archs() -> List[str]:
    return [a for a in ARCHS if a != "puma_paper"]


#: the registry models the trace/offload benchmark prices a decode step for
#: (one small dense, one MoE — exercising expert dispatch — one GQA dense).
TRACE_ARCHS: List[str] = [
    "stablelm_1_6b",
    "granite_moe_1b_a400m",
    "chatglm3_6b",
]


def moe_archs() -> List[str]:
    """Architectures with a routed-expert MLP (MoE expert dispatch)."""
    return [a for a in lm_archs() if get_config(a).n_experts > 0]


def cells(arch: str) -> Dict[str, RunShape]:
    """The assigned (shape -> RunShape) cells for one arch, with skips."""
    cfg = get_config(arch)
    out = {}
    for sname, shape in SHAPES.items():
        if sname == "long_500k" and not cfg.sub_quadratic:
            continue  # quadratic attention: skipped per assignment
        out[sname] = shape
    return out
