"""Performance hillclimbing over the dry-run (the reference's
``repro/launch/perf.py``).

Runs named experiment variants against a cell, recomputes the three
roofline terms (at the H100's peaks, ``launch/roofline.py``) through the
same small-variant extrapolation, and appends hypothesis -> change ->
before/after -> verdict records to ``experiments/torch_perf_log.json``.

    PYTHONPATH=src python -m repro_torch.launch.perf --cell stablelm_1_6b/train_4k \\
        --variant pure_dp
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict

from repro_torch.launch import roofline as RL
from repro_torch.launch.dryrun import run_cell

PERF_LOG = "experiments/torch_perf_log.json"

_PURE_DP_RULES = {
    "batch": ("data", "model"), "seq_res": None, "heads": None,
    "kv_heads": None, "mlp": None, "vocab": None, "moe_t": None,
    "moe_cap": None, "moe_flat": None,
}
_PURE_DP_PARAM_RULES = {
    "vocab": None, "embed": ("data", "model"), "embed_tp": None,
    "heads": None, "kv_heads": None, "mlp": None,
}

#: named experiment variants, the reference's: kwargs passed to run_cell
#: (rules = activation rule overrides, param_rules = parameter sharding
#: overrides, ...).
VARIANTS: Dict[str, Dict[str, Any]] = {
    "baseline": {},
    # pure data parallelism: the "model" axis as extra FSDP width; no TP
    "pure_dp": {"rules": _PURE_DP_RULES, "param_rules": _PURE_DP_PARAM_RULES,
                "accum_steps": 1},
    # sequence parallelism off
    "no_sp": {"rules": {"seq_res": None}},
    # remat policy: save matmul outputs (no forward recompute in backward)
    "remat_dots": {"remat": "dots"},
    "remat_none": {"remat": "none"},
    # un-fused attention baseline
    "naive_attn": {"attn_impl": "naive"},
    # MoE: tighter capacity
    "cap_1_0": {"cfg_overrides": {"moe_capacity_factor": 1.0}},
    # decode: bf16 KV (undo the fp8 default) for A/B
    "kv_bf16": {"cfg_overrides": {"kv_cache_dtype": "bfloat16"}},
    # decode: fp8 KV cache
    "kv_fp8": {"cfg_overrides": {"kv_cache_dtype": "float8_e4m3fn"}},
    # combos
    "pure_dp_dots": {"rules": _PURE_DP_RULES, "param_rules": _PURE_DP_PARAM_RULES,
                     "accum_steps": 1, "remat": "dots"},
}


def measure(arch: str, shape_name: str, variant: str) -> Dict[str, Any]:
    kw = dict(VARIANTS[variant])
    attn_impl = kw.pop("attn_impl", "chunked")
    kw.setdefault("accum_steps", 1)
    kw.setdefault("remat", "full")
    tot = RL.extrapolate(arch, shape_name, attn_impl=attn_impl, **kw)["total"]
    mf = RL.model_flops_per_device(arch, shape_name)
    terms = RL.terms(tot)
    bound = max(terms.values())
    # peak memory at full depth
    full = run_cell(arch, shape_name, False, attn_impl=attn_impl, **kw)
    return {
        "arch": arch, "shape": shape_name, "variant": variant,
        **terms,
        "dominant": max(terms, key=terms.get),
        "useful_flops_ratio": mf["model_flops_per_device"] / tot["flops"],
        "roofline_fraction": (mf["model_flops_per_device"] / RL.PEAK_FLOPS) / bound,
        "peak_bytes_full": full["per_device"]["peak_bytes"],
        "totals_per_device": tot,
        "card": RL.card(),
    }


def log_experiment(rec: Dict[str, Any], hypothesis: str = "") -> None:
    try:
        with open(PERF_LOG) as f:
            log = json.load(f)
    except (OSError, json.JSONDecodeError):
        log = []
    rec = dict(rec)
    if hypothesis:
        rec["hypothesis"] = hypothesis
    log.append(rec)
    os.makedirs(os.path.dirname(PERF_LOG) or ".", exist_ok=True)
    with open(PERF_LOG, "w") as f:
        json.dump(log, f, indent=1)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, help="arch/shape")
    ap.add_argument("--variant", required=True, choices=sorted(VARIANTS))
    ap.add_argument("--hypothesis", default="")
    args = ap.parse_args()
    arch, shape_name = args.cell.split("/")
    arch = arch.replace("-", "_")
    rec = measure(arch, shape_name, args.variant)
    log_experiment(rec, args.hypothesis)
    print(json.dumps({k: v for k, v in rec.items() if k != "totals_per_device"},
                     indent=1))


if __name__ == "__main__":
    main()
