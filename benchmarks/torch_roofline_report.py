"""Roofline table of the port (the reference's ``roofline_report.py``) from
``experiments/torch_*.json`` (written by ``repro_torch.launch.roofline``):
per (arch x shape), the step time the largest term bounds, and the
roofline fraction at the H100's peaks; ``roofline/missing`` where there
are no records."""
from __future__ import annotations

import json
import os
from typing import Callable, Dict

PATHS = [
    ("roofline", "experiments/torch_roofline_results.json"),
    ("roofline_final", "experiments/torch_roofline_final_decode.json"),
]


def run(emit: Callable[[str, float, float], None]) -> Dict:
    out = {}
    for tag, path in PATHS:
        if not os.path.exists(path):
            continue
        with open(path) as f:
            res = json.load(f)
        for key, rec in sorted(res.items()):
            if rec.get("compute_s") is None:
                continue
            step_us = max(rec["compute_s"], rec["memory_s"], rec["collective_s"]) * 1e6
            emit(f"{tag}/{rec['arch']}/{rec['shape']}", round(step_us, 1),
                 round(rec["roofline_fraction"], 4))
            out[f"{tag}|{key}"] = rec["roofline_fraction"]
    if not out:
        emit("roofline/missing", 0.0, 0.0)
    return out
