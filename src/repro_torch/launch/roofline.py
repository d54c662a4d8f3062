"""Roofline analysis over the dry-run (the reference's
``repro/launch/roofline.py``), priced at the H100's peaks.

Terms per (arch x shape) on the single-pod mesh, all PER DEVICE per step:

  compute_s    = flops / PEAK_FLOPS              (989 TFLOP/s bf16)
  memory_s     = fused_bytes / HBM_BW            (3.35 TB/s)
  collective_s = collective_bytes / NET_BW       (50 GB/s a card each way)

The reference compiles small unrolled variants because XLA counts a
``lax.scan`` body once, and solves F(L) = A + L*B (dense, moe, ssm, vlm,
encdec) or F = A + Lm*Bm + n_app*Ba for the hybrid (Mamba layers plus
shared-attention applications) for the full depth.  The port counts every
layer anyway, so its extrapolation equals a direct count at full depth; it
stays so that the records compare with the reference's, and the tests hold
it against the direct count.  Peak memory comes from the full-depth dry-run
record (no extrapolation).

Each record names the card it is priced for (``card``): the published
dense peaks of the H100 SXM at its 700 W limit, and, where ``nvidia-smi``
answers, the name and power limit of the card in this machine.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
from typing import Any, Dict, Optional

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import cells, get_config, lm_archs
from repro_torch.launch.dryrun import run_cell

#: bf16 dense tensor-core peak of one H100 SXM (NVIDIA H100 data sheet,
#: without sparsity; assumes the 700 W power limit)
PEAK_FLOPS = 989e12
#: HBM3 bandwidth of one H100 SXM (same data sheet)
HBM_BW = 3.35e12
#: a 16-rank "data" or "model" axis spans two 8-card hosts, so its
#: collectives cross the hosts' network: NDR InfiniBand at 400 Gb/s a card
#: (one ConnectX-7 per GPU in a DGX H100), 50e9 B/s each way
NET_BW = 50e9
#: NVLink 4 within a host, 900 GB/s a card both ways: 450e9 B/s each way
#: (the in-host term, for collectives that stay on one host)
NVLINK_BW = 450e9
CHIPS = 256             # single-pod roofline
CARD = "NVIDIA H100 SXM (published dense peaks, 700 W)"

METRICS = ("flops", "bytes_accessed", "fused_bytes", "collective_bytes")

ROOFLINE_PATH = "experiments/torch_roofline_results.json"


@functools.lru_cache(maxsize=1)
def _nvidia_smi() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def card() -> Dict[str, Any]:
    """The constants a record is priced at, and the card ``nvidia-smi`` names."""
    return {"priced_for": CARD, "peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW,
            "net_bw": NET_BW, "nvlink_bw": NVLINK_BW, "nvidia_smi": _nvidia_smi()}


def _pd(rec: Dict) -> Dict[str, float]:
    return {m: float(rec["per_device"][m]) for m in METRICS}


def _lin2(f1: Dict, f2: Dict) -> Dict[str, Dict[str, float]]:
    """F(L) = A + L*B from L=1,2 samples."""
    B = {m: f2[m] - f1[m] for m in METRICS}
    A = {m: f1[m] - B[m] for m in METRICS}
    return {"A": A, "B": B}


def extrapolate(arch: str, shape_name: str, *, attn_impl: str, **run_kw) -> Dict[str, Any]:
    """Per-device totals for the full layer count, via small variants
    (``accum_steps=1``, as the reference's).  ``run_kw`` goes on to
    ``run_cell`` (``perf.measure``'s variants)."""
    cfg = get_config(arch)
    kw = dict(attn_impl=attn_impl, scan_layers=False, multi_pod=False,
              accum_steps=1)
    kw.update(run_kw)

    if cfg.family == "hybrid":
        every = cfg.attn_every
        f6 = _pd(run_cell(arch, shape_name, n_layers=every, **kw))
        f7 = _pd(run_cell(arch, shape_name, n_layers=every + 1, **kw))
        f12 = _pd(run_cell(arch, shape_name, n_layers=2 * every, **kw))
        Bm = {m: f7[m] - f6[m] for m in METRICS}
        Ba = {m: f12[m] - f6[m] - every * Bm[m] for m in METRICS}
        A = {m: f6[m] - every * Bm[m] - Ba[m] for m in METRICS}
        L = cfg.n_layers
        n_app = L // every
        total = {m: A[m] + L * Bm[m] + n_app * Ba[m] for m in METRICS}
        return {
            "total": total,
            "fixed": A,
            "per_layer": Bm,
            "per_attn_app": Ba,
            "samples": {"L6": f6, "L7": f7, "L12": f12},
        }

    f1 = _pd(run_cell(arch, shape_name, n_layers=1, **kw))
    f2 = _pd(run_cell(arch, shape_name, n_layers=2, **kw))
    co = _lin2(f1, f2)
    L = cfg.n_layers
    total = {m: co["A"][m] + L * co["B"][m] for m in METRICS}
    return {
        "total": total,
        "fixed": co["A"],
        "per_layer": co["B"],
        "samples": {"L1": f1, "L2": f2},
    }


def model_flops_per_device(arch: str, shape_name: str) -> Dict[str, float]:
    """Useful-work floor: 6*N_active*D (train) / 2*N_active*D (inference)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    n = cfg.n_active_params()
    tokens = (
        shape.global_batch
        if shape.is_decode
        else shape.global_batch * shape.seq_len
    )
    mult = 6 if shape.mode == "train" else 2
    return {
        "n_active_params": n,
        "tokens_per_step": tokens,
        "model_flops_per_device": mult * n * tokens / CHIPS,
    }


def terms(tot: Dict[str, float]) -> Dict[str, float]:
    """The three roofline terms of per-device totals."""
    return {"compute_s": tot["flops"] / PEAK_FLOPS,
            # the fusion-aware estimate; raw bytes_accessed is the upper bound
            "memory_s": tot["fused_bytes"] / HBM_BW,
            "collective_s": tot["collective_bytes"] / NET_BW}


def roofline_cell(
    arch: str,
    shape_name: str,
    *,
    attn_impl: str = "chunked",
    dryrun_record: Optional[Dict] = None,
) -> Dict[str, Any]:
    ext = extrapolate(arch, shape_name, attn_impl=attn_impl)
    tot = ext["total"]
    t = terms(tot)
    dominant = max(t, key=t.get)
    mf = model_flops_per_device(arch, shape_name)
    bound = max(t.values())
    rec = {
        "arch": arch,
        "shape": shape_name,
        "attn_impl": attn_impl,
        "mesh": "16x16",
        **t,
        "memory_s_unfused_bound": tot["bytes_accessed"] / HBM_BW,
        "dominant": dominant,
        "useful_flops_ratio": (
            mf["model_flops_per_device"] / tot["flops"] if tot["flops"] else 0.0
        ),
        "roofline_fraction": (
            # fraction of the card's peak the dominant resource implies for
            # useful model flops: (model_flops/peak) / step_time_bound
            (mf["model_flops_per_device"] / PEAK_FLOPS) / bound if bound else 0.0
        ),
        "totals_per_device": tot,
        "model_flops": mf,
        "extrapolation": ext,
        "card": card(),
    }
    if dryrun_record is not None and dryrun_record.get("status") == "ok":
        rec["peak_bytes_full_compile"] = dryrun_record["per_device"]["peak_bytes"]
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--attn", default="chunked")
    ap.add_argument("--out", default=ROOFLINE_PATH)
    ap.add_argument("--dryrun-results", default="experiments/torch_dryrun_results.json")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()

    try:
        with open(args.dryrun_results) as f:
            dres = json.load(f)
    except (OSError, json.JSONDecodeError):
        dres = {}
    try:
        with open(args.out) as f:
            results = json.load(f)
    except (OSError, json.JSONDecodeError):
        results = {}

    archs = lm_archs() if args.arch == "all" else [args.arch.replace("-", "_")]
    for arch in archs:
        shape_names = list(cells(arch)) if args.shape == "all" else [args.shape]
        for shape_name in shape_names:
            key = f"{arch}|{shape_name}|{args.attn}"
            if key in results and not args.force:
                print(f"[skip] {key}")
                continue
            print(f"[roofline] {key}", flush=True)
            dr = dres.get(f"{arch}|{shape_name}|16x16|{args.attn}")
            try:
                rec = roofline_cell(
                    arch, shape_name, attn_impl=args.attn, dryrun_record=dr
                )
                print(
                    f"  compute={rec['compute_s']*1e3:.2f}ms "
                    f"memory={rec['memory_s']*1e3:.2f}ms "
                    f"collective={rec['collective_s']*1e3:.2f}ms "
                    f"dominant={rec['dominant']} "
                    f"useful={rec['useful_flops_ratio']:.2f} "
                    f"roofline_frac={rec['roofline_fraction']:.3f}"
                )
            except Exception as e:  # noqa: BLE001
                rec = {"arch": arch, "shape": shape_name, "status": "error",
                       "error": f"{type(e).__name__}: {e}"}
                print(f"  FAILED: {rec['error']}")
            results[key] = rec
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
