"""Record a serving scenario into a ``repro_torch.trace`` op trace.

It builds the engine ``benchmarks/torch_serve_bench.py`` builds for a
scenario (same smoke model, same pool overrides, same watermark
maintenance), attaches a :class:`~repro_torch.trace.record.TraceRecorder`,
plays the scenario's fixed-seed request stream through
:func:`repro_torch.serve.loadgen.play`, and finalizes the trace with the
engine's end-of-run totals.

Every input is seed-pinned and the trace is priced by the SimCost model
with ``eos_id=None``, so the weights do not enter it: the JSONL equals,
byte for byte, the golden the reference records
(``tests/goldens/steady_smoke.trace.jsonl``), on the card or on the CPU.
The model runs with ``attn_impl="naive"``, as the reference's does::

    PYTHONPATH=src python -m repro_torch.trace.serve_trace --device cpu [--write PATH]
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.trace.record import DEFAULT_SIM, TraceRecorder

_MODELS: Dict[str, Tuple] = {}


def smoke_model(device="cuda"):
    """The smoke serving model shared with ``benchmarks/torch_serve_bench.py``:
    ``(model, params)``, random weights from a seeded generator, built once
    per device."""
    from repro_torch import resolve_device
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import LM

    device = resolve_device(device)
    if str(device) not in _MODELS:
        cfg = get_config("stablelm_1_6b").smoke()
        model = LM(cfg, attn_impl="naive", remat=None)
        _MODELS[str(device)] = (model, model.init(0, device=device))
    return _MODELS[str(device)]


def record_scenario(
    name: str = "steady",
    *,
    smoke: bool = True,
    n_requests: Optional[int] = None,
    device="cuda",
) -> Tuple[TraceRecorder, Dict[str, object]]:
    """Play scenario ``name`` under a recorder; returns (trace, play record).

    ``n_requests`` truncates the scenario's request stream (keeping its
    seeds).
    """
    from repro_torch.core.kv_pool import KVPoolConfig
    from repro_torch.serve.engine import MaintenanceConfig, ServeEngine
    from repro_torch.serve.loadgen import build_scenario, play

    model, params = smoke_model(device)
    cfg = model.cfg
    sc = build_scenario(name, smoke=smoke)
    base = dict(
        num_blocks=32, block_size=8, kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
        n_layers=cfg.n_layers, max_seqs=4, max_blocks_per_seq=16,
        blocks_per_arena=16, policy="puma", dtype="float32",
    )
    base.update(sc.pool_overrides())
    pool_cfg = KVPoolConfig(**base)
    tile_bytes = (
        2 * pool_cfg.n_layers * pool_cfg.block_size * pool_cfg.kv_heads
        * pool_cfg.head_dim * np.dtype(pool_cfg.dtype).itemsize
    )
    trace = TraceRecorder(
        channels=pool_cfg.n_channels,
        banks_per_channel=8,
        blocks_per_arena=pool_cfg.blocks_per_arena,
        block_bytes=int(tile_bytes),
        sim=dict(DEFAULT_SIM),
        meta={
            "scenario": name,
            "seed": sc.seed,
            "smoke": bool(smoke),
            "model": "stablelm_1_6b.smoke",
            "policy": pool_cfg.policy,
        },
    )
    eng = ServeEngine(
        model, params, pool_cfg,
        device=device, maintenance=MaintenanceConfig(), trace=trace,
    )
    specs = sc.generate()
    if n_requests is not None:
        specs = specs[:n_requests]
    rec = play(eng, specs, max_steps=sc.max_steps)
    trace.finalize(
        clock=eng.clock,
        tokens_decoded=eng.tokens_decoded,
        tokens_prefilled=eng.tokens_prefilled,
        maintenance_ns=eng.maintenance_ns,
    )
    return trace, rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scenario", default="steady")
    ap.add_argument("--full", action="store_true",
                    help="full-size scenario (default: smoke)")
    ap.add_argument("--write", metavar="PATH", default=None,
                    help="write the canonical JSONL to PATH")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    trace, rec = record_scenario(args.scenario, smoke=not args.full, device=args.device)
    if args.write:
        trace.write(args.write)
        print(f"[serve_trace] wrote {args.write} ({len(trace.events)} events)")
    else:
        print(f"[serve_trace] {args.scenario}: {len(trace.events)} events, "
              f"done={rec['done']}/{rec['submitted']}")


if __name__ == "__main__":
    main()
