"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The run builds or loads the program's kernels
(``build/kernels/`` in the checkout), draws the weights on the card from
the seed, warms up the cell's shapes, measures for ``--seconds``, compares
what the window served with the plain reference, and prints one JSON line:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``, each compared number
beside its limit (also the last lines on standard error).

It exits non-zero and prints no result without enough CUDA devices, or if
JAX, flax or the JAX package was loaded.  ``--smoke`` rehearses the same
path on the CPU at tiny sizes; every metric is then "not measured".
``--control 1`` also reads the float8 control (``check.py``); benchmark
runs leave it off.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build"
# the program's and the toolchain's caches, at fixed paths inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(BUILD / sub)
os.environ["USE_FLAX"] = "0"
# the package by its name from the checkout's root, and not this folder's
# modules as top-level names
sys.path[:] = [str(ROOT)] + [p for p in sys.path if Path(p or ".").resolve() != ROOT / "portbench"]

import torch  # noqa: E402

from portbench import arch as arch_mod  # noqa: E402
from portbench import cells, check, profiling, program, traffic, weights  # noqa: E402
from portbench.serve import Server  # noqa: E402

#: top-level module names a run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
NOT_MEASURED = "not measured"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def finite(x):
    """A number JSON can hold: an infinite reading as 1e30."""
    return 1e30 if isinstance(x, float) and math.isinf(x) else x


def window_closed(obs, cuda) -> bool:
    """After the window: False (and a message) if a forbidden module was
    loaded; else the device's peak memory read into ``obs``."""
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded in the run: {found}", file=sys.stderr)
        return False
    obs.memory_peak_bytes = torch.cuda.max_memory_allocated() if cuda else 0
    return True


def free_device(cuda) -> None:
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()


def serve_cell(args, a, mix, limits, device, cuda):
    from repro_torch.core.kv_pool import KVPoolConfig
    from repro_torch.serve import engine as engine_mod

    if cuda:
        from repro_torch.kernels import _build
        _build.build(("paged_attention",))
    model = program.model(a)
    params = weights.make(model.param_defs(), std=a.init_std, dtype=model.dtype,
                          vocab_size=a.vocab_size, seed=args.seed, device=device)
    pool = mix["pool"]
    engine = engine_mod.ServeEngine(model, params, KVPoolConfig(
        num_blocks=pool["num_blocks"], block_size=pool["block_size"], kv_heads=a.n_kv_heads,
        head_dim=a.head_dim, n_layers=a.n_layers, max_seqs=mix["slots"],
        max_blocks_per_seq=pool["max_blocks_per_seq"],
        blocks_per_arena=pool["blocks_per_arena"], dtype=a.dtype,
    ), device=device, jit=cuda)
    plan = traffic.plan(mix, args.seed, a.vocab_size)
    server = Server(engine, mix, plan, engine_mod.Request, arch=a, cuda=cuda)
    if args.trace:
        server.instrument(engine_mod)
    server.warm_up()
    obs = server.obs
    obs.setup_s = time.perf_counter() - T_START

    server.window(args.seconds)
    if args.trace:
        obs.profile = server.profile_stretch(mix["trace_steps"])
    server.finish()
    if not window_closed(obs, cuda):
        return None
    obs.engine = engine.metrics()
    sampled = check.sample(obs.records, args.seed, mix["check"]["requests"])
    attempted = sum(r.in_window for r in obs.records)
    failed = sum(r.in_window and r.failed for r in obs.records)
    server.engine = engine = model = None
    free_device(cuda)
    readings = check.compare(params, a, sampled, control=bool(args.control))
    checks = check.verdict(readings, failed, limits)
    if mix["kind"] == "open":
        # how the backlog went: first tokens of the window's first and second halves
        due = sorted((r for r in obs.records if r.in_window), key=lambda r: r.due)
        ttft = [((r.times[0] if r.times else obs.end) - r.due) * 1e3 for r in due]
        half = len(ttft) // 2
        readings.update(queued_at_close=obs.queued_at_close, due=len(ttft),
                        ttft_mean_first_half=sum(ttft[:half]) / max(half, 1),
                        ttft_mean_second_half=sum(ttft[half:]) / max(len(ttft) - half, 1))
    readings.update(preemptions=obs.engine.get("preemptions"))
    return obs, readings, checks, attempted, failed


def train_cell(args, a, mix, limits, device, cuda):
    from portbench import train
    from portbench.reference import train as ref_train

    model = program.model(a, attn_impl=mix["attn_impl"], remat=mix["remat"])
    params = weights.make(model.param_defs(), std=a.init_std, dtype=model.dtype,
                          vocab_size=a.vocab_size, seed=args.seed, device=device)
    job = train.Job(model, params, mix, args.seed, arch=a, device=device, cuda=cuda)
    job.first_steps()
    obs = job.obs
    obs.setup_s = time.perf_counter() - T_START
    job.window(args.seconds)
    if args.trace:
        obs.profile = job.profile_stretch(mix["trace_steps"])
    if not window_closed(obs, cuda):
        return None
    got = job.program
    job = model = params = None
    free_device(cuda)
    # the reference starts again from the harness's weights and batches
    w0 = weights.make(program.model(a).param_defs(), std=a.init_std, dtype=torch_dtype(a),
                      vocab_size=a.vocab_size, seed=args.seed, device=device)
    batches = [train.batch(mix, args.seed, i, a.vocab_size, device)
               for i in range(mix["check_steps"])]
    t0 = time.perf_counter()
    ref = ref_train.steps(w0, a, batches, mix["optimizer"])
    readings = check.train_gaps(got, ref)
    readings["reference_s"] = time.perf_counter() - t0
    readings["loss"] = got["loss"]
    readings["reference_loss"] = ref["loss"]
    if args.control:
        low = ref_train.steps(w0, a, batches, mix["optimizer"], precision="fp8")
        readings["control"] = check.train_gaps(low, ref)
        readings["control_loss"] = low["loss"]
    finite_losses = all(math.isfinite(x) for x in got["loss"])
    # the numbers compared are those the cell's limits name
    checks = {name: {"value": readings[name], "limit": limit} for name, limit in limits.items()}
    checks["non_finite_loss"] = {"value": int(not finite_losses), "limit": 0}
    return obs, readings, checks, obs.steps, 0


def torch_dtype(a):
    return getattr(torch, a.dtype)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = cells.resolve(cells.load_benchmark(), args.workload)
    cuda = not args.smoke
    if cuda and (not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA device(s); {n} available", file=sys.stderr)
        return 2
    device = torch.device("cuda" if cuda else "cpu")

    program.import_port()
    a = arch_mod.load(cell.config_file)
    if args.smoke:
        a = a.smoke()
    mix = traffic.load(cell.traffic_file, smoke=args.smoke)
    limits = cells.limits(cell)
    key = "smoke" if args.smoke else "limit"
    limits = {name: entry[key] for name, entry in limits.items()}
    drive = train_cell if mix["kind"] == "train" else serve_cell
    out = drive(args, a, mix, limits, device, cuda)
    if out is None:
        return 3
    obs, readings, checks, attempted, failed = out

    ctx = types.SimpleNamespace(obs=obs, arch=a, mix=mix)
    wanted = cell.per_layer if args.trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = cells.reader(m["name"])(ctx)
        if value is None:
            continue
        metrics[m["name"]] = {"value": NOT_MEASURED if args.smoke else value, "unit": m["unit"]}
    if cuda:
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
               "memory_peak_bytes": obs.memory_peak_bytes}
    else:
        dev = {"platform": "cpu", "kind": NOT_MEASURED, "count": 0,
               "memory_peak_bytes": NOT_MEASURED}
    result = {"correct": check.correct(checks), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if args.trace and obs.profile is not None:
        prof = obs.profile
        if cuda:
            dev["busy_s"] = prof["busy_s"]
            dev["window_s"] = prof["window_s"]
            result["breakdown"] = profiling.breakdown(prof)
        else:
            dev["busy_s"] = dev["window_s"] = NOT_MEASURED
    info = {k: finite(v) for k, v in readings.items()}
    info.update(window_s=obs.window_s, window_tokens=obs.window_tokens, steps=obs.steps,
                setup_s=obs.setup_s)
    print("run " + json.dumps(info), file=sys.stderr)
    if args.control:
        if mix["kind"] == "train":
            result["control"] = {"program": {k: readings[k] for k in readings["control"]},
                                 "control": readings["control"]}
        else:
            result["control"] = {"logit_gap": finite(readings["logit_gap"]),
                                 "control_gap": finite(readings["control_gap"])}
    result["checks"] = {k: {"value": finite(c["value"]), "limit": c["limit"]}
                        for k, c in checks.items()}
    check.print_checks(checks)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
