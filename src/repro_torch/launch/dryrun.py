"""The multi-pod dry-run over a fake process group (the reference's
``repro/launch/dryrun.py``).

For every (architecture x input-shape x mesh) cell it runs the real step
function once over abstract inputs, proving the sharding config is coherent
at 256/512 ranks, and records memory / cost / collective statistics.  The
reference lowers and compiles against ``ShapeDtypeStruct``s on 512 fake
host devices and reads XLA's analyses; the port runs the step's Python once:

* on meta tensors (``LM.init(device="meta")``, ``input_specs``,
  ``abstract_cache``), so nothing is allocated or computed and no device is
  touched: the dry-run runs the same with or without a card;
* as DTensors placed over the production mesh (``"cuda"`` mesh type, so
  DTensor asks for the collectives it would ask NCCL for);
* on a fake process group of 256 ranks (16x16) or 512 (2x16x16), which
  ``run_cell`` starts in its own process and destroys when it is done.
  Where a group is already started (under ``torchrun``) it raises.

``hlo_stats.OpRecorder`` writes what that pass does on rank 0's local
shards: the ops and their flops, the bytes they read and write, the
collectives DTensor issues, and the peak of live bytes.  The record's keys
are the reference's:

* ``argument_bytes`` / ``output_bytes`` -- local shard bytes of the step's
  arguments and results (the production placements are even, so every rank
  holds the same).  An argument no op reads is left out, as ``jax.jit``
  prunes unused arguments (rwkv6's decode positions); a Python-int cache
  length counts as the reference's int32 scalar.  As XLA counts it, a
  result of several leaves adds the result tuple's table, 8 bytes a leaf.
* ``alias_bytes`` -- the donated arguments: the train step's params and
  optimizer state (``donate=True`` updates them in place), decode's cache
  (written in place).
* ``peak_bytes`` -- the peak of live bytes over the pass, arguments
  included: every storage an op makes lives until Python drops its last
  tensor.  ``temp_bytes`` is that peak less the arguments and the results
  that are not donated arguments, so that ``peak = argument + output +
  temp - alias`` as in the reference.  XLA's buffer assignment reuses and
  schedules buffers across the whole module; the eager count is what the
  caching allocator would hold, without its rounding.
* ``flops``, ``bytes_accessed``, ``fused_bytes``, ``collective_bytes`` and
  ``collectives`` -- ``hlo_stats`` over the op record.

The train cells' params are the port's: in the compute dtype (bf16), with
f32 moments; the reference's are f32 master weights.  Its serving cells
cast f32 leaves to bf16 as the reference's do.

``scan_layers`` is accepted and recorded; the port has no scan, so every
layer is run and counted (the reference's scanned compile counts the body
once).  ``lower_s`` is the time to build the abstract cell, ``compile_s``
the time of the traced pass.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2_vl_72b \\
        --shape train_4k --mesh single --attn chunked
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor

from repro_torch.configs.base import SHAPES, ModelConfig, RunShape
from repro_torch.configs.registry import cells, get_config, lm_archs
from repro_torch.dist import sharding as shd
from repro_torch.launch import hlo_stats
from repro_torch.launch.inputs import abstract_cache, batch_shardings, input_specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.transformer import LM
from repro_torch.optim import adamw as opt_mod
from repro_torch.train.step import build_train_step
from repro_torch.tree import leaves, tree_map

RESULTS_PATH = "experiments/torch_dryrun_results.json"

#: gradient-accumulation microbatching for train cells ("auto"), the
#: reference's table (sized there for a 16 GB chip).
ACCUM_DEFAULTS = {
    "qwen2_vl_72b": 16,
    "granite_34b": 8,
    "mistral_nemo_12b": 4,
    "zamba2_7b": 4,
    "chatglm3_6b": 4,
    "rwkv6_7b": 4,
    "granite_moe_3b_a800m": 4,
    "granite_moe_1b_a400m": 4,
}

#: long-context decode has global_batch=1, so the "data" axis is idle:
#: spread the KV-cache length over BOTH axes.
SHAPE_RULES = {"long_500k": {"kv_seq": ("model", "data")}}

#: decode cells whose bf16 KV cache does not fit even fully sharded: fp8
#: KV pages, computing in bf16 on read.
KV_DTYPE_DEFAULTS = {("qwen2_vl_72b", "decode_32k"): "float8_e4m3fn"}

#: argument positions each mode's step donates (updates in place)
DONATED = {"train": (0, 1), "prefill": (), "decode": (2,)}

#: bytes of an output tuple's table per leaf, as XLA counts its result
_TUPLE_ENTRY_BYTES = 8


def auto_accum(arch: str, shape: RunShape) -> int:
    if shape.mode != "train":
        return 1
    return ACCUM_DEFAULTS.get(arch, 2)


def _batch_shardings(ispecs: Dict, mesh) -> Dict:
    return batch_shardings(ispecs, mesh)


@contextlib.contextmanager
def fake_process_group(world: int):
    """A fake process group of ``world`` ranks in this process, as rank 0;
    destroyed on exit.  Raises where a group is already started."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already started; the dry-run starts its own "
                           "fake one and does not run under torchrun")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _put(tree, shardings):
    """Each tensor of ``tree`` distributed by its ``Sharding``; other leaves
    (a cache's int lengths) as they are."""
    return tree_map(lambda t, s: distribute_tensor(t, s.mesh, s.placements)
                    if isinstance(t, torch.Tensor) else t, tree, shardings)


def build_cell(
    cfg: ModelConfig,
    shape: RunShape,
    mesh,
    *,
    attn_impl: str = "chunked",
    remat: str = "full",
    scan_layers: bool = True,
    rules: Optional[Dict] = None,
    accum_steps: int = 1,
):
    """Returns (step_fn, abstract_args, model) for one cell under ``mesh``
    (meta tensors; DTensors over ``mesh``, plain ones where it is None).
    ``scan_layers`` has no effect: the port has no scan."""
    model = LM(cfg, attn_impl=attn_impl, remat=remat)
    shd.set_mesh(mesh)
    if rules:
        shd.ACT_RULES.update(rules)  # caller restores (see run_cell)

    params = model.init(device="meta")
    if shape.mode != "train":
        # serving checkpoints are bf16 (f32 only in the optimizer state)
        params = tree_map(lambda a: a.to(torch.bfloat16) if a.dtype == torch.float32 else a,
                          params)
    batch = input_specs(cfg, shape)
    if mesh is not None:
        params = _put(params, shd.shardings_for(model.param_specs(), params, mesh))
        batch = _put(batch, _batch_shardings(batch, mesh))

    if shape.mode == "train":
        step = build_train_step(model, opt_mod.AdamWConfig(), accum_steps=accum_steps,
                                donate=True)
        return step, (params, opt_mod.init_opt_state(params), batch), model

    if shape.mode == "prefill":
        return model.prefill_logits, (params, batch), model

    cache = abstract_cache(model, shape)
    if mesh is not None:
        cache = _put(cache, shd.axes_to_shardings(model.cache_spec_axes(), cache, mesh))
    return model.decode_step, (params, batch, cache), model


def _leaf_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return hlo_stats.tensor_bytes(x)
    return 4 if isinstance(x, int) else 0   # an int length: the reference's int32


def _tree_bytes(tree, rec=None) -> int:
    """Local bytes of ``tree``'s leaves; with ``rec``, of those the step
    read (and its int lengths)."""
    return sum(_leaf_bytes(x) for x in leaves(tree)
               if rec is None or not isinstance(x, torch.Tensor) or rec.was_read(x))


def trace_step(fn, args, donated=()) -> Dict[str, Any]:
    """Run ``fn(*args)`` once under an ``OpRecorder``: the dry-run's
    ``per_device`` numbers, its ``collectives``, and the op ``record``."""
    rec = hlo_stats.OpRecorder()
    rec.track(args)
    with torch.no_grad(), rec:
        out = fn(*args)
    arg_b = _tree_bytes(args, rec)
    out_leaves = leaves(out)
    out_b = _tree_bytes(out) + (_TUPLE_ENTRY_BYTES * len(out_leaves)
                                if len(out_leaves) > 1 else 0)
    alias_b = sum(_tree_bytes(args[i], rec) for i in donated)
    temp_b = max(0, rec.peak_bytes - (arg_b + out_b - alias_b))
    colls = hlo_stats.collective_stats(rec.record)
    per_device = {
        "argument_bytes": arg_b,
        "output_bytes": out_b,
        "temp_bytes": temp_b,
        "alias_bytes": alias_b,
        "peak_bytes": arg_b + out_b + temp_b - alias_b,
        "flops": hlo_stats.flops(rec.record),
        "bytes_accessed": hlo_stats.bytes_accessed(rec.record),
        "fused_bytes": hlo_stats.fused_bytes_estimate(rec.record),
        "collective_bytes": sum(v["bytes"] for v in colls.values()),
    }
    return {"per_device": per_device, "collectives": colls, "record": rec.record}


def cell_config(arch: str, shape_name: str, n_layers: Optional[int] = None,
                overrides: Optional[Dict] = None) -> ModelConfig:
    """The config a cell runs: ``arch``'s, cut to ``n_layers`` (the
    encoder's too), with the cell's KV cache dtype and ``overrides``."""
    cfg = get_config(arch)
    over = {}
    if n_layers is not None:
        over["n_layers"] = n_layers
        if cfg.is_encdec:
            over["enc_layers"] = n_layers
    if (arch, shape_name) in KV_DTYPE_DEFAULTS:
        over["kv_cache_dtype"] = KV_DTYPE_DEFAULTS[(arch, shape_name)]
    over.update(overrides or {})
    return dataclasses.replace(cfg, **over) if over else cfg


def unsharded_trace(arch: str, shape_name: str, n_layers: Optional[int] = None) -> Dict[str, Any]:
    """``trace_step`` of the cell's step (no accumulation) on meta tensors
    without a mesh: its flops are what ranks x a sharded step's flops a
    device cover, and exceed by the work the ranks repeat."""
    shape = SHAPES[shape_name]
    fn, args, _ = build_cell(cell_config(arch, shape_name, n_layers), shape, None, accum_steps=1)
    return trace_step(fn, args, DONATED[shape.mode])


def run_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool,
    *,
    attn_impl: str = "chunked",
    remat: str = "full",
    scan_layers: bool = True,
    n_layers: Optional[int] = None,
    rules: Optional[Dict] = None,
    keep_hlo: bool = False,
    accum_steps: Optional[int] = None,
    param_rules: Optional[Dict] = None,
    cfg_overrides: Optional[Dict] = None,
) -> Dict[str, Any]:
    """Trace one cell on a fake process group; return the dry-run record
    (``keep_hlo``: with the op record under ``"op_record"``, there being no
    HLO)."""
    cfg = cell_config(arch, shape_name, n_layers, cfg_overrides)
    shape = SHAPES[shape_name]
    if accum_steps is None:
        accum_steps = auto_accum(arch, shape)
    eff_rules = dict(SHAPE_RULES.get(shape_name, {}))
    eff_rules.update(rules or {})
    eff_param_rules = dict(param_rules or {})

    t0 = time.time()
    with fake_process_group(512 if multi_pod else 256), shd.use_mesh(None), \
            shd.override_rules(**eff_rules), shd.override_param_rules(**eff_param_rules):
        mesh = make_production_mesh(multi_pod=multi_pod)
        fn, args, model = build_cell(
            cfg, shape, mesh,
            attn_impl=attn_impl, remat=remat, scan_layers=scan_layers,
            accum_steps=accum_steps,
        )
        t_lower = time.time() - t0
        t0 = time.time()
        traced = trace_step(fn, args, DONATED[shape.mode])
        t_compile = time.time() - t0
        del fn, args, model

    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": 512 if multi_pod else 256,
        "attn_impl": attn_impl,
        "remat": remat,
        "scan_layers": scan_layers,
        "accum_steps": accum_steps,
        "kv_cache_dtype": cfg.kv_cache_dtype,
        "n_layers": cfg.n_layers,
        "mode": shape.mode,
        "lower_s": round(t_lower, 1),
        "compile_s": round(t_compile, 1),
        "per_device": traced["per_device"],
        "collectives": traced["collectives"],
        "status": "ok",
    }
    if keep_hlo:
        rec["op_record"] = [dataclasses.asdict(e) for e in traced["record"]]
    return rec


def _load(path: str) -> Dict[str, Any]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return {}


def _key(arch, shape, mesh_name, attn):
    return f"{arch}|{shape}|{mesh_name}|{attn}"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--attn", default="chunked", choices=["naive", "chunked"])
    ap.add_argument("--remat", default="full")
    ap.add_argument("--out", default=RESULTS_PATH)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()

    archs = lm_archs() if args.arch == "all" else [args.arch.replace("-", "_")]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = _load(args.out)

    for arch in archs:
        shape_names = (
            list(cells(arch)) if args.shape == "all" else [args.shape]
        )
        for shape_name in shape_names:
            for multi in meshes:
                mesh_name = "2x16x16" if multi else "16x16"
                key = _key(arch, shape_name, mesh_name, args.attn)
                if key in results and results[key].get("status") == "ok" and not args.force:
                    print(f"[skip] {key}")
                    continue
                print(f"[cell] {key} ...", flush=True)
                try:
                    rec = run_cell(
                        arch, shape_name, multi,
                        attn_impl=args.attn, remat=args.remat,
                    )
                except Exception as e:  # noqa: BLE001 — record the failure
                    rec = {
                        "arch": arch, "shape": shape_name, "mesh": mesh_name,
                        "status": "error", "error": f"{type(e).__name__}: {e}",
                        "traceback": traceback.format_exc()[-2000:],
                    }
                    print(f"[FAIL] {key}: {rec['error']}")
                else:
                    pd = rec["per_device"]
                    print(
                        f"[ok]   {key}: compile={rec['compile_s']}s "
                        f"peak={pd['peak_bytes']/2**30:.2f}GiB "
                        f"flops={pd['flops']:.3g} coll={pd['collective_bytes']:.3g}B"
                    )
                results[key] = rec
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
