"""Tracegen-style GEMV/MoE offload model: decode matvecs priced as PUD ops.

The roadmap question this answers: *what fraction of an LLM decode step is
PUD-executable under PUMA placement?*  Following HBM-PIMulator's Tracegen
(Model_GEMV / Mixtral): a decode step is a stream of matrix-vector products
— attention projections, the (routed, for MoE) MLP mats, and the LM head —
and each weight matrix maps onto DRAM banks row by row.  We price every
matvec as one ``mac`` op (:mod:`repro_torch.core.pud`'s MIMDRAM/Proteus-style
arithmetic extension) over two operands:

* the **weight matrix** — ``n_out x d_in`` float32, the data that actually
  lives in DRAM and dominates decode bandwidth;
* a same-size **accumulator array** — MIMDRAM-style in-situ partial-sum
  bit-planes co-located with the weight rows (one partial-sum row per
  weight DRAM row), reduced by the mat peripherals.

A DRAM row of the weight matrix is PUD-executable iff both operands'
regions are contiguous, row-aligned, and share a global subarray — exactly
the paper's criterion, so the four allocator placements reproduce the §1
story at decode-step granularity: ``malloc``/``posix_memalign`` scatter
4 KB pages (0 %), ``hugepage`` co-locates only when two independent huge
pages happen to mirror subarrays (partial), PUMA's ``pim_alloc`` +
``pim_alloc_align`` co-locates by construction (~100 %).  Rows that fail
fall back to the CPU; the adaptive dispatch in ``simulate_op`` keeps the
baseline honest (an allocator with 0 % offload prices at exactly CPU
speed, never slower).

MoE expert dispatch: only the ``experts_per_tok`` routed experts' mats are
priced per token (seeded routing — same seed, same expert stream), after
the router matvec.  All experts' weights stay resident, as on hardware.

``gemv_execute`` is the functional counterpart: it computes ``W @ x`` by
partitioning W's output rows into in-DRAM and CPU-fallback groups per the
same placement plan and dispatching each group as its own ``torch.mv`` —
bit-exact against one whole-matrix ``torch.mv`` (the property test drives
this with integer-valued float32 so accumulation order cannot introduce
ULP noise).  It takes a numpy array (computed on the CPU) or a tensor
(computed on the tensor's device, the card included) and returns the same
kind; the plan and its masks stay host numpy.

``channel_study`` is the per-channel arm: PUMA channel-striped placement
on a multi-channel BANK_REGION map, ops dispatched through a live
:class:`~repro_torch.core.controller.DramController` (with trace emission), so
bank-level parallelism and mode switches show up in the makespan.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.registry import TRACE_ARCHS, get_config
from repro_torch.core import pud
from repro_torch.core.allocators import (
    Allocation,
    HugePageModel,
    MallocModel,
    PhysicalMemory,
    PosixMemalignModel,
)
from repro_torch.core.controller import DramController
from repro_torch.core.dram import AddressMap, BANK_REGION_SCHEME, DramGeometry
from repro_torch.core.puma import PumaAllocator

__all__ = [
    "ALLOCATORS",
    "TRACE_ARCHS",
    "weight_shapes",
    "decode_op_stream",
    "build_placement",
    "offload_report",
    "gemv_execute",
    "channel_study",
]

ITEMSIZE = 4  # float32 — decode weights in the smoke configs
ALLOCATORS: Tuple[str, ...] = ("malloc", "posix_memalign", "hugepage", "puma")


def weight_shapes(cfg) -> Dict[str, Tuple[int, int]]:
    """Every decode-path weight matrix of ``cfg`` as name -> (n_out, d_in).

    Names are stable and ordered (layer-major, module order), so placement
    and op streams derived from them are deterministic.
    """
    shapes: Dict[str, Tuple[int, int]] = {}
    d, H, KV, hd, ff = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff
    for li in range(cfg.n_layers):
        p = f"L{li}"
        shapes[f"{p}/attn/wq"] = (H * hd, d)
        shapes[f"{p}/attn/wk"] = (KV * hd, d)
        shapes[f"{p}/attn/wv"] = (KV * hd, d)
        shapes[f"{p}/attn/wo"] = (d, H * hd)
        if cfg.n_experts:
            shapes[f"{p}/moe/router"] = (cfg.n_experts, d)
            for e in range(cfg.n_experts):
                shapes[f"{p}/moe/e{e}/w_in"] = (ff, d)
                shapes[f"{p}/moe/e{e}/w_gate"] = (ff, d)
                shapes[f"{p}/moe/e{e}/w_out"] = (d, ff)
        elif cfg.activation == "swiglu":
            shapes[f"{p}/mlp/w_in"] = (ff, d)
            shapes[f"{p}/mlp/w_gate"] = (ff, d)
            shapes[f"{p}/mlp/w_out"] = (d, ff)
        else:
            shapes[f"{p}/mlp/w_in"] = (ff, d)
            shapes[f"{p}/mlp/w_out"] = (d, ff)
    shapes["lm_head"] = (cfg.vocab_size, d)
    return shapes


def decode_op_stream(cfg, *, seed: int = 0, n_tokens: int = 2) -> List[str]:
    """The matvec stream of ``n_tokens`` decode steps, as weight names.

    For MoE layers, each token routes to ``experts_per_tok`` experts drawn
    without replacement from a seeded generator (HBM-PIMulator's Mixtral
    trace does the same): the stream is deterministic in ``seed`` but
    different tokens activate different experts.
    """
    rng = np.random.default_rng(seed)
    ops: List[str] = []
    for _t in range(n_tokens):
        for li in range(cfg.n_layers):
            p = f"L{li}"
            ops += [f"{p}/attn/{w}" for w in ("wq", "wk", "wv", "wo")]
            if cfg.n_experts:
                ops.append(f"{p}/moe/router")
                routed = sorted(
                    int(e) for e in rng.choice(
                        cfg.n_experts, size=cfg.experts_per_tok, replace=False
                    )
                )
                for e in routed:
                    ops += [
                        f"{p}/moe/e{e}/{w}"
                        for w in ("w_in", "w_gate", "w_out")
                    ]
            elif cfg.activation == "swiglu":
                ops += [f"{p}/mlp/{w}" for w in ("w_in", "w_gate", "w_out")]
            else:
                ops += [f"{p}/mlp/w_in", f"{p}/mlp/w_out"]
        ops.append("lm_head")
    return ops


def build_placement(
    shapes: Dict[str, Tuple[int, int]],
    allocator: str,
    mem: PhysicalMemory,
    *,
    prealloc_huge: int = 32,
) -> Dict[str, Tuple[Allocation, Allocation]]:
    """Place every weight matrix (and its accumulator) with one allocator.

    malloc / posix_memalign / hugepage allocate weight and accumulator as
    two independent requests — exactly what a library calling the standard
    interfaces gets.  PUMA allocates the weight with ``pim_alloc`` and the
    accumulator with ``pim_alloc_align`` against it, the paper's
    co-location API.
    """
    placement: Dict[str, Tuple[Allocation, Allocation]] = {}
    if allocator == "puma":
        pa = PumaAllocator(mem)
        pa.pim_preallocate(prealloc_huge)
        for name, (n_out, d_in) in shapes.items():
            nbytes = n_out * d_in * ITEMSIZE
            w = pa.pim_alloc(nbytes)
            acc = None if w is None else pa.pim_alloc_align(nbytes, w)
            if w is None or acc is None:
                raise MemoryError(
                    f"PUMA pool exhausted placing {name} "
                    f"({nbytes} bytes; raise prealloc_huge)"
                )
            placement[name] = (w, acc)
        return placement
    mk = {
        "malloc": lambda m: MallocModel(m),
        "posix_memalign": lambda m: PosixMemalignModel(m),
        "hugepage": lambda m: HugePageModel(m, "mmap"),
    }[allocator]
    al = mk(mem)
    for name, (n_out, d_in) in shapes.items():
        nbytes = n_out * d_in * ITEMSIZE
        placement[name] = (al.alloc(nbytes), al.alloc(nbytes))
    return placement


def offload_report(
    arch: str,
    allocator: str,
    *,
    seed: int = 0,
    n_tokens: int = 2,
    model: Optional[pud.PudCostModel] = None,
    recorder=None,
) -> Dict[str, object]:
    """Price ``n_tokens`` decode steps of ``arch`` (smoke config) under one
    allocator placement: PUD-offloaded row fraction + SimCost-style speedup
    of the adaptive PUD dispatch over CPU-only decode.

    Uses the default (cacheline-interleaved, 8 KB-region) address map —
    the same one the §1 fraction study (``benchmarks/alloc_fraction.py``)
    reports on, so the numbers compose with the paper's.
    """
    cfg = get_config(arch).smoke()
    amap = AddressMap()
    mem = PhysicalMemory(amap, seed=seed)
    shapes = weight_shapes(cfg)
    placement = build_placement(shapes, allocator, mem)
    stream = decode_op_stream(cfg, seed=seed, n_tokens=n_tokens)
    mdl = model or pud.PudCostModel()
    rows = rows_pud = 0
    t_ns = t_cpu_ns = 0.0
    for name in stream:
        w, acc = placement[name]
        plan = pud.plan_rows("mac", [w, acc], amap)
        rows += plan.n_rows
        rows_pud += sum(plan.in_pud)
        res = pud.simulate_op(
            "mac", [w, acc], amap, mdl,
            recorder=recorder, label=f"{arch}/{allocator}/{name}",
        )
        t_ns += res.t_ns
        t_cpu_ns += res.t_cpu_ns
    return {
        "arch": arch,
        "allocator": allocator,
        "n_tokens": n_tokens,
        "n_weights": len(shapes),
        "n_ops": len(stream),
        "moe": cfg.n_experts > 0,
        "experts_per_tok": cfg.experts_per_tok,
        "rows": rows,
        "rows_pud": rows_pud,
        "offload_fraction": round(rows_pud / rows, 6) if rows else 0.0,
        "decode_ns": round(t_ns, 3),
        "decode_cpu_ns": round(t_cpu_ns, 3),
        "speedup_vs_cpu": round(t_cpu_ns / t_ns, 4) if t_ns else 1.0,
    }


def gemv_execute(
    w,
    x,
    w_alloc: Allocation,
    acc_alloc: Allocation,
    amap: AddressMap,
):
    """Compute ``y = W @ x`` dispatching W's rows per the placement plan.

    Output rows whose DRAM row is PUD-executable compute as one group (the
    in-DRAM mac), the rest as another (CPU fallback) — scattered back into
    one result.  Both groups use ``torch.mv``, so the test invariant is that
    *partitioned* dispatch is bit-exact against the whole-matrix product.
    A W row is attributed to the DRAM row holding its first byte (W rows
    divide the 8 KB region evenly for every power-of-two ``d_in`` here).

    ``w`` and ``x`` are numpy arrays (the result is a numpy array) or
    tensors on one device (the result is a tensor there); the row groups'
    index tensors are built on that device once per call.
    """
    as_numpy = isinstance(w, np.ndarray)
    wt = torch.from_numpy(np.ascontiguousarray(w)) if as_numpy else w
    xt = torch.as_tensor(np.asarray(x) if as_numpy else x, device=wt.device)
    n_out, d_in = wt.shape
    plan = pud.plan_rows("mac", [w_alloc, acc_alloc], amap)
    y = torch.zeros((n_out,), dtype=wt.dtype, device=wt.device)
    if plan.n_rows:
        mask = np.asarray(plan.in_pud, dtype=bool)
        bytes_per_wrow = d_in * wt.element_size()
        dram_row = (np.arange(n_out, dtype=np.int64) * bytes_per_wrow
                    ) // amap.region_bytes
        dram_row = np.minimum(dram_row, plan.n_rows - 1)
        wmask = mask[dram_row]
        for m in (wmask, ~wmask):
            idx = np.flatnonzero(m)
            if idx.size:
                it = torch.from_numpy(idx).to(wt.device)
                y[it] = torch.mv(wt[it], xt)
    return y.numpy() if as_numpy else y


def channel_study(
    arch: str,
    *,
    channels: int = 4,
    seed: int = 0,
    n_tokens: int = 1,
    model: Optional[pud.PudCostModel] = None,
    recorder=None,
) -> Dict[str, object]:
    """Per-channel arm: PUMA channel-striped weights on a ``channels``-wide
    BANK_REGION map, the mac stream dispatched through a live
    :class:`~repro_torch.core.controller.DramController` (trace-recorded when a
    ``recorder`` is passed).  Reports the makespan, per-channel balance,
    and the parallel gain over a serial single-channel burst.
    """
    cfg = get_config(arch).smoke()
    amap = AddressMap(
        DramGeometry(channels=channels, subarrays_per_bank=128),
        BANK_REGION_SCHEME,
    )
    mem = PhysicalMemory(amap, seed=seed, n_huge_pages=128, huge_scatter=1.0)
    pa = PumaAllocator(mem, amap, stripe_channels=True)
    pa.pim_preallocate(64)
    placement: Dict[str, Tuple[Allocation, Allocation]] = {}
    for name, (n_out, d_in) in weight_shapes(cfg).items():
        nbytes = n_out * d_in * ITEMSIZE
        w = pa.pim_alloc(nbytes)
        acc = None if w is None else pa.pim_alloc_align(nbytes, w)
        if w is None or acc is None:
            raise MemoryError(f"PUMA channel pool exhausted placing {name}")
        placement[name] = (w, acc)
    mdl = model or pud.PudCostModel()
    dram = DramController(amap, recorder=recorder)
    rows = rows_pud = 0
    for name in decode_op_stream(cfg, seed=seed, n_tokens=n_tokens):
        w, acc = placement[name]
        plan = pud.plan_rows("mac", [w, acc], amap)
        rows += plan.n_rows
        rows_pud += sum(plan.in_pud)
        pud.simulate_op(
            "mac", [w, acc], amap, mdl, controller=dram,
            recorder=recorder, label=f"{arch}/puma/{name}",
        )
    rep = dram.occupancy_report()
    dispatched = int(sum(rep["pud_rows"]))
    serial_ns = dispatched * mdl.pud_row_ns("mac")
    makespan = float(rep["makespan_ns"])
    return {
        "arch": arch,
        "channels": channels,
        "rows": rows,
        "rows_pud": rows_pud,
        "rows_dispatched": dispatched,
        "offload_fraction": round(rows_pud / rows, 6) if rows else 0.0,
        "makespan_ns": round(makespan, 3),
        "serial_ns": round(serial_ns, 3),
        "parallel_speedup": (
            round(serial_ns / makespan, 4) if makespan else 1.0
        ),
        "balance": round(float(rep["pud_row_balance"]), 4),
        "mode_switches": rep["mode_switches"],
    }
