"""The port's compile-only dry-run (``repro_torch.launch.dryrun`` and
``hlo_stats``) against the reference's ``launch/dryrun.py``.

The reference's records come from one process of its own
(``tests/ref_launch_records.py``, ``JAX_PLATFORMS=cpu``, its own
``XLA_FLAGS``, 180 s), over the cells of ``CELLS``: every family and every
mode once, at 1 layer, zamba2 at ``attn_every`` and ``attn_every + 1``.
zamba2 is taken at decode_32k: its prefill_32k trace on the port runs its
Mamba2 chunk loop as ~10^5 DTensor ops and takes ~105 s a cell here.

On the port's side the same cells run on a fake 256-rank process group.
Held equal to the reference's, with the differences each test names:
argument, output and alias bytes.  Held to a band measured here: flops
and peak per device over the reference's (``BANDS``, ``PEAK_BANDS``, with
the reason for each), and the work the sharded step repeats, 256 x its
flops per device over those of the step without a mesh (``REPEATED``).
Recorded, not held
equal: the collectives' kinds and counts (XLA's partitioner and DTensor's
redistributions differ; PERF.md has them side by side).

Then ``hlo_stats`` per device on a fake 2 x 4 mesh (a sharded matmul's
local flops, one all-gather's bytes, the counts of ``CommDebugMode`` over a
smoke MoE train step), ``fused_bytes_estimate``'s rules on hand-built
records (the counterpart of ``tests/test_hlo_stats.py``'s snippet),
``LM.init(device="meta")`` for every family, and the CLI on both meshes.
Each fake process group is started and destroyed inside its test.
"""
import json
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from ref_launch_records import CELLS, key, run_reference  # noqa: E402
from repro_torch.configs.base import SHAPES, RunShape  # noqa: E402
from repro_torch.configs.registry import get_config, lm_archs  # noqa: E402
from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.launch import dryrun, hlo_stats  # noqa: E402
from repro_torch.launch.hlo_stats import OpEntry  # noqa: E402
from repro_torch.launch.mesh import make_smoke_mesh  # noqa: E402
from repro_torch.models.transformer import LM  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
RANKS = 256
SIZES = {"data": 16, "model": 16}

#: port flops / reference flops per cell, (low, high), measured on this
#: tree (PERF.md §6, the dry-run table), with the reason the two counts differ.
#: * prefill 3.36: the reference's chunked attention is a lax.scan over
#:   64 KV chunks whose body XLA counts once; the port counts every chunk.
#: * train 0.92-1.08: the same scan, over the 8 KV chunks of 4096 tokens,
#:   against the elementwise ops XLA counts and the port does not; seamless
#:   counts its encoder's and its cross-attention's chunks too.  Each piece
#:   of work is done once across the ranks: the loss and the head product
#:   vocab-parallel (port fault F6), attention split by query heads
#:   (granite_moe's 16 on 8 KV heads, F7), every attention projection's
#:   columns split over "model" (granite_moe's K/V, F11; seamless's
#:   encoder K/V, F13).
#: * decode 0.63-0.87: the port counts products only, XLA its elementwise
#:   ops too.  Each piece of work is done once across the ranks: rwkv6's
#:   channel-mix receptance, whose "embed_tp" columns no axis splits, was
#:   done whole on every "model" rank (port fault F9, 1.32 before), and so
#:   were the recent ring's attention (F10) and qwen2_vl's K/V projection
#:   (F11), zamba2's B, C and dt projections (F12).
BANDS = {
    "stablelm_1_6b|train_4k|1": (1.0, 1.1),
    "stablelm_1_6b|prefill_32k|1": (3.2, 3.5),
    "stablelm_1_6b|decode_32k|1": (0.65, 0.70),
    "granite_moe_1b_a400m|train_4k|1": (0.88, 0.96),
    "rwkv6_7b|decode_32k|1": (0.84, 0.90),
    "zamba2_7b|decode_32k|6": (0.62, 0.68),
    "zamba2_7b|decode_32k|7": (0.60, 0.67),
    "qwen2_vl_72b|decode_32k|1": (0.61, 0.66),
    "seamless_m4t_medium|train_4k|1": (1.04, 1.12),
}

#: port peak / reference peak per device, (low, high), measured on this
#: tree with the storages live at each peak
#: (``scripts/dryrun_vs_reference.py --peak-detail``), each band the
#: measured ratio -5 % / +5 %.  XLA reuses and schedules buffers across the
#: module; the eager step holds each storage until Python drops it.  Since
#: the norm and the vocab-parallel loss keep only what their backward needs
#: and work a chunk of rows at a time in f32 (port faults P1, P2), no f32
#: activation-sized norm or logits buffer is live at any peak: stablelm
#: train peaks over 1 (1.08) in the chunked attention's backward, its f32
#: (16, 2, 1, 4096, 512) scores and their exp, 0.27 GB each, beside bf16
#: activations; prefill (0.85) on bf16 (2, 32768, 2048) activations;
#: seamless train (0.52) on bf16 activations and the attention's scores;
#: granite_moe train (0.74) on the MoE's dispatch buffers of 1.3 GB; the
#: decode cells on an f32 copy of the rank's KV cache shard or one
#: FSDP-gathered weight, no table-sized buffer (port fault F8).  Before P1
#: and P2: stablelm train 1.55 and prefill 1.21 (the norms' f32 copies of
#: their input, 0.54 GB each), seamless train 1.16 (the loss's four f32
#: (16, 4096, 16128) buffers, 4.2 GB each), granite_moe 0.82.
PEAK_BANDS = {
    "stablelm_1_6b|train_4k|1": (1.03, 1.14),
    "stablelm_1_6b|prefill_32k|1": (0.81, 0.89),
    "stablelm_1_6b|decode_32k|1": (0.78, 0.87),
    "granite_moe_1b_a400m|train_4k|1": (0.71, 0.78),
    "rwkv6_7b|decode_32k|1": (0.72, 0.80),
    "zamba2_7b|decode_32k|6": (0.68, 0.76),
    "zamba2_7b|decode_32k|7": (0.67, 0.75),
    "qwen2_vl_72b|decode_32k|1": (0.43, 0.48),
    "seamless_m4t_medium|train_4k|1": (0.50, 0.55),
}

#: the most work the sharded step may repeat: 256 x the port's per-device
#: flops over the flops of the same step without a mesh, each cell's
#: measured ratio and at most 0.02 over (``scripts/dryrun_vs_reference.py
#: --repeated-detail`` names each product behind a ratio over 1).  Every
#: cell measures 1.0000 but granite_moe's 1.0088: its router product and
#: gate combine run on every "model" rank, as the experts' partial sums
#: over their split width need the same tokens there (ROADMAP.md).
#: Before the repairs of port faults F9-F13: granite_moe 1.07, seamless
#: 1.09, decode 1.04 (stablelm), 1.52 (rwkv6), 1.03 / 1.04 (zamba2), 1.12
#: (qwen2_vl); before F6-F8's, the train cells 8.03 / 3.07 / 9.00.
REPEATED = {
    "stablelm_1_6b|train_4k|1": 1.02,
    "stablelm_1_6b|prefill_32k|1": 1.02,
    "stablelm_1_6b|decode_32k|1": 1.02,
    "granite_moe_1b_a400m|train_4k|1": 1.02,
    "rwkv6_7b|decode_32k|1": 1.02,
    "zamba2_7b|decode_32k|6": 1.02,
    "zamba2_7b|decode_32k|7": 1.02,
    "qwen2_vl_72b|decode_32k|1": 1.02,
    "seamless_m4t_medium|train_4k|1": 1.02,
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several test processes at once; one torch thread per
    process keeps them from contending for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference("dryrun", tmp_path_factory.mktemp("ref_dryrun"))


@pytest.fixture(scope="module")
def port():
    return {key(a, s, n): dryrun.run_cell(a, s, False, n_layers=n, scan_layers=False,
                                          accum_steps=1)
            for a, s, n in CELLS}


class _Mesh:
    """The production single-pod mesh's axes, for ``shardings_for``."""
    shape = SIZES
    axis_names = tuple(SIZES)


def _bf16_param_bytes(cfg) -> int:
    """Local bytes of the port's bf16 params on the 16 x 16 mesh: the
    reference trains f32 master weights, twice these."""
    model = LM(cfg)
    params = model.init(device="meta")
    shard = leaves(shd.shardings_for(model.param_specs(), params, _Mesh()))
    total = 0
    for p, s in zip(leaves(params), shard):
        if p.dtype == torch.bfloat16:
            n = p.numel()
            for e in s.spec:
                for a in (e if isinstance(e, tuple) else (e,) if e else ()):
                    n //= SIZES[a]
            total += n * p.element_size()
    return total


def _ring_bytes(cfg, shape) -> int:
    """Local bytes of the decode cache's recent rings (K and V), whose heads
    the port leaves whole, as the reference's input does."""
    model = LM(cfg)
    cache = model.init_cache(shape.global_batch, shape.seq_len, device="meta")
    layers = cache["layers"]
    node = layers.get("attn", layers) if isinstance(layers, dict) else {}
    return sum(t.numel() * t.element_size() // SIZES["data"] for t in node.get("recent", ()))


@pytest.mark.parametrize("cell", [key(*c) for c in CELLS])
def test_memory_bytes_equal_the_reference(cell, ref, port):
    """argument, output and alias bytes per device equal the reference's,
    but for two differences that follow from the port's design:
    * train: the port's params are bf16 with f32 moments, the reference's
      f32 master weights (twice the bytes) -- in the arguments, the results
      and the donated buffers alike;
    * decode: the port writes the recent ring in place, keeping its
      placement (heads whole); XLA lays the ring it returns out with its
      heads over "model" where they divide by 16, so that result is 1/16
      the size and cannot alias its donated input."""
    arch, shape_name, n = cell.split("|")
    cfg, shape = dryrun.cell_config(arch, shape_name, int(n)), SHAPES[shape_name]
    mine, theirs = port[cell]["per_device"], ref[cell]["per_device"]
    arg, out, alias = mine["argument_bytes"], mine["output_bytes"], mine["alias_bytes"]
    if shape.mode == "train":
        p = _bf16_param_bytes(cfg)
        arg, out, alias = arg + p, out + p, alias + p
    if shape.mode == "decode" and cfg.n_kv_heads % SIZES["model"] == 0:
        ring = _ring_bytes(cfg, shape)
        out -= ring - ring // SIZES["model"]
        alias -= ring
    assert (arg, out, alias) == (theirs["argument_bytes"], theirs["output_bytes"],
                                 theirs["alias_bytes"])
    assert port[cell]["status"] == "ok"
    assert set(port[cell]["collectives"]) == set(hlo_stats.COLLECTIVES)
    assert mine["peak_bytes"] == (mine["argument_bytes"] + mine["output_bytes"]
                                  + mine["temp_bytes"] - mine["alias_bytes"])


def test_chip_smoke_cells_carry_the_cpu_argument_bytes(port, ref):
    """``chip_smoke.py``'s phase ``[roofline]`` holds each production cell
    on the card to the argument bytes this CPU run gives, and its flops and
    peak to the reference's on the CPU (``ROOFLINE_REF``), within bounds
    that this CPU run meets."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for arch, shape, arg_bytes in smoke.ROOFLINE_CELLS:
        mine, theirs = port[key(arch, shape, 1)], ref[key(arch, shape, 1)]["per_device"]
        assert mine["per_device"]["argument_bytes"] == arg_bytes
        assert smoke.ROOFLINE_REF[(arch, shape)] == (theirs["flops"], theirs["peak_bytes"])
        assert mine["per_device"]["flops"] / theirs["flops"] <= smoke.ROOFLINE_MAX_FLOPS
        assert (mine["per_device"]["peak_bytes"] / theirs["peak_bytes"]
                <= smoke.ROOFLINE_MAX_PEAK[mine["mode"]])


@pytest.mark.parametrize("arch", ["stablelm_1_6b", "granite_moe_1b_a400m"])
def test_accumulated_train_cell_splits_the_peak_not_the_flops(arch, port):
    """``chip_smoke.py``'s train cells at their own accumulation
    (``auto_accum``: 2 and 4 microbatches through ``build_train_step``'s
    loop under the production mesh, the vocab-parallel loss inside it):
    status ok, the argument bytes and flops of the step without
    accumulation, and a peak at most 1.1 x that step's share of a
    microbatch (stablelm 1.045, granite_moe 1.057 measured)."""
    one = port[key(arch, "train_4k", 1)]["per_device"]
    rec = dryrun.run_cell(arch, "train_4k", False, n_layers=1, scan_layers=False)
    n, mine = rec["accum_steps"], rec["per_device"]
    assert n == dryrun.auto_accum(arch, SHAPES["train_4k"]) > 1
    assert rec["status"] == "ok"
    assert mine["argument_bytes"] == one["argument_bytes"]
    assert mine["flops"] == one["flops"]
    assert mine["peak_bytes"] <= 1.1 * one["peak_bytes"] / n


@pytest.mark.parametrize("cell", [key(*c) for c in CELLS])
def test_flops_within_the_stated_band(cell, ref, port):
    lo, hi = BANDS[cell]
    ratio = port[cell]["per_device"]["flops"] / ref[cell]["per_device"]["flops"]
    assert lo <= ratio <= hi, ratio


@pytest.mark.parametrize("cell", [key(*c) for c in CELLS])
def test_peak_within_the_stated_band(cell, ref, port):
    lo, hi = PEAK_BANDS[cell]
    ratio = port[cell]["per_device"]["peak_bytes"] / ref[cell]["per_device"]["peak_bytes"]
    assert lo <= ratio <= hi, ratio


@pytest.mark.parametrize("cell", [key(*c) for c in CELLS])
def test_flops_over_the_ranks_cover_the_unsharded_step(cell, port):
    """Per-device flops are counted on local shards, replicated work on
    every rank: over 256 ranks they are at least the unsharded step's, and
    at most ``REPEATED`` times it."""
    arch, shape_name, n = cell.split("|")
    whole = dryrun.unsharded_trace(arch, shape_name, int(n))["per_device"]["flops"]
    assert whole > 0
    assert whole <= port[cell]["per_device"]["flops"] * RANKS <= REPEATED[cell] * whole


# -- hlo_stats per device on a fake 2 x 4 mesh ------------------------------------------

def _on_mesh(fn):
    with dryrun.fake_process_group(8), shd.use_mesh(None):
        return fn(make_smoke_mesh(2, 4))


def test_sharded_matmul_records_the_local_flops():
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    m, k, n = 64, 256, 96

    def run(mesh):
        x = distribute_tensor(torch.empty(m, k, device="meta"), mesh, [Shard(0), Replicate()])
        w = distribute_tensor(torch.empty(k, n, device="meta"), mesh,
                              [Replicate(), Replicate()])
        rec = hlo_stats.OpRecorder()
        with rec:
            y = x @ w
        return rec.record, y

    record, y = _on_mesh(run)
    assert tuple(y.shape) == (m, n)
    assert hlo_stats.flops(record) == 2 * (m // 2) * n * k
    assert hlo_stats.op_census(record)["mm"] == 1
    assert hlo_stats.total_collective_bytes(record) == 0


def test_redistribute_records_one_all_gather():
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    def run(mesh):
        x = distribute_tensor(torch.empty(256, 4096, dtype=torch.bfloat16, device="meta"),
                              mesh, [Shard(0), Replicate()])
        rec = hlo_stats.OpRecorder()
        with rec:
            x.redistribute(mesh, [Replicate(), Replicate()])
        return rec.record

    st = hlo_stats.collective_stats(_on_mesh(run))
    assert st["all-gather"] == {"count": 1, "bytes": 256 * 4096 * 2}
    assert sum(v["count"] for v in st.values()) == 1


def test_collective_counts_equal_comm_debug_mode():
    """One train step of the smoke granite_moe_1b_a400m (the sharded MoE
    path) on a 2 x 4 mesh: the record's counts by kind are
    ``CommDebugMode``'s."""
    from torch.distributed.tensor.debug import CommDebugMode

    cfg = get_config("granite_moe_1b_a400m").smoke()

    def run(mesh):
        fn, args, _ = dryrun.build_cell(cfg, RunShape("t", 32, 4, "train"), mesh,
                                        accum_steps=1)
        rec = hlo_stats.OpRecorder()
        with torch.no_grad(), CommDebugMode() as comm, rec:
            fn(*args)
        return rec.record, comm.get_comm_counts()

    record, counts = _on_mesh(run)
    theirs = {k: 0 for k in hlo_stats.COLLECTIVES}
    for op, c in counts.items():
        theirs[OpEntry(f"{op}.default", ()).collective] += c
    mine = {k: v["count"] for k, v in hlo_stats.collective_stats(record).items()}
    assert mine == theirs and mine["all-gather"] > 0 and mine["reduce-scatter"] > 0


def test_a_started_group_is_refused():
    with dryrun.fake_process_group(8):
        with pytest.raises(RuntimeError, match="already started"):
            dryrun.run_cell("stablelm_1_6b", "decode_32k", False, n_layers=1)
    assert not torch.distributed.is_initialized()


# -- fused_bytes_estimate's rules -------------------------------------------------------

def _e(op, result, *operands, transposes=False):
    return OpEntry(op, tuple(result), tuple(operands), transposes=transposes)


F32 = "float32"
A = ((128, 256), F32)     # 131072 bytes
B = ((256, 64), F32)      # 65536
C = ((128, 64), F32)      # 32768
IDX = ((128,), "int64")   # 1024


@pytest.mark.parametrize("entry, fused", [
    (_e("aten.mm.default", [C], A, B), 32768 + 131072 + 65536),          # product
    (_e("repro.kernel.default", [C], A), 32768 + 131072),                # custom kernel
    (_e("aten.cat.default", [((256, 256), F32)], A, A), 262144 + 2 * 131072),  # concatenation
    (_e("aten.sort.default", [A, ((128, 256), "int64")], A), 131072 * 2 + 262144),
    (_e("aten.clone.default", [A], A, transposes=True), 2 * 131072),     # transpose copy
    (_e("aten.clone.default", [A], A), 0),                               # plain copy
    (_e("aten.copy_.default", [A], A, A), 0),
    (_e("aten.index_select.default", [C], ((512, 64), F32), IDX), 2 * 32768 + 1024),
    (_e("aten.index_put_.default", [((512, 64), F32)], ((512, 64), F32), IDX, C),
     2 * 32768 + 1024),                                                  # scatter
    (_e("aten.sum.dim_IntList", [((128,), F32)], A), 512 + 131072),      # reduction
    (_e("aten.mul.Tensor", [A], A, A), 0),                               # elementwise
    (_e("aten.max.other", [A], A, A), 0),
    (_e("_c10d_functional.all_reduce.default", [A], A), 0),              # collective
])
def test_fused_bytes_rules(entry, fused):
    assert hlo_stats.fused_bytes_estimate([entry]) == fused


def test_record_statistics_on_a_hand_built_record():
    rec = [
        _e("_c10d_functional.all_gather_into_tensor.default", [((128, 256), F32)],
           ((8, 256), F32)),
        _e("_c10d_functional.all_reduce.default", [((64,), "bfloat16")], ((64,), "bfloat16")),
        _e("_c10d_functional.reduce_scatter_tensor.default", [((4,), F32)], ((64,), F32)),
        _e("_dtensor.shard_dim_alltoall.default", [((16, 2), F32)], ((16, 2), F32)),
        _e("aten.mm.default", [C], A, B),
        _e("aten.mul.Tensor", [C], C, C),
    ]
    st = hlo_stats.collective_stats(rec)
    assert st["all-gather"] == {"count": 1, "bytes": 128 * 256 * 4}
    assert st["all-reduce"] == {"count": 1, "bytes": 128}
    assert st["reduce-scatter"] == {"count": 1, "bytes": 16}
    assert st["all-to-all"] == {"count": 1, "bytes": 128}
    assert hlo_stats.total_collective_bytes(rec) == 128 * 256 * 4 + 128 + 16 + 128
    assert hlo_stats.bytes_accessed(rec) == 3 * 32768 + 131072 + 65536 + 32768
    with pytest.raises(ValueError, match="no counterpart"):
        hlo_stats.collective_stats([_e("_c10d_functional.broadcast.default", [A], A)])


def _mm(a, b, site, op="aten.mm.default"):
    """A product's entry: operand shapes a @ b (the last two dims), at ``site``."""
    out = a[:-1] + b[-1:]
    n = 2 * a[-1]
    for d in out:
        n *= d
    return OpEntry(op, ((out, F32),), ((a, F32), (b, F32)), n, site=site)


def test_repeated_products_match_each_product_by_its_lines():
    """``repeated_products`` on hand-built records of 16 ranks: a product
    each rank does a 16th of (x1) and one every rank does whole (x16); two
    products of the same shapes told apart by the line that reaches them
    (the ring's segment and the main one); a product the sharded step
    reaches through a ``shard_map`` of its own; and one line whose product
    DTensor runs as ``bmm`` in one layer, ``mm`` in another (its line x1)."""
    split, whole_ring = "models/t.py:1 > models/a.py:5", "models/t.py:1 > models/a.py:9"
    whole = [_mm((64, 32), (32, 16), "models/t.py:1 > models/a.py:2"),
             _mm((64, 32), (32, 16), split), _mm((64, 32), (32, 16), whole_ring),
             _mm((64, 32), (32, 64), "models/t.py:3"), _mm((64, 32), (32, 64), "models/t.py:3")]
    mine = [_mm((4, 32), (32, 16), "models/t.py:1 > models/a.py:2"),
            _mm((64, 32), (32, 16), split),
            _mm((64, 32), (32, 1), whole_ring + " > models/s.py:7 > models/s.py:8"),
            _mm((1, 4, 32), (1, 32, 64), "models/t.py:3", "aten.bmm.default"),
            _mm((4, 32), (32, 64), "models/t.py:3")]
    rows = hlo_stats.repeated_products(mine, whole, 16, 10)
    got = {(r["site"], r["op"]): r for r in rows}
    assert got[("models/t.py:1 > models/a.py:2", "aten.mm.default")]["ratio"] == 1
    assert got[(split, "aten.mm.default")]["ratio"] == 16
    ring = got[(whole_ring + " > models/s.py:7 > models/s.py:8", "aten.mm.default")]
    assert ring["whole_site"] == whole_ring and ring["ratio"] == 1
    both = [r for r in rows if r["site"] == "models/t.py:3"]
    assert [r["site_ratio"] for r in both] == [1, 1] and sorted(r["ratio"] for r in both) == [
        0.5, 0.5]
    assert [r["ranks_flops"] for r in rows] == sorted((r["ranks_flops"] for r in rows),
                                                      reverse=True)
    assert len(hlo_stats.repeated_products(mine, whole, 16, 2)) == 2


def test_product_sites_name_the_forward_line_of_a_backward_product():
    """Within ``product_sites()`` a product is put down to its lines of
    model code; its gradient's products to the same lines and "(grad)"."""
    from repro_torch.models import layers

    x = torch.empty(8, 16, device="meta", requires_grad=True)
    w = torch.empty(16, 4, device="meta", requires_grad=True)
    rec = hlo_stats.OpRecorder()
    with hlo_stats.product_sites(), rec:
        y = layers.column_parallel(x, w)
        torch.autograd.grad(y.sum(), (x, w))
    sites = [e.site for e in rec.record if e.flops]
    line = sites[0]
    assert line.startswith("models/layers.py:") and len(sites) == 3
    assert sites[1:] == [line + " (grad)"] * 2
    rec = hlo_stats.OpRecorder()
    with rec:
        layers.column_parallel(x, w)
    assert [e.site for e in rec.record if e.flops] == [""]


# -- abstract params, the CLI ---------------------------------------------------------------

@pytest.mark.parametrize("arch", lm_archs())
def test_meta_init_gives_the_shapes_and_dtypes_of_an_init(arch):
    model = LM(get_config(arch).smoke())
    meta, real = leaves(model.init(device="meta")), leaves(model.init(0, device="cpu"))
    assert [(t.shape, t.dtype, t.device.type) for t in meta] == [
        (t.shape, t.dtype, "meta") for t in real]


def test_cli_writes_both_meshes(tmp_path):
    out = tmp_path / "dryrun.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "stablelm_1_6b",
         "--shape", "decode_32k", "--mesh", "both", "--out", str(out)],
        capture_output=True, text=True, timeout=240, cwd=str(tmp_path),
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(out.read_text())
    assert sorted(res) == ["stablelm_1_6b|decode_32k|16x16|chunked",
                           "stablelm_1_6b|decode_32k|2x16x16|chunked"]
    for rec in res.values():
        assert rec["status"] == "ok" and rec["n_layers"] == 24
    assert res["stablelm_1_6b|decode_32k|2x16x16|chunked"]["chips"] == 512
