"""The port's GEMV/MoE offload model (``repro_torch.trace.gemv``) against the
reference's ``repro.trace.gemv`` on the CPU: the weight shapes, the seeded
decode op streams (MoE routing included), every allocator's placement and
priced report, the per-channel arm, the partitioned product's bit-exactness
under every placement, the paper-story assertions, and the replay of its
PUD op trace through the port's ``replay_trace``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as ref_get_config  # noqa: E402
from repro.core import pud as ref_pud  # noqa: E402
from repro.core.allocators import PhysicalMemory as RefPhysicalMemory  # noqa: E402
from repro.core.dram import AddressMap as RefAddressMap  # noqa: E402
from repro.trace import gemv as ref_gemv  # noqa: E402
from repro_torch.configs.registry import get_config, moe_archs  # noqa: E402
from repro_torch.core import pud  # noqa: E402
from repro_torch.core.allocators import HUGE_PAGE, PhysicalMemory  # noqa: E402
from repro_torch.core.dram import AddressMap  # noqa: E402
from repro_torch.trace import gemv, parse_trace, replay_trace  # noqa: E402
from repro_torch.trace.record import TraceRecorder  # noqa: E402

ARCHS = list(gemv.TRACE_ARCHS)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several test processes at once; one torch thread per
    process keeps them from contending for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_module_is_exported_and_names_the_reference_sets():
    import repro_torch.trace as trace

    assert trace.gemv is gemv and "gemv" in trace.__all__
    assert gemv.ALLOCATORS == ref_gemv.ALLOCATORS
    assert tuple(gemv.TRACE_ARCHS) == tuple(ref_gemv.TRACE_ARCHS) and len(ARCHS) >= 3


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_weight_shapes_equal_reference(arch, full):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    if not full:
        cfg, ref_cfg = cfg.smoke(), ref_cfg.smoke()
    ours, theirs = gemv.weight_shapes(cfg), ref_gemv.weight_shapes(ref_cfg)
    assert list(ours.items()) == list(theirs.items())


@pytest.mark.parametrize("seed", [0, 11, 12])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_op_stream_equals_reference(arch, seed):
    """The seeded expert routing (``default_rng(seed)``, ``choice`` without
    replacement, sorted) draws the reference's experts for every token."""
    cfg, ref_cfg = get_config(arch).smoke(), ref_get_config(arch).smoke()
    for n_tokens in (1, 3):
        assert (gemv.decode_op_stream(cfg, seed=seed, n_tokens=n_tokens)
                == ref_gemv.decode_op_stream(ref_cfg, seed=seed, n_tokens=n_tokens))


@pytest.mark.parametrize("allocator", gemv.ALLOCATORS)
@pytest.mark.parametrize("arch", ARCHS)
def test_offload_report_equals_reference(arch, allocator):
    for kw in ({}, {"seed": 5, "n_tokens": 1}):
        assert gemv.offload_report(arch, allocator, **kw) == ref_gemv.offload_report(
            arch, allocator, **kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_channel_study_equals_reference(arch):
    assert gemv.channel_study(arch) == ref_gemv.channel_study(arch)
    assert gemv.channel_study(arch, channels=2, n_tokens=2) == ref_gemv.channel_study(
        arch, channels=2, n_tokens=2)


def test_full_width_layer0_placement_equals_reference():
    """stablelm_1_6b's full-width layer 0 (the shapes ``chip_smoke.py``'s
    ``[gemv]`` phase places), PUMA's pool holding the weights and their
    accumulators: every allocator's in-PUD rows equal the reference's.  PUMA
    offloads few of them: each matrix spans more than one 1024-region
    subarray, and worst-fit drains every subarray it takes for the weight,
    leaving its accumulator no same-subarray room."""
    shapes = {n: s for n, s in gemv.weight_shapes(get_config("stablelm_1_6b")).items()
              if n.startswith("L0/")}
    n_huge = -(-sum(2 * o * i * gemv.ITEMSIZE for o, i in shapes.values()) // HUGE_PAGE)
    shares = {}
    for al in gemv.ALLOCATORS:
        amap, ref_amap = AddressMap(), RefAddressMap()
        ours = gemv.build_placement(shapes, al, PhysicalMemory(amap, seed=3),
                                    prealloc_huge=n_huge)
        theirs = ref_gemv.build_placement(shapes, al, RefPhysicalMemory(ref_amap, seed=3),
                                          prealloc_huge=n_huge)
        rows = rows_pud = 0
        for name in shapes:
            plan = pud.plan_rows("mac", list(ours[name]), amap)
            ref_plan = ref_pud.plan_rows("mac", list(theirs[name]), ref_amap)
            assert list(plan.in_pud) == list(ref_plan.in_pud), (al, name)
            rows, rows_pud = rows + plan.n_rows, rows_pud + sum(plan.in_pud)
        shares[al] = rows_pud / rows
    assert shares["malloc"] == shares["posix_memalign"] == 0.0
    assert 0.0 < shares["hugepage"] < shares["puma"] < 0.1, shares


@pytest.mark.parametrize("allocator", gemv.ALLOCATORS)
def test_gemv_bit_exact_under_every_placement(allocator):
    """The reference's property (``tests/test_trace_replay.py``): the
    partitioned product is bit-exact against the whole matrix's, here
    ``torch.mv`` and the reference's ``jnp.dot`` alike."""
    cfg = get_config("stablelm_1_6b").smoke()
    shapes = gemv.weight_shapes(cfg)
    amap = AddressMap()
    placement = gemv.build_placement(shapes, allocator, PhysicalMemory(amap, seed=3))
    rng = np.random.default_rng(7)
    for name in ("L0/attn/wq", "L1/mlp/w_out", "lm_head"):
        n_out, d_in = shapes[name]
        w = rng.integers(-8, 8, size=(n_out, d_in)).astype(np.float32)
        x = rng.integers(-8, 8, size=(d_in,)).astype(np.float32)
        y = gemv.gemv_execute(w, x, *placement[name], amap)
        assert isinstance(y, np.ndarray) and y.dtype == np.float32
        assert np.array_equal(y, torch.mv(torch.from_numpy(w), torch.from_numpy(x)).numpy())
        assert np.array_equal(y, np.asarray(jnp.dot(jnp.asarray(w), jnp.asarray(x))))


def test_gemv_takes_tensors_and_returns_a_tensor_on_their_device():
    """A tensor in, a tensor out on the same device, bit-exact, on a matrix
    whose rows split between the two groups: full-width stablelm_1_6b's
    ``wk`` under PUMA, placed with the rest of layer 0."""
    shapes = {n: s for n, s in gemv.weight_shapes(get_config("stablelm_1_6b")).items()
              if n.startswith("L0/")}
    n_huge = -(-sum(2 * o * i * gemv.ITEMSIZE for o, i in shapes.values()) // HUGE_PAGE)
    amap = AddressMap()
    placement = gemv.build_placement(shapes, "puma", PhysicalMemory(amap, seed=3),
                                     prealloc_huge=n_huge)
    plan = pud.plan_rows("mac", list(placement["L0/attn/wk"]), amap)
    assert 0 < sum(plan.in_pud) < plan.n_rows   # both row groups are dispatched
    rng = np.random.default_rng(9)
    w = rng.integers(-8, 8, size=shapes["L0/attn/wk"]).astype(np.float32)
    x = rng.integers(-8, 8, size=(w.shape[1],)).astype(np.float32)
    y = gemv.gemv_execute(torch.from_numpy(w), torch.from_numpy(x), *placement["L0/attn/wk"],
                          amap)
    assert isinstance(y, torch.Tensor) and y.device.type == "cpu"
    assert torch.equal(y, torch.mv(torch.from_numpy(w), torch.from_numpy(x)))
    assert np.array_equal(gemv.gemv_execute(w, x, *placement["L0/attn/wk"], amap), y.numpy())


def test_offload_fractions_tell_the_paper_story():
    reports = {al: gemv.offload_report("stablelm_1_6b", al, n_tokens=1)
               for al in gemv.ALLOCATORS}
    frac = {al: r["offload_fraction"] for al, r in reports.items()}
    assert frac["malloc"] == 0.0
    assert frac["posix_memalign"] == 0.0
    assert 0.0 < frac["hugepage"] < 0.95
    assert frac["puma"] >= 0.99
    assert all(frac["puma"] > frac[al] for al in ("malloc", "posix_memalign", "hugepage"))
    # adaptive dispatch: CPU-bound placements price at exactly CPU speed
    assert reports["malloc"]["speedup_vs_cpu"] == 1.0
    assert reports["posix_memalign"]["speedup_vs_cpu"] == 1.0
    assert reports["hugepage"]["speedup_vs_cpu"] >= 1.0
    assert reports["puma"]["speedup_vs_cpu"] >= 1.5


def test_moe_routing_deterministic_and_routed():
    assert "granite_moe_1b_a400m" in moe_archs()
    cfg = get_config("granite_moe_1b_a400m").smoke()
    a = gemv.decode_op_stream(cfg, seed=11, n_tokens=3)
    assert a == gemv.decode_op_stream(cfg, seed=11, n_tokens=3)
    assert a != gemv.decode_op_stream(cfg, seed=12, n_tokens=3)
    experts = {op.split("/")[2] for op in a if "/moe/e" in op}
    assert len(experts) >= 2, "routing never varied the expert set"
    moe_l0 = [op for op in a if op.startswith("L0/moe/e")]
    assert len(moe_l0) == cfg.experts_per_tok * 3 * 3  # w_in/w_gate/w_out, 3 tokens


def test_gemv_pud_op_trace_replays(tmp_path):
    """The offload model's pud_op events (the controller-dispatched channel
    arm included) replay bit-exactly from the JSONL alone, through the
    port's replay executor; the JSONL equals the reference recorder's."""
    from repro.trace.record import TraceRecorder as RefTraceRecorder

    rec = TraceRecorder(channels=1, meta={"what": "gemv"})
    ref_rec = RefTraceRecorder(channels=1, meta={"what": "gemv"})
    gemv.offload_report("stablelm_1_6b", "hugepage", n_tokens=1, recorder=rec)
    ref_gemv.offload_report("stablelm_1_6b", "hugepage", n_tokens=1, recorder=ref_rec)
    for r in (rec, ref_rec):
        r.finalize(clock=0, tokens_decoded=0, tokens_prefilled=0, maintenance_ns=0.0)
    assert rec.to_jsonl() == ref_rec.to_jsonl()
    res = replay_trace(parse_trace(rec.to_jsonl()))
    assert res.ok, res.report()

    rec2 = TraceRecorder(channels=4, meta={"what": "channel"})
    report = gemv.channel_study("stablelm_1_6b", recorder=rec2)
    rec2.finalize(clock=0, tokens_decoded=0, tokens_prefilled=0, maintenance_ns=0.0)
    res2 = replay_trace(parse_trace(rec2.to_jsonl()))
    assert res2.ok, res2.report()
    assert report["parallel_speedup"] >= 2.0
    path = tmp_path / "gemv.trace.jsonl"
    rec2.write(str(path))
    assert replay_trace(path.read_text()).ok
