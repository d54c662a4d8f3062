"""The port's PUD substrate against the reference: the allocators, the PUD
cost model (``plan_rows`` / ``simulate_op`` / ``execute_op``), the Figure 2
table, the examples, and the ``pud_*`` bulk ops on CPU tensors.

The host model is numpy in both packages, so every number and byte is held
equal exactly.  The ``bulk_op`` CUDA kernel itself runs only on a card: see
tests/test_torch_cuda.py.
"""
import contextlib
import importlib.util
import io
import pathlib
import re
import runpy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import repro.core.allocators as ref_allocators  # noqa: E402
import repro.core.controller as ref_controller  # noqa: E402
import repro.core.dram as ref_dram  # noqa: E402
import repro.core.pud as ref_pud  # noqa: E402
import repro.core.puma as ref_puma  # noqa: E402
import repro_torch.core.allocators as port_allocators  # noqa: E402
import repro_torch.core.controller as port_controller  # noqa: E402
import repro_torch.core.dram as port_dram  # noqa: E402
import repro_torch.core.pud as port_pud  # noqa: E402
import repro_torch.core.puma as port_puma  # noqa: E402
from repro.kernels.pud_bulk import ops as ref_pud_ops  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs.registry import get_config, lm_archs  # noqa: E402
from repro_torch.kernels.pud_bulk import ops as pud_ops  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKGS = {
    "ref": (ref_dram, ref_allocators, ref_puma, ref_pud, ref_controller),
    "port": (port_dram, port_allocators, port_puma, port_pud, port_controller),
}
#: small geometries (16 MB) so execute_op can hold the whole "physical" memory
GEOMETRIES = {1: dict(channels=1, subarrays_per_bank=8, rows_per_subarray=256),
              8: dict(channels=8, subarrays_per_bank=8, rows_per_subarray=32)}
SCHEMES = ("BANK_REGION_SCHEME", "CACHELINE_INTERLEAVED_SCHEME")


def _operands(pkg, kind, op, channels, scheme):
    """The same allocation script under one package: (amap, operands)."""
    dram, allocators, puma, pud, _ = PKGS[pkg]
    amap = dram.AddressMap(dram.DramGeometry(**GEOMETRIES[channels]), getattr(dram, scheme))
    mem = allocators.PhysicalMemory(amap, seed=1, n_huge_pages=4, occupancy=0.1)
    size = 3 * amap.region_bytes + 123
    n = pud.N_OPERANDS[op]
    if kind == "puma":
        al = puma.PumaAllocator(mem, stripe_channels=channels > 1)
        al.pim_preallocate(4)
        ops = [al.pim_alloc(size)]
        while len(ops) < n:
            ops.append(al.pim_alloc_align(size, ops[0]))
        return amap, ops
    al = {"malloc": allocators.MallocModel, "posix_memalign": allocators.PosixMemalignModel,
          "hugepage": allocators.HugePageModel}[kind](mem)
    return amap, [al.alloc(size) for _ in range(n)]


def dataclass_fields(x):
    return {k: getattr(x, k) for k in x.__dataclass_fields__}


def _load(path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _numbers(text):
    return re.findall(r"\d+\.\d+|\d+", text)


def _sim_fields(r):
    return (r.op, r.size, r.pud_fraction, r.t_ns, r.t_cpu_ns, r.rows_per_channel,
            r.faulted_rows, r.speedup_vs_cpu, r.channel_balance)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("channels", [1, 8])
@pytest.mark.parametrize("op", ["zero", "copy", "and", "or", "not", "mac"])
@pytest.mark.parametrize("kind", ["malloc", "posix_memalign", "hugepage", "puma"])
def test_plan_simulate_execute_match_reference(kind, op, channels, scheme):
    (amap_r, ops_r), (amap_p, ops_p) = (_operands(p, kind, op, channels, scheme) for p in PKGS)
    assert [[(e.va_off, e.pa, e.nbytes) for e in a.extents] for a in ops_p] == \
        [[(e.va_off, e.pa, e.nbytes) for e in a.extents] for a in ops_r]

    plan_r, plan_p = ref_pud.plan_rows(op, ops_r, amap_r), port_pud.plan_rows(op, ops_p, amap_p)
    assert (plan_p.n_rows, plan_p.in_pud, plan_p.tail_bytes, plan_p.faulted_rows) == \
        (plan_r.n_rows, plan_r.in_pud, plan_r.tail_bytes, plan_r.faulted_rows)
    np.testing.assert_array_equal(plan_p.subarrays, plan_r.subarrays)
    np.testing.assert_array_equal(plan_p.channel_rows(amap_p), plan_r.channel_rows(amap_r))

    assert _sim_fields(port_pud.simulate_op(op, ops_p, amap_p)) == \
        _sim_fields(ref_pud.simulate_op(op, ops_r, amap_r))
    assert _sim_fields(port_pud.simulate_op(op, ops_p, amap_p, adaptive=False)) == \
        _sim_fields(ref_pud.simulate_op(op, ops_r, amap_r, adaptive=False))
    # through the per-channel controllers: same pricing, same queue state
    ctl_r, ctl_p = ref_controller.DramController(amap_r), port_controller.DramController(amap_p)
    for _ in range(2):
        assert _sim_fields(port_pud.simulate_op(op, ops_p, amap_p, controller=ctl_p)) == \
            _sim_fields(ref_pud.simulate_op(op, ops_r, amap_r, controller=ctl_r))
    assert ctl_p.occupancy_report() == ctl_r.occupancy_report()

    phys = np.random.default_rng(0).integers(0, 256, amap_r.total_bytes, dtype=np.uint8)
    phys_r, phys_p = phys.copy(), phys.copy()
    if op == "mac":   # priced, but not executable on the functional model
        with pytest.raises(ValueError):
            ref_pud.execute_op(op, ops_r, phys_r, amap_r)
        with pytest.raises(ValueError):
            port_pud.execute_op(op, ops_p, phys_p, amap_p)
        return
    ex_r = ref_pud.execute_op(op, ops_r, phys_r, amap_r)
    ex_p = port_pud.execute_op(op, ops_p, phys_p, amap_p)
    assert ex_p.in_pud == ex_r.in_pud
    assert np.array_equal(phys_p, phys_r)
    assert not np.array_equal(phys_p, phys) or op == "copy"


@pytest.mark.parametrize("with_controller", [False, True])
def test_price_migration_matches_reference(with_controller):
    costs = []
    for dram, pud, controller in ((ref_dram, ref_pud, ref_controller),
                                  (port_dram, port_pud, port_controller)):
        amap = dram.AddressMap(dram.DramGeometry(**GEOMETRIES[8]))
        ctl = controller.DramController(amap) if with_controller else None
        cost = pud.price_migration([3, 11, 11, 40, 5], 7, amap.region_bytes, channels=8,
                                   controller=ctl, cpu_pas=np.arange(7) * 4096)
        costs.append((dataclass_fields(cost), cost.total_ns,
                      ctl.occupancy_report() if ctl else None))
    assert costs[1] == costs[0]


def test_puma_paper_config_and_core_exports():
    import repro.core as ref_core
    import repro_torch.core as port_core
    from repro.configs.registry import get_config as ref_get_config

    cfg, ref_cfg = get_config("puma_paper"), ref_get_config("puma_paper")
    assert dataclass_fields(cfg) == dataclass_fields(ref_cfg)
    assert cfg.geometry().total_bytes == ref_cfg.geometry().total_bytes
    assert "puma_paper" not in lm_archs()
    assert sorted(port_core.__all__) == sorted(ref_core.__all__)


def test_fig2_table_matches_reference():
    ref_bench = _load(ROOT / "benchmarks" / "microbench.py")
    port_bench = _load(ROOT / "benchmarks" / "torch_microbench.py")
    emitted = {"ref": [], "port": []}
    ref_table = ref_bench.run(lambda name, us, val: emitted["ref"].append((name, val)))
    port_table = port_bench.run(lambda name, us, val: emitted["port"].append((name, val)))
    assert port_table == ref_table
    assert emitted["port"] == emitted["ref"]


def _run_main(path, argv=None):
    mod = _load(path)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = mod.main() if argv is None else mod.main(argv)
    return result, buf.getvalue()


def _run_reference_script(path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_path(str(path), run_name="__main__")
    return buf.getvalue()


def test_quickstart_matches_reference():
    rows, out = _run_main(ROOT / "examples" / "torch_quickstart.py")
    ref_out = _run_reference_script(ROOT / "examples" / "quickstart.py")
    assert _numbers(out) == _numbers(ref_out)
    assert rows["PUMA"]["pud_fraction"] == 1.0 and rows["malloc"]["pud_fraction"] == 0.0


def test_pud_bitwise_example_matches_reference():
    matches, out = _run_main(ROOT / "examples" / "torch_pud_bitwise.py",
                             ["--device", "cpu", "--rows", "65536"])
    ref_out = _run_reference_script(ROOT / "examples" / "pud_bitwise.py")
    ref_matches = int(re.search(r"(\d+) matches", ref_out).group(1))
    assert matches == ref_matches
    assert f"{matches} matches" in out


# -- pud_* on CPU tensors ------------------------------------------------------

RNG = np.random.default_rng(0)
OPS = [("zero", 1), ("copy", 1), ("not", 1), ("and", 2), ("or", 2), ("xor", 2), ("maj", 3)]


@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.int8, np.uint8])
@pytest.mark.parametrize("shape", [(8, 128), (100,), (3, 5, 7), (1000, 3)])
def test_pud_ops_match_reference(dtype, shape):
    info = np.iinfo(dtype)
    xs = [RNG.integers(info.min, int(info.max) + 1, size=shape, dtype=dtype) for _ in range(3)]
    for op, arity in OPS:
        ref = getattr(ref_pud_ops, f"pud_{op}")(*map(jnp.asarray, xs[:arity]), use_kernel=False)
        got = getattr(pud_ops, f"pud_{op}")(*map(torch.from_numpy, xs[:arity]))
        want = np.asarray(ref)
        assert got.shape == shape and got.numpy().dtype == want.dtype, op
        np.testing.assert_array_equal(got.numpy(), want, err_msg=op)


def test_pud_ops_on_bool_match_reference():
    xs = [RNG.integers(0, 2, 1000).astype(bool) for _ in range(3)]
    for op, arity in OPS:
        ref = getattr(ref_pud_ops, f"pud_{op}")(*map(jnp.asarray, xs[:arity]), use_kernel=False)
        got = getattr(pud_ops, f"pud_{op}")(*map(torch.from_numpy, xs[:arity]))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref), err_msg=op)
    np.testing.assert_array_equal(pud_ops.pud_not(torch.from_numpy(xs[0])).numpy(), ~xs[0])


def test_pud_ops_reject_mismatched_operands_and_floats():
    before = kernels.launches["bulk_op"]
    x = torch.zeros(12, dtype=torch.int32)
    for bad in (torch.zeros(13, dtype=torch.int32), torch.zeros(12, dtype=torch.int64)):
        with pytest.raises(ValueError, match="differ"):
            pud_ops.pud_and(x, bad)
    with pytest.raises(TypeError):
        pud_ops.pud_not(torch.zeros(4))
    # same element count, other shape: the first operand's shape wins
    assert pud_ops.pud_or(x.view(3, 4), x.view(4, 3)).shape == (3, 4)
    # non-contiguous operands are taken as they are
    y = torch.arange(24, dtype=torch.int32).view(4, 6).t()
    assert torch.equal(pud_ops.pud_copy(y), y)
    assert pud_ops.pud_zero(torch.ones(5, dtype=torch.float32)).sum() == 0
    assert kernels.launches["bulk_op"] == before    # the CPU path launches nothing
