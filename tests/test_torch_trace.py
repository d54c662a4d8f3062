"""The port's serving load harness and trace layer against the reference
(CPU): the golden trace regenerated byte for byte and replayed bit-exactly,
the five serve-bench records equal to ``BENCH_serve.json``, the loadgen
streams equal, and generated ids equal to the reference engine's on the
same bridged weights in a scenario whose compaction chains moves.  Also the
block copy's parallel-copy semantics when a move's source is another
move's destination, which that scenario's compaction plans need."""
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.pud_bulk import ops as ref_pud_ops  # noqa: E402
from repro.serve import loadgen as ref_loadgen  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.pud_bulk import ops as pud_ops  # noqa: E402
from repro_torch.serve import loadgen  # noqa: E402
from repro_torch.trace import TraceSchemaError, parse_trace, replay_trace  # noqa: E402
from repro_torch.trace.serve_trace import record_scenario  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "goldens" / "steady_smoke.trace.jsonl"
BENCH = json.loads((ROOT / "BENCH_serve.json").read_text())


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several test processes at once; one torch thread per
    process keeps them from contending for the cores (it is no slower here)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load_bench():
    import importlib.util

    spec = importlib.util.spec_from_file_location("torch_serve_bench",
                                                  ROOT / "benchmarks" / "torch_serve_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_golden_trace_regenerates_byte_for_byte():
    trace, rec = record_scenario("steady", smoke=True, device="cpu")
    assert trace.to_jsonl() == GOLDEN.read_text()
    assert rec["done"] == rec["submitted"] > 0


def test_golden_replays_bit_exact_and_refuses_other_schemas():
    text = GOLDEN.read_text()
    res = replay_trace(parse_trace(text))
    assert res.ok, res.report()
    assert res.recomputed["sim_ns"] == res.totals["sim_ns"] > 0
    lines = text.splitlines()
    header = json.loads(lines[0])
    header["schema"] = 999
    with pytest.raises(TraceSchemaError, match="999"):
        parse_trace("\n".join([json.dumps(header)] + lines[1:]))


@pytest.mark.parametrize("name", loadgen.SCENARIO_NAMES)
def test_serve_bench_record_equals_reference(name):
    rec, _ = _load_bench().run_scenario(name, smoke=True, device="cpu")
    assert json.dumps(rec, sort_keys=True) == json.dumps(BENCH[f"scenario/{name}"], sort_keys=True)


def test_serve_bench_config_and_comparison():
    bench = _load_bench()
    results = {f"scenario/{n}": BENCH[f"scenario/{n}"] for n in loadgen.SCENARIO_NAMES}
    results["config"] = dict(BENCH["config"])
    assert bench.differing(results, BENCH) == []
    results["scenario/steady"] = dict(results["scenario/steady"], done=0)
    assert bench.differing(results, BENCH) == ["scenario/steady"]


@pytest.mark.parametrize("name", loadgen.SCENARIO_NAMES)
def test_loadgen_streams_equal_reference(name):
    ours = loadgen.build_scenario(name, smoke=True)
    ref = ref_loadgen.build_scenario(name, smoke=True)
    assert ours.seed == ref.seed and ours.pool_overrides() == ref.pool_overrides()
    assert [vars(s) if hasattr(s, "__dict__") else s for s in ours.generate()] == \
        [vars(s) if hasattr(s, "__dict__") else s for s in ref.generate()]


def test_bursty_ids_equal_reference_with_chained_compaction_moves():
    """Check (c) on the bursty scenario, whose maintenance plans chain a
    move into a block another move of the same pass empties: with the
    reference's weights bridged in, every request's generated ids equal the
    reference engine's (both apply the plan with parallel-copy semantics)."""
    from repro.configs.registry import get_config as ref_get_config
    from repro.core.kv_pool import KVPoolConfig as RefPoolConfig
    from repro.models.transformer import LM as RefLM
    from repro.serve.engine import MaintenanceConfig as RefMaint, ServeEngine as RefEngine
    from repro_torch.configs.registry import get_config
    from repro_torch.core.kv_pool import KVPoolConfig
    from repro_torch.models.bridge import params_from_numpy
    from repro_torch.models.transformer import LM
    from repro_torch.serve.engine import MaintenanceConfig, ServeEngine

    ref_model = RefLM(ref_get_config("stablelm_1_6b").smoke(), attn_impl="naive", remat=None)
    ref_params = ref_model.init(jax.random.key(0))
    model = LM(get_config("stablelm_1_6b").smoke(), attn_impl="naive", remat=None)
    params = params_from_numpy(model, jax.tree.map(np.asarray, ref_params), device="cpu")
    cfg = model.cfg
    sc = loadgen.build_scenario("bursty", smoke=True)
    base = dict(num_blocks=32, block_size=8, kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                n_layers=cfg.n_layers, max_seqs=4, max_blocks_per_seq=16,
                blocks_per_arena=16, policy="puma", dtype="float32")
    base.update(sc.pool_overrides())
    ref_eng = RefEngine(ref_model, ref_params, RefPoolConfig(**base), use_kernel=False,
                        maintenance=RefMaint())
    eng = ServeEngine(model, params, KVPoolConfig(**base), device="cpu",
                      maintenance=MaintenanceConfig())
    ref_loadgen.play(ref_eng, ref_loadgen.build_scenario("bursty", smoke=True).generate(),
                     max_steps=sc.max_steps)
    loadgen.play(eng, sc.generate(), max_steps=sc.max_steps)
    assert eng.compaction_passes == ref_eng.compaction_passes > 0
    ours = {r.rid: list(r.out) for r in eng.done}
    theirs = {r.rid: list(r.out) for r in ref_eng.done}
    assert len(ours) == 36 and ours == theirs


@pytest.mark.parametrize("src,dst,waves", [
    ([1, 2], [3, 4], [[0, 1]]),
    ([14, 12, 10], [10, 0, 4], [[1, 2], [0]]),          # 10 is read before 14 lands on it
    ([5, 6, 7], [6, 7, 8], [[2], [1], [0]]),            # a chain of three
    ([3, 9], [3, 4], [[0, 1]]),                         # a block copied onto itself
])
def test_copy_waves_order_chained_moves(src, dst, waves):
    got = pud_ops.copy_waves(np.array(src), np.array(dst))
    assert [w.tolist() for w in got] == waves
    for w in got:   # each launch's sources and destinations are disjoint (self-copies aside)
        s, d = set(np.array(src)[w]), set(np.array(dst)[w])
        assert not (s & d) - {a for a, b in zip(src, dst) if a == b}


def test_copy_waves_refuse_cycles():
    with pytest.raises(ValueError, match="cyclic"):
        pud_ops.copy_waves(np.array([1, 2, 3]), np.array([2, 3, 1]))


def test_block_copy_with_chained_moves_matches_reference():
    """Parallel-copy semantics with a source that is another pair's
    destination: the port's block copy equals the reference's (its Pallas
    kernel in interpret mode)."""
    rng = np.random.default_rng(0)
    pool = rng.normal(size=(16, 24)).astype(np.float32)
    src, dst = np.array([14, 12, 10, 9], np.int32), np.array([10, 0, 4, 3], np.int32)
    ref = ref_pud_ops.pool_block_copy(jnp.asarray(pool), jnp.asarray(src), jnp.asarray(dst),
                                      use_kernel=True)
    before = kernels.launches["block_copy"]
    ours = pud_ops.pool_block_copy(torch.from_numpy(pool.copy()), src, dst)
    assert kernels.launches["block_copy"] == before
    assert np.array_equal(ours.numpy(), np.asarray(ref))
    assert np.array_equal(ours.numpy()[4], pool[10]) and np.array_equal(ours.numpy()[10], pool[14])
