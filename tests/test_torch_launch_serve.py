"""The port's serving entry points against the reference's, on the CPU:
``repro_torch.launch.serve`` against ``repro.launch.serve`` (the printed
line, and the generated ids on the reference's own weights through the
bridge), ``examples/torch_serve_paged.py`` against
``examples/serve_paged.py``, and the engine's ``jit=`` switch, which on the
CPU runs the same eager step either way."""
import contextlib
import importlib.util
import io
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

import repro.launch.serve as ref_launch  # noqa: E402
from repro.serve.engine import ServeEngine as RefEngine  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.kv_pool import KVPoolConfig  # noqa: E402
from repro_torch.graphs import GraphCache, decode_step_jit  # noqa: E402
from repro_torch.launch import serve as port_launch  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.models.transformer import LM  # noqa: E402
from repro_torch.serve.engine import MaintenanceConfig, Request, ServeEngine  # noqa: E402
from repro_torch.serve.paged_runner import paged_decode_step, paged_decode_step_jit  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
POLICIES = ["puma", "first_fit", "random"]

_LAUNCH_LINE = re.compile(
    r"\[serve\] (\S+) policy=(\S+): (\d+) requests, (\d+) tokens, [\d.]+ tok/s \| "
    r"contiguity=(\S+) descriptors/tile=(\S+)")
_EXAMPLE_LINE = re.compile(
    r"(\S+)\s+served\s+(\d+) reqs, (\d+) tokens in\s+[\d.]+s \| contiguity=(\S+) "
    r"descriptors/tile=(\S+) align_hits=(\d+) misses=(\d+)")


def _fields(pattern, text):
    """Every match of ``pattern`` in ``text`` (the timing left out)."""
    rows = pattern.findall(text)
    assert rows, text
    return rows


@pytest.fixture(scope="module", params=POLICIES)
def ref_launch_run(request):
    """The reference launcher's ``main`` at ``--policy``, its printed output
    and the engine it ran (recorded through a subclass)."""
    engines = []

    class Recording(RefEngine):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            engines.append(self)

    mp = pytest.MonkeyPatch()
    mp.setattr(ref_launch, "ServeEngine", Recording)
    mp.setattr("sys.argv", ["serve", "--policy", request.param])
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            ref_launch.main()
    finally:
        mp.undo()
    assert len(engines) == 1
    return request.param, out.getvalue(), engines[0]


def test_launcher_prints_the_reference_fields(ref_launch_run):
    policy, ref_out, _ = ref_launch_run
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        port_launch.main(["--device", "cpu", "--policy", policy])
    ours = _fields(_LAUNCH_LINE, out.getvalue())
    assert ours == _fields(_LAUNCH_LINE, ref_out)
    assert ours[0][:3] == ("stablelm_1_6b", policy, "16")


def test_launcher_ids_equal_the_reference_on_its_weights(ref_launch_run):
    """The port's serve on the reference launcher's own weights (bridged)
    generates the reference's ids, request for request."""
    policy, _, ref_eng = ref_launch_run
    args = port_launch.parse_args(["--device", "cpu", "--policy", policy])
    model = LM(get_config(args.arch).smoke(), attn_impl="naive", remat=None)
    params = params_from_numpy(model, jax.tree.map(np.asarray, ref_eng.params), device="cpu")
    eng, done, _ = port_launch.serve(model, params, args)
    ours = {r.rid: [int(t) for t in r.out] for r in done}
    ref = {r.rid: [int(t) for t in r.out] for r in ref_eng.done}
    assert len(ours) == args.requests and ours == ref
    assert eng.jit and eng.graphs.captures == 0   # CPU: eager under jit=True


@pytest.mark.parametrize("arch", ["rwkv6_7b", "zamba2_7b", "seamless_m4t_medium"])
def test_launcher_refuses_state_and_encdec_families_as_the_reference(arch, monkeypatch):
    monkeypatch.setattr("sys.argv", ["serve", "--arch", arch])
    with pytest.raises(SystemExit) as ref:
        ref_launch.main()
    with pytest.raises(SystemExit) as ours:
        port_launch.main(["--arch", arch, "--device", "cpu"])
    assert str(ours.value) == str(ref.value) and arch in str(ours.value)


def _load(relpath):
    spec = importlib.util.spec_from_file_location(pathlib.Path(relpath).stem, ROOT / relpath)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_prints_the_reference_contiguity_and_alignment(monkeypatch):
    """``examples/torch_serve_paged.py --device cpu`` against
    ``examples/serve_paged.py``: per policy the same requests, tokens,
    contiguity, descriptors per tile and align hits and misses."""
    monkeypatch.setattr("sys.argv", ["serve_paged.py"])
    ref_out, out = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(ref_out):
        _load("examples/serve_paged.py").main()
    with contextlib.redirect_stdout(out):
        _load("examples/torch_serve_paged.py").main(["--device", "cpu"])
    ours = _fields(_EXAMPLE_LINE, out.getvalue())
    assert [r[0] for r in ours] == POLICIES
    assert ours == _fields(_EXAMPLE_LINE, ref_out.getvalue())


def _smoke_engine(model, params, jit, maintenance=None):
    cfg = model.cfg
    pool_cfg = KVPoolConfig(
        num_blocks=64, block_size=8, kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
        n_layers=cfg.n_layers, max_seqs=4, max_blocks_per_seq=16,
        blocks_per_arena=16, dtype="float32")
    eng = ServeEngine(model, params, pool_cfg, device="cpu", jit=jit, maintenance=maintenance)
    rng = np.random.default_rng(7)
    for rid in range(9):
        eng.submit(Request(rid=rid, prompt=rng.integers(0, cfg.vocab_size,
                                                        int(rng.integers(3, 40))).tolist(),
                           max_new=int(rng.integers(2, 12))))
    return eng


@pytest.mark.parametrize("maintenance", [None, MaintenanceConfig(
    free_low=0.9, frag_high=0.05, contig_low=0.999, max_moves=64, every=2)],
    ids=["plain", "maintenance"])
def test_jit_engine_on_cpu_equals_eager(maintenance):
    """``ServeEngine(jit=True, device="cpu")`` (the default switch) serves
    exactly as ``jit=False``: ids, host metrics and the pools bit for bit,
    with no graph captured."""
    model = LM(get_config("stablelm_1_6b").smoke())
    params = model.init(1, device="cpu")
    engines = {jit: _smoke_engine(model, params, jit, maintenance) for jit in (True, False)}
    for eng in engines.values():
        eng.run()
    a, b = engines[True], engines[False]
    assert {r.rid: r.out for r in a.done} == {r.rid: r.out for r in b.done}
    assert len(a.done) == 9
    assert a.metrics() == b.metrics()
    assert torch.equal(a.pool.k, b.pool.k) and torch.equal(a.pool.v, b.pool.v)
    assert a.graphs is model._cuda_graphs and a.graphs.captures == 0 and b.graphs is None
    if maintenance:
        assert a.compaction_passes > 0


def test_paged_decode_step_jit_on_cpu_runs_the_eager_step():
    cfg = get_config("stablelm_1_6b").smoke()
    model = LM(cfg)
    params = model.init(2, device="cpu")
    rng = np.random.default_rng(2)
    L_, nb, bs, maxb = cfg.n_layers, 16, 8, 4
    kp = torch.from_numpy(rng.normal(size=(L_, nb, bs, cfg.n_kv_heads, cfg.hd)).astype(np.float32))
    vp = torch.from_numpy(rng.normal(size=kp.shape).astype(np.float32))
    lens = np.array([5, 17, 30], np.int32)
    tbl = np.full((3, maxb), -1, np.int32)
    for b, n in enumerate(lens):
        tbl[b, :-(-n // bs)] = rng.choice(nb, size=-(-n // bs), replace=False)
    toks = rng.integers(0, cfg.vocab_size, (3, 1))
    pos = (lens - 1)[:, None].astype(np.int64)
    graphs = GraphCache()
    got = paged_decode_step_jit(params, cfg, toks, pos, kp, vp, tbl, lens, graphs=graphs)
    want = paged_decode_step(params, cfg, torch.from_numpy(toks), torch.from_numpy(pos), kp, vp,
                             torch.from_numpy(tbl), torch.from_numpy(lens))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert graphs.captures == 0 and graphs.pool is None


def test_decode_step_jit_on_cpu_runs_the_eager_step_and_refuses_the_hybrid_family():
    model = LM(get_config("rwkv6_7b").smoke())
    params = model.init(3, device="cpu")
    tok = torch.tensor([[5], [9]])
    batch = {"tokens": tok, "positions": torch.zeros_like(tok)}
    c1, c2 = model.init_cache(2, 4, device="cpu"), model.init_cache(2, 4, device="cpu")
    with torch.no_grad():
        for _ in range(3):
            l1, c1 = decode_step_jit(model, params, batch, c1)
            l2, c2 = model.decode_step(params, batch, c2)
            assert torch.equal(l1, l2) and c1["len"] == c2["len"]
    assert all(torch.equal(a, b) for a, b in zip(c1["layers"], c2["layers"]))
    hybrid = LM(get_config("zamba2_7b").smoke())
    with pytest.raises(NotImplementedError, match="host-int lengths"):
        decode_step_jit(hybrid, None, batch, None)
