"""The span recorder (``trace/spans.py``) and its spans in the serving
engine and the train step.

On the CPU, on the smoke stablelm_1_6b: the engine's span tree (each step a
root over its phases, each prefill under the admission scan), self time as
the span less its children and its K/V writes, the requests' host stamps in
order; with recording off nothing is recorded and the ids and ``metrics()``
are unchanged; under ``torch.profiler`` each span is a range of its name
whose start the ring's clock maps onto; the train step's three phases under
``train.step``, with no device time on the CPU; the ring's wrap.  On a card
(marker ``cuda``): ``graph_captures`` counts the captures, and the decode
and train spans carry device time.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.kv_pool import KVPoolConfig  # noqa: E402
from repro_torch.models.transformer import LM  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serve.engine import MaintenanceConfig, Request, ServeEngine  # noqa: E402
from repro_torch.trace import spans  # noqa: E402
from repro_torch.train.step import build_train_step  # noqa: E402

PHASES = {"engine.admit", "engine.batch", "engine.decode", "engine.readback"}


@pytest.fixture(scope="module")
def smoke():
    model = LM(get_config("stablelm_1_6b").smoke(), attn_impl="naive", remat=None)
    return model, model.init(1, device="cpu")


@pytest.fixture
def recorder():
    spans.reset()
    spans.enable(True)
    yield spans.RECORDER
    spans.enable(True)
    spans.reset()


def _engine(model, params, device="cpu", n=9, seed=7, **kw):
    cfg = model.cfg
    pool_cfg = KVPoolConfig(
        num_blocks=64, block_size=8, kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
        n_layers=cfg.n_layers, max_seqs=4, max_blocks_per_seq=16, blocks_per_arena=16,
        dtype=cfg.dtype)
    eng = ServeEngine(model, params, pool_cfg, device=device, **kw)
    rng = np.random.default_rng(seed)
    for rid in range(n):
        eng.submit(Request(rid=rid, prompt=rng.integers(0, cfg.vocab_size,
                                                        int(rng.integers(3, 40))).tolist(),
                           max_new=int(rng.integers(2, 12))))
    return eng


def _dur(s):
    return s.end - s.start


def test_engine_span_tree(smoke, recorder):
    eng = _engine(*smoke)
    eng.run()
    trees = spans.trees()
    assert [t[0].clock for t in trees] == list(range(1, eng.clock + 1))
    prefills = 0
    for tree in trees:
        root, rest = tree[0], tree[1:]
        assert root.name == "engine.step" and root.parent is None
        by_id = {s.id: s for s in tree}
        for s in rest:
            assert s.root == root.id
            parent = by_id[s.parent]
            if s.name == "engine.prefill":
                assert parent.name == "engine.admit" and s.attrs["tokens"] > 0
                assert s.rid is not None and s.device_ns is None
                prefills += 1
            else:
                assert s.name in PHASES and parent is root
            assert parent.start <= s.start <= s.end <= parent.end
        names = [s.name for s in rest if s.parent == root.id]
        # the admission scan when requests were queued; no maintenance configured
        assert names[-3:] == ["engine.batch", "engine.decode", "engine.readback"]
        assert names[:-3] in ([], ["engine.admit"])
        assert root.attrs["batch"] > 0 and root.attrs["decoded"] <= root.attrs["batch"]
        assert root.attrs["admitted"] == sum(s.name == "engine.prefill" for s in rest)
        assert root.attrs["engine.kv_write"] > 0
    assert prefills == len(eng.done) == 9
    summary = spans.summary()
    assert summary["engine.step"]["count"] == eng.clock
    assert summary["engine.prefill"]["count"] == 9
    assert summary["engine.kv_write"]["count"] == eng.steps        # one figure a step
    assert summary["engine.decode"]["device_ms"] is None


def test_maintenance_checks_are_spans(smoke, recorder):
    marks = MaintenanceConfig(free_low=0.9, frag_high=0.05, contig_low=0.999, max_moves=64,
                              every=2)
    eng = _engine(*smoke, maintenance=marks)
    eng.run()
    checks = [s for t in spans.trees() for s in t if s.name == "engine.maintain"]
    assert checks and all(s.parent == s.root for s in checks)
    assert eng.compaction_passes > 0 and len(checks) >= eng.compaction_passes


def test_self_time_is_the_span_less_its_children(smoke, recorder):
    eng = _engine(*smoke, n=5)
    eng.run()
    totals = {}
    for tree in spans.trees():
        for s in tree:
            kids = sum(_dur(c) for c in tree if c.parent == s.id)
            covered = kids + s.attrs.get("engine.kv_write", 0)
            assert s.self_ns == _dur(s) - covered >= 0
            totals[s.name] = totals.get(s.name, 0) + s.self_ns
    summary = spans.summary()
    for name, ns in totals.items():
        assert summary[name]["self_ms"] == pytest.approx(ns / 1e6, abs=1e-9)
    kv = summary["engine.kv_write"]
    assert kv["self_ms"] == kv["total_ms"] == pytest.approx(
        sum(t[0].attrs["engine.kv_write"] for t in spans.trees()) / 1e6, abs=1e-9)


def test_request_stamps_in_order(smoke, recorder):
    eng = _engine(*smoke)
    done = eng.run()
    for r in done:
        assert r.t_submit <= r.t_admit <= r.t_first <= r.t_done
    q = Request(rid=99, prompt=[1, 2], max_new=2)
    assert dataclasses.replace(q, t_submit=5) == q and "t_submit" not in repr(q)


def test_disabled_records_nothing_and_changes_nothing(smoke, recorder):
    on = _engine(*smoke)
    on.run()
    assert spans.trees()
    spans.reset()
    spans.enable(False)
    off = _engine(*smoke)
    off.run()
    assert spans.trees() == [] and spans.summary() == {}
    assert {r.rid: r.out for r in off.done} == {r.rid: r.out for r in on.done}
    assert off.metrics() == on.metrics()


def test_spans_sit_on_the_profilers_clock(smoke, recorder):
    eng = _engine(*smoke, n=4)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng.run()
    start = prof.profiler.kineto_results.trace_start_ns()
    ring = sorted((s for t in spans.trees() for s in t), key=lambda s: s.start)
    assert ring and all(s.profiled for s in ring)
    events = {}
    for e in prof.events():
        events.setdefault(e.name, []).append(e.time_range.start)
    for name in {s.name for s in ring}:
        mine = [s for s in ring if s.name == name]
        theirs = sorted(events.get(name, []))
        assert len(theirs) == len(mine), name
        for s, us in zip(mine, theirs):
            if s is ring[0]:
                continue
            assert abs((spans.wall_ns(s.start) - start) / 1e3 - us) < 1000, (name, s.id)
    assert len(events["engine.kv_write"]) == eng.steps          # one write a step


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_phases(smoke, recorder, accum):
    model, params = smoke
    ocfg = adamw.AdamWConfig(warmup_steps=1, total_steps=10)
    step = build_train_step(model, ocfg, accum_steps=accum)
    gen = torch.Generator().manual_seed(0)
    t = torch.randint(0, model.cfg.vocab_size, (4, 17), generator=gen)
    batch = {"tokens": t[:, :-1], "targets": t[:, 1:],
             "positions": torch.arange(16).expand(4, 16)}
    step(params, adamw.init_opt_state(params), batch)
    (tree,) = spans.trees()
    root = tree[0]
    assert root.name == "train.step" and root.device_ns is None
    names = [s.name for s in tree[1:]]
    assert names == ["train.forward", "train.backward"] * accum + ["train.optimizer"]
    assert all(s.parent == root.id and s.device_ns is None for s in tree[1:])
    assert root.self_ns == _dur(root) - sum(_dur(s) for s in tree[1:])


def test_ring_wraps_and_parts_add_up(recorder):
    n = spans.RING // 2 + 3             # two spans a tree: the first three trees leave the ring
    outer = []
    for i in range(n):
        with spans.span("outer", clock=i) as o:
            with spans.span("inner") as inner:
                pass
            seg = spans.part("seg")
            for _ in range(3):
                with seg:
                    pass
        assert o.self_ns == _dur(o) - _dur(inner) - o.attrs["seg"] >= 0
        outer.append(o)
    trees = spans.trees()
    assert [t[0].clock for t in trees] == list(range(3, n))
    assert all([s.name for s in t] == ["outer", "inner"] for t in trees)
    s = spans.summary()
    assert (s["outer"]["count"], s["inner"]["count"], s["seg"]["count"]) == (n, n, n)
    assert s["seg"]["total_ms"] == pytest.approx(
        sum(o.attrs["seg"] for o in outer) / 1e6, abs=1e-6)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: graph capture and CUDA events have no CPU mode")


@pytest.mark.cuda
def test_graph_captures_counted_and_device_time(card, recorder):
    cfg = dataclasses.replace(get_config("stablelm_1_6b").smoke(), dtype="float32",
                              kv_cache_dtype="float32")
    model = LM(cfg, remat=None)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    eng = _engine(model, params, device="cuda", jit=True)
    eng.run()
    m = eng.metrics()
    assert m["graph_captures"] == eng.graphs.captures >= 1
    assert m["graph_capture_ms"] == eng.graphs.capture_ms > 0
    summary = spans.summary()
    assert summary["graph.capture"]["count"] == eng.graphs.captures
    for name in ("engine.decode", "engine.prefill"):
        assert summary[name]["device_count"] == summary[name]["count"]
        assert summary[name]["device_ms"] > 0
    assert summary["engine.step"]["device_ms"] is None
    eager = _engine(model, params, device="cuda", jit=False)
    eager.run()
    assert eager.metrics()["graph_captures"] == 0
    assert {r.rid: r.out for r in eager.done} == {r.rid: r.out for r in eng.done}
