"""The MoE family (granite-MoE: top-k routed SwiGLU experts) in the port
against the reference on the same numpy inputs (f32, CPU): the block's
routing, capacity drops, output and aux loss (``models/moe.py``), the smoke
``granite_moe_1b_a400m`` through ``LM`` (prefill, train loss and its
gradients, the split-cache decode step), the paged decode step, the serving
engine and the serve launcher.  Weights come from the reference's
``LM.init(jax.random.key(0))`` through the bridge.

Tolerances: routing (expert ids, buffer rows, dropped slots) exact; tensors
within 2e-5 of max(1, max |ref|) as tests/test_torch_serve.py; gradients
within 1e-3 of each leaf's largest (ROADMAP.md, tolerance notes); ids equal.

Traps the routing must avoid, each named by a test: ``jax.lax.top_k`` puts
the lower expert first on ties where ``torch.topk`` promises nothing, and
``jnp.argsort`` is stable where ``torch.argsort`` is not unless asked."""
import contextlib
import dataclasses
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.launch.serve as ref_launch  # noqa: E402
from repro.configs.registry import get_config as ref_get_config  # noqa: E402
from repro.core.kv_pool import KVPoolConfig as RefPoolConfig  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models.transformer import LM as RefLM  # noqa: E402
from repro.serve.engine import Request as RefRequest  # noqa: E402
from repro.serve.engine import ServeEngine as RefEngine  # noqa: E402
from repro.serve.paged_runner import paged_decode_step as ref_paged_step  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.kv_pool import KVPoolConfig  # noqa: E402
from repro_torch.launch import serve as port_launch  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.models.transformer import LM  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.paged_runner import paged_decode_step  # noqa: E402
from repro_torch.train.step import value_and_grad  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

TOL = 2e-5
GRAD_TOL = 1e-3
ARCH = "granite_moe_1b_a400m"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several test processes at once; one torch thread per
    process keeps them from contending for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """(reference LM, its f32 params, port LM, bridged params)."""
    ref = RefLM(ref_get_config(ARCH).smoke(), attn_impl="naive", remat=None)
    ref_params = ref.init(jax.random.key(0))
    model = LM(get_config(ARCH).smoke(), remat=None)
    params = params_from_numpy(model, jax.tree.map(np.asarray, ref_params), device="cpu")
    return ref, ref_params, model, params


def _scaled_err(ours, ref):
    ref = np.asarray(ref)
    err = np.abs(ours.detach().float().numpy() - ref).max()
    return float(err) / max(1.0, float(np.abs(ref).max()))


def _cfg(**kw):
    return dataclasses.replace(get_config(ARCH).smoke(), **kw)


def _ref_route(xt, router, cfg):
    """The reference's routing lines (``repro/models/moe.py:_moe_math``),
    which it does not expose: (expert ids, buffer rows) as numpy."""
    T = xt.shape[0]
    E, K = cfg.n_experts, cfg.experts_per_tok
    C = max(8, int(cfg.moe_capacity_factor * T * K / E))
    logits = jnp.einsum("td,de->te", jnp.asarray(xt), jnp.asarray(router))
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    _, eidx = jax.lax.top_k(probs, K)
    pos = ref_moe._positions_in_expert(eidx.reshape(-1), E).reshape(T, K)
    dst = jnp.where(pos < C, eidx * C + pos, E * C)
    return np.asarray(eidx), np.asarray(dst)


def _weights(cfg, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return [rng.normal(size=s).astype(np.float32) * scale / np.sqrt(s[-2])
            for s in ((d, E), (E, d, f), (E, d, f), (E, f, d))]


def _both_math(xt, ws, cfg):
    r_out, r_aux = ref_moe._moe_math(jnp.asarray(xt), *map(jnp.asarray, ws), cfg)
    o_out, o_aux = moe._moe_math(torch.from_numpy(xt), *map(torch.from_numpy, ws), cfg)
    return (r_out, r_aux), (o_out, o_aux)


def _integer_inputs(cfg, T, seed, dup=(), bias=None):
    """Tokens and a router of small integers, so every logit is exact in any
    summation order and equal logits give equal probabilities in both
    packages.  ``dup`` lists router columns made equal, and raised through a
    constant feature so that they lead most tokens' rows; ``bias`` routes
    every token first to that expert."""
    rng = np.random.default_rng(seed)
    xt = rng.integers(-2, 3, size=(T, cfg.d_model)).astype(np.float32)
    router = rng.integers(-2, 3, size=(cfg.d_model, cfg.n_experts)).astype(np.float32)
    xt[:, 0] = 1.0
    if dup:
        router[0, dup[0]] = 30.0
        for e in dup[1:]:
            router[:, e] = router[:, dup[0]]
    if bias is not None:
        router[0, bias] = 1000.0
    return xt, router


# -- routing --------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["random", "runs", "one_expert"])
def test_positions_in_expert_match_reference_with_a_stable_sort(kind):
    """The within-expert position of each slot is its rank in slot order,
    which an unstable argsort would permute among runs of equal ids."""
    rng = np.random.default_rng(3)
    E = 8
    flat = {"random": rng.integers(0, E, 333),
            "runs": np.repeat(rng.integers(0, E, 40), rng.integers(1, 30, 40)),
            "one_expert": np.full(300, 5)}[kind].astype(np.int32)
    want = np.asarray(ref_moe._positions_in_expert(jnp.asarray(flat), E))
    got = moe._positions_in_expert(torch.from_numpy(flat).long(), E)
    assert np.array_equal(got.numpy(), want)
    for e in range(E):                      # 0, 1, 2, ... in slot order
        assert np.array_equal(got.numpy()[flat == e], np.arange((flat == e).sum()))


@pytest.mark.parametrize("dup", [(1, 2, 3), (0, 7), (2, 3, 4, 5, 6)])
def test_top_k_ties_take_the_lower_expert_as_jax_lax_top_k(dup):
    """Router columns duplicated, so their probabilities tie exactly: the
    expert ids and buffer rows equal the reference's (the lower expert
    first), and so does the output."""
    cfg = _cfg()
    xt, router = _integer_inputs(cfg, 48, seed=sum(dup), dup=dup)
    ws = _weights(cfg, 1)
    ws[0] = router
    probs, _, eidx, dst = moe._route(torch.from_numpy(xt), torch.from_numpy(router), cfg)
    tied = probs[:, list(dup)]
    assert bool((tied == tied[:, :1]).all())   # exact ties in every row
    want_e, want_dst = _ref_route(xt, router, cfg)
    assert np.array_equal(eidx.numpy(), want_e) and np.array_equal(dst.numpy(), want_dst)
    # the ties decided the picks (tied experts picked in most rows), and the
    # picked ones are always the lowest of the group, in order
    picks = [[e for e in row if e in dup] for row in want_e.tolist()]
    assert sum(bool(p) for p in picks) > len(picks) // 2
    assert all(p == sorted(dup)[:len(p)] for p in picks)
    (r_out, r_aux), (o_out, o_aux) = _both_math(xt, ws, cfg)
    assert _scaled_err(o_out, r_out) < TOL and abs(float(o_aux) - float(r_aux)) < TOL


@pytest.mark.parametrize("T", [16, 64, 200])
def test_slots_over_capacity_are_dropped_as_the_reference(T):
    """Every token routed first to one expert: the slots past its capacity
    go to the drop row, the same slots as the reference's, and the output
    (the kept slots only) matches."""
    cfg = _cfg()
    xt, router = _integer_inputs(cfg, T, seed=T, bias=3)
    ws = _weights(cfg, 2)
    ws[0] = router
    E, C = cfg.n_experts, moe.capacity(cfg, T)
    want_e, want_dst = _ref_route(xt, router, cfg)
    _, _, eidx, dst = moe._route(torch.from_numpy(xt), torch.from_numpy(router), cfg)
    assert np.array_equal(eidx.numpy(), want_e) and np.array_equal(dst.numpy(), want_dst)
    # expert 3 keeps the first C tokens' first slots and drops the rest
    dropped = dst.numpy() == E * C
    assert np.array_equal(np.nonzero(dropped[:, 0])[0], np.arange(C, T))
    xt = xt / 8                             # outputs at a moderate scale
    (r_out, r_aux), (o_out, o_aux) = _both_math(xt, ws, cfg)
    assert _scaled_err(o_out, r_out) < TOL and abs(float(o_aux) - float(r_aux)) < TOL


@pytest.mark.parametrize("T", [8, 64, 200])
def test_kept_slots_have_buffer_rows_of_their_own(T):
    """Only the drop row receives several slots, so the scatter (an atomic
    index add on the card) copies every kept slot bit for bit, whatever the
    order of the adds; the gather reads zeros for dropped slots."""
    cfg = _cfg()
    xt, router = _integer_inputs(cfg, T, seed=T + 1, bias=5 if T > 8 else None)
    xt = torch.from_numpy(xt / 7).float()
    _, gate, _, dst = moe._route(xt, torch.from_numpy(router), cfg)
    E, C = cfg.n_experts, moe.capacity(cfg, T)
    kept = dst[dst < E * C]
    assert kept.unique().numel() == kept.numel()
    buf = moe._dispatch(xt, dst, E, C).reshape(E * C, -1)
    tok = torch.arange(T)[:, None].expand_as(dst)
    assert torch.equal(buf[kept], xt[tok[dst < E * C]])
    eo = torch.randn(E, C, cfg.d_model, generator=torch.Generator().manual_seed(T))
    out = moe._combine(eo, dst, gate)
    want = torch.zeros(T, cfg.d_model)
    for t in range(T):
        for k in range(cfg.experts_per_tok):
            if dst[t, k] < E * C:
                want[t] += gate[t, k] * eo.reshape(E * C, -1)[dst[t, k]]
    assert torch.allclose(out, want, rtol=0, atol=1e-5)
    assert (T > C) == bool((dst == E * C).any())


def test_bf16_router_and_combine_run_in_x_dtype():
    """In bf16 (the card's serving type) the router is cast to x's dtype
    before its product and the gate-weighted sum runs in x's dtype, as in
    the reference: the routing equals the reference's bf16 routing and the
    output is bf16, within 2e-2 of scale of the reference's."""
    cfg = _cfg()
    xt, router = _integer_inputs(cfg, 64, seed=4, dup=(2, 5))
    ws = _weights(cfg, 3)
    ws[0] = router
    r_out, r_aux = ref_moe._moe_math(jnp.asarray(xt, jnp.bfloat16), *map(jnp.asarray, ws), cfg)
    xb = torch.from_numpy(xt).bfloat16()
    o_out, o_aux = moe._moe_math(xb, *map(torch.from_numpy, ws), cfg)
    _, _, eidx, dst = moe._route(xb, torch.from_numpy(router), cfg)
    want_e, want_dst = _ref_route(xt, router, cfg)
    assert np.array_equal(eidx.numpy(), want_e) and np.array_equal(dst.numpy(), want_dst)
    assert o_out.dtype == torch.bfloat16 and r_out.dtype == jnp.bfloat16
    assert _scaled_err(o_out, np.asarray(r_out, np.float32)) < 2e-2
    assert abs(float(o_aux) - float(r_aux)) < TOL


@pytest.mark.parametrize("T,E,K", [(1, 8, 2), (8, 8, 2), (37, 8, 2), (8, 40, 8), (300, 40, 8)])
def test_moe_math_output_and_aux_match_reference(T, E, K):
    cfg = _cfg(n_experts=E, experts_per_tok=K)
    rng = np.random.default_rng(T + E)
    xt = rng.normal(size=(T, cfg.d_model)).astype(np.float32)
    (r_out, r_aux), (o_out, o_aux) = _both_math(xt, _weights(cfg, T, scale=2.0), cfg)
    assert o_out.shape == r_out.shape and o_out.dtype == torch.float32
    assert _scaled_err(o_out, r_out) < TOL
    assert o_aux.dtype == torch.float32 and abs(float(o_aux) - float(r_aux)) < TOL * max(1, float(r_aux))


def test_capacity_is_the_reference_rule():
    cfg = get_config("granite_moe_3b_a800m")
    assert moe.capacity(cfg, 8) == 8           # decode at 8 slots: 1.25 * 64 / 40 < 8
    assert moe.capacity(cfg, 512) == 128       # a 512-token prompt
    assert moe.capacity(_cfg(), 64) == 20


# -- the model ----------------------------------------------------------------------

def _tokens(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    return toks, np.tile(np.arange(S, dtype=np.int32), (B, 1))


def test_smoke_model_builds_with_moe_leaves(pair):
    _, ref_params, model, params = pair
    assert model.family == "moe" and set(params["layers"]) == {"ln1", "attn", "ln2", "moe"}
    E, d, f = model.cfg.n_experts, model.cfg.d_model, model.cfg.d_ff
    assert tuple(params["layers"]["moe"]["wg"].shape) == (model.cfg.n_layers, E, d, f)
    assert set(ref_params["layers"]) == set(params["layers"])


def test_prefill_logits_match_reference(pair):
    ref, ref_params, model, params = pair
    toks, pos = _tokens(model.cfg, 2, 13, 6)
    rl = ref.prefill_logits(ref_params, {"tokens": jnp.asarray(toks), "positions": jnp.asarray(pos)})
    with torch.no_grad():
        ol = model.prefill_logits(params, {"tokens": torch.from_numpy(toks).long(),
                                           "positions": torch.from_numpy(pos).long()})
    assert ol.shape == rl.shape and _scaled_err(ol, rl) < TOL


def _train_batch(cfg, seed):
    toks, pos = _tokens(cfg, 3, 24, seed)
    tg = np.roll(toks, -1, axis=1)
    jb = {"tokens": jnp.asarray(toks), "positions": jnp.asarray(pos), "targets": jnp.asarray(tg)}
    tb = {k: torch.from_numpy(np.array(v)).long() for k, v in jb.items()}
    return jb, tb


def test_train_loss_carries_the_aux_loss_as_the_reference(pair):
    ref, ref_params, model, params = pair
    jb, tb = _train_batch(model.cfg, 7)
    ref_loss = float(ref.train_loss(ref_params, jb))
    with torch.no_grad():
        loss = float(model.train_loss(params, tb))
        x, pos = model._embed_inputs(params, tb)
        _, _, aux = model._run_decoder_stack(params, x, pos, None, None)
    assert abs(loss - ref_loss) < TOL
    assert aux.dtype == torch.float32 and 0.5 < float(aux) / model.cfg.n_layers < 4.0


@pytest.mark.parametrize("remat", [None, "full"])
def test_grads_match_reference(pair, remat):
    ref, ref_params, model, params = pair
    jb, tb = _train_batch(model.cfg, 8)
    ref_loss, ref_grads = jax.value_and_grad(ref.train_loss)(ref_params, jb)
    loss, grads = value_and_grad(LM(model.cfg, remat=remat).train_loss, params, tb)
    assert abs(float(loss) - float(ref_loss)) < TOL
    ref_leaves = jax.tree_util.tree_flatten_with_path(ref_grads)[0]
    ours = leaves(grads)
    assert len(ours) == len(ref_leaves)
    for (path, g_ref), g in zip(ref_leaves, ours):
        g_ref = np.asarray(g_ref)
        assert g.shape == g_ref.shape
        err = float(np.abs(g.detach().numpy() - g_ref).max())
        assert err <= GRAD_TOL * max(np.abs(g_ref).max(), 1e-3), path
    assert float(np.abs(leaves(grads["layers"]["moe"])[0].numpy()).max()) > 0


def test_decode_step_matches_reference(pair):
    """A prompt through ``decode_step`` on the split cache (the engine's
    prefill, capacity from the prompt's length), then one token."""
    ref, ref_params, model, params = pair
    toks, pos = _tokens(model.cfg, 2, 11, 5)
    rc = ref.init_cache(2, 16, recent_size=16)
    oc = model.init_cache(2, 16, recent_size=16, device="cpu")
    rl, rc = ref.decode_step(ref_params, {"tokens": jnp.asarray(toks),
                                          "positions": jnp.asarray(pos)}, rc)
    with torch.no_grad():
        ol, oc = model.decode_step(params, {"tokens": torch.from_numpy(toks).long(),
                                            "positions": torch.from_numpy(pos).long()}, oc)
    assert _scaled_err(ol, rl) < TOL
    for ours, theirs in zip(oc["layers"]["recent"], rc["layers"]["recent"]):
        assert _scaled_err(ours, theirs) < TOL
    nxt, npos = toks[:, -1:], pos[:, -1:] + 1
    rl2, _ = ref.decode_step(ref_params, {"tokens": jnp.asarray(nxt),
                                          "positions": jnp.asarray(npos)}, rc)
    with torch.no_grad():
        ol2, oc = model.decode_step(params, {"tokens": torch.from_numpy(nxt).long(),
                                             "positions": torch.from_numpy(npos).long()}, oc)
    assert _scaled_err(ol2, rl2) < TOL and oc["len_rec"] == 12


@pytest.mark.parametrize("lens", [[1, 9, 17, 30], [40, 33, 25, 16]])
def test_paged_decode_step_matches_reference(pair, lens):
    ref, ref_params, model, params = pair
    cfg = model.cfg
    rng = np.random.default_rng(sum(lens))
    L_, nb, bs, maxb = cfg.n_layers, 32, 8, 6
    kp = rng.normal(size=(L_, nb, bs, cfg.n_kv_heads, cfg.hd)).astype(np.float32) * 4
    vp = rng.normal(size=kp.shape).astype(np.float32) * 4
    B = len(lens)
    tbl = np.full((B, maxb), -1, np.int32)
    for b, n in enumerate(lens):
        need = -(-n // bs)
        tbl[b, :need] = rng.choice(nb, size=need, replace=False)
    lens = np.asarray(lens, np.int32)
    toks = rng.integers(0, cfg.vocab_size, size=(B, 1)).astype(np.int32)
    pos = (lens - 1)[:, None].astype(np.int32)
    r_logits, r_k, r_v = ref_paged_step(
        ref_params, ref.cfg, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(tbl), jnp.asarray(lens), use_kernel=True,
    )
    T = torch.from_numpy
    with torch.no_grad():
        o_logits, o_k, o_v = paged_decode_step(
            params, cfg, T(toks).long(), T(pos).long(), T(kp), T(vp), T(tbl), T(lens))
    assert o_logits.shape == r_logits.shape
    assert _scaled_err(o_logits, r_logits) < TOL
    assert _scaled_err(o_k, r_k) < TOL and _scaled_err(o_v, r_v) < TOL


# -- serving ------------------------------------------------------------------------

def _pool_kw(cfg):
    return dict(num_blocks=96, block_size=8, kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                n_layers=cfg.n_layers, max_seqs=4, max_blocks_per_seq=12,
                blocks_per_arena=16, policy="puma", dtype="float32")


def _prompts(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, int(rng.integers(3, 40))).tolist() for _ in range(n)]


def test_engine_ids_match_reference(pair):
    """Six requests, four slots: ids, admission and finish clocks equal the
    reference engine's, and the first layer's pool pages within 2e-5 of
    scale.  Deeper pages carry the reference init's growth with depth
    (ROADMAP.md, fault 4): at the third layer both packages' f32 pages lie
    up to 3.7e-5 of scale from the same prefill in float64, the port the
    nearer at 5 of these 6 prompts."""
    ref, ref_params, model, params = pair
    cfg = model.cfg
    r_eng = RefEngine(ref, ref_params, RefPoolConfig(**_pool_kw(cfg)), use_kernel=False)
    o_eng = ServeEngine(model, params, KVPoolConfig(**_pool_kw(cfg)), device="cpu")
    for i, p in enumerate(_prompts(cfg, 6, 9)):
        r_eng.submit(RefRequest(rid=i, prompt=list(p), max_new=6))
        o_eng.submit(Request(rid=i, prompt=p, max_new=6))
    r_done, o_done = r_eng.run(), o_eng.run()
    assert len(o_done) == 6 and [r.rid for r in o_done] == [r.rid for r in r_done]
    for o, r in zip(o_done, r_done):
        assert o.out == [int(t) for t in r.out], (o.rid, o.out, r.out)
        assert (o.admit_clock, o.finish_clock) == (r.admit_clock, r.finish_clock)
    assert _scaled_err(o_eng.pool.k[0], r_eng.pool.k[0]) < TOL
    assert _scaled_err(o_eng.pool.v[0], r_eng.pool.v[0]) < TOL


def test_jit_engine_on_cpu_equals_eager(pair):
    """``ServeEngine(jit=True)`` on the CPU serves the MoE model exactly as
    ``jit=False``: ids, metrics and pools bit for bit, no graph captured."""
    _, _, model, params = pair
    cfg = model.cfg
    engines = {}
    for jit in (True, False):
        eng = ServeEngine(model, params, KVPoolConfig(**_pool_kw(cfg)), device="cpu", jit=jit)
        for i, p in enumerate(_prompts(cfg, 5, 10)):
            eng.submit(Request(rid=i, prompt=p, max_new=4))
        eng.run()
        engines[jit] = eng
    a, b = engines[True], engines[False]
    assert len(a.done) == 5
    assert {r.rid: r.out for r in a.done} == {r.rid: r.out for r in b.done}
    assert a.metrics() == b.metrics()
    assert torch.equal(a.pool.k, b.pool.k) and torch.equal(a.pool.v, b.pool.v)
    assert a.graphs.captures == 0 and b.graphs is None


def test_launcher_prints_the_reference_fields(monkeypatch):
    """``repro_torch.launch.serve --arch granite_moe_1b_a400m`` prints the
    reference launcher's line (requests, tokens, contiguity, descriptors)."""
    monkeypatch.setattr("sys.argv", ["serve", "--arch", ARCH, "--requests", "6"])
    ref_out, out = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(ref_out):
        ref_launch.main()
    with contextlib.redirect_stdout(out):
        port_launch.main(["--arch", ARCH, "--requests", "6", "--device", "cpu"])

    def fields(text):
        head, tail = text.strip().split(" tok/s | ")
        return head.rsplit(",", 1)[0], tail

    assert fields(out.getvalue()) == fields(ref_out.getvalue())
    assert f"[serve] {ARCH} policy=puma: 6 requests" in out.getvalue()


def test_launch_train_runs_the_moe_family(tmp_path):
    """``repro_torch.launch.train`` goes through ``train_loss``: a few steps
    of the smoke MoE model with finite losses."""
    out = launch_train.main(["--arch", ARCH, "--steps", "3", "--seq", "32", "--batch", "2",
                             "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    losses = [m["loss"] for _, m in out["history"]]
    assert len(losses) == 3 and all(np.isfinite(losses))
