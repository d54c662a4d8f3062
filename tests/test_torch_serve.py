"""The port's paged decode runner and serving engine against the reference
(f32, CPU): runner outputs on random block tables, and the engine's
generated ids, host metrics, fork pages and block tables in the scenarios of
tests/test_serve.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as ref_get_config  # noqa: E402
from repro.core.kv_pool import KVPoolConfig as RefPoolConfig  # noqa: E402
from repro.models.transformer import LM as RefLM  # noqa: E402
from repro.serve.engine import Request as RefRequest  # noqa: E402
from repro.serve.engine import ServeEngine as RefEngine  # noqa: E402
from repro.serve.paged_runner import paged_decode_step as ref_paged_step  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.kv_pool import KVPoolConfig, PagedKVPool  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.models.transformer import LM  # noqa: E402
from repro_torch.serve.engine import MaintenanceConfig, Request, ServeEngine  # noqa: E402
from repro_torch.serve.paged_runner import paged_decode_step  # noqa: E402

TOL = 2e-5

# host metrics that must match the reference exactly
HOST_METRICS = ("mean_contiguous_fraction", "descriptors_per_tile", "live_seqs",
                "channels", "channel_balance", "clock", "steps", "tokens",
                "tokens_prefilled", "submitted", "done", "queue_depth",
                "used_fraction", "frag", "align_hits", "align_misses", "rejected",
                "cancelled", "preemptions", "injected_misses")


@pytest.fixture(scope="module")
def pair():
    ref_cfg = ref_get_config("stablelm_1_6b").smoke()
    ref = RefLM(ref_cfg, attn_impl="naive", remat=None)
    ref_params = ref.init(jax.random.key(0))
    model = LM(get_config("stablelm_1_6b").smoke())
    params = params_from_numpy(model, jax.tree.map(np.asarray, ref_params), device="cpu")
    return ref, ref_params, model, params


def _pool_kw(cfg, **kw):
    base = dict(
        num_blocks=128, block_size=8, kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
        n_layers=cfg.n_layers, max_seqs=8, max_blocks_per_seq=16,
        blocks_per_arena=16, policy="puma", dtype="float32",
    )
    base.update(kw)
    return base


def _scaled_err(ours, ref):
    """Max abs error over max(1, max |ref|): see tests/test_torch_models.py."""
    ref = np.asarray(ref)
    err = np.abs(ours.detach().numpy() - ref).max()
    return float(err) / max(1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("lens", [[1, 9, 17, 30], [1, 1, 2, 8], [40, 33, 25, 16]])
def test_paged_decode_step_matches_reference(pair, lens):
    ref, ref_params, model, params = pair
    cfg = model.cfg
    rng = np.random.default_rng(sum(lens))
    L_, nb, bs, KV, hd, maxb = cfg.n_layers, 32, 8, cfg.n_kv_heads, cfg.hd, 6
    kp = rng.normal(size=(L_, nb, bs, KV, hd)).astype(np.float32) * 4
    vp = rng.normal(size=(L_, nb, bs, KV, hd)).astype(np.float32) * 4
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
    o_logits, o_k, o_v = paged_decode_step(
        params, cfg, T(toks).long(), T(pos).long(), T(kp), T(vp), T(tbl), T(lens),
    )
    assert o_logits.shape == r_logits.shape
    assert _scaled_err(o_logits, r_logits) < TOL
    assert _scaled_err(o_k, r_k) < TOL and _scaled_err(o_v, r_v) < TOL


def _run_both(pair, pool_kw, prompts, max_new):
    ref, ref_params, model, params = pair
    r_eng = RefEngine(ref, ref_params, RefPoolConfig(**pool_kw), use_kernel=False)
    o_eng = ServeEngine(model, params, KVPoolConfig(**pool_kw), device="cpu")
    for i, p in enumerate(prompts):
        r_eng.submit(RefRequest(rid=i, prompt=list(p), max_new=max_new))
        o_eng.submit(Request(rid=i, prompt=[int(t) for t in p], max_new=max_new))
    return r_eng, r_eng.run(), o_eng, o_eng.run()


def _assert_same_serving(r_eng, r_done, o_eng, o_done):
    assert [r.rid for r in o_done] == [r.rid for r in r_done]
    for o, r in zip(o_done, r_done):
        assert o.out == [int(t) for t in r.out], (o.rid, o.out, r.out)
        assert (o.admit_clock, o.finish_clock, o.preemptions) == (
            r.admit_clock, r.finish_clock, r.preemptions)
    om, rm = o_eng.metrics(), r_eng.metrics()
    for key in HOST_METRICS:
        assert om[key] == rm[key], key


def test_engine_matches_reference_four_requests(pair):
    cfg = pair[2].cfg
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(rng.integers(4, 18)))
               for _ in range(4)]
    r_eng, r_done, o_eng, o_done = _run_both(pair, _pool_kw(cfg), prompts, 6)
    assert len(o_done) == 4
    _assert_same_serving(r_eng, r_done, o_eng, o_done)


def test_engine_matches_reference_under_pressure(pair):
    cfg = pair[2].cfg
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 64, 6) for _ in range(5)]
    r_eng, r_done, o_eng, o_done = _run_both(
        pair, _pool_kw(cfg, num_blocks=32, max_seqs=2), prompts, 4)
    assert len(o_done) == 5
    _assert_same_serving(r_eng, r_done, o_eng, o_done)
    assert o_eng.pool.pool.free_tiles() == o_eng.pool.pool.total_tiles


def test_engine_fork_matches_reference(pair):
    ref, ref_params, model, params = pair
    cfg = model.cfg
    kw = _pool_kw(cfg)
    r_eng = RefEngine(ref, ref_params, RefPoolConfig(**kw), use_kernel=False)
    o_eng = ServeEngine(model, params, KVPoolConfig(**kw), device="cpu")
    prompt = [1, 2, 3, 4, 5, 6, 7, 8, 9]
    r_eng.submit(RefRequest(rid=0, prompt=prompt, max_new=4))
    o_eng.submit(Request(rid=0, prompt=prompt, max_new=4))
    r_eng.step()
    o_eng.step()
    parent = next(iter(o_eng.live))
    assert parent == next(iter(r_eng.live))
    r_fork = r_eng.pool.fork(parent, use_kernel=True)
    before = kernels.launches["block_copy"]
    o_fork = o_eng.pool.fork(parent)
    assert kernels.launches["block_copy"] == before      # CPU: plain version
    assert o_fork == r_fork is not None
    tbl = o_eng.pool.block_table()
    np.testing.assert_array_equal(tbl, r_eng.pool.block_table())
    np.testing.assert_array_equal(o_eng.pool.seq_lens(), r_eng.pool.seq_lens())
    pb, fb = tbl[parent][tbl[parent] >= 0], tbl[o_fork][tbl[o_fork] >= 0]
    assert len(pb) == len(fb) and list(pb) != list(fb)
    for ours, theirs in ((o_eng.pool.k, r_eng.pool.k), (o_eng.pool.v, r_eng.pool.v)):
        assert torch.equal(ours[:, pb], ours[:, fb])
        assert _scaled_err(ours, theirs) < TOL
    # both continue: the fork generates the parent's continuation
    out = list(o_eng.live[parent].out)
    assert out == [int(t) for t in r_eng.live[parent].out]
    o_eng.live[o_fork] = Request(rid=1, prompt=[], max_new=4, out=list(out))
    r_eng.live[r_fork] = RefRequest(rid=1, prompt=[], max_new=4, out=list(out))
    o_outs = {r.rid: r.out for r in o_eng.run()}
    r_outs = {r.rid: [int(t) for t in r.out] for r in r_eng.run()}
    assert o_outs == r_outs
    assert o_outs[0][-3:] == o_outs[1][-3:]


def test_pool_write_paths_match_reference(pair):
    """write_prompt_kv zero-pads the last block; write_token_kv lands at
    position ntok-1 — both in place."""
    cfg = pair[2].cfg
    kw = _pool_kw(cfg)
    pool = PagedKVPool(KVPoolConfig(**kw), device="cpu")
    from repro.core.kv_pool import PagedKVPool as RefPool
    rpool = RefPool(RefPoolConfig(**kw))
    rng = np.random.default_rng(3)
    slot, rslot = pool.admit(11), rpool.admit(11)
    assert slot == rslot
    k = rng.normal(size=(11, cfg.n_kv_heads, cfg.hd)).astype(np.float32)
    pool.write_prompt_kv(slot, 1, torch.from_numpy(k), torch.from_numpy(-k))
    rpool.write_prompt_kv(rslot, 1, jnp.asarray(k), jnp.asarray(-k))
    pool.append_token(slot), rpool.append_token(rslot)
    t = rng.normal(size=(cfg.n_kv_heads, cfg.hd)).astype(np.float32)
    pool.write_token_kv(slot, 0, torch.from_numpy(t), torch.from_numpy(2 * t))
    rpool.write_token_kv(rslot, 0, jnp.asarray(t), jnp.asarray(2 * t))
    np.testing.assert_array_equal(pool.k.numpy(), np.asarray(rpool.k))
    np.testing.assert_array_equal(pool.v.numpy(), np.asarray(rpool.v))


def test_engine_refuses_maintenance(pair):
    model, params = pair[2], pair[3]
    with pytest.raises(NotImplementedError):
        ServeEngine(model, params, KVPoolConfig(**_pool_kw(model.cfg)),
                    device="cpu", maintenance=MaintenanceConfig())


def test_engine_device_defaults_to_cuda(pair, monkeypatch):
    """Without a card, an engine that was not asked for the CPU raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model, params = pair[2], pair[3]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(model, params, KVPoolConfig(**_pool_kw(model.cfg)))
    with pytest.raises(RuntimeError):
        PagedKVPool(KVPoolConfig(**_pool_kw(model.cfg)))
    with pytest.raises(RuntimeError):
        model.init(0)


def test_engine_params_device_mismatch_raises(pair):
    model = pair[2]
    params = {"embed": {"tok": torch.empty(4, 4, device="meta")}}
    with pytest.raises(ValueError):
        ServeEngine(model, params, KVPoolConfig(**_pool_kw(model.cfg)), device="cpu")
