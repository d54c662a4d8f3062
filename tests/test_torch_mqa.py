"""granite_34b's attention layout, MQA with 48 query heads on one KV head of
128 (a group of 48 x 128 = 6144 values, past what the paged kernel once
took), through the port's paged decode runner and serving engine against
the reference's on the same numpy inputs (f32, CPU): the granite config at
2 layers and a narrow d_model, weights from the reference's init.
Tolerance: 2e-5 of max(1, max |ref|), as tests/test_torch_serve.py."""
import dataclasses

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
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.kv_pool import KVPoolConfig  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.models.transformer import LM  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.paged_runner import paged_decode_step  # noqa: E402

TOL = 2e-5
# granite_34b's heads at full width (48 query heads, 1 KV head, head width
# 128), its gelu MLP and layernorm; depth, d_model, d_ff and vocab cut
LAYOUT = dict(n_layers=2, d_model=256, n_heads=48, n_kv_heads=1, head_dim=128, d_ff=256)


@pytest.fixture(scope="module")
def pair():
    ref_cfg = dataclasses.replace(ref_get_config("granite_34b").smoke(), **LAYOUT)
    ref = RefLM(ref_cfg, attn_impl="naive", remat=None)
    ref_params = ref.init(jax.random.key(0))
    cfg = dataclasses.replace(get_config("granite_34b").smoke(), **LAYOUT)
    assert (cfg.n_heads // cfg.n_kv_heads) * cfg.hd == 6144
    assert (cfg.activation, cfg.norm) == ("gelu", "layernorm")
    model = LM(cfg)
    params = params_from_numpy(model, jax.tree.map(np.asarray, ref_params), device="cpu")
    return ref, ref_params, model, params


def _scaled_err(ours, ref):
    ref = np.asarray(ref)
    err = np.abs(ours.detach().numpy() - ref).max()
    return float(err) / max(1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("lens", [[1, 9, 17, 30], [40, 33, 25, 16]])
def test_mqa48_paged_decode_step_matches_reference(pair, lens):
    ref, ref_params, model, params = pair
    cfg = model.cfg
    rng = np.random.default_rng(sum(lens))
    L_, nb, bs, maxb = cfg.n_layers, 32, 8, 6
    kp = rng.normal(size=(L_, nb, bs, cfg.n_kv_heads, cfg.hd)).astype(np.float32) * 4
    vp = rng.normal(size=(L_, nb, bs, cfg.n_kv_heads, cfg.hd)).astype(np.float32) * 4
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


def test_mqa48_engine_matches_reference(pair):
    """Three requests served by both engines: ids, admission and finish
    clocks, and the pool's pages equal."""
    ref, ref_params, model, params = pair
    cfg = model.cfg
    kw = dict(num_blocks=64, block_size=8, kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
              n_layers=cfg.n_layers, max_seqs=4, max_blocks_per_seq=8, blocks_per_arena=16,
              policy="puma", dtype="float32")
    r_eng = RefEngine(ref, ref_params, RefPoolConfig(**kw), use_kernel=False)
    o_eng = ServeEngine(model, params, KVPoolConfig(**kw), device="cpu")
    rng = np.random.default_rng(4)
    for i in range(3):
        p = rng.integers(0, cfg.vocab_size, size=int(rng.integers(4, 20)))
        r_eng.submit(RefRequest(rid=i, prompt=list(p), max_new=5))
        o_eng.submit(Request(rid=i, prompt=[int(t) for t in p], max_new=5))
    r_done, o_done = r_eng.run(), o_eng.run()
    assert len(o_done) == 3
    assert [r.rid for r in o_done] == [r.rid for r in r_done]
    for o, r in zip(o_done, r_done):
        assert o.out == [int(t) for t in r.out], (o.rid, o.out, r.out)
        assert (o.admit_clock, o.finish_clock) == (r.admit_clock, r.finish_clock)
    assert _scaled_err(o_eng.pool.k, r_eng.pool.k) < TOL
    assert _scaled_err(o_eng.pool.v, r_eng.pool.v) < TOL
