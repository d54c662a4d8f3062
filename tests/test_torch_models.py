"""The port's model math against the reference on the same numpy inputs
(f32, CPU): norms, rope variants, attention segments, and the dense LM's
split-cache prefill with weights bridged from the reference's init."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as ref_get_config  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import rope as ref_rope  # noqa: E402
from repro.models.params import ParamDef as RefParamDef  # noqa: E402
from repro.models.transformer import LM as RefLM  # noqa: E402
from repro_torch.configs.registry import get_config, lm_archs  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import rope  # noqa: E402
from repro_torch.models.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.models.transformer import LM  # noqa: E402

TOL = 2e-5


def _err(ours, ref):
    return float(np.abs(ours.detach().numpy() - np.asarray(ref)).max())


def _scaled_err(ours, ref):
    """Max abs error over max(1, max |ref|).  Whole-model activations reach
    magnitudes of 20-80 under the reference's init, where float32 rounding
    of another summation order alone moves values by ~1e-6 of their size
    (sharpened by near one-hot softmax rows), so deep tensors are held to
    2e-5 of their scale rather than 2e-5 absolute."""
    ref = np.asarray(ref)
    return _err(ours, ref) / max(1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("norm", ["layernorm", "rmsnorm"])
def test_apply_norm(norm):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3 + 1
    p = {"scale": rng.normal(size=64).astype(np.float32)}
    if norm == "layernorm":
        p["bias"] = rng.normal(size=64).astype(np.float32)
    ref = ref_layers.apply_norm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    ours = layers.apply_norm({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x))
    assert _err(ours, ref) < TOL


@pytest.mark.parametrize("arch,kind", [
    ("stablelm_1_6b", "rope"), ("chatglm3_6b", "rope2d"), ("qwen2_vl_72b", "mrope"),
])
def test_apply_rope(arch, kind):
    cfg = get_config(arch).smoke()
    ref_cfg = ref_get_config(arch).smoke()
    assert cfg.rope == kind == ref_cfg.rope
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 4, cfg.hd)).astype(np.float32)
    shape = (2, 7, 3) if kind == "mrope" else (2, 7)
    pos = rng.integers(0, 40, size=shape).astype(np.int32)
    ref = ref_rope.apply_rope(ref_cfg, jnp.asarray(x), jnp.asarray(pos))
    ours = rope.apply_rope(cfg, torch.from_numpy(x), torch.from_numpy(pos).long())
    assert _err(ours, ref) < TOL


@pytest.mark.parametrize("full_width", [False, True])
@pytest.mark.parametrize("shape", [(4, 1, 3), (1, 9, 3), (3, 5, 3)])
def test_apply_mrope_at_decode_and_prefill_shapes(shape, full_width):
    """M-RoPE at the engine's decode (B, 1, 3) and prefill (1, S, 3)
    positions, at the smoke sections (4, 6, 6) of head width 32 and the
    full width's (16, 24, 24) of 128, with each stream its own positions."""
    cfg, ref_cfg = get_config("qwen2_vl_72b"), ref_get_config("qwen2_vl_72b")
    if not full_width:
        cfg, ref_cfg = cfg.smoke(), ref_cfg.smoke()
    assert cfg.mrope_sections == ((16, 24, 24) if full_width else (4, 6, 6))
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=shape[:2] + (4, cfg.hd)).astype(np.float32)
    pos = rng.integers(0, 5000, size=shape).astype(np.int32)
    ref = ref_rope.apply_rope(ref_cfg, jnp.asarray(x), jnp.asarray(pos))
    ours = rope.apply_rope(cfg, torch.from_numpy(x), torch.from_numpy(pos).long())
    assert _err(ours, ref) < TOL


def _qkv(seed, B, Sq, Sk, H, KV, hd):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, H, hd)).astype(np.float32),
            rng.normal(size=(B, Sk, KV, hd)).astype(np.float32),
            rng.normal(size=(B, Sk, KV, hd)).astype(np.float32))


@pytest.mark.parametrize("kv_len,kv_offset", [(9, 0), (0, 0), (5, 4)])
def test_attention_with_lse_and_merge(kv_len, kv_offset):
    q, k, v = _qkv(2, 2, 3, 9, 4, 2, 16)
    q_pos = np.array([[6, 7, 8], [10, 11, 12]], np.int32)
    kw = dict(kv_len=kv_len, kv_offset=kv_offset, scale=0.25)
    ro, rl = ref_attn._attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_pos=jnp.asarray(q_pos), **kw)
    oo, ol = attn._attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_pos=torch.from_numpy(q_pos).long(), **kw)
    assert _err(oo, ro) < TOL and _err(ol, rl) < TOL
    # merge with a second segment (and with an all-empty one)
    q2, k2, v2 = _qkv(3, 2, 3, 4, 4, 2, 16)
    ro2, rl2 = ref_attn._attention_with_lse(
        jnp.asarray(q), jnp.asarray(k2), jnp.asarray(v2), kv_len=4, kv_offset=9,
        scale=0.25, q_pos=jnp.asarray(q_pos + 9))
    oo2, ol2 = attn._attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k2), torch.from_numpy(v2), kv_len=4,
        kv_offset=9, scale=0.25, q_pos=torch.from_numpy(q_pos + 9).long())
    ref_m = ref_attn.merge_segments([(ro, rl), (ro2, rl2)])
    our_m = attn.merge_segments([(oo, ol), (oo2, ol2)])
    assert _err(our_m, ref_m) < TOL


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("impl", ["naive", "chunked"])
def test_inner_attention(impl, causal):
    q, k, v = _qkv(4, 2, 33, 40, 4, 2, 16)
    kw = dict(impl=impl, causal=causal, kv_len=37, scale=0.25, q_offset=5)
    ref = ref_attn._inner_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    ours = attn._inner_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kw)
    assert _err(ours, ref) < TOL


def test_chunked_attention_ragged_blocks():
    q, k, v = _qkv(5, 1, 4, 70, 4, 4, 8)
    kw = dict(causal=True, kv_len=70, scale=0.3, q_offset=66, block_k=32)
    ref = ref_attn._chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    ours = attn._chunked_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kw)
    assert _err(ours, ref) < TOL


def test_pallas_impl_matches_reference_pallas_path():
    """On the CPU the pallas path takes the flash kernel's plain version and
    matches the reference's pallas path (its Pallas kernel in interpret mode)
    at 2e-5, causal and not."""
    q, k, v = _qkv(6, 2, 40, 40, 4, 2, 32)
    for causal in (True, False):
        kw = dict(impl="pallas", causal=causal, kv_len=40, scale=32 ** -0.5)
        ref = ref_attn._inner_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
        ours = attn._inner_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), **kw)
        assert ours.shape == q.shape and _err(ours, ref) < TOL


@pytest.fixture(scope="module")
def stablelm_pair():
    ref_cfg = ref_get_config("stablelm_1_6b").smoke()
    ref = RefLM(ref_cfg, attn_impl="naive", remat=None)
    ref_params = ref.init(jax.random.key(0))
    model = LM(get_config("stablelm_1_6b").smoke())
    params = params_from_numpy(model, jax.tree.map(np.asarray, ref_params), device="cpu")
    return ref, ref_params, model, params


def test_bridge_keeps_paths_and_dtypes(stablelm_pair):
    ref, ref_params, model, params = stablelm_pair
    back = params_to_numpy(params)
    flat_ref = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, ref_params))[0]
    assert len(flat_ref) == len(jax.tree.leaves(back))
    for path, leaf in flat_ref:
        node = back
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, leaf)
    assert params["layers"]["ln1"]["scale"].dtype == torch.float32
    assert params["layers"]["attn"]["wq"].dtype == model.dtype


def test_bridge_casts_matmul_weights_only():
    cfg = dataclasses.replace(get_config("stablelm_1_6b").smoke(), dtype="bfloat16")
    model = LM(cfg)
    tree = params_to_numpy(model.init(0, device="cpu"))
    params = params_from_numpy(model, tree, device="cpu")
    assert params["embed"]["head"].dtype == torch.bfloat16
    assert params["final_ln"]["bias"].dtype == torch.float32


def test_init_follows_reference_rule():
    """fan-in is shape[-2]: a stacked wq (L, d, H, hd) draws with std 1/sqrt(H)."""
    cfg = dataclasses.replace(get_config("stablelm_1_6b").smoke(), d_model=256, n_heads=8)
    params = LM(cfg).init(torch.Generator().manual_seed(3), device="cpu")
    wq = params["layers"]["attn"]["wq"]
    assert abs(wq.std().item() - 8 ** -0.5) < 0.02
    assert abs(params["embed"]["tok"].std().item() - 0.02) < 0.002
    assert torch.all(params["layers"]["ln1"]["scale"] == 1)
    assert params["embed"]["tok"].shape[0] == layers.pad_vocab(cfg) == 2048


def test_decode_step_prefill_matches_reference(stablelm_pair):
    ref, ref_params, model, params = stablelm_pair
    rng = np.random.default_rng(5)
    S = 11
    toks = rng.integers(0, model.cfg.vocab_size, size=(2, S)).astype(np.int32)
    pos = np.tile(np.arange(S, dtype=np.int32), (2, 1))
    ref_cache = ref.init_cache(2, S, recent_size=S)
    rl, rc = ref.decode_step(ref_params, {"tokens": jnp.asarray(toks), "positions": jnp.asarray(pos)}, ref_cache)
    cache = model.init_cache(2, S, recent_size=S, device="cpu")
    ol, oc = model.decode_step(params, {"tokens": torch.from_numpy(toks).long(),
                                        "positions": torch.from_numpy(pos).long()}, cache)
    assert ol.shape == rl.shape and _scaled_err(ol, rl) < TOL
    for ours, theirs in zip(oc["layers"]["recent"], rc["layers"]["recent"]):
        assert _scaled_err(ours, theirs) < TOL
    assert oc["len_rec"] == int(rc["len_rec"]) == S
    # one more decode step on top of the filled ring
    nxt = toks[:, -1:]
    rl2, _ = ref.decode_step(ref_params, {"tokens": jnp.asarray(nxt), "positions": jnp.asarray(pos[:, -1:] + 1)},
                             jax.tree.map(lambda a: a, rc) | {"layers": {
                                 "main": rc["layers"]["main"],
                                 "recent": tuple(jnp.pad(a, ((0, 0), (0, 0), (0, 1), (0, 0), (0, 0)))
                                                 for a in rc["layers"]["recent"])}})
    oc["layers"]["recent"] = tuple(torch.nn.functional.pad(a, (0, 0, 0, 0, 0, 1))
                                   for a in oc["layers"]["recent"])
    ol2, _ = model.decode_step(params, {"tokens": torch.from_numpy(nxt).long(),
                                        "positions": torch.from_numpy(pos[:, -1:] + 1).long()}, oc)
    assert _scaled_err(ol2, rl2) < TOL


def test_prefill_logits_matches_reference(stablelm_pair):
    ref, ref_params, model, params = stablelm_pair
    rng = np.random.default_rng(6)
    toks = rng.integers(0, 512, size=(2, 9)).astype(np.int32)
    pos = np.tile(np.arange(9, dtype=np.int32), (2, 1))
    rl = ref.prefill_logits(ref_params, {"tokens": jnp.asarray(toks), "positions": jnp.asarray(pos)})
    ol = model.prefill_logits(params, {"tokens": torch.from_numpy(toks).long(),
                                       "positions": torch.from_numpy(pos).long()})
    assert _scaled_err(ol, rl) < TOL


@pytest.mark.parametrize("arch", lm_archs())
def test_every_family_builds_the_reference_tree(arch):
    """Every model family is ported: each config's ``LM`` builds, with and
    without remat, and its params have the reference's paths and shapes."""
    cfg = get_config(arch).smoke()
    for remat in (None, "full", "dots"):
        assert LM(cfg, remat=remat).remat == remat
    ours = jax.tree_util.tree_flatten_with_path(params_to_numpy(LM(cfg).init(0, device="cpu")))[0]
    theirs = jax.tree_util.tree_flatten_with_path(
        RefLM(ref_get_config(arch).smoke(), remat=None).param_defs(),
        is_leaf=lambda d: isinstance(d, RefParamDef))[0]
    assert [(p, a.shape) for p, a in ours] == [(p, tuple(d.shape)) for p, d in theirs]


def test_puma_paper_config_raises_until_dram_model_is_ported():
    """The DRAM model is ported: the paper's config builds and equals the
    reference's, geometry and address map included."""
    cfg, ref = get_config("puma_paper"), ref_get_config("puma_paper")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert cfg.address_map().total_bytes == ref.address_map().total_bytes


@pytest.mark.parametrize("arch", ["stablelm_1_6b", "chatglm3_6b", "granite_moe_1b_a400m",
                                  "zamba2_7b", "rwkv6_7b", "qwen2_vl_72b",
                                  "seamless_m4t_medium"])
def test_configs_equal_reference(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(ref_get_config(arch))
