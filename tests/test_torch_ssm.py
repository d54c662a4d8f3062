"""The port's ssm (RWKV6) and hybrid (Zamba2) families and its decay-attention
math against the reference on the same numpy inputs (CPU, f32).

* ``linear_scan``: the chunked form, the one-step decode and the sequential
  oracle, with and without the bonus, chaining an initial state and decoding
  after a prefill, at the reference's 2e-3 (``tests/test_linear_scan.py``);
* the kernel's wrapper (its plain version on CPU tensors) against the
  reference's Pallas kernel in interpret mode at ``tests/test_kernel_decay.py``'s
  shapes, 2e-3;
* the RWKV6 time-mix and channel-mix and the Mamba2 block, and the whole
  smoke models (``train_loss``, ``prefill_logits``, ``decode_step`` over a
  prompt and then one token), with weights bridged from the reference's
  ``LM.init`` and the leaves its init leaves zero (inert) set to seeded
  nonzero values; whole-model tensors at 2e-5 of max(1, max |ref|);
* the reference's own decode-vs-teacher-forcing (2e-4) and split-cache flush
  (5e-4) checks, on the port; the flush where the reference's clamps
  (ROADMAP.md, fault 5); the dispatch rule of ``chunked_decay_attention``.
"""
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as ref_get_config  # noqa: E402
from repro.kernels.decay_attention import ops as ref_decay_ops  # noqa: E402
from repro.models import linear_scan as ref_ls  # noqa: E402
from repro.models import mamba2 as ref_m2  # noqa: E402
from repro.models import rwkv6 as ref_r6  # noqa: E402
from repro.models.transformer import LM as RefLM  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels.decay_attention import ops as decay_ops  # noqa: E402
from repro_torch.models import linear_scan as ls  # noqa: E402
from repro_torch.models import mamba2 as m2  # noqa: E402
from repro_torch.models import rwkv6 as r6  # noqa: E402
from repro_torch.models.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.models.inert import inert_leaves, perturb_inert  # noqa: E402
from repro_torch.models.transformer import LM  # noqa: E402

SCAN_TOL = 2e-3     # the reference's decay-attention tolerance
MODEL_TOL = 2e-5    # of max(1, max |ref|), as tests/test_torch_models.py
# Tolerance note (ROADMAP.md): zamba2's Mamba states below the shared
# attention block match to 8.3e-7 of their scale, those after it to 2.7e-5
# (scripts/ssm_cpu_checks.py, 9 seeds of weights and perturbation): the
# block's attention, its projections drawn at the reference's fan-in
# (ROADMAP.md, fault 4), amplifies float32 rounding of the residual stream
MAMBA_STATE_TOL = 5e-5

# the reference's functions, jitted: eager JAX retraces every scan per call
ref_chunked = jax.jit(ref_ls.chunked_decay_attention, static_argnames=("return_state",))
ref_time_mix = jax.jit(ref_r6.apply_time_mix, static_argnums=1)
ref_channel_mix = jax.jit(ref_r6.apply_channel_mix, static_argnums=1)
ref_mamba = jax.jit(ref_m2.apply_mamba, static_argnums=1)


@functools.lru_cache(maxsize=None)
def _ref_model(arch, seed):
    """The reference's smoke model (naive attention, no remat), its jitted
    entry points, and its ``LM.init(jax.random.key(seed))`` as numpy."""
    ref = RefLM(ref_get_config(arch).smoke(), attn_impl="naive", remat=None)
    fns = types.SimpleNamespace(**{name: jax.jit(getattr(ref, name)) for name in (
        "train_loss", "prefill_logits", "decode_step")}, flush_cache=ref.flush_cache,
        init_cache=ref.init_cache)
    tree = jax.tree.map(np.asarray, jax.jit(ref.init)(jax.random.key(seed)))
    return fns, tree


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several test processes at once; one torch thread per
    process keeps them from contending for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _err(ours, ref):
    return float(np.abs(ours.detach().float().numpy() - np.asarray(ref, np.float32)).max())


def _scaled_err(ours, ref):
    ref = np.asarray(ref, np.float32)
    return _err(ours, ref) / max(1.0, float(np.abs(ref).max()))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _scan_inputs(B, S, H, dk, dv, seed=0, bonus=False):
    """tests/test_linear_scan.py's inputs, and a bonus of scale 0.2."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, dk)).astype(np.float32)
    k = (rng.normal(size=(B, S, H, dk)) * 0.3).astype(np.float32)
    v = rng.normal(size=(B, S, H, dv)).astype(np.float32)
    lw = (-np.abs(rng.normal(size=(B, S, H, dk))) * 0.3).astype(np.float32)
    u = (rng.normal(size=(H, dk)) * 0.2).astype(np.float32) if bonus else None
    return q, k, v, lw, u


def _pair(args):
    """(jax arrays, torch tensors) of the same numpy arrays (None kept)."""
    return ([None if a is None else jnp.asarray(a) for a in args],
            [None if a is None else _t(a) for a in args])


# -- linear_scan ----------------------------------------------------------------

@pytest.mark.parametrize("bonus", [False, True])
@pytest.mark.parametrize("B,S,H,dk,dv", [(2, 64, 2, 16, 16), (1, 45, 3, 8, 24),
                                         (1, 7, 1, 5, 3)])
def test_chunked_matches_reference(B, S, H, dk, dv, bonus):
    q, k, v, lw, u = _scan_inputs(B, S, H, dk, dv, seed=S, bonus=bonus)
    h0 = np.random.default_rng(1).normal(size=(B, H, dk, dv)).astype(np.float32)
    (jq, jk, jv, jw, ju, jh), (tq, tk, tv, tw, tu, th) = _pair((q, k, v, lw, u, h0))
    for init in (None, "h0"):
        ry, rs = ref_chunked(
            jq, jk, jv, jw, bonus=ju, initial_state=jh if init else None, return_state=True)
        oy, os_ = ls.chunked_decay_attention(
            tq, tk, tv, tw, bonus=tu, initial_state=th if init else None, return_state=True)
        assert oy.shape == ry.shape and os_.shape == rs.shape
        assert _err(oy, ry) < SCAN_TOL and _err(os_, rs) < SCAN_TOL


@pytest.mark.parametrize("bonus", [False, True])
def test_step_and_sequential_oracle_match_reference(bonus):
    q, k, v, lw, u = _scan_inputs(2, 19, 2, 8, 12, seed=3, bonus=bonus)
    state = np.random.default_rng(4).normal(size=(2, 2, 8, 12)).astype(np.float32)
    (jq, jk, jv, jw, ju, js), (tq, tk, tv, tw, tu, ts) = _pair((q, k, v, lw, u, state))
    ry, rs = ref_ls.decay_attention_step(jq[:, 0], jk[:, 0], jv[:, 0], jw[:, 0], js, bonus=ju)
    oy, os_ = ls.decay_attention_step(tq[:, 0], tk[:, 0], tv[:, 0], tw[:, 0], ts, bonus=tu)
    assert _err(oy, ry) < SCAN_TOL and _err(os_, rs) < SCAN_TOL
    ry, rs = ref_ls.decay_attention_ref(jq, jk, jv, jw, bonus=ju, initial_state=js,
                                        return_state=True)
    oy, os_ = ls.decay_attention_ref(tq, tk, tv, tw, bonus=tu, initial_state=ts,
                                     return_state=True)
    assert _err(oy, ry) < SCAN_TOL and _err(os_, rs) < SCAN_TOL
    # and the port's chunked form against the port's own oracle
    cy, cs = ls.chunked_decay_attention(tq, tk, tv, tw, bonus=tu, initial_state=ts,
                                        return_state=True)
    assert _err(cy, oy.numpy()) < SCAN_TOL and _err(cs, os_.numpy()) < SCAN_TOL


def test_initial_state_chaining_and_decode_after_prefill():
    """tests/test_linear_scan.py's two properties, on the port and against
    the reference: a pass equals two halves chaining the state, and a
    prefill of S-1 tokens then one step equals the prefill of S."""
    q, k, v, lw, _ = _scan_inputs(1, 40, 2, 8, 8)
    tq, tk, tv, tw = map(_t, (q, k, v, lw))
    y_full, s_full = ls.chunked_decay_attention(tq, tk, tv, tw, return_state=True)
    y1, s1 = ls.chunked_decay_attention(tq[:, :20], tk[:, :20], tv[:, :20], tw[:, :20],
                                        return_state=True)
    y2, s2 = ls.chunked_decay_attention(tq[:, 20:], tk[:, 20:], tv[:, 20:], tw[:, 20:],
                                        initial_state=s1, return_state=True)
    assert _err(torch.cat([y1, y2], 1), y_full.numpy()) < SCAN_TOL
    assert _err(s2, s_full.numpy()) < SCAN_TOL
    ry = ref_chunked(*map(jnp.asarray, (q, k, v, lw)))
    assert _err(y_full, ry) < SCAN_TOL

    q, k, v, lw, _ = _scan_inputs(2, 17, 2, 8, 8)
    u = (np.random.default_rng(0).normal(size=(2, 8)) * 0.2).astype(np.float32)
    tq, tk, tv, tw = map(_t, (q, k, v, lw))
    for bonus in (None, _t(u)):
        y_full, s_full = ls.chunked_decay_attention(tq, tk, tv, tw, bonus=bonus,
                                                    return_state=True)
        _, s_head = ls.chunked_decay_attention(tq[:, :-1], tk[:, :-1], tv[:, :-1],
                                               tw[:, :-1], bonus=bonus, return_state=True)
        y1, s1 = ls.decay_attention_step(tq[:, -1], tk[:, -1], tv[:, -1], tw[:, -1], s_head,
                                         bonus=bonus)
        assert _err(y1, y_full[:, -1].numpy()) < SCAN_TOL
        assert _err(s1, s_full.numpy()) < SCAN_TOL


# -- the kernel's wrapper (plain version on the CPU) against the JAX kernel ----

# tests/test_kernel_decay.py's shapes (B, S, H, dk, dv, use_bonus), then its
# three-chunk state carry (constant decay -0.05)
KERNEL_SHAPES = [
    (2, 64, 2, 16, 16, False),
    (1, 100, 3, 32, 32, True),
    (2, 32, 1, 8, 24, True),
    (1, 33, 2, 64, 64, False),
    (1, 96, 1, 16, 16, "carry"),
]


def kernel_case_inputs(B, S, H, dk, dv, use_bonus):
    """The reference kernel test's inputs (seed 0; seed 1 and a constant
    decay for the state-carry case)."""
    if use_bonus == "carry":
        rng = np.random.default_rng(1)
        q = rng.normal(size=(B, S, H, dk)).astype(np.float32)
        k = (rng.normal(size=(B, S, H, dk)) * 0.3).astype(np.float32)
        v = rng.normal(size=(B, S, H, dv)).astype(np.float32)
        return q, k, v, np.full((B, S, H, dk), -0.05, np.float32), None
    rng = np.random.default_rng(0)
    q = rng.normal(size=(B, S, H, dk)).astype(np.float32)
    k = (rng.normal(size=(B, S, H, dk)) * 0.3).astype(np.float32)
    v = rng.normal(size=(B, S, H, dv)).astype(np.float32)
    lw = (-np.abs(rng.normal(size=(B, S, H, dk))) * 0.3).astype(np.float32)
    u = (rng.normal(size=(H, dk)) * 0.2).astype(np.float32) if use_bonus else None
    return q, k, v, lw, u


@pytest.mark.parametrize("case", KERNEL_SHAPES, ids=lambda c: "-".join(map(str, c)))
def test_kernel_wrapper_matches_jax_kernel(case):
    args = kernel_case_inputs(*case)
    (jq, jk, jv, jw, ju), (tq, tk, tv, tw, tu) = _pair(args)
    want = ref_decay_ops.decay_attention(jq, jk, jv, jw, bonus=ju, use_kernel=True)
    before = kernels.launches["decay_attention"]
    got = decay_ops.decay_attention(tq, tk, tv, tw, bonus=tu)
    assert kernels.launches["decay_attention"] == before   # plain version on the CPU
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _err(got, want) < SCAN_TOL


def test_kernel_wrapper_state_and_checks():
    q, k, v, lw, u = _scan_inputs(2, 40, 2, 8, 8, bonus=True)
    tq, tk, tv, tw, tu = map(_t, (q, k, v, lw, u))
    h0 = torch.randn(2, 2, 8, 8, generator=torch.Generator().manual_seed(0))
    y, hT = decay_ops.decay_attention(tq, tk, tv, tw, bonus=tu, initial_state=h0,
                                      return_state=True)
    ry, rs = ref_chunked(*map(jnp.asarray, (q, k, v, lw)), bonus=jnp.asarray(u),
                         initial_state=jnp.asarray(h0.numpy()), return_state=True)
    assert _err(y, ry) < SCAN_TOL and _err(hT, rs) < SCAN_TOL
    with pytest.raises(ValueError):
        decay_ops.decay_attention(tq, tk, tv[:, :, :1], tw)
    with pytest.raises(ValueError):
        decay_ops.decay_attention(tq, tk, tv, tw, bonus=tu[:, :3])
    tq.requires_grad_(True)
    with pytest.raises(RuntimeError):
        decay_ops.decay_attention(tq, tk, tv, tw)


# -- the dispatch rule ------------------------------------------------------------

def _fake(device, requires_grad=False):
    return types.SimpleNamespace(device=torch.device(device), requires_grad=requires_grad)


def test_dispatch_rule_three_branches():
    """CPU -> plain; CUDA outside autograd -> kernel; CUDA under autograd ->
    plain (the kernel has no backward)."""
    assert not ls.takes_kernel(_fake("cpu"), _fake("cpu"))
    assert ls.takes_kernel(_fake("cuda"), _fake("cuda"), None)
    assert not ls.takes_kernel(_fake("cuda"), _fake("cuda", requires_grad=True))
    with torch.no_grad():
        assert ls.takes_kernel(_fake("cuda"), _fake("cuda", requires_grad=True))
    # CPU tensors take the plain math, and it carries gradients
    q, k, v, lw, u = map(_t, _scan_inputs(1, 40, 2, 8, 8, bonus=True))
    q.requires_grad_(True)
    before = kernels.launches["decay_attention"]
    y = ls.chunked_decay_attention(q, k, v, lw, bonus=u)
    y.sum().backward()
    assert kernels.launches["decay_attention"] == before
    assert q.grad is not None and bool(torch.isfinite(q.grad).all())
    want = ls.chunked_decay_ref(q.detach(), k, v, lw, bonus=u)
    assert torch.equal(y.detach(), want)


# -- the blocks -------------------------------------------------------------------

def _perturb(tree, family, seed=0):
    """A copy of ``tree`` with the leaves the reference's init leaves zero
    set to seeded values by the port's one rule (``models/inert.py``)."""
    tree = jax.tree.map(np.array, tree)
    perturb_inert(family, tree["layers"], seed)
    return tree


@pytest.mark.parametrize("arch,family", [("rwkv6_7b", "ssm"), ("zamba2_7b", "hybrid")])
def test_inert_rule_sets_every_zero_init_leaf(arch, family):
    """The rule names exactly the layer leaves the init draws as zeros, and
    gives each a seeded float32 array of its shape with nonzero values."""
    model = LM(get_config(arch).smoke(), remat=None)
    defs = model.param_defs()["layers"]
    zeros = sorted((g, n) for g, leaves in defs.items() for n, d in leaves.items()
                   if d.init == "zeros")
    layers = params_to_numpy(model.init(0, device="cpu"))["layers"]
    assert sorted(inert_leaves(family, layers)) == zeros
    a = perturb_inert(family, {g: dict(v) for g, v in layers.items()}, 3)
    b = perturb_inert(family, {g: dict(v) for g, v in layers.items()}, 3)
    for g, n in zeros:
        assert a[g][n].dtype == np.float32 and a[g][n].shape == tuple(defs[g][n].shape)
        assert np.array_equal(a[g][n], b[g][n]) and np.count_nonzero(a[g][n]) == a[g][n].size


@pytest.fixture(scope="module")
def rwkv_layer():
    ref_cfg = ref_get_config("rwkv6_7b").smoke()
    tree = _perturb(_ref_model("rwkv6_7b", 0)[1], "ssm")
    lp = jax.tree.map(lambda a: a[0], tree["layers"])
    return ref_cfg, get_config("rwkv6_7b").smoke(), lp


def _tree_t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)), tree)


def test_apply_time_mix_matches_reference(rwkv_layer):
    ref_cfg, cfg, lp = rwkv_layer
    H, hd = cfg.d_model // cfg.ssm_head_dim, cfg.ssm_head_dim
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 37, cfg.d_model)).astype(np.float32)
    st = [rng.normal(size=s).astype(np.float32)
          for s in ((2, cfg.d_model), (2, cfg.d_model), (2, H, hd, hd))]
    jp, tp = jax.tree.map(jnp.asarray, lp["tm"]), _tree_t(lp["tm"])
    ro, _ = ref_time_mix(jp, ref_cfg, jnp.asarray(x))
    oo, none = r6.apply_time_mix(tp, cfg, _t(x))
    assert none is None and _err(oo, ro) < MODEL_TOL * max(1.0, float(np.abs(ro).max()))
    for S in (37, 1):       # a prompt with a state, and one decode step
        rstate = ref_r6.RwkvState(*map(jnp.asarray, st))
        ostate = r6.RwkvState(*map(_t, st))
        ro, (rs, rw) = ref_time_mix(jp, ref_cfg, jnp.asarray(x[:, :S]), rstate)
        oo, (os_, ow) = r6.apply_time_mix(tp, cfg, _t(x[:, :S]), ostate)
        assert _scaled_err(oo, ro) < MODEL_TOL
        assert _err(os_, rs) == 0.0 and _err(ow, rw) < SCAN_TOL


def test_apply_channel_mix_matches_reference(rwkv_layer):
    ref_cfg, cfg, lp = rwkv_layer
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 9, cfg.d_model)).astype(np.float32)
    prev = rng.normal(size=(2, cfg.d_model)).astype(np.float32)
    jp, tp = jax.tree.map(jnp.asarray, lp["cm"]), _tree_t(lp["cm"])
    for p in (None, prev):
        ro, rs = ref_channel_mix(jp, ref_cfg, jnp.asarray(x),
                                          None if p is None else jnp.asarray(p))
        oo, os_ = r6.apply_channel_mix(tp, cfg, _t(x), None if p is None else _t(p))
        assert _scaled_err(oo, ro) < MODEL_TOL
        assert (rs is None) == (os_ is None)


def test_apply_mamba_matches_reference():
    ref_cfg = ref_get_config("zamba2_7b").smoke()
    cfg = get_config("zamba2_7b").smoke()
    tree = _perturb(_ref_model("zamba2_7b", 0)[1], "hybrid")
    mp = jax.tree.map(lambda a: a[0], tree["layers"]["mamba"])
    jp, tp = jax.tree.map(jnp.asarray, mp), _tree_t(mp)
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 41, cfg.d_model)).astype(np.float32)
    d_in = cfg.ssm_expand * cfg.d_model
    H, ns, hd = d_in // cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_head_dim
    conv = rng.normal(size=(2, cfg.ssm_conv - 1, d_in + 2 * ns)).astype(np.float32)
    ssd = rng.normal(size=(2, H, ns, hd)).astype(np.float32)
    ro, _ = ref_mamba(jp, ref_cfg, jnp.asarray(x))
    oo, _ = m2.apply_mamba(tp, cfg, _t(x))
    assert _scaled_err(oo, ro) < MODEL_TOL
    for S in (41, 1):
        ro, rs = ref_mamba(jp, ref_cfg, jnp.asarray(x[:, :S]),
                                    ref_m2.MambaState(jnp.asarray(conv), jnp.asarray(ssd)))
        oo, os_ = m2.apply_mamba(tp, cfg, _t(x[:, :S]), m2.MambaState(_t(conv), _t(ssd)))
        assert _scaled_err(oo, ro) < MODEL_TOL
        assert _scaled_err(os_.conv, rs.conv) < MODEL_TOL and _err(os_.ssd, rs.ssd) < SCAN_TOL


# -- whole smoke models --------------------------------------------------------------

ARCHS = {"rwkv6_7b": "ssm", "zamba2_7b": "hybrid"}


@pytest.fixture(scope="module", params=list(ARCHS))
def model_pair(request):
    arch = request.param
    ref, tree = _ref_model(arch, 0)
    tree = _perturb(tree, ARCHS[arch])
    model = LM(get_config(arch).smoke(), remat=None)
    params = params_from_numpy(model, tree, device="cpu")
    return arch, ref, jax.tree.map(jnp.asarray, tree), model, params, tree


def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    return toks[:, :S], toks[:, 1:], pos


def test_bridge_carries_ssm_and_hybrid_trees(model_pair):
    arch, ref, ref_params, model, params, tree = model_pair
    back = params_to_numpy(params)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat) == len(jax.tree.leaves(back))
    for path, leaf in flat:
        node = back
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, leaf)
    layers = params["layers"]
    if arch == "rwkv6_7b":
        f32 = [layers["tm"][n] for n in ("w0", "u", "ln_scale")]
        assert layers["tm"]["mu_r"].dtype == model.dtype
    else:
        f32 = [layers["mamba"][n] for n in ("dt_bias", "A_log", "norm")]
        assert params["shared_attn"]["attn"]["wq"].dtype == model.dtype
    assert all(t.dtype == torch.float32 for t in f32)


def test_train_loss_and_prefill_logits_match_reference(model_pair):
    arch, ref, ref_params, model, params, _ = model_pair
    toks, tgts, pos = _batch(model.cfg, 2, 40, seed=1)
    rb = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgts),
          "positions": jnp.asarray(pos)}
    ob = {"tokens": _t(toks).long(), "targets": _t(tgts).long(), "positions": _t(pos).long()}
    rl = float(ref.train_loss(ref_params, rb))
    ol = model.train_loss(params, ob).item()
    assert abs(ol - rl) / max(1.0, abs(rl)) < MODEL_TOL
    assert _scaled_err(model.prefill_logits(params, ob), ref.prefill_logits(ref_params, rb)) < MODEL_TOL


def test_decode_step_matches_reference(model_pair):
    """A prompt of 35 tokens through ``decode_step`` (the chunked form with a
    state), then one token (the one-step form): logits and every state and
    cache (the Mamba states at ``MAMBA_STATE_TOL``)."""
    arch, ref, ref_params, model, params, _ = model_pair
    S = 35
    toks, _, pos = _batch(model.cfg, 2, S + 1, seed=2)
    rc = ref.init_cache(2, S + 1)
    oc = model.init_cache(2, S + 1, device="cpu")
    for sl in (slice(0, S), slice(S, S + 1)):
        rl, rc = ref.decode_step(ref_params, {"tokens": jnp.asarray(toks[:, sl]),
                                              "positions": jnp.asarray(pos[:, sl])}, rc)
        ol, oc = model.decode_step(params, {"tokens": _t(toks[:, sl]).long(),
                                            "positions": _t(pos[:, sl]).long()}, oc)
        assert _scaled_err(ol, rl) < MODEL_TOL
        ours = jax.tree_util.tree_flatten_with_path(oc["layers"])[0]
        theirs = jax.tree.leaves(rc["layers"])
        assert len(ours) == len(theirs)
        for (path, a), b in zip(ours, theirs):
            tol = MAMBA_STATE_TOL if "mamba" in jax.tree_util.keystr(path) else MODEL_TOL
            assert _scaled_err(a, b) < tol, jax.tree_util.keystr(path)
    total = oc["len"] + oc.get("len_rec", 0)
    assert total == int(rc["len"]) + int(rc.get("len_rec", 0)) == S + 1


def test_decode_matches_teacher_forcing(model_pair):
    """tests/test_models.py::test_decode_matches_teacher_forcing on the port:
    token-by-token decode logits == the full-sequence forward's, 2e-4."""
    arch, _, _, model, params, _ = model_pair
    S = 9
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, model.cfg.vocab_size, (1, S)).astype(np.int64))
    pos = torch.arange(S)[None]
    full = model.prefill_logits(params, {"tokens": toks, "positions": pos})
    cache = model.init_cache(1, S + 1, device="cpu")
    for t in range(S):
        logits, cache = model.decode_step(
            params, {"tokens": toks[:, t:t + 1], "positions": pos[:, t:t + 1]}, cache)
    np.testing.assert_allclose(logits.numpy(), full.numpy(), rtol=2e-4, atol=2e-4)


def _zamba_tokens(cfg, S):
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, S)).astype(np.int64))
    return toks, torch.arange(S)[None]


def test_split_cache_decode_with_flush_matches_prefill():
    """tests/test_split_cache.py's zamba2 case on the port: a recent ring of
    4, flushed whenever full during 11 decode steps, 5e-4."""
    cfg = get_config("zamba2_7b").smoke()
    model = LM(cfg, remat=None)
    params = model.init(torch.Generator().manual_seed(1), device="cpu")
    S = 11
    toks, pos = _zamba_tokens(cfg, S)
    full = model.prefill_logits(params, {"tokens": toks, "positions": pos})
    cache = model.init_cache(1, S + 4, recent_size=4, device="cpu")
    n_flushes = 0
    for t in range(S):
        logits, cache = model.decode_step(
            params, {"tokens": toks[:, t:t + 1], "positions": pos[:, t:t + 1]}, cache)
        if cache["len_rec"] == 4:
            cache = model.flush_cache(cache)
            n_flushes += 1
    assert n_flushes >= 2
    assert float((logits - full).abs().max()) < 5e-4


def test_flush_near_the_end_of_the_store_keeps_every_token():
    """ROADMAP.md, fault 5: with 4 tokens in the main store of 6 and 2 in a
    ring of 4, the reference's flush writes the whole ring at a start that
    ``dynamic_update_slice`` clamps from 4 to 2, overwriting tokens 2 and 3;
    the port writes the 2 tokens at 4.  The next step's logits then match
    teacher forcing in the port (5e-4) and not in the reference."""
    arch = "zamba2_7b"
    ref, tree = _ref_model(arch, 1)
    ref_params = jax.tree.map(jnp.asarray, tree)
    model = LM(get_config(arch).smoke(), remat=None)
    params = params_from_numpy(model, tree, device="cpu")
    toks = np.random.default_rng(0).integers(0, model.cfg.vocab_size, (1, 7)).astype(np.int32)
    pos = np.arange(7, dtype=np.int32)[None]
    to_port = lambda a: torch.from_numpy(a).long()  # noqa: E731
    errs = {}
    for name, m, p, cache, conv in (
        ("port", model, params, model.init_cache(1, 6, recent_size=4, device="cpu"), to_port),
        ("reference", ref, ref_params, ref.init_cache(1, 6, recent_size=4), jnp.asarray),
    ):
        full = m.prefill_logits(p, {"tokens": conv(toks), "positions": conv(pos)})
        for t in range(7):
            logits, cache = m.decode_step(p, {"tokens": conv(toks[:, t:t + 1]),
                                              "positions": conv(pos[:, t:t + 1])}, cache)
            if t in (3, 5):          # flush after 4 tokens, then after 2 more
                cache = m.flush_cache(cache)
        errs[name] = float(np.abs(np.asarray(logits) - np.asarray(full)).max())
    assert errs["port"] < 5e-4, errs
    assert errs["reference"] > 1e-2, errs
    with pytest.raises(ValueError):   # 3 tokens in the ring, a main store of 2
        cache = model.init_cache(1, 2, recent_size=4, device="cpu")
        for t in range(3):
            _, cache = model.decode_step(params, {"tokens": to_port(toks[:, t:t + 1]),
                                                  "positions": to_port(pos[:, t:t + 1])}, cache)
        model.flush_cache(cache)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_remat_full_recomputes_the_same_gradients(arch):
    """``remat="full"`` checkpoints each layer body (the Mamba body only in
    the hybrid family): the loss and every gradient equal the no-remat run's,
    which autograd takes through the plain chunked math."""
    from repro_torch.train.step import value_and_grad

    _, tree = _ref_model(arch, 0)
    tree = _perturb(tree, ARCHS[arch])
    toks, tgts, pos = _batch(get_config(arch).smoke(), 2, 40, seed=3)
    batch = {"tokens": _t(toks).long(), "targets": _t(tgts).long(), "positions": _t(pos).long()}
    out = {}
    for remat in (None, "full"):
        model = LM(get_config(arch).smoke(), remat=remat)
        out[remat] = value_and_grad(model.train_loss, params_from_numpy(model, tree, device="cpu"),
                                    batch)
    assert torch.equal(out[None][0], out["full"][0])
    flat = [jax.tree.leaves(jax.tree.map(lambda g: g.numpy(), out[r][1])) for r in (None, "full")]
    for a, b in zip(*flat):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6 * max(1.0, float(np.abs(a).max())))
