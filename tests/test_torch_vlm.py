"""The vlm family (Qwen2-VL: the dense decoder with M-RoPE and patch
embeddings spliced over the first positions) in the port against the
reference on the same numpy inputs (f32, CPU): the batch builder, the smoke
``qwen2_vl_72b`` through ``LM`` (train loss and its gradients, prefill, the
split-cache decode chain), the paged decode step at (B, 1, 3) positions, the
serving engine with a fork, and the serve launcher.  Weights come from the
reference's ``LM.init(jax.random.key(0))`` through the bridge.

Tolerances: batches bit-equal; tensors within 2e-5 of max(1, max |ref|) as
tests/test_torch_serve.py; gradients within 1e-3 of each leaf's largest
(ROADMAP.md, tolerance notes); ids equal.

The reference engine hands its M-RoPE model 2-D positions, which the rope
misreads (ROADMAP.md, fault 6): the port's engine gives text tokens (B, S, 3)
positions with t = h = w = index, and its ids are held against the
reference's model-level greedy loop fed those.  The fault itself is pinned
here on the reference."""
import contextlib
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import RunShape as RefRunShape  # noqa: E402
from repro.configs.registry import get_config as ref_get_config  # noqa: E402
from repro.core.kv_pool import KVPoolConfig as RefPoolConfig  # noqa: E402
from repro.launch.inputs import make_batch as ref_make_batch  # noqa: E402
from repro.models import rope as ref_rope  # noqa: E402
from repro.models.transformer import LM as RefLM  # noqa: E402
from repro.serve.engine import Request as RefRequest  # noqa: E402
from repro.serve.engine import ServeEngine as RefEngine  # noqa: E402
from repro.serve.paged_runner import paged_decode_step as ref_paged_step  # noqa: E402
from repro_torch.configs.base import RunShape  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.kv_pool import KVPoolConfig  # noqa: E402
from repro_torch.launch import inputs  # noqa: E402
from repro_torch.launch import serve as port_launch  # noqa: E402
from repro_torch.models import rope  # noqa: E402
from repro_torch.models.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.models.transformer import LM  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.paged_runner import graph_key, paged_decode_step  # noqa: E402
from repro_torch.train.step import value_and_grad  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

TOL = 2e-5
GRAD_TOL = 1e-3
ARCH = "qwen2_vl_72b"


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
    ref = np.asarray(ref, np.float32)
    err = np.abs(ours.detach().float().numpy() - ref).max()
    return float(err) / max(1.0, float(np.abs(ref).max()))


def _to_torch(batch):
    """Port tensors of a reference batch; integer entries as int64, as the
    engine's."""
    return {k: torch.from_numpy(np.array(t, np.float32 if k in ("patch_embeds", "loss_mask")
                                         else np.int64))
            for k, t in batch.items()}


def _pos3(S, start=0, B=1):
    return np.broadcast_to(np.arange(start, start + S)[None, :, None], (B, S, 3)).copy()


# -- the batch builder ----------------------------------------------------------

SHAPES = [("train", 24, 2), ("prefill", 300, 1), ("prefill", 20, 3), ("decode", 64, 4)]


@pytest.mark.parametrize("arch", [ARCH, "stablelm_1_6b", "seamless_m4t_medium"])
@pytest.mark.parametrize("mode,S,B", SHAPES)
def test_make_batch_is_bit_equal_to_the_reference(arch, mode, S, B):
    """Every entry the reference builds, with its shape, dtype and bits;
    patch embeddings (B, min(256, S), d) in bf16 rounded as the reference
    rounds float64 (through float32), and M-RoPE positions (B, S, 3)."""
    cfg, ref_cfg = get_config(arch).smoke(), ref_get_config(arch).smoke()
    ours = inputs.make_batch(cfg, RunShape("s", S, B, mode), seed=S + B, device="cpu")
    theirs = ref_make_batch(ref_cfg, RefRunShape("s", S, B, mode), seed=S + B)
    assert set(ours) == set(theirs)
    for k, t in ours.items():
        r = np.asarray(theirs[k])
        assert tuple(t.shape) == r.shape and str(t.dtype).split(".")[-1] == str(r.dtype), k
        if t.dtype == torch.bfloat16:
            assert np.array_equal(t.view(torch.int16).numpy(), r.view(np.int16)), k
        else:
            assert np.array_equal(t.numpy(), r), k
    if arch == ARCH and mode != "decode":
        assert ours["patch_embeds"].shape == (B, min(inputs.N_PATCHES, S), cfg.d_model)
    if arch == ARCH:
        assert ours["positions"].shape == (B, 1 if mode == "decode" else S, 3)


def test_make_batch_rounds_embeddings_through_float32():
    """A float64 value just past a bfloat16 tie: rounded directly it goes
    up, through float32 (which drops the excess) it ties to even.  The
    reference's ``jnp.asarray`` takes the second, and so does the port."""
    x = np.array([1.0 + 2.0 ** -8 + 2.0 ** -30])
    ref = np.asarray(jnp.asarray(x, jnp.bfloat16)).view(np.uint16)
    ours = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16).view(torch.int16)
    assert int(ref[0]) == int(ours[0]) == 0x3F80          # 1.0, the even neighbour


# -- the model ------------------------------------------------------------------

def test_vlm_builds_the_dense_tree_and_encdec_its_own(pair):
    """The vlm family takes the dense tree; the encdec family (ported since)
    builds an encoder and a cross-attending decoder in its place."""
    _, ref_params, model, params = pair
    assert model.family == "vlm" and set(params["layers"]) == {"ln1", "attn", "ln2", "mlp"}
    dense = LM(get_config("stablelm_1_6b").smoke())
    assert set(params["layers"]) == set(dense.param_defs()["layers"])
    assert set(ref_params) == set(params) and set(ref_params["layers"]) == set(params["layers"])
    encdec = LM(get_config("seamless_m4t_medium").smoke())
    assert encdec.family == "encdec" and set(encdec.param_defs()) == {
        "embed", "final_ln", "encoder", "enc_ln", "decoder"}


def test_bridge_carries_the_vlm_tree_as_it_is(pair):
    """Paths, shapes and values through the bridge and back, no new leaves."""
    _, ref_params, model, params = pair
    back = params_to_numpy(params)
    flat_ref = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, ref_params))[0]
    assert len(flat_ref) == len(leaves(params))
    for path, leaf in flat_ref:
        node = back
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, leaf)


def _train_batches(cfg, S=24, B=2, n_patches=8, seed=11):
    """The reference's train batch, patches cut to the first ``n_patches``
    positions so that tokens and patches both reach the loss."""
    jb = ref_make_batch(ref_get_config(ARCH).smoke(), RefRunShape("t", S, B, "train"), seed)
    jb = dict(jb, patch_embeds=jb["patch_embeds"][:, :n_patches])
    return jb, _to_torch(jb)


def test_train_loss_matches_reference_with_patches(pair):
    ref, ref_params, model, params = pair
    jb, tb = _train_batches(model.cfg)
    assert tb["positions"].shape == (2, 24, 3) and tb["patch_embeds"].shape == (2, 8, 128)
    ref_loss = float(ref.train_loss(ref_params, jb))
    with torch.no_grad():
        loss = float(model.train_loss(params, tb))
    assert abs(loss - ref_loss) < TOL * max(1.0, abs(ref_loss))


@pytest.mark.parametrize("S,B", [(13, 2), (300, 1)])
def test_prefill_logits_match_reference_with_patches(pair, S, B):
    """At S = 300 the make_batch patches cover the first 256 positions."""
    ref, ref_params, model, params = pair
    jb = ref_make_batch(ref.cfg, RefRunShape("p", S, B, "prefill"), seed=S)
    if S < inputs.N_PATCHES:
        jb = dict(jb, patch_embeds=jb["patch_embeds"][:, :5])
    rl = ref.prefill_logits(ref_params, jb)
    with torch.no_grad():
        ol = model.prefill_logits(params, _to_torch(jb))
    assert ol.shape == rl.shape and _scaled_err(ol, rl) < TOL


def test_patch_embeds_change_output(pair):
    """The reference's own check (tests/test_models.py), in the port: moving
    the patches moves the loss."""
    _, _, model, params = pair
    tb = inputs.make_batch(model.cfg, RunShape("t", 32, 2, "train"), seed=0, device="cpu")
    with torch.no_grad():
        l1 = float(model.train_loss(params, tb))
        l2 = float(model.train_loss(params, dict(tb, patch_embeds=tb["patch_embeds"] + 1.0)))
        l3 = float(model.train_loss(params, {k: v for k, v in tb.items() if k != "patch_embeds"}))
    assert l1 != l2 and l1 != l3


def test_patches_longer_than_the_tokens_raise_in_both(pair):
    ref, ref_params, model, params = pair
    jb, tb = _train_batches(model.cfg, S=6, B=1, n_patches=6)
    pe = np.concatenate([np.asarray(jb["patch_embeds"], np.float32)] * 2, axis=1)   # 12 > 6
    with pytest.raises(TypeError):
        ref.train_loss(ref_params, dict(jb, patch_embeds=jnp.asarray(pe)))
    with pytest.raises(ValueError, match="patch_embeds"):
        model.train_loss(params, dict(tb, patch_embeds=torch.from_numpy(pe)))


_FLOAT = torch.Tensor.float


@pytest.fixture(scope="module")
def grads64(pair):
    """seed -> the port's gradients of the train loss run in float64
    throughout (``Tensor.float`` a no-op on float64 tensors while it runs,
    as scripts/grad_precision.py does): the referee where the two packages'
    f32 gradients part."""
    _, _, model, params = pair
    out = {}

    def run(seed):
        if seed not in out:
            _, tb = _train_batches(model.cfg, seed=seed)
            m64 = LM(model.cfg, remat=None)
            m64.dtype = torch.float64
            torch.Tensor.float = lambda t: t if t.dtype == torch.float64 else _FLOAT(t)
            try:
                _, g = value_and_grad(m64.train_loss, tree_map(lambda t: t.double(), params),
                                      dict(tb, patch_embeds=tb["patch_embeds"].double()))
            finally:
                torch.Tensor.float = _FLOAT
            out[seed] = [t.numpy() for t in leaves(g)]
        return out[seed]
    return run


@pytest.mark.parametrize("seed", [11, 12])
@pytest.mark.parametrize("remat", [None, "full"])
def test_grads_match_reference(pair, grads64, remat, seed):
    """Per leaf within 1e-3 of the reference's largest, or, where the two
    part by more, the port's nearer a float64 backward than the
    reference's.  Batch 12 is one where they part: its near one-hot
    attention rows (ROADMAP.md, fault 4) set both packages' f32 gradients
    more than 1e-3 of scale from float64, the reference's the further;
    batch 11 keeps every leaf within 1e-3 of the reference."""
    ref, ref_params, model, params = pair
    jb, tb = _train_batches(model.cfg, seed=seed)
    ref_loss, ref_grads = jax.value_and_grad(ref.train_loss)(ref_params, jb)
    loss, grads = value_and_grad(LM(model.cfg, remat=remat).train_loss, params, tb)
    assert abs(float(loss) - float(ref_loss)) < TOL * max(1.0, abs(float(ref_loss)))
    ref_leaves = jax.tree_util.tree_flatten_with_path(ref_grads)[0]
    ours = leaves(grads)
    assert len(ours) == len(ref_leaves)
    parted = 0
    for (path, g_ref), g, g64 in zip(ref_leaves, ours, grads64(seed)):
        g_ref, g = np.asarray(g_ref), g.detach().numpy()
        assert g.shape == g_ref.shape
        if np.abs(g - g_ref).max() <= GRAD_TOL * max(np.abs(g_ref).max(), 1e-3):
            continue
        parted += 1
        assert np.abs(g - g64).max() < np.abs(g_ref - g64).max(), path
    assert parted == 0 or seed == 12


def test_split_cache_decode_chain_with_flushes_matches_reference(pair):
    """tests/test_split_cache.py's vlm case in both packages: a 4-token
    prompt with 3 patches through ``decode_step``, then one token a step on
    a ring of 4 with flushes, every step's logits against the reference's;
    the last within 5e-4 of the teacher-forced prefill, the reference's
    own bound."""
    ref, ref_params, model, params = pair
    cfg = model.cfg
    S, P = 11, 4
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (1, S)).astype(np.int32)
    pe = (rng.normal(size=(1, 3, cfg.d_model)) * 0.02).astype(np.float32)
    pos = _pos3(S).astype(np.int32)
    full = ref.prefill_logits(ref_params, {"tokens": jnp.asarray(toks), "positions": jnp.asarray(pos),
                                           "patch_embeds": jnp.asarray(pe)})
    rc = ref.init_cache(1, S + 4, recent_size=4)
    oc = model.init_cache(1, S + 4, recent_size=4, device="cpu")
    flushes = 0
    steps = [(0, P)] + [(t, t + 1) for t in range(P, S)]
    for i, (a, b) in enumerate(steps):
        jb = {"tokens": jnp.asarray(toks[:, a:b]), "positions": jnp.asarray(pos[:, a:b])}
        if i == 0:
            jb["patch_embeds"] = jnp.asarray(pe)
        rl, rc = ref.decode_step(ref_params, jb, rc)
        with torch.no_grad():
            ol, oc = model.decode_step(params, _to_torch(jb), oc)
        assert _scaled_err(ol, rl) < TOL, (a, b)
        if oc["len_rec"] == 4:
            assert int(rc["len_rec"]) == 4
            rc, oc = ref.flush_cache(rc), model.flush_cache(oc)
            flushes += 1
    assert flushes >= 2 and oc["len"] + oc["len_rec"] == S
    for ours, theirs in zip(oc["layers"]["main"], rc["layers"]["main"]):
        assert _scaled_err(ours[:, :, :oc["len"]], np.asarray(theirs)[:, :, :oc["len"]]) < TOL
    assert float(np.abs(ol.numpy() - np.asarray(full)).max()) < 5e-4


# -- rope ------------------------------------------------------------------------

def test_mrope_refuses_positions_without_a_stream_axis(pair):
    cfg = pair[2].cfg
    x = torch.zeros(1, 5, 4, cfg.hd)
    for bad in (torch.arange(5)[None], torch.zeros(1, 5, 2, dtype=torch.long)):
        with pytest.raises(ValueError, match="mrope"):
            rope.apply_rope(cfg, x, bad)


# -- the paged decode step ---------------------------------------------------------

def _paged_inputs(cfg, lens, seed):
    rng = np.random.default_rng(seed)
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
    pos = np.repeat((lens - 1)[:, None, None], 3, axis=-1).astype(np.int32)
    return toks, pos, kp, vp, tbl, lens


@pytest.mark.parametrize("lens", [[1, 9, 17, 30], [40, 33, 25, 16], [7]])
def test_paged_decode_step_matches_reference_at_3d_positions(pair, lens):
    """(B, 1, 3) positions through both packages' paged steps, the same pool
    pages and tables: logits and the new token's K/V."""
    ref, ref_params, model, params = pair
    cfg = model.cfg
    toks, pos, kp, vp, tbl, lens = _paged_inputs(cfg, lens, sum(lens))
    r_logits, r_k, r_v = ref_paged_step(
        ref_params, ref.cfg, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(tbl), jnp.asarray(lens), use_kernel=True,
    )
    T = torch.from_numpy
    with torch.no_grad():
        o_logits, o_k, o_v = paged_decode_step(
            params, cfg, T(toks).long(), T(pos).long(), T(kp), T(vp), T(tbl), T(lens))
        with pytest.raises(ValueError, match="mrope"):
            paged_decode_step(params, cfg, T(toks).long(), T(pos[..., 0]).long(), T(kp), T(vp),
                              T(tbl), T(lens))
    assert o_logits.shape == r_logits.shape
    assert _scaled_err(o_logits, r_logits) < TOL
    assert _scaled_err(o_k, r_k) < TOL and _scaled_err(o_v, r_v) < TOL


def test_graph_key_parts_vlm_from_dense(pair):
    """One ``GraphCache`` over a vlm and a dense model of the same shapes
    never hands one's graph to the other: the config is in the key."""
    _, _, model, params = pair
    dense = get_config("mistral_nemo_12b").smoke()
    assert dense.rope == "rope" and (dense.n_layers, dense.n_kv_heads, dense.hd) == (3, 2, 32) == (
        model.cfg.n_layers, model.cfg.n_kv_heads, model.cfg.hd)
    kp = torch.zeros(3, 8, 4, 2, 32)
    vp = torch.zeros_like(kp)
    toks, tbl = np.zeros((2, 1), np.int64), np.zeros((2, 3), np.int32)
    a = graph_key(params, model.cfg, kp, vp, toks, tbl)
    assert a == graph_key(params, model.cfg, kp, vp, toks, tbl)
    assert a != graph_key(params, dense, kp, vp, toks, tbl)


# -- serving ------------------------------------------------------------------------

def _pool_kw(cfg, max_seqs=8):
    return dict(num_blocks=96, block_size=8, kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                n_layers=cfg.n_layers, max_seqs=max_seqs, max_blocks_per_seq=12,
                blocks_per_arena=16, policy="puma", dtype="float32")


def _prompts(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, int(rng.integers(3, 40))).tolist() for _ in range(n)]


def _ref_generate(ref, ref_params, prompt, max_new):
    """tests/test_serve.py's greedy ``decode_step`` loop, with the 3-D
    positions (t = h = w = index) of the reference's own model tests."""
    S = len(prompt)
    cache = ref.init_cache(1, S + max_new + 1)
    batch = {"tokens": jnp.asarray([prompt], jnp.int32), "positions": jnp.asarray(_pos3(S))}
    logits, cache = ref.decode_step(ref_params, batch, cache)
    out = [int(jnp.argmax(logits[0]))]
    for t in range(max_new - 1):
        batch = {"tokens": jnp.asarray([[out[-1]]], jnp.int32),
                 "positions": jnp.asarray(_pos3(1, start=S + t))}
        logits, cache = ref.decode_step(ref_params, batch, cache)
        out.append(int(jnp.argmax(logits[0])))
    return out


def _serve_with_fork(model, params, prompts, max_new, jit=False):
    """Six requests on eight slots; after the first step the lowest live slot
    is forked and the child continues the parent's ids.  Returns (engine,
    {rid: ids}, the parent's rid)."""
    eng = ServeEngine(model, params, KVPoolConfig(**_pool_kw(model.cfg)), device="cpu", jit=jit)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new=max_new))
    eng.step()
    parent = min(eng.live)
    child = eng.pool.fork(parent)
    assert child is not None
    preq = eng.live[parent]
    eng.live[child] = Request(rid=100, prompt=list(preq.prompt), max_new=max_new,
                              out=list(preq.out))
    done = eng.run()
    return eng, {r.rid: list(r.out) for r in done}, preq.rid


def test_engine_ids_match_the_reference_loop_with_3d_positions(pair):
    """The served ids of every request equal the reference's model-level
    greedy loop fed (1, S, 3) positions; the fork's child continues its
    parent's ids."""
    ref, ref_params, model, params = pair
    prompts = _prompts(model.cfg, 6, 21)
    eng, ids, parent = _serve_with_fork(model, params, prompts, 6)
    assert sorted(ids) == [0, 1, 2, 3, 4, 5, 100] and not eng.rejected
    for rid, p in enumerate(prompts):
        assert ids[rid] == _ref_generate(ref, ref_params, p, 6), rid
    assert ids[100] == ids[parent]


def test_jit_engine_on_cpu_equals_eager(pair):
    """``ServeEngine(jit=True)`` on the CPU serves the vlm model exactly as
    ``jit=False``: ids, metrics and pools bit for bit, no graph captured."""
    _, _, model, params = pair
    prompts = _prompts(model.cfg, 6, 22)
    (a, ids_a, _), (b, ids_b, _) = (_serve_with_fork(model, params, prompts, 4, jit=j)
                                    for j in (True, False))
    assert len(ids_a) == 7 and ids_a == ids_b
    assert a.metrics() == b.metrics()
    assert torch.equal(a.pool.k, b.pool.k) and torch.equal(a.pool.v, b.pool.v)
    assert a.graphs.captures == 0 and b.graphs is None


def test_engine_prefill_and_step_positions_are_3d(pair, monkeypatch):
    """What the engine hands the model: (1, S, 3) in prefill and (B, 1, 3)
    in decode, each stream the token's index."""
    import repro_torch.serve.engine as engine_mod
    _, _, model, params = pair
    seen = {"prefill": [], "decode": []}
    decode_step, step_jit = model.decode_step, engine_mod.paged_decode_step_jit

    def record_prefill(p, batch, cache):
        seen["prefill"].append(batch["positions"].clone())
        return decode_step(p, batch, cache)

    def record_decode(p, cfg, tokens, positions, *args, **kw):
        seen["decode"].append(positions.copy())
        return step_jit(p, cfg, tokens, positions, *args, **kw)

    monkeypatch.setattr(model, "decode_step", record_prefill)
    monkeypatch.setattr(engine_mod, "paged_decode_step_jit", record_decode)
    eng = ServeEngine(model, params, KVPoolConfig(**_pool_kw(model.cfg)), device="cpu")
    for i, p in enumerate(_prompts(model.cfg, 3, 23)):
        eng.submit(Request(rid=i, prompt=p, max_new=3))
    eng.run()
    assert len(seen["prefill"]) == 3 and len(seen["decode"]) >= 2
    for pos in seen["prefill"]:
        S = pos.shape[1]
        assert tuple(pos.shape) == (1, S, 3) and torch.equal(pos, torch.from_numpy(_pos3(S)))
    for pos in seen["decode"]:
        assert pos.shape[1:] == (1, 3) and (pos == pos[..., :1]).all()


# -- reference fault 6 ------------------------------------------------------------

def test_reference_fault_6_engine_positions_are_2d(pair):
    """The reference engine passes 2-D positions to its M-RoPE model: its
    rope on a (1, S) array differs from the (1, S, 3) broadcast its model
    tests use by more than 1, and so do the prefill logits of a 5-token
    prompt (4.35 at a scale of 3.40); with 4 requests its decode step
    raises ``TypeError``.  If the reference is fixed, this fails and
    ROADMAP.md's fault 6 is to be updated."""
    ref, ref_params, model, _ = pair
    S = 5
    x = np.random.default_rng(3).normal(size=(1, S, 4, ref.cfg.hd)).astype(np.float32)
    flat = ref_rope.apply_rope(ref.cfg, jnp.asarray(x), jnp.arange(S, dtype=jnp.int32)[None])
    pos3 = ref_rope.apply_rope(ref.cfg, jnp.asarray(x), jnp.asarray(_pos3(S)))
    assert float(jnp.abs(flat - pos3).max()) > 1.0
    toks = jnp.asarray(np.random.default_rng(0).integers(0, ref.cfg.vocab_size, (1, S)), jnp.int32)
    flat, pos3 = (ref.prefill_logits(ref_params, {"tokens": toks, "positions": p})
                  for p in (jnp.arange(S)[None], jnp.asarray(_pos3(S))))
    assert float(jnp.abs(flat - pos3).max()) > 1.0
    eng = RefEngine(ref, ref_params, RefPoolConfig(**_pool_kw(model.cfg)), use_kernel=False)
    for i, p in enumerate(_prompts(model.cfg, 4, 24)):
        eng.submit(RefRequest(rid=i, prompt=p, max_new=4))
    with pytest.raises(TypeError):
        eng.run()


# -- the launcher -----------------------------------------------------------------

def test_launcher_serves_the_vlm_family(pair):
    """``repro_torch.launch.serve --arch qwen2_vl_72b --device cpu`` prints
    the launcher's line; on the reference's weights (bridged) its ids equal
    the reference's greedy loop with 3-D positions."""
    ref, ref_params, model, params = pair
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        port_launch.main(["--arch", ARCH, "--requests", "4", "--max-new", "4", "--device", "cpu"])
    # the first id of each request comes from its prefill, the rest are decoded
    assert f"[serve] {ARCH} policy=puma: 4 requests, 12 tokens" in out.getvalue()
    args = port_launch.parse_args(["--arch", ARCH, "--requests", "5", "--max-new", "5",
                                   "--device", "cpu"])
    _, done, _ = port_launch.serve(model, params, args)
    rng = np.random.default_rng(0)          # the launcher's prompts
    prompts = [list(rng.integers(0, model.cfg.vocab_size, int(rng.integers(8, 64))))
               for _ in range(args.requests)]
    assert len(done) == 5
    for r in done:
        assert r.prompt == prompts[r.rid]
        assert [int(t) for t in r.out] == _ref_generate(ref, ref_params,
                                                        [int(t) for t in r.prompt], 5), r.rid
