"""The encdec family (SeamlessM4T: a bidirectional encoder over precomputed
frame embeddings, a causal decoder with cross-attention to the encoder
output) in the port against the reference on the same numpy inputs (f32,
CPU): the config and the params tree, the encoder, ``prefill_logits`` under
each attention path, the train loss and its gradients, the split-cache
decode over the cross cache with flushes, greedy ids, and reference fault 7.
Weights come from the reference's ``LM.init(jax.random.key(1))``, the key
of the reference's own split-cache test (tests/test_split_cache.py), through
the bridge.

Tolerances: tensors within 2e-5 of max(1, max |ref|) as
tests/test_torch_serve.py; gradients within 1e-3 of each leaf's largest
(ROADMAP.md, tolerance notes); decode against the port's own prefill within
5e-4, the reference's bound; ids equal.

Precision.  Under the reference's init the smoke model is chaotic in its
depth (ROADMAP.md, fault 4), more so than the decoder-only families: on a
(2, 9) prompt over 7 frames at key 0 the reference's own three attention
paths lie up to 7.8e-5 of scale apart in f32, and over six train batches
of 24 tokens both packages' f32 gradients lie 1e-3 to 3e-2 of each leaf's
largest from a float64 backward, either package the nearer.  So the f32
comparisons run at the reference's own split-cache shape (one sequence),
and every comparison also runs with both packages in float64 throughout
(``float64()``), where they agree to ~1e-10 and a wrong op cannot hide.
"""
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import RunShape as RefRunShape  # noqa: E402
from repro.configs.registry import get_config as ref_get_config  # noqa: E402
from repro.data import pipeline as ref_pipe  # noqa: E402
from repro.launch.inputs import make_batch as ref_make_batch  # noqa: E402
from repro.models.transformer import LM as RefLM  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.models.transformer import LM, layer_params  # noqa: E402
from repro_torch.train import trainer as trainer_mod  # noqa: E402
from repro_torch.train.step import value_and_grad  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

TOL = 2e-5
GRAD_TOL = 1e-3
ARCH = "seamless_m4t_medium"
IMPLS = ("naive", "chunked", "pallas")
# (dtype, batch): f32 at the reference's own split-cache shape, float64 wider
PRECISIONS = [("float32", 1), ("float64", 2)]
_FLOAT = torch.Tensor.float


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
    ref_params = ref.init(jax.random.key(1))
    model = LM(get_config(ARCH).smoke(), remat=None)
    params = params_from_numpy(model, jax.tree.map(np.asarray, ref_params), device="cpu")
    return ref, ref_params, model, params


@contextlib.contextmanager
def float64():
    """Both packages in float64 throughout: JAX's 64-bit mode with
    ``jnp.float32`` read as float64 (the reference's f32 islands: norms,
    scores, softmax) and ``jnp.int32`` as int64 (its cache lengths meet
    64-bit indices there), and ``Tensor.float`` a no-op on float64 tensors
    (the port's, as scripts/grad_precision.py runs it)."""
    f32, i32 = jnp.float32, jnp.int32
    with jax.enable_x64(True):
        jnp.float32, jnp.int32 = jnp.float64, jnp.int64
        torch.Tensor.float = lambda t: t if t.dtype == torch.float64 else _FLOAT(t)
        try:
            yield
        finally:
            jnp.float32, jnp.int32 = f32, i32
            torch.Tensor.float = _FLOAT


def precision(dtype):
    return float64() if dtype == "float64" else contextlib.nullcontext()


def _models(pair, dtype, impl="naive", remat=None):
    """(reference LM, its params, port LM, its params) in ``dtype``; call
    inside ``precision(dtype)``."""
    ref, ref_params, model, params = pair
    ref, model = RefLM(ref.cfg, attn_impl=impl, remat=remat), LM(model.cfg, attn_impl=impl,
                                                                 remat=remat)
    if dtype == "float64":
        ref.dtype, model.dtype = jnp.dtype(jnp.float64), torch.float64
        ref_params = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)), ref_params)
        params = tree_map(lambda t: t.double(), params)
    return ref, ref_params, model, params


def _scaled_err(ours, ref):
    ref = np.asarray(ref, np.float32)
    err = np.abs(ours.detach().float().numpy() - ref).max()
    return float(err) / max(1.0, float(np.abs(ref).max()))


def _inputs(cfg, B, S, Se, seed, dtype="float32"):
    """Tokens, (B, S) positions and frame embeddings (numpy normal x 0.02,
    as tests/test_split_cache.py makes them), for both packages."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    enc = (rng.normal(size=(B, Se, cfg.d_model)) * 0.02).astype(dtype)
    jb = {"tokens": jnp.asarray(toks), "positions": jnp.asarray(pos), "enc_embeds": jnp.asarray(enc)}
    tb = {"tokens": torch.from_numpy(toks).long(), "positions": torch.from_numpy(pos).long(),
          "enc_embeds": torch.from_numpy(enc)}
    return jb, tb


def _cast(batch, dtype):
    """A reference batch in ``dtype`` (embeddings and mask) for both
    packages: (jax batch, port batch, integer entries int64)."""
    jb = {k: jnp.asarray(np.asarray(t, dtype if k in ("enc_embeds", "loss_mask") else np.int32))
          for k, t in batch.items()}
    tb = {k: torch.from_numpy(np.array(t, dtype if k in ("enc_embeds", "loss_mask")
                                       else np.int64))
          for k, t in batch.items()}
    return jb, tb


# -- config and parameters ------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
def test_config_equals_reference(smoke):
    cfg, ref_cfg = get_config(ARCH), ref_get_config(ARCH)
    if smoke:
        cfg, ref_cfg = cfg.smoke(), ref_cfg.smoke()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert cfg.is_encdec and (cfg.enc_layers, cfg.n_layers) == (ref_cfg.enc_layers, ref_cfg.n_layers)


def test_param_tree_paths_and_shapes_equal_reference(pair):
    """The encdec tree: ``encoder`` stacked over enc_layers, ``enc_ln``,
    ``decoder`` stacked over n_layers with cross-attention, ``embed`` and
    ``final_ln``; the same paths and shapes as the reference's, carried by
    the bridge unchanged and back."""
    _, ref_params, model, params = pair
    cfg = model.cfg
    assert set(params) == {"embed", "final_ln", "encoder", "enc_ln", "decoder"}
    assert set(params["encoder"]) == {"ln1", "attn", "ln2", "mlp"}
    assert set(params["decoder"]) == {"ln1", "attn", "lnx", "xattn", "ln2", "mlp"}
    assert params["encoder"]["attn"]["wq"].shape == (cfg.enc_layers, cfg.d_model, cfg.n_heads, cfg.hd)
    assert params["decoder"]["xattn"]["wk"].shape == (cfg.n_layers, cfg.d_model, cfg.n_kv_heads,
                                                      cfg.hd)
    flat_ref = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, ref_params))[0]
    assert len(flat_ref) == len(leaves(params))
    back = params_to_numpy(params)
    for (path, leaf), ours in zip(flat_ref, leaves(params)):
        node = back
        for key in path:
            node = node[key.key]
        assert tuple(ours.shape) == leaf.shape, path
        np.testing.assert_array_equal(node, leaf)
    fresh = model.init(0, device="cpu")
    assert [tuple(t.shape) for t in leaves(fresh)] == [tuple(t.shape) for t in leaves(params)]


# -- forwards -------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("impl", IMPLS)
def test_run_encoder_matches_reference(pair, impl, dtype):
    """The bidirectional encoder (and enc_ln) under each attention path:
    the port's pallas path takes the flash kernel's plain version on the
    CPU, the reference's its Pallas kernel in interpret mode."""
    with precision(dtype):
        ref, ref_params, model, params = _models(pair, dtype, impl)
        jb, tb = _inputs(model.cfg, 2, 5, 12, seed=3, dtype=dtype)
        r = ref._run_encoder(ref_params, jb["enc_embeds"])
        with torch.no_grad():
            o = model._run_encoder(params, tb["enc_embeds"])
        assert o.dtype == model.dtype and o.shape == r.shape == (2, 12, model.cfg.d_model)
        assert _scaled_err(o, r) < TOL


@pytest.mark.parametrize("dtype,B", PRECISIONS)
@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_logits_match_reference(pair, impl, dtype, B):
    with precision(dtype):
        ref, ref_params, model, params = _models(pair, dtype, impl)
        jb, tb = _inputs(model.cfg, B, 11 - 2 * (B - 1), 8 - (B - 1), seed=0, dtype=dtype)
        r = ref.prefill_logits(ref_params, jb)
        with torch.no_grad():
            o = model.prefill_logits(params, tb)
        assert o.shape == r.shape
        assert _scaled_err(o, r) < TOL


def test_encoder_input_changes_the_output(pair):
    """The decoder reads the encoder: other frames, other logits."""
    _, _, model, params = pair
    _, tb = _inputs(model.cfg, 1, 6, 5, seed=4)
    with torch.no_grad():
        a = model.prefill_logits(params, tb)
        b = model.prefill_logits(params, dict(tb, enc_embeds=tb["enc_embeds"] + 0.05))
    assert not torch.equal(a, b)


# -- training -------------------------------------------------------------------

def _train_batch(dtype, S=24, B=2, seed=11):
    """The reference's train batch (``launch/inputs.py``: enc_embeds of (B, S,
    d) in bf16, widened to ``dtype``) for both packages."""
    return _cast(ref_make_batch(ref_get_config(ARCH).smoke(), RefRunShape("t", S, B, "train"),
                                seed), dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_train_loss_matches_reference(pair, dtype):
    with precision(dtype):
        ref, ref_params, model, params = _models(pair, dtype)
        jb, tb = _train_batch(dtype)
        assert tb["enc_embeds"].shape == (2, 24, model.cfg.d_model)
        ref_loss = float(ref.train_loss(ref_params, jb))
        with torch.no_grad():
            loss = float(model.train_loss(params, tb))
    assert abs(loss - ref_loss) < TOL * max(1.0, abs(ref_loss))


@pytest.mark.parametrize("remat", [None, "full", "dots"])
def test_grads_match_reference(pair, remat):
    """Every leaf, the encoder's included, within 1e-3 of the reference
    gradient's largest magnitude, both packages in float64 with the same
    ``remat`` (in f32 both lie up to 3e-2 from float64 here: see above)."""
    with float64():
        ref, ref_params, model, params = _models(pair, "float64", remat=remat)
        jb, tb = _train_batch("float64")
        ref_loss, ref_grads = jax.value_and_grad(ref.train_loss)(ref_params, jb)
        loss, grads = value_and_grad(model.train_loss, params, tb)
        ref_leaves = jax.tree_util.tree_flatten_with_path(ref_grads)[0]
    assert abs(float(loss) - float(ref_loss)) < TOL * max(1.0, abs(float(ref_loss)))
    ours = leaves(grads)
    assert len(ours) == len(ref_leaves)
    seen = set()
    for (path, g_ref), g in zip(ref_leaves, ours):
        g_ref, g = np.asarray(g_ref), g.numpy()
        assert g.shape == g_ref.shape and g.dtype == g_ref.dtype == np.float64
        assert np.abs(g - g_ref).max() <= GRAD_TOL * max(np.abs(g_ref).max(), 1e-3), path
        seen.add(path[0].key)
    assert {"encoder", "enc_ln", "decoder"} <= seen
    assert float(np.abs(grads["encoder"]["attn"]["wq"].numpy()).max()) > 0


# -- decode over the cross cache ------------------------------------------------

def _fill_cross(model, params, cache, enc):
    """tests/test_split_cache.py's cross cache: the encoder once, then each
    decoder layer's cross-attention K/V of its output."""
    enc_out = model._run_encoder(params, enc)
    ck, cv = cache["layers"]["cross"]
    for li in range(model.cfg.n_layers):
        k, v = model._encoder_kv(layer_params(params["decoder"], li)["xattn"], enc_out)
        ck[li], cv[li] = k, v


def _caches(ref, ref_params, model, params, B, max_len, Se, enc_jax, enc_torch, ring):
    """Both packages' split caches with the cross cache filled, in the
    models' dtype (the configs' cache dtype is f32)."""
    rc = ref.init_cache(B, max_len, enc_len=Se, recent_size=ring)
    rc["layers"] = jax.tree.map(lambda a: a.astype(ref.dtype), rc["layers"])
    ek = ref._run_encoder(ref_params, enc_jax)
    ks, vs = [], []
    for li in range(ref.cfg.n_layers):
        lp = jax.tree.map(lambda a: a[li], ref_params["decoder"])
        k, v = ref._encoder_kv(lp["xattn"], ek)
        ks.append(k)
        vs.append(v)
    rc["layers"]["cross"] = (jnp.stack(ks), jnp.stack(vs))
    oc = model.init_cache(B, max_len, enc_len=Se, recent_size=ring, device="cpu")
    oc["layers"] = tree_map(lambda t: t.to(model.dtype), oc["layers"])
    with torch.no_grad():
        _fill_cross(model, params, oc, enc_torch)
    return rc, oc


@pytest.mark.parametrize("dtype,B", PRECISIONS)
@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_split_cache_decode_with_flushes_matches_reference(pair, impl, dtype, B):
    """tests/test_split_cache.py's encdec case in both packages: a 4-token
    prompt through ``decode_step`` over 8 encoder frames, then one token a
    step on a ring of 4 with flushes (the flush moves only ``"self"``);
    every step's logits against the reference's, the cross cache unchanged,
    and the last within 5e-4 of the port's own teacher-forced prefill."""
    S, P, Se = 11, 4, 8
    with precision(dtype):
        ref, ref_params, model, params = _models(pair, dtype, impl)
        jb, tb = _inputs(model.cfg, B, S, Se, seed=0, dtype=dtype)
        rc, oc = _caches(ref, ref_params, model, params, B, S + 4, Se, jb["enc_embeds"],
                         tb["enc_embeds"], 4)
        assert oc["enc_len"] == Se and oc["layers"]["cross"][0].shape == (
            model.cfg.n_layers, B, Se, model.cfg.n_kv_heads, model.cfg.hd)
        for ours, theirs in zip(oc["layers"]["cross"], rc["layers"]["cross"]):
            assert _scaled_err(ours, theirs) < TOL
        with torch.no_grad():
            full = model.prefill_logits(params, tb)
        cross = [t.clone() for t in oc["layers"]["cross"]]
        flushes = 0
        for a, b in [(0, P)] + [(t, t + 1) for t in range(P, S)]:
            step = {k: jb[k][:, a:b] for k in ("tokens", "positions")}
            rl, rc = ref.decode_step(ref_params, step, rc)
            with torch.no_grad():
                ol, oc = model.decode_step(params, {k: tb[k][:, a:b] for k in step}, oc)
            assert _scaled_err(ol, rl) < TOL, (a, b)
            if oc["len_rec"] == 4:
                assert int(rc["len_rec"]) == 4
                rc, oc = ref.flush_cache(rc), model.flush_cache(oc)
                flushes += 1
        n = oc["len"]
        for ours, theirs in zip(oc["layers"]["self"]["main"], rc["layers"]["self"]["main"]):
            assert _scaled_err(ours[:, :, :n], np.asarray(theirs)[:, :, :n]) < TOL
    assert flushes >= 2 and n + oc["len_rec"] == S
    assert all(torch.equal(x, y) for x, y in zip(cross, oc["layers"]["cross"]))
    assert float((ol - full).abs().max()) < 5e-4


def test_greedy_ids_equal_reference_loop(pair):
    """Two sequences over their own encoder frames (f32): a 4-token prompt,
    then 12 greedy ids through ``decode_step`` with a ring of 4 (flushed
    when full), equal to the reference's loop."""
    ref, ref_params, model, params = pair
    B, P, Se, new = 2, 4, 6, 12
    jb, tb = _inputs(model.cfg, B, P, Se, seed=9)
    rc, oc = _caches(ref, ref_params, model, params, B, P + new, Se, jb["enc_embeds"],
                     tb["enc_embeds"], 4)
    ids = {"ref": [], "port": []}
    r_toks, o_toks = jb["tokens"], tb["tokens"]
    for t in range(new):
        pos = np.arange(P)[None] if t == 0 else np.array([[P + t - 1]])
        pos = np.repeat(pos, B, 0)
        rl, rc = ref.decode_step(ref_params, {"tokens": r_toks, "positions": jnp.asarray(pos)}, rc)
        with torch.no_grad():
            ol, oc = model.decode_step(params, {"tokens": o_toks,
                                                "positions": torch.from_numpy(pos)}, oc)
        if oc["len_rec"] == 4:
            rc, oc = ref.flush_cache(rc), model.flush_cache(oc)
        r_toks, o_toks = jnp.argmax(rl, -1)[:, None], ol.argmax(-1)[:, None]
        ids["ref"].append(np.asarray(r_toks)[:, 0])
        ids["port"].append(o_toks[:, 0].numpy())
    assert np.array_equal(np.stack(ids["port"], 1), np.stack(ids["ref"], 1))


# -- reference fault 7 ----------------------------------------------------------

def test_reference_fault_7_synth_batch_has_no_encoder_input(pair):
    """``repro.data.pipeline.synth_batch`` builds no ``enc_embeds``, so the
    reference's ``train_loss`` raises ``KeyError`` on its own trainer's
    batches (and its trainer retries step 0 forever); the port's pipeline
    is the same."""
    ref, ref_params, model, params = pair
    dcfg = ref_pipe.DataConfig(vocab_size=ref.cfg.vocab_size, seq_len=16, batch_per_shard=2)
    nb = ref_pipe.synth_batch(dcfg, 0, 0)
    assert "enc_embeds" not in nb
    with pytest.raises(KeyError, match="enc_embeds"):
        ref.train_loss(ref_params, {k: jnp.asarray(v) for k, v in nb.items()})
    with pytest.raises(KeyError, match="enc_embeds"):
        model.train_loss(params, {k: torch.from_numpy(v) for k, v in nb.items()})


def test_launch_train_raises_rather_than_looping(tmp_path, monkeypatch, capsys):
    """``launch.train --arch seamless_m4t_medium`` trains: the trainer
    completes each pipeline batch with ``enc_embeds``
    (``launch/inputs.py:complete_batch``).  A step that fails twice still
    raises rather than looping as the reference's trainer does: with the
    completion's ``enc_embeds`` taken out again, the step raises
    ``KeyError``, the trainer recovers once, the same step fails again and
    the error propagates."""
    out = launch_train.main(["--arch", ARCH, "--steps", "3", "--seq", "16", "--batch", "2",
                             "--device", "cpu", "--ckpt-dir", str(tmp_path / "ok")])
    assert [s for s, _ in out["history"]] == [0, 1, 2] and out["recoveries"] == 0
    assert all(np.isfinite(m["loss"]) for _, m in out["history"])
    complete = trainer_mod.complete_batch
    monkeypatch.setattr(trainer_mod, "complete_batch", lambda *a, **kw: {
        k: v for k, v in complete(*a, **kw).items() if k != "enc_embeds"})
    capsys.readouterr()
    with pytest.raises(KeyError, match="enc_embeds"):
        launch_train.main(["--arch", ARCH, "--steps", "3", "--seq", "16", "--batch", "2",
                           "--device", "cpu", "--ckpt-dir", str(tmp_path / "bare")])
    logs = capsys.readouterr().out
    assert logs.count("step 0 failed (") == 1 and logs.count("step 0 failed again") == 1
