"""``launch.train`` on the vlm (qwen2_vl_72b) and encdec (seamless_m4t_medium)
families: the trainer completes each pipeline batch for its config
(``launch/inputs.py:complete_batch``), held against the reference's
``train_loss`` on the same completed batches (numpy) at the bridged init
``LM.init(jax.random.key(0))``, the init of the reference's launcher.

The reference's own trainer cannot run these families on its pipeline's
batches (ROADMAP.md, reference faults 7 and 8, both pinned here or in
tests/test_torch_encdec.py), so its loss and gradients are compared, not its
trainer.

Tolerances: the step-0 loss within 1e-4 (PERF.md §2, smoke training);
gradients within 1e-3 of each leaf's largest (ROADMAP.md, tolerance notes),
in f32 and, with both packages in float64 throughout, for encdec, whose f32
gradients are chaotic under the reference's init; the other families'
batches byte-equal to ``synth_batch``'s.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as ref_get_config  # noqa: E402
from repro.data import pipeline as ref_pipe  # noqa: E402
from repro.models.transformer import LM as RefLM  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.inputs import N_PATCHES, complete_batch  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.models.transformer import LM  # noqa: E402
from repro_torch.train.step import value_and_grad  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

LOSS_TOL = 1e-4
GRAD_TOL = 1e-3
FAMILIES = ("qwen2_vl_72b", "seamless_m4t_medium")
OTHERS = ("stablelm_1_6b", "granite_moe_1b_a400m", "rwkv6_7b", "zamba2_7b")
SEQ, BATCH = 32, 2
_FLOAT = torch.Tensor.float


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several test processes at once; one torch thread per
    process keeps them from contending for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def float64():
    """Both packages in float64 throughout, as tests/test_torch_encdec.py
    runs them: JAX's 64-bit mode with ``jnp.float32`` read as float64 and
    ``jnp.int32`` as int64, ``Tensor.float`` a no-op on float64 tensors."""
    f32, i32 = jnp.float32, jnp.int32
    with jax.enable_x64(True):
        jnp.float32, jnp.int32 = jnp.float64, jnp.int64
        torch.Tensor.float = lambda t: t if t.dtype == torch.float64 else _FLOAT(t)
        try:
            yield
        finally:
            jnp.float32, jnp.int32 = f32, i32
            torch.Tensor.float = _FLOAT


def _data(cfg):
    return pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ, batch_per_shard=BATCH)


def _batch(cfg, step):
    """The trainer's batch of ``step``, completed, as numpy."""
    dcfg = _data(cfg)
    return complete_batch(cfg, dcfg.seed, pipeline.synth_batch(dcfg, step, 0), step, 0)


@pytest.fixture(scope="module", params=FAMILIES)
def pair(request):
    """(reference LM, its f32 params, port LM, bridged params), chunked
    attention and no remat as the smoke launcher builds them."""
    ref = RefLM(ref_get_config(request.param).smoke(), attn_impl="chunked", remat=None)
    ref_params = ref.init(jax.random.key(0))
    model = LM(get_config(request.param).smoke(), attn_impl="chunked", remat=None)
    params = params_from_numpy(model, jax.tree.map(np.asarray, ref_params), device="cpu")
    return ref, ref_params, model, params


# -- reference fault 8 --------------------------------------------------------------

def test_reference_fault_8_synth_batch_positions_are_2d():
    """``repro.data.pipeline.synth_batch`` gives (B, S) positions for every
    config; the reference's M-RoPE rope reads the last axis as the (t, h, w)
    streams, so its vlm ``train_loss`` raises ``TypeError`` on its own
    trainer's batches (and its trainer retries step 0 forever).  The port's
    rope refuses them too.  If the reference is fixed, this fails and
    ROADMAP.md's fault 8 is to be updated."""
    ref = RefLM(ref_get_config("qwen2_vl_72b").smoke(), attn_impl="chunked")
    ref_params = ref.init(jax.random.key(0))
    dcfg = ref_pipe.DataConfig(vocab_size=ref.cfg.vocab_size, seq_len=16, batch_per_shard=2)
    nb = ref_pipe.synth_batch(dcfg, 0, 0)
    assert nb["positions"].shape == (2, 16)
    with pytest.raises(TypeError, match="incompatible shapes for broadcasting"):
        ref.train_loss(ref_params, {k: jnp.asarray(v) for k, v in nb.items()})
    model = LM(get_config("qwen2_vl_72b").smoke(), attn_impl="chunked")
    with pytest.raises(ValueError):
        model.train_loss(model.init(0, device="cpu"),
                         {k: torch.from_numpy(v) for k, v in nb.items()})


# -- the completed batch ------------------------------------------------------------

@pytest.mark.parametrize("arch", OTHERS)
def test_other_families_batches_stay_byte_equal_to_synth_batch(arch):
    cfg = get_config(arch).smoke()
    for step in (0, 3):
        nb = pipeline.synth_batch(_data(cfg), step, 0)
        ref = ref_pipe.synth_batch(ref_pipe.DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                                       batch_per_shard=BATCH), step, 0)
        out = complete_batch(cfg, _data(cfg).seed, nb, step, 0)
        assert sorted(out) == sorted(ref)
        for k in ref:
            assert out[k].dtype == ref[k].dtype and out[k].tobytes() == ref[k].tobytes(), k


@pytest.mark.parametrize("arch", FAMILIES)
def test_completed_batch_has_the_train_shape(arch):
    """M-RoPE positions t = h = w = index, the embeddings of the train
    shape, the same for a step drawn again (a resumed run) and new for the
    next step or another data-parallel rank."""
    cfg = get_config(arch).smoke()
    b = _batch(cfg, 0)
    emb = "patch_embeds" if cfg.frontend == "vision" else "enc_embeds"
    n = min(N_PATCHES, SEQ) if emb == "patch_embeds" else SEQ
    assert b[emb].shape == (BATCH, n, cfg.d_model) and b[emb].dtype == np.float32
    assert 0.01 < b[emb].std() < 0.03
    if cfg.rope == "mrope":
        assert b["positions"].shape == (BATCH, SEQ, 3)
        assert (b["positions"] == np.arange(SEQ)[None, :, None]).all()
    else:
        assert b["positions"].shape == (BATCH, SEQ)
    again = _batch(cfg, 0)
    assert all(np.array_equal(again[k], b[k]) for k in b)
    dcfg = _data(cfg)
    other_rank = complete_batch(cfg, dcfg.seed, pipeline.synth_batch(dcfg, 0, 1), 0, 1)
    assert not np.array_equal(_batch(cfg, 1)[emb], b[emb])
    assert not np.array_equal(other_rank[emb], b[emb])


# -- against the reference ------------------------------------------------------------

def _both(b):
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in b.items()})


def test_step0_loss_matches_reference(pair):
    ref, ref_params, model, params = pair
    jb, tb = _both(_batch(model.cfg, 0))
    ref_loss = float(ref.train_loss(ref_params, jb))
    with torch.no_grad():
        loss = float(model.train_loss(params, tb))
    assert np.isfinite(loss) and abs(loss - ref_loss) < LOSS_TOL, (loss, ref_loss)


def _grad_errs(ref, ref_params, model, params, b):
    jb, tb = _both(b)
    ref_loss, ref_grads = jax.value_and_grad(ref.train_loss)(ref_params, jb)
    loss, grads = value_and_grad(model.train_loss, params, tb)
    ref_leaves = jax.tree_util.tree_flatten_with_path(ref_grads)[0]
    ours = leaves(grads)
    assert len(ours) == len(ref_leaves)
    errs = {}
    for (path, g_ref), g in zip(ref_leaves, ours):
        g_ref, g = np.asarray(g_ref), g.detach().numpy()
        assert g.shape == g_ref.shape and g.dtype == g_ref.dtype
        errs[jax.tree_util.keystr(path)] = (np.abs(g - g_ref).max()
                                            / max(np.abs(g_ref).max(), 1e-3))
    return float(loss), float(ref_loss), errs


def test_grads_match_reference(pair):
    """The gradients of the first AdamW step: every leaf within 1e-3 of the
    reference gradient's largest, in f32 for vlm and, both packages in
    float64, for encdec (whose f32 gradients lie up to 3e-2 of scale from
    float64 in either package: ROADMAP.md, tolerance notes)."""
    ref, ref_params, model, params = pair
    b = _batch(model.cfg, 0)
    if model.cfg.is_encdec:
        with float64():
            ref = RefLM(ref.cfg, attn_impl="chunked", remat=None)
            ref.dtype = jnp.dtype(jnp.float64)
            model = LM(model.cfg, attn_impl="chunked", remat=None)
            model.dtype = torch.float64
            ref_params = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)), ref_params)
            params = tree_map(lambda t: t.double(), params)
            b = {k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in b.items()}
            loss, ref_loss, errs = _grad_errs(ref, ref_params, model, params, b)
    else:
        loss, ref_loss, errs = _grad_errs(ref, ref_params, model, params, b)
    assert abs(loss - ref_loss) < LOSS_TOL
    bad = {k: e for k, e in errs.items() if e > GRAD_TOL}
    assert not bad, bad


# -- the launcher -----------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_launch_train_trains_the_family(arch, tmp_path):
    """``python -m repro_torch.launch.train --arch <arch> --device cpu``
    (smoke) takes its steps with finite losses and no recovery."""
    out = launch_train.main(["--arch", arch, "--steps", "3", "--seq", str(SEQ), "--batch",
                             str(BATCH), "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert [s for s, _ in out["history"]] == [0, 1, 2]
    assert all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) for _, m in out["history"])
    assert out["recoveries"] == 0


def test_donated_step_is_bit_equal_to_the_functional_step(monkeypatch):
    """The trainer's step (``donate=True``: params and moments updated in
    place, a slice at a time) against the functional step, two steps of the
    smoke vlm model, the slices made small so every leaf takes several."""
    from repro_torch.optim import adamw
    from repro_torch.train.step import build_train_step

    monkeypatch.setattr(adamw, "DONATE_SLICE", 1000)
    model = LM(get_config("qwen2_vl_72b").smoke(), attn_impl="chunked", remat=None)
    ocfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=10)
    runs = {}
    for donate in (False, True):
        params = model.init(0, device="cpu")
        opt = adamw.init_opt_state(params)
        step = build_train_step(model, ocfg, donate=donate)
        for i in range(2):
            before = leaves(params)
            params, opt, metrics = step(params, opt, {k: torch.from_numpy(v) for k, v in
                                                      _batch(model.cfg, i).items()})
            assert all((a is b) == donate for a, b in zip(leaves(params), before))
        runs[donate] = (params, opt, metrics)
    (p0, o0, m0), (p1, o1, m1) = runs[False], runs[True]
    assert {k: float(v) for k, v in m0.items()} == {k: float(v) for k, v in m1.items()}
    for a, b in zip(leaves((p0, o0)), leaves((p1, o1)), strict=True):
        assert torch.equal(a, b)


def test_a_train_step_frees_its_state_without_the_cycle_collector():
    """Port fault F4 (ROADMAP.md): ``tree.flatten``/``unflatten`` walked
    trees with recursive closures, reference cycles that held every leaf
    they saw (a step's gradients, the previous params and moments) until
    Python's cycle collector ran, so a few steps' state piled up on the
    card.  With the collector off, a step's gradients and the state it
    replaced are freed as soon as they are released."""
    import gc
    import weakref

    from repro_torch.optim import adamw
    from repro_torch.train.step import build_train_step

    model = LM(get_config("qwen2_vl_72b").smoke(), attn_impl="chunked", remat="full")
    batch = {k: torch.from_numpy(v) for k, v in _batch(model.cfg, 0).items()}
    params = model.init(0, device="cpu")
    value_and_grad(model.train_loss, params, batch)   # first call: lazy imports
    gc.collect()
    gc.disable()
    try:
        _, grads = value_and_grad(model.train_loss, params, batch)
        refs = [weakref.ref(t) for t in leaves(grads)]
        del grads
        assert all(r() is None for r in refs)
        opt = adamw.init_opt_state(params)
        step = build_train_step(model, adamw.AdamWConfig())
        refs = [weakref.ref(t) for t in leaves((params, opt))]
        params, opt, _ = step(params, opt, batch)
        assert all(r() is None for r in refs)
    finally:
        gc.enable()
