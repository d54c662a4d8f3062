"""The port's training path against the reference on the same numpy inputs
(CPU): the loss, its gradients, AdamW, gradient compression, the data
pipeline, checkpoints, the train step and the trainer, and the launcher.
Weights come from the reference's init through ``models/bridge.py``.

Tolerances: the data pipeline is byte-equal; the smoke model's loss within
2e-5 and its per-leaf gradients within 1e-3 of each leaf's largest
gradient (the init's near one-hot attention rows amplify float32 rounding
in the backward: against a float64 backward of the same weights the
reference's f32 gradients are off by up to 1.0e-4 of the largest, the
port's by up to 5.2e-4; ROADMAP.md, tolerance notes);
optimizer arithmetic within 2e-6 (one f32 update); three train steps as
``test_three_train_steps_match_reference`` states, against the reference's
own spread between its attention paths."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.ckpt import checkpoint as ref_ckpt  # noqa: E402
from repro.configs.base import RunShape as RefRunShape  # noqa: E402
from repro.configs.registry import get_config as ref_get_config  # noqa: E402
from repro.data import pipeline as ref_pipe  # noqa: E402
from repro.launch.inputs import make_batch as ref_make_batch  # noqa: E402
from repro.models.transformer import LM as RefLM, cross_entropy as ref_ce  # noqa: E402
from repro.optim import adamw as ref_opt  # noqa: E402
from repro.optim import compression as ref_comp  # noqa: E402
from repro.train.step import build_train_step as ref_build_train_step  # noqa: E402
from repro_torch.ckpt import checkpoint as ckpt  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.data import pipeline as pipe  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.models.transformer import LM, cross_entropy  # noqa: E402
from repro_torch.optim import adamw as opt  # noqa: E402
from repro_torch.optim import compression as comp  # noqa: E402
from repro_torch.train.step import build_eval_step, build_train_step, value_and_grad  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from repro_torch.tree import flatten, leaves, tree_map, unflatten  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several test processes at once; one torch thread per
    process keeps them from contending for the cores (it is no slower here)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _err(ours, ref):
    return float(np.abs(np.asarray(ours, np.float32) - np.asarray(ref, np.float32)).max())


def _np(t):
    return t.detach().float().numpy()


@pytest.fixture(scope="module")
def pair():
    """(reference LM, its f32 params, port LM, bridged params, numpy tree)."""
    ref = RefLM(ref_get_config("stablelm_1_6b").smoke(), attn_impl="naive", remat=None)
    ref_params = ref.init(jax.random.key(0))
    tree = jax.tree.map(np.asarray, ref_params)
    model = LM(get_config("stablelm_1_6b").smoke(), attn_impl="naive", remat=None)
    return ref, ref_params, model, params_from_numpy(model, tree, device="cpu"), tree


def _data_cfg(mod, seq=32, batch=4, vocab=512):
    return mod.DataConfig(vocab_size=vocab, seq_len=seq, batch_per_shard=batch)


def _batches(step=0, **kw):
    nb = ref_pipe.synth_batch(_data_cfg(ref_pipe, **kw), step, 0)
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(v) for k, v in nb.items()})


# -- tree order ------------------------------------------------------------------

def test_tree_flatten_order_is_jax_order(pair):
    _, ref_params, _, params, _ = pair
    state = {"params": params, "opt": opt.init_opt_state(params)}
    ref_state = {"params": ref_params, "opt": ref_opt.init_opt_state(ref_params)}
    ours, tdef = flatten(state)
    theirs = jax.tree.leaves(ref_state)
    assert [tuple(x.shape) for x in ours] == [tuple(x.shape) for x in theirs]
    back = unflatten(tdef, ours)
    assert back["opt"].step is state["opt"].step and set(back) == {"params", "opt"}
    assert leaves(None) == [] and tree_map(lambda a: a + 1, {"b": 1, "a": (2, 3)}) == {"a": (3, 4), "b": 2}


# -- loss and gradients -------------------------------------------------------------

@pytest.mark.parametrize("masked", [True, False])
def test_cross_entropy_matches_reference(masked):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 7, 50)).astype(np.float32) * 4
    targets = rng.integers(0, 50, size=(3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) > 0.3).astype(np.float32) if masked else None
    ref = ref_ce(jnp.asarray(logits), jnp.asarray(targets), None if mask is None else jnp.asarray(mask))
    ours = cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets),
                         None if mask is None else torch.from_numpy(mask))
    assert abs(float(ours) - float(ref)) < 2e-5


def test_train_loss_matches_reference(pair):
    ref, ref_params, model, params, _ = pair
    jb, tb = _batches(seq=48)
    ref_loss = float(ref.train_loss(ref_params, jb))
    with torch.no_grad():
        assert abs(float(model.train_loss(params, tb)) - ref_loss) < 2e-5
    assert abs(float(build_eval_step(model)(params, tb)) - ref_loss) < 2e-5


@pytest.mark.parametrize("remat", [None, "full"])
def test_grads_match_reference_value_and_grad(pair, remat):
    ref, ref_params, model, params, _ = pair
    jb, tb = _batches(step=1, seq=48)
    ref_loss, ref_grads = jax.value_and_grad(ref.train_loss)(ref_params, jb)
    model = LM(model.cfg, attn_impl="chunked", remat=remat)
    loss, grads = value_and_grad(model.train_loss, params, tb)
    assert abs(float(loss) - float(ref_loss)) < 2e-5
    ref_leaves = jax.tree_util.tree_flatten_with_path(ref_grads)[0]
    ours = leaves(grads)
    assert len(ours) == len(ref_leaves)
    for (path, g_ref), g in zip(ref_leaves, ours):
        g_ref = np.asarray(g_ref)
        assert g.shape == g_ref.shape
        assert _err(_np(g), g_ref) <= 1e-3 * max(np.abs(g_ref).max(), 1e-3), path
    assert all(not p.requires_grad for p in leaves(params))   # grads did not leak into params


# -- remat="dots" ----------------------------------------------------------------

REMAT_ARCHS = ["stablelm_1_6b", "granite_moe_1b_a400m", "zamba2_7b", "rwkv6_7b",
               "seamless_m4t_medium"]


class _Products(TorchDispatchMode):
    """Counts the matrix products a region runs: ``"mm"`` those with no
    batch dimension (``mm``, ``addmm``, a ``bmm`` with an operand broadcast
    over its batch), ``"bmm"`` the batched ones."""

    def __init__(self):
        super().__init__()
        self.n = {"mm": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in ("mm", "addmm"):
            self.n["mm"] += 1
        elif name == "bmm":
            self.n["mm" if 0 in (args[0].stride(0), args[1].stride(0)) else "bmm"] += 1
        return func(*args, **(kwargs or {}))


def _remat_pair(arch, remat):
    """(reference LM(remat=...), its key-0 params, port LM(remat=...), bridged
    params, a 16-token train batch of ``launch/inputs.py`` for both)."""
    ref = RefLM(ref_get_config(arch).smoke(), attn_impl="naive", remat=remat)
    ref_params = ref.init(jax.random.key(0))
    model = LM(get_config(arch).smoke(), attn_impl="naive", remat=remat)
    params = params_from_numpy(model, jax.tree.map(np.asarray, ref_params), device="cpu")
    jb = ref_make_batch(ref.cfg, RefRunShape("t", 16, 2, "train"), 1)
    tb = {k: torch.from_numpy(np.array(v, np.float32 if k in ("enc_embeds", "loss_mask")
                                       else np.int64)) for k, v in jb.items()}
    return ref, ref_params, model, params, jb, tb


def _grads_and_products(model, params, batch):
    """The train loss's gradients, and the products the forward and the
    backward each ran."""
    flat, tdef = flatten(params)
    lv = [p.detach().requires_grad_(True) for p in flat]
    fwd, bwd = _Products(), _Products()
    with torch.enable_grad():
        with fwd:
            loss = model.train_loss(unflatten(tdef, lv), batch)
        with bwd:
            grads = torch.autograd.grad(loss, lv)
    return grads, fwd.n, bwd.n


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_dots_and_full_grads_equal_no_remat(arch):
    """Recomputing in the backward pass changes no gradient: bit-equal to
    ``remat=None`` on the CPU, for every family's remat body."""
    *_, model, params, _, tb = _remat_pair(arch, None)
    base, _, _ = _grads_and_products(model, params, tb)
    for remat in ("dots", "full"):
        grads, _, _ = _grads_and_products(LM(model.cfg, attn_impl="naive", remat=remat),
                                          params, tb)
        assert all(torch.equal(a, b) for a, b in zip(base, grads)), remat


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_dots_recomputes_no_unbatched_product(arch):
    """A dispatch-mode count of the backward pass: under ``"dots"`` it runs
    as many unbatched products as without remat (every projection's output
    was saved, none recomputed) and more batched ones (attention scores,
    expert products and the like are recomputed); under ``"full"`` it also
    recomputes the layers' unbatched products.  The forward is the same
    under all three."""
    *_, model, params, _, tb = _remat_pair(arch, None)
    runs = {remat: _grads_and_products(LM(model.cfg, attn_impl="naive", remat=remat), params, tb)
            for remat in (None, "dots", "full")}
    (_, fwd, bwd), (_, fwd_d, bwd_d), (_, fwd_f, bwd_f) = runs[None], runs["dots"], runs["full"]
    assert fwd == fwd_d == fwd_f and fwd["mm"] > 0 and fwd["bmm"] > 0
    assert bwd_d["mm"] == bwd["mm"] and bwd_d["bmm"] > bwd["bmm"]
    assert bwd_f["mm"] > bwd["mm"] and bwd_f["bmm"] == bwd_d["bmm"]


@pytest.mark.parametrize("arch", REMAT_ARCHS[:-1])
def test_remat_dots_grads_match_reference(arch):
    """``LM(remat="dots")`` in both packages: the loss within 2e-5 and every
    leaf within 1e-3 of the reference gradient's largest (the encdec family
    is held in float64, tests/test_torch_encdec.py::test_grads_match_reference)."""
    ref, ref_params, model, params, jb, tb = _remat_pair(arch, "dots")
    ref_loss, ref_grads = jax.value_and_grad(ref.train_loss)(ref_params, jb)
    loss, grads = value_and_grad(model.train_loss, params, tb)
    assert abs(float(loss) - float(ref_loss)) < 2e-5 * max(1.0, abs(float(ref_loss)))
    ref_leaves = jax.tree_util.tree_flatten_with_path(ref_grads)[0]
    assert len(leaves(grads)) == len(ref_leaves)
    for (path, g_ref), g in zip(ref_leaves, leaves(grads)):
        g_ref = np.asarray(g_ref)
        assert _err(_np(g), g_ref) <= 1e-3 * max(np.abs(g_ref).max(), 1e-3), path


def test_remat_takes_none_full_or_dots():
    cfg = get_config("stablelm_1_6b").smoke()
    assert [LM(cfg, remat=r).remat for r in (None, "none", "full", "dots")] == [
        None, None, "full", "dots"]
    with pytest.raises(ValueError):
        LM(cfg, remat="offload")


# -- optimizer -------------------------------------------------------------------------

def _random_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(6, 5)).astype(np.float32),
            "b": {"c": rng.normal(size=(7,)).astype(np.float32) * 3}}


@pytest.mark.parametrize("step", [0, 1, 3, 5, 6, 50, 99, 100, 150])
def test_schedule_matches_reference(step):
    cfg = dict(lr=3e-3, warmup_steps=5, total_steps=100)
    ref = ref_opt.schedule(ref_opt.AdamWConfig(**cfg), jnp.asarray(step, jnp.int32))
    ours = opt.schedule(opt.AdamWConfig(**cfg), torch.tensor(step, dtype=torch.int32))
    assert abs(float(ours) - float(ref)) <= 1e-6 * 3e-3


def test_apply_updates_matches_reference():
    """Three AdamW updates with clipping on (grad norm above 1) and off."""
    p, cfg = _random_tree(1), dict(lr=1e-2, warmup_steps=1, total_steps=10)
    rp, tp = jax.tree.map(jnp.asarray, p), tree_map(torch.from_numpy, p)
    rs, ts = ref_opt.init_opt_state(rp), opt.init_opt_state(tp)
    for i, gscale in enumerate((0.01, 3.0, 0.1)):
        g = tree_map(lambda a: a * gscale, _random_tree(10 + i))
        assert abs(float(opt.global_norm(tree_map(torch.from_numpy, g)))
                   - float(ref_opt.global_norm(jax.tree.map(jnp.asarray, g)))) < 2e-6 * (1 + 10 * gscale)
        rp, rs, rm = ref_opt.apply_updates(rp, jax.tree.map(jnp.asarray, g), rs, ref_opt.AdamWConfig(**cfg))
        tp, ts, tm = opt.apply_updates(tp, tree_map(torch.from_numpy, g), ts, opt.AdamWConfig(**cfg))
        for a, b in zip(leaves(tp) + leaves(ts.mu) + leaves(ts.nu), jax.tree.leaves((rp, rs.mu, rs.nu))):
            assert _err(_np(a), b) < 2e-6
        assert int(ts.step) == int(rs.step) == i + 1 and ts.step.dtype == torch.int32
        assert abs(float(tm["lr"]) - float(rm["lr"])) < 1e-9
    assert tp["w"].dtype == torch.float32


def test_apply_updates_keeps_bf16_params_and_f32_moments():
    p = {"w": torch.randn(4, 3, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)}
    state = opt.init_opt_state(p)
    new, state, _ = opt.apply_updates(p, {"w": torch.ones(4, 3, dtype=torch.bfloat16)}, state,
                                      opt.AdamWConfig(lr=0.1, warmup_steps=0))
    assert new["w"].dtype == torch.bfloat16 and state.mu["w"].dtype == torch.float32
    assert not torch.equal(new["w"], p["w"])


def test_round_half_to_even_in_both():
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5], np.float32)
    assert np.array_equal(torch.round(torch.from_numpy(x)).numpy(), np.asarray(jnp.round(jnp.asarray(x))))
    assert torch.round(torch.from_numpy(x)).tolist() == [-2, -2, -0, 0, 2, 2, 4]


def test_compress_grads_matches_reference():
    """Error-feedback compression over 4 steps, including values that land
    exactly half-way between two quantization levels."""
    g = _random_tree(3)
    g["w"][0, :3] = np.array([63.5, -63.5, 127.0]) * (np.abs(g["w"]).max() / 127.0)
    re, te = ref_comp.init_error_state(jax.tree.map(jnp.asarray, g)), comp.init_error_state(
        tree_map(torch.from_numpy, g))
    for step in range(4):
        gs = tree_map(lambda a: a * (1 + 0.1 * step), g)
        rd, re = ref_comp.compress_grads(jax.tree.map(jnp.asarray, gs), re)
        td, te = comp.compress_grads(tree_map(torch.from_numpy, gs), te)
        for a, b in zip(leaves(td) + leaves(te), jax.tree.leaves((rd, re))):
            assert _err(_np(a), b) < 1e-6


def test_compression_error_feedback_unbiased():
    rng = np.random.default_rng(0)
    g = {"w": torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32))}
    err = comp.init_error_state(g)
    acc = np.zeros((64, 64))
    acc_raw = np.zeros((64, 64))
    for step in range(50):
        gs = {"w": g["w"] * (1.0 + 0.01 * step)}
        deq, err = comp.compress_grads(gs, err)
        acc += deq["w"].double().numpy()
        acc_raw += gs["w"].double().numpy()
    assert np.abs(acc - acc_raw).max() / np.abs(acc_raw).max() < 0.01


# -- data ------------------------------------------------------------------------------

@pytest.mark.parametrize("kw,step,rank", [
    (dict(vocab=1000, seq=128, batch=4), 7, 3),
    (dict(vocab=512, seq=32, batch=4), 0, 0),
    (dict(vocab=100352, seq=128, batch=8), 19, 0),
])
def test_synth_batch_byte_equal(kw, step, rank):
    ref = ref_pipe.synth_batch(_data_cfg(ref_pipe, **kw), step, rank)
    ours = pipe.synth_batch(_data_cfg(pipe, **kw), step, rank)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and ours[k].tobytes() == ref[k].tobytes(), k


def test_data_iterator_resumes_at_step():
    it = pipe.DataIterator(_data_cfg(pipe), dp_rank=0, start_step=5)
    step, batch = next(it)
    it.close()
    assert step == 5
    assert batch["tokens"].tobytes() == ref_pipe.synth_batch(_data_cfg(ref_pipe), 5, 0)["tokens"].tobytes()


# -- checkpoints ------------------------------------------------------------------------

def _ckpt_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32)),
            "b": {"c": torch.from_numpy(rng.integers(0, 9, (3,)).astype(np.int32))}}


def test_checkpoint_roundtrip_with_bf16_and_opt_state(tmp_path):
    t = _ckpt_tree()
    t["h"] = torch.randn(5, 3, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    t["opt"] = opt.init_opt_state({"x": t["a"]})
    ckpt.save(str(tmp_path), 7, t)
    assert ckpt.latest_step(str(tmp_path)) == 7
    meta = json.loads((tmp_path / "step_00000007" / "manifest.json").read_text())
    assert meta["complete"] and "bfloat16" in [leaf["dtype"] for leaf in meta["leaves"]]
    got = ckpt.restore(str(tmp_path), 7, t)
    for a, b in zip(leaves(t), leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_incomplete_checkpoint_ignored(tmp_path):
    ckpt.save(str(tmp_path), 5, _ckpt_tree())
    d = tmp_path / "step_00000009"
    d.mkdir()
    (d / "manifest.json").write_text(json.dumps({"step": 9, "complete": False, "n_leaves": 0, "leaves": []}))
    assert ckpt.latest_step(str(tmp_path)) == 5


def test_gc_keeps_latest(tmp_path):
    for s in [1, 2, 3, 4, 5]:
        ckpt.save(str(tmp_path), s, _ckpt_tree(), keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step_00000004", "step_00000005"]


def test_restore_validates_shapes(tmp_path):
    ckpt.save(str(tmp_path), 1, _ckpt_tree())
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), 1, {"a": torch.zeros(2, 2), "b": {"c": torch.zeros(3, dtype=torch.int32)}})
    with pytest.raises(ValueError, match="leaf count"):
        ckpt.restore(str(tmp_path), 1, {"a": torch.zeros(4, 8)})


def test_checkpoint_cross_reads_with_reference(tmp_path):
    """float32 (and int) trees written by one package restore in the other."""
    t = _ckpt_tree(2)
    ckpt.save(str(tmp_path / "port"), 3, t)
    jt = jax.tree.map(lambda a: jnp.asarray(a.numpy()), t)
    got = ref_ckpt.restore(str(tmp_path / "port"), 3, jt)
    for a, b in zip(leaves(t), jax.tree.leaves(got)):
        assert np.array_equal(a.numpy(), np.asarray(b)) and a.numpy().dtype == np.asarray(b).dtype
    ref_ckpt.save(str(tmp_path / "ref"), 4, jt)
    assert ckpt.latest_step(str(tmp_path / "ref")) == 4
    back = ckpt.restore(str(tmp_path / "ref"), 4, t)
    for a, b in zip(leaves(t), leaves(back)):
        assert torch.equal(a, b)


# -- the train step ------------------------------------------------------------------------

def _update_error(ours, theirs, init) -> float:
    """||p_port - p_ref|| / ||p_ref - p_init|| over all leaves."""
    num = den = 0.0
    for a, b, c in zip(leaves(ours), jax.tree.leaves(theirs), jax.tree.leaves(init)):
        b, c = np.asarray(b, np.float64), np.asarray(c, np.float64)
        num += float(((_np(a) - b) ** 2).sum())
        den += float(((b - c) ** 2).sum())
    return (num / den) ** 0.5


@pytest.mark.parametrize("accum", [1, 2])
def test_three_train_steps_match_reference(pair, accum):
    """Three train steps from the same weights on the same batches.  AdamW
    moves every element by about lr whatever its gradient's size, so an
    element whose gradient is below float32 rounding moves either way, and
    with this init the runs part quickly: the reference run with naive
    attention against itself with chunked attention has its losses 1.15e-3
    apart (relative) at step 3 and its params 7.9e-2 apart (relative to the
    update); port against reference, 6.4e-5 and 8.9e-2.  Held: step 1 as
    tight as the gradients (loss 2e-5, grad norm 1e-4 relative, params 1e-2
    of the update); steps 2-3 losses within 1e-3 relative, params within
    0.2 of the update."""
    ref, ref_params, model, params, _ = pair
    ocfg = dict(lr=3e-3, warmup_steps=1, total_steps=10)
    rstep = jax.jit(ref_build_train_step(ref, ref_opt.AdamWConfig(**ocfg), accum_steps=accum))
    tstep = build_train_step(model, opt.AdamWConfig(**ocfg), accum_steps=accum)
    rp, rs, tp, ts = ref_params, ref_opt.init_opt_state(ref_params), params, opt.init_opt_state(params)
    for step in range(3):
        jb, tb = _batches(step)
        rp, rs, rm = rstep(rp, rs, jb)
        tp, ts, tm = tstep(tp, ts, tb)
        loss, ref_loss = float(tm["loss"]), float(rm["loss"])
        if step == 0:
            assert abs(loss - ref_loss) < 2e-5
            assert abs(float(tm["grad_norm"]) - float(rm["grad_norm"])) < 1e-4 * float(rm["grad_norm"])
            assert _update_error(tp, rp, ref_params) < 1e-2
        else:
            assert abs(loss - ref_loss) < 1e-3 * ref_loss
    assert _update_error(tp, rp, ref_params) < 0.2
    assert int(ts.step) == 3


def test_grad_accumulation_matches_full_batch(pair):
    _, _, model, params, _ = pair
    ocfg = opt.AdamWConfig(warmup_steps=0, total_steps=10)
    _, tb = _batches()
    p1, _, m1 = build_train_step(model, ocfg, accum_steps=1)(params, opt.init_opt_state(params), tb)
    p2, _, m2 = build_train_step(model, ocfg, accum_steps=2)(params, opt.init_opt_state(params), tb)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-5
    for a, b in zip(leaves(p1), leaves(p2)):
        assert _err(_np(a), _np(b)) < 1e-5


def test_compressed_train_step_takes_and_returns_error_state(pair):
    _, _, model, params, _ = pair
    step = build_train_step(model, opt.AdamWConfig(warmup_steps=1), grad_compression=True)
    _, tb = _batches()
    out = step(params, opt.init_opt_state(params), tb, comp.init_error_state(params))
    assert len(out) == 4 and set(leaves(out[2])[0].shape) == set(leaves(params)[0].shape)


# -- the trainer -----------------------------------------------------------------------------

def _trainer(pair, tmp, total, every, **kw):
    _, _, model, _, tree = pair
    tcfg = TrainerConfig(total_steps=total, ckpt_every=every, ckpt_dir=str(tmp), log_every=1000,
                         **kw.pop("tcfg", {}))
    ocfg = kw.pop("ocfg", opt.AdamWConfig(warmup_steps=2, total_steps=20))
    return Trainer(model, kw.pop("data", _data_cfg(pipe)), ocfg, tcfg, device="cpu",
                   init_params=lambda: params_from_numpy(model, tree, device="cpu"),
                   log=lambda s: None, **kw)


def test_loss_decreases(pair, tmp_path):
    out = _trainer(pair, tmp_path, 40, 100, data=_data_cfg(pipe, seq=64, batch=8),
                   ocfg=opt.AdamWConfig(lr=5e-3, warmup_steps=5, total_steps=40)).run()
    hist = [m["loss"] for _, m in out["history"]]
    assert np.mean(hist[-5:]) < np.mean(hist[:5]) - 0.5, hist


def test_checkpoint_resume_bit_exact(pair, tmp_path):
    out_a = _trainer(pair, tmp_path / "a", 10, 100).run()
    _trainer(pair, tmp_path / "b", 5, 5).run()
    out_b = _trainer(pair, tmp_path / "b", 10, 100).run()
    assert [s for s, _ in out_b["history"]] == list(range(5, 10))
    for a, b in zip(leaves(out_a["params"]), leaves(out_b["params"])):
        assert torch.equal(a, b)


def test_failure_recovery(pair, tmp_path):
    boom = {"armed": True}

    def failure_hook(step):
        if step == 7 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("injected node failure")

    out = _trainer(pair, tmp_path, 10, 5, failure_hook=failure_hook).run()
    assert out["recoveries"] == 1
    assert max(s for s, _ in out["history"]) == 9


def test_repeated_failure_raises_instead_of_looping(pair, tmp_path):
    """A step that fails again after its recovery propagates (the reference
    replays it forever)."""
    calls = []

    def failure_hook(step):
        if step == 3:
            calls.append(step)
            raise RuntimeError("deterministic fault")

    t = _trainer(pair, tmp_path, 6, 2, failure_hook=failure_hook)
    with pytest.raises(RuntimeError, match="deterministic fault"):
        t.run()
    assert calls == [3, 3] and t.recoveries == 1


def test_grad_compression_trainer_raises_as_the_reference_cannot_run_it(pair, tmp_path):
    """``grad_compression=True``: the step wants an error state the loop
    never passes, as in the reference (which retries step 0 forever); the
    port's trainer raises after one recovery."""
    t = _trainer(pair, tmp_path, 3, 100, tcfg={"grad_compression": True})
    with pytest.raises((ValueError, TypeError, AttributeError)):
        t.run()
    assert t.recoveries == 1 and not t.metrics_history


def test_launch_train_lowers_the_loss_on_cpu(tmp_path, capsys):
    out = launch_train.main(["--arch", "stablelm_1_6b", "--steps", "20", "--device", "cpu",
                             "--ckpt-dir", str(tmp_path)])
    losses = [m["loss"] for _, m in out["history"]]
    assert len(losses) == 20 and losses[-1] < losses[0] - 0.2
    assert "[train] stablelm_1_6b: loss" in capsys.readouterr().out


def test_entry_points_need_a_card_unless_asked_for_the_cpu(pair, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, model, _, _ = pair
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(model, _data_cfg(pipe), opt.AdamWConfig(), TrainerConfig(ckpt_dir=str(tmp_path)))
