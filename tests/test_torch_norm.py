"""The norm as one autograd function (``repro_torch.models.layers.apply_norm``,
port fault P1): its forward runs the formula the port ran before, op for op
in the same order, on one f32 copy of x worked in place, so its output is
bit-equal to the formula's (kept here as ``formula``) and within 2e-5 of
the reference's ``repro.models.layers.apply_norm``; its backward keeps x in
its own dtype, the f32 mean and reciprocal RMS and the scale, and its
gradients are held to autograd through the formula.  LayerNorm (with a
bias) and RMSNorm, float32 and bfloat16 inputs, on seeded numpy draws."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as ref_layers  # noqa: E402
from repro_torch.models import layers  # noqa: E402

FORMS = ["layernorm", "rmsnorm"]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SHAPE = (3, 40, 96)
REF_TOL = 2e-5
GRAD_TOL = 1e-5


def formula(p, x, eps: float = 1e-6):
    """``apply_norm`` as it was before it became an autograd function."""
    xf = x.float()
    if "bias" in p:
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:
        ms = (xf * xf).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * p["scale"]
    return out.to(x.dtype)


def _inputs(form, dtype, seed=0):
    """x (3, 40, 96) off centre with a spread of row scales, the params
    around their init, the output's cotangent; float32 numpy draws."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=SHAPE) * rng.uniform(0.1, 4.0, size=SHAPE[:-1] + (1,)) + 0.7)
    p = {"scale": 1 + 0.1 * rng.normal(size=SHAPE[-1])}
    if form == "layernorm":
        p["bias"] = 0.1 * rng.normal(size=SHAPE[-1])
    g = rng.normal(size=SHAPE)
    t = {k: torch.from_numpy(v.astype(np.float32)) for k, v in p.items()}
    return torch.from_numpy(x.astype(np.float32)).to(dtype), t, torch.from_numpy(
        g.astype(np.float32)).to(dtype), {k: v.astype(np.float32) for k, v in p.items()}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("form", FORMS)
def test_forward_is_bit_equal_to_the_formula_and_near_the_reference(form, dtype):
    x, p, _, p_np = _inputs(form, DTYPES[dtype])
    out = layers.apply_norm(p, x)
    assert out.dtype == x.dtype
    assert torch.equal(out, formula(p, x))
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16 if dtype == "bfloat16" else
                                               jnp.float32)
    ref = np.asarray(ref_layers.apply_norm({k: jnp.asarray(v) for k, v in p_np.items()}, jx)
                     .astype(jnp.float32))
    err = float(np.abs(out.float().numpy() - ref).max())
    assert err <= REF_TOL, err


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("form", FORMS)
def test_gradients_match_autograd_through_the_formula(form, dtype):
    """Every gradient within 1e-5 of its largest of autograd through the
    formula on the same inputs, computed in f32 (x's cast to x's dtype)."""
    x, p, g, _ = _inputs(form, DTYPES[dtype])
    grads = []
    for fn in (layers.apply_norm, formula):
        xs = x.clone().requires_grad_()
        ps = {k: v.clone().requires_grad_() for k, v in p.items()}
        fn(ps, xs).backward(g)
        grads.append({"x": xs.grad, **{k: v.grad for k, v in ps.items()}})
    mine, want = grads
    for k, v in want.items():
        assert mine[k].dtype == v.dtype
        scale = float(v.float().abs().max())
        err = float((mine[k].float() - v.float()).abs().max())
        assert err <= GRAD_TOL * scale, (k, err, scale)


@pytest.mark.parametrize("form", FORMS)
def test_backward_keeps_x_in_its_dtype_and_the_row_statistics(form):
    """What autograd saves for the norm's backward on a bfloat16 input: x
    itself (bfloat16), the f32 mean (layernorm) and reciprocal RMS, one a
    row, and the scale; no f32 tensor of x's shape (before: the f32 copy of
    x and the products of it)."""
    x, p, _, _ = _inputs(form, torch.bfloat16)
    saved = []

    def pack(t):
        saved.append((t.dtype, tuple(t.shape)))
        return t

    xs = x.clone().requires_grad_()
    ps = {k: v.clone().requires_grad_() for k, v in p.items()}
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        layers.apply_norm(ps, xs)
    rows = SHAPE[:-1] + (1,)
    want = [(torch.bfloat16, SHAPE)] + [(torch.float32, rows)] * (2 if form == "layernorm" else 1)
    assert sorted(saved, key=str) == sorted(want + [(torch.float32, SHAPE[-1:])], key=str)


@pytest.mark.parametrize("form", FORMS)
def test_a_float32_input_is_left_as_it_is(form):
    """The forward works in place on a copy: a float32 x (whose ``.float()``
    is x itself) comes back unchanged."""
    x, p, _, _ = _inputs(form, torch.float32)
    before = x.clone()
    layers.apply_norm(p, x)
    assert torch.equal(x, before)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("form", FORMS)
def test_rows_in_chunks_give_the_same_norm(monkeypatch, form, dtype):
    """A chunk of 7 rows at a time (``layers.CHUNK_BYTES``; 18 chunks of the
    120 rows, the last one short): the forward still bit-equal to the
    formula, the gradients within 1e-5 of their largest of autograd
    through it."""
    monkeypatch.setattr(layers, "CHUNK_BYTES", 4 * SHAPE[-1] * 7)
    test_forward_is_bit_equal_to_the_formula_and_near_the_reference(form, dtype)
    test_gradients_match_autograd_through_the_formula(form, dtype)
