"""The decay-attention kernel's path rule (``kernels/decay_attention/ops.py:
kernel_path``) on the CPU, where no kernel runs: which path each call
takes, decided from type and strides alone, which bfloat16 views the
tensor-core paths refuse, and which float32 views go to ``simt``.  The
model's own views are taken from its layer code at smoke width (bfloat16
and float32) and rebuilt at full width, so the full-width main path is
known to meet the 16-byte row rule before it runs on the card.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels.decay_attention import ops as decay_ops  # noqa: E402
from repro_torch.models import mamba2 as m2  # noqa: E402
from repro_torch.models import rwkv6 as r6  # noqa: E402
from repro_torch.models.transformer import LM  # noqa: E402

BF16 = torch.bfloat16


def _mamba_views(B, S, H, d_in, ns, hd, dtype=BF16):
    """``mamba2.py``'s call: C and B are slices of the conv output ``xBC``
    (d_in + 2 ns wide) broadcast over heads, v a fresh tensor, the per-head
    f32 decay broadcast over the state dim."""
    xBC = torch.zeros(B, S, d_in + 2 * ns, dtype=dtype)
    _, Bp, Cp = torch.split(xBC, [d_in, ns, ns], dim=-1)
    q = Cp[:, :, None, :].expand(B, S, H, ns)
    k = Bp[:, :, None, :].expand(B, S, H, ns)
    v = torch.zeros(B, S, H, hd, dtype=dtype)
    log_w = torch.zeros(B, S, H, dtype=torch.float32)[..., None].expand(B, S, H, ns)
    return q, k, v, log_w


def _rwkv_views(B, S, d, hd, dtype=BF16):
    """``rwkv6.py``'s call: projections reshaped to heads, an f32 decay."""
    H = d // hd
    r, k, v = ((torch.zeros(B, S, d, dtype=dtype) @ torch.zeros(d, d, dtype=dtype))
               .reshape(B, S, H, hd) for _ in range(3))
    log_w = torch.zeros(B, S, d, dtype=torch.float32).reshape(B, S, H, hd)
    return r, k, v, log_w


@pytest.mark.parametrize("arch,path", [("zamba2_7b", "scalar_tc"), ("rwkv6_7b", "vector_tc")])
def test_model_layer_views_take_their_path(monkeypatch, arch, path):
    """The calls the smoke model's own layer code makes take their family's
    tensor-core path: in bfloat16, and in float32 its f32 sibling."""
    seen = []

    def capture(q, k, v, log_w, **kw):
        seen.append((q.dtype, decay_ops.kernel_path(q, k, v, log_w)))
        B, S, H, _ = q.shape
        y = torch.zeros(B, S, H, v.shape[-1], dtype=q.dtype)
        return y, torch.zeros(B, H, q.shape[-1], v.shape[-1])

    monkeypatch.setattr(m2 if arch == "zamba2_7b" else r6, "chunked_decay_attention", capture)
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(get_config(arch).smoke(), dtype=dtype)
        model = LM(cfg, remat=None)
        params = model.init(0, device="cpu")
        tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 40)))
        batch = {"tokens": tokens, "positions": torch.arange(40)[None].expand(2, 40)}
        with torch.no_grad():
            model.prefill_logits(params, batch)
    n = get_config(arch).smoke().n_layers
    assert seen == [(BF16, path)] * n + [(torch.float32, f"{path}_f32")] * n


@pytest.mark.parametrize("dtype", [BF16, torch.float32], ids=["bf16", "f32"])
def test_full_width_views_meet_the_row_rule(dtype):
    """At full width: zamba2_7b's xBC rows are 7296 elements (C at 7232, B
    at 7168, each a multiple of 8), rwkv6_7b's heads 64 wide; in bfloat16
    and in float32 they take the tensor-core paths."""
    suffix = "" if dtype == BF16 else "_f32"
    zc, rc = get_config("zamba2_7b"), get_config("rwkv6_7b")
    d_in = zc.ssm_expand * zc.d_model
    views = _mamba_views(2, 33, d_in // zc.ssm_head_dim, d_in, zc.ssm_state, zc.ssm_head_dim,
                         dtype)
    assert views[0].stride(1) == d_in + 2 * zc.ssm_state == 7296
    assert decay_ops.kernel_path(*views) == "scalar_tc" + suffix
    views = _rwkv_views(2, 33, rc.d_model, rc.ssm_head_dim, dtype)
    assert decay_ops.kernel_path(*views) == "vector_tc" + suffix


@pytest.mark.parametrize("arch", ["zamba2_7b", "rwkv6_7b"])
def test_smoke_views_meet_the_f32_row_rule(arch):
    """At smoke width (state and heads 16 wide) the float32 views take the
    tensor-core path too: zamba2's C and B start at whole 16 bytes of xBC."""
    cfg = get_config(arch).smoke()
    if arch == "zamba2_7b":
        d_in = cfg.ssm_expand * cfg.d_model
        views = _mamba_views(2, 40, d_in // cfg.ssm_head_dim, d_in, cfg.ssm_state,
                             cfg.ssm_head_dim, torch.float32)
        assert (d_in * 4) % 16 == 0 and decay_ops.kernel_path(*views) == "scalar_tc_f32"
    else:
        views = _rwkv_views(2, 40, cfg.d_model, cfg.ssm_head_dim, torch.float32)
        assert decay_ops.kernel_path(*views) == "vector_tc_f32"


def test_kernel_path_rule_and_refusals():
    q, k, v, lw = _rwkv_views(1, 8, 64, 16)
    assert decay_ops.kernel_path(q.float(), k.float(), v.float(), lw) == "vector_tc_f32"
    # float32 takes any view: one the 16-byte copies cannot read goes to the
    # CUDA-core kernel, which reads element by element
    assert decay_ops.kernel_path(q.float()[..., ::2], k.float()[..., ::2], v.float(),
                                 lw[..., ::2]) == "simt"
    # stride 0 over heads for q and k but a per-channel decay: vector
    qs, ks, vs, lws = _mamba_views(1, 8, 4, 32, 16, 16)
    assert decay_ops.kernel_path(qs, ks, vs, lws.contiguous()) == "vector_tc"
    assert decay_ops.kernel_path(qs, ks, vs, lws) == "scalar_tc"
    bad = {
        "dk not a multiple of 8": _rwkv_views(1, 8, 48, 12),
        "unaligned base": (torch.zeros(q.numel() + 1, dtype=BF16)[1:].reshape(q.shape), k, v,
                           lw),
        "d not contiguous": (q[..., ::2], k[..., ::2], v, lw[..., ::2]),
        "row stride off 16 bytes": _mamba_views(1, 8, 4, 36, 16, 16),
    }
    for what, views in bad.items():
        with pytest.raises(ValueError, match="16-byte"):
            decay_ops.kernel_path(*views)


def _f32_views(B=2, S=8, H=3, dk=16, dv=16):
    return (torch.zeros(B, S, H, dk), torch.zeros(B, S, H, dk), torch.zeros(B, S, H, dv),
            torch.zeros(B, S, H, dk))


def _unaligned(t):
    """``t``'s shape and strides one float past a 16-byte boundary."""
    return torch.zeros(t.numel() + 1)[1:].reshape(t.shape)


def _stride0(t, dim):
    """``t`` broadcast along ``dim`` (stride 0 there)."""
    return t.narrow(dim, 0, 1).expand(t.shape)


def _padded_rows(t, pad):
    """``t`` as a view into rows ``pad`` floats wider than d."""
    B, S, H, d = t.shape
    return torch.zeros(B, S, H, d + pad)[..., :d]


F32_ROW_CASES = {
    # (views of q, k, v, log_w) -> path
    "aligned": (lambda q, k, v, w: (q, k, v, w), "vector_tc_f32"),
    "d % 4 (dk 6)": (lambda q, k, v, w: _f32_views(dk=6), "simt"),
    "d % 4 (dv 10)": (lambda q, k, v, w: _f32_views(dv=10), "simt"),
    "unaligned base of q": (lambda q, k, v, w: (_unaligned(q), k, v, w), "simt"),
    "unaligned base of v": (lambda q, k, v, w: (q, k, _unaligned(v), w), "simt"),
    "unaligned base of log_w": (lambda q, k, v, w: (q, k, v, _unaligned(w)), "simt"),
    "row stride off 16 bytes (k)": (lambda q, k, v, w: (q, _padded_rows(k, 2), v, w), "simt"),
    "row stride on 16 bytes (k)": (lambda q, k, v, w: (q, _padded_rows(k, 4), v, w),
                                   "vector_tc_f32"),
    "d not contiguous": (lambda q, k, v, w: (q, k, v.transpose(2, 3).contiguous()
                                             .transpose(2, 3), w), "simt"),
    "stride 0 over batch": (lambda q, k, v, w: (_stride0(q, 0), _stride0(k, 0), v, w),
                            "vector_tc_f32"),
    "stride 0 over tokens": (lambda q, k, v, w: (_stride0(q, 1), k, v, _stride0(w, 1)),
                             "vector_tc_f32"),
    "stride 0 over heads (q, k)": (lambda q, k, v, w: (_stride0(q, 2), _stride0(k, 2), v, w),
                                   "vector_tc_f32"),
    "stride 0 over heads and log_w over d": (
        lambda q, k, v, w: (_stride0(q, 2), _stride0(k, 2), v, _stride0(w, 3)), "scalar_tc_f32"),
    "stride 0 over d (q)": (lambda q, k, v, w: (_stride0(q, 3), k, v, w), "simt"),
    "stride 0 over d (log_w), heads not shared": (
        lambda q, k, v, w: (q, k, v, _stride0(w, 3)), "simt"),
}


@pytest.mark.parametrize("case", list(F32_ROW_CASES))
def test_f32_row_rule(case):
    """The float32 row rule: d contiguous and a multiple of 4, a 16-byte
    aligned base and strides of whole 16 bytes (stride 0 counts as whole)
    take a tensor-core path; any other float32 view takes ``simt`` (never a
    refusal)."""
    make, want = F32_ROW_CASES[case]
    views = make(*_f32_views())
    assert decay_ops.kernel_path(*views) == want


def _decay_precision():
    """scripts/decay_precision.py as a module (scripts/ is not a package)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "scripts" / "decay_precision.py"
    spec = importlib.util.spec_from_file_location("decay_precision", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("family,form", [("mamba2", "scalar"), ("rwkv6", "vector")])
def test_f32_paths_need_three_tf32_products(family, form):
    """The f32 tensor-core paths' design on the CPU (``scripts/decay_precision.py
    --dtype float32``, 128 tokens at the clip): three TF32 products a pair,
    with the float64 scan, stay at least as close to a float64 oracle as the
    plain chunked form in float32 (what ``simt`` computes); three bf16
    products do not, at two or more times its error (what rules them out)."""
    prec = _decay_precision()
    q, k, v, lw, u, h0 = prec.inputs(family, 128, 2, pinned=True, exact=False)
    oy, _ = prec.oracle(q, k, v, lw, u, h0)
    scale = max(1.0, oy.abs().max().item())
    err = {s: (prec.emulate(q, k, v, lw, u, h0, s, form, exact_inputs=False)[0] - oy)
           .abs().max().item() / scale for s in ("bf16x3", "3xtf32")}
    err["f32"] = (prec.plain_f32(q, k, v, lw, u, h0, "f32 chunked")[0] - oy).abs().max().item() / scale
    assert err["3xtf32"] <= err["f32"], err
    assert err["bf16x3"] > 2 * err["f32"], err
