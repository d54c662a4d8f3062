"""The decay-attention kernel's path rule (``kernels/decay_attention/ops.py:
kernel_path``) on the CPU, where no kernel runs: which path each call
takes, decided from type and strides alone, and which bfloat16 views the
tensor-core paths refuse.  The model's own views are taken from its layer
code at smoke width (bfloat16) and rebuilt at full width, so the
full-width main path is known to meet the 16-byte row rule before it runs
on the card.
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
    """The calls the smoke model's own layer code makes, in bfloat16, take
    their family's path; the same calls in float32 take ``simt``."""
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
    assert seen == [(BF16, path)] * n + [(torch.float32, "simt")] * n


def test_full_width_views_meet_the_row_rule():
    """At full width: zamba2_7b's xBC rows are 7296 bf16 (C at 7232, B at
    7168, each a multiple of 8 elements), rwkv6_7b's heads 64 wide."""
    zc, rc = get_config("zamba2_7b"), get_config("rwkv6_7b")
    d_in = zc.ssm_expand * zc.d_model
    views = _mamba_views(2, 33, d_in // zc.ssm_head_dim, d_in, zc.ssm_state, zc.ssm_head_dim)
    assert views[0].stride(1) == d_in + 2 * zc.ssm_state == 7296
    assert decay_ops.kernel_path(*views) == "scalar_tc"
    views = _rwkv_views(2, 33, rc.d_model, rc.ssm_head_dim)
    assert decay_ops.kernel_path(*views) == "vector_tc"


def test_kernel_path_rule_and_refusals():
    q, k, v, lw = _rwkv_views(1, 8, 64, 16)
    assert decay_ops.kernel_path(q.float(), k.float(), v.float(), lw) == "simt"
    # float32 takes any view: the CUDA-core kernel reads element by element
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
