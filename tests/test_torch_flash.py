"""The port's flash attention against the reference on the same numpy
inputs (CPU): the kernel's wrapper (which takes its plain version on CPU
tensors) against the reference's Pallas kernel in interpret mode at the
reference's own test shapes, the model's attention implementations against
each other, and the reference's treatment of ``kv_len`` / ``q_offset`` on
the pallas path, which the port keeps.  Tolerances are the reference's:
2e-5 f32, 2e-2 bf16 (``tests/test_kernels.py``), 2e-5 of the scale for
whole-model tensors (``tests/test_torch_models.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as ref_get_config  # noqa: E402
from repro.data.pipeline import DataConfig as RefDataConfig, synth_batch as ref_synth  # noqa: E402
from repro.kernels.flash_attention import ops as ref_fl  # noqa: E402
from repro.kernels.flash_attention import ref as ref_fl_ref  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models.transformer import LM as RefLM  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fl  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.models.transformer import LM  # noqa: E402

TOL = {np.float32: 2e-5, "bfloat16": 2e-2}

# tests/test_kernels.py::test_flash_attention_matches_ref
SHAPES = [
    (2, 4, 2, 64, 64, 32, True, np.float32),
    (1, 8, 1, 100, 100, 64, True, np.float32),
    (2, 4, 4, 32, 96, 80, False, np.float32),
    (1, 2, 2, 1, 200, 128, False, np.float32),
    (1, 4, 2, 128, 128, 64, True, "bfloat16"),
    (1, 48, 1, 33, 33, 128, True, np.float32),
]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several test processes at once; one torch thread per
    process keeps them from contending for the cores (it is no slower here)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_qkv(seed, B, Hq, Hkv, Sq, Sk, D):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Hq, Sq, D)).astype(np.float32),
            rng.normal(size=(B, Hkv, Sk, D)).astype(np.float32),
            rng.normal(size=(B, Hkv, Sk, D)).astype(np.float32))


def _err(ours, ref):
    return float(np.abs(ours.detach().float().numpy() - np.asarray(ref, np.float32)).max())


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal,dtype", SHAPES)
def test_flash_matches_reference_kernel(B, Hq, Hkv, Sq, Sk, D, causal, dtype):
    arrs = _np_qkv(0, B, Hq, Hkv, Sq, Sk, D)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ref = ref_fl.flash_attention(*(jnp.asarray(a, jdt) for a in arrs), causal=causal,
                                 use_kernel=True)
    before = kernels.launches["flash_attention"]
    ours = fl.flash_attention(*(torch.from_numpy(a).to(tdt) for a in arrs), causal=causal)
    assert kernels.launches["flash_attention"] == before   # the CPU takes the plain version
    assert ours.dtype == tdt and tuple(ours.shape) == (B, Hq, Sq, D)
    assert _err(ours, ref) < TOL[dtype]


@pytest.mark.parametrize("kv_len", [None, 37])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_ref_matches_reference_ref(causal, kv_len):
    arrs = _np_qkv(1, 2, 6, 3, 29, 50, 16)
    ref = ref_fl_ref.attention_ref(*map(jnp.asarray, arrs), causal=causal, kv_len=kv_len)
    ours = attention_ref(*map(torch.from_numpy, arrs), causal=causal, kv_len=kv_len)
    assert _err(ours, ref) < 2e-5


def test_flash_vs_model_attention_impls():
    """naive / chunked / pallas agree on the same inputs, in both packages
    (the reference's test at its 3e-5)."""
    rng = np.random.default_rng(2)
    q, k, v = (rng.normal(size=(2, 65, 4, 32)).astype(np.float32) for _ in range(3))
    kw = dict(causal=True, kv_len=65, scale=32 ** -0.5)
    ref_naive = ref_attn._inner_attention(*map(jnp.asarray, (q, k, v)), impl="naive", **kw)
    for impl in ("naive", "chunked", "pallas"):
        ours = attn._inner_attention(*map(torch.from_numpy, (q, k, v)), impl=impl, **kw)
        assert _err(ours, ref_naive) < 3e-5, impl


def test_pallas_path_ignores_kv_len_and_q_offset_as_the_reference_does():
    """The reference's pallas branch passes neither ``kv_len`` nor
    ``q_offset`` to the kernel, so on a dense cache with S > 1 it attends to
    unwritten rows with the wrong causal alignment (ROADMAP.md, faults).  The
    port keeps those semantics: its pallas path equals the reference's, and
    both differ from naive by the same amount while chunked matches naive."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(1, 3, 2, 16)).astype(np.float32)
    k, v = (rng.normal(size=(1, 16, 2, 16)).astype(np.float32) for _ in range(2))
    kw = dict(causal=True, kv_len=8, scale=0.25, q_offset=5)
    out, ref = {}, {}
    for impl in ("naive", "chunked", "pallas"):
        ref[impl] = np.asarray(ref_attn._inner_attention(*map(jnp.asarray, (q, k, v)), impl=impl, **kw))
        out[impl] = attn._inner_attention(*map(torch.from_numpy, (q, k, v)), impl=impl, **kw).numpy()
    assert np.abs(out["pallas"] - ref["pallas"]).max() < 2e-5
    ref_gap = np.abs(ref["pallas"] - ref["naive"]).max()
    assert ref_gap > 0.5 and abs(np.abs(out["pallas"] - out["naive"]).max() - ref_gap) < 2e-5
    assert np.abs(out["chunked"] - ref["naive"]).max() < 2e-5


def test_flash_raises_under_autograd():
    q, k, v = (torch.from_numpy(a) for a in _np_qkv(4, 1, 2, 2, 8, 8, 16))
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        fl.flash_attention(q, k, v)
    with torch.no_grad():
        assert fl.flash_attention(q, k, v).shape == q.shape
    q.requires_grad_(False)
    assert fl.flash_attention(q, k, v).shape == q.shape   # nothing to differentiate


@pytest.mark.parametrize("shapes", [
    ((1, 4, 8, 16), (1, 3, 8, 16)),    # Hq not a multiple of Hkv
    ((1, 4, 8, 16), (1, 2, 8, 32)),    # head dims differ
    ((4, 8, 16), (4, 8, 16)),          # not 4-D
])
def test_flash_rejects_bad_shapes(shapes):
    qs, ks = shapes
    with pytest.raises(ValueError):
        fl.flash_attention(torch.zeros(qs), torch.zeros(ks), torch.zeros(ks))


@pytest.fixture(scope="module")
def smoke_pair():
    ref_cfg = ref_get_config("stablelm_1_6b").smoke()
    ref_params = RefLM(ref_cfg, attn_impl="naive", remat=None).init(jax.random.key(0))
    tree = jax.tree.map(np.asarray, ref_params)
    batch = ref_synth(RefDataConfig(vocab_size=ref_cfg.vocab_size, seq_len=48,
                                    batch_per_shard=2), 0, 0)
    return ref_cfg, ref_params, tree, batch


@pytest.mark.parametrize("entry", ["train_loss", "prefill_logits"])
def test_lm_pallas_matches_reference_and_chunked(smoke_pair, entry):
    """The whole smoke model through the pallas path: equal to the
    reference's pallas path and to the port's chunked path, at 2e-5 of the
    output's scale."""
    ref_cfg, ref_params, tree, batch = smoke_pair
    ref = getattr(RefLM(ref_cfg, attn_impl="pallas", remat=None), entry)(
        ref_params, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    outs = {}
    for impl in ("pallas", "chunked"):
        model = LM(get_config("stablelm_1_6b").smoke(), attn_impl=impl)
        with torch.no_grad():
            outs[impl] = getattr(model, entry)(params_from_numpy(model, tree, device="cpu"), tb)
    scale = max(1.0, float(np.abs(np.asarray(ref)).max()))
    assert _err(outs["pallas"], ref) / scale < 2e-5
    assert _err(outs["pallas"], outs["chunked"].numpy()) / scale < 2e-5
