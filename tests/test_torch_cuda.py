"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  The kernels have no CPU mode, so every test here skips without a
CUDA device.  This file imports no JAX, so it runs on a machine without it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pg_ops  # noqa: E402
from repro_torch.kernels.paged_attention.ref import paged_attention_ref  # noqa: E402
from repro_torch.kernels.pud_bulk import ops as pud_ops  # noqa: E402
from repro_torch.kernels.pud_bulk.ref import block_copy_ref  # noqa: E402

# the reference's tolerances: 2e-5 f32 (paged attention), 2e-2 bf16 (attention)
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}

PAGED_CASES = [
    dict(B=2, Hq=8, Hkv=2, D=64, nb=32, bs=16, maxb=6),
    dict(B=1, Hq=4, Hkv=4, D=128, nb=16, bs=8, maxb=4),
    dict(B=3, Hq=16, Hkv=1, D=32, nb=64, bs=16, maxb=8),
    dict(B=3, Hq=8, Hkv=2, D=64, nb=32, bs=16, maxb=6, zero_len_row=True),
    dict(B=2, Hq=32, Hkv=2, D=64, nb=32, bs=16, maxb=5),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


def _paged_inputs(seed, B, Hq, Hkv, D, nb, bs, maxb, zero_len_row=False):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Hq, D)).astype(np.float32)
    kp = rng.normal(size=(nb, bs, Hkv, D)).astype(np.float32)
    vp = rng.normal(size=(nb, bs, Hkv, D)).astype(np.float32)
    lens = rng.integers(1, maxb * bs, size=(B,))
    if zero_len_row:
        lens[0] = 0
    tbl = np.full((B, maxb), -1, np.int32)
    for b in range(B):
        need = -(-int(lens[b]) // bs)
        tbl[b, :need] = rng.choice(nb, size=need, replace=False)
    return q, kp, vp, tbl, lens.astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", PAGED_CASES, ids=lambda c: "-".join(map(str, c.values())))
def test_paged_attention_kernel_matches_plain(cuda, case, dtype):
    q, kp, vp, tbl, lens = [torch.from_numpy(a).cuda() for a in _paged_inputs(1, **case)]
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    before = kernels.launches["paged_attention"]
    out = pg_ops.paged_attention(q, kp, vp, tbl, lens)
    torch.cuda.synchronize()
    assert kernels.launches["paged_attention"] == before + 1
    B, Hq, D = q.shape
    plain = paged_attention_ref(
        q.reshape(B, kp.shape[2], -1, D), kp, vp, tbl, lens, scale=D ** -0.5,
    ).reshape(q.shape)
    assert out.dtype == dtype
    diff = (out.float() - plain.float()).abs()
    assert diff.max().item() < TOL[dtype]
    if dtype == torch.bfloat16:
        # both round the same f32 result: at most one bf16 ulp apart
        assert bool((diff <= 2.0 ** -7 * plain.float().abs() + 1e-5).all())
    if case.get("zero_len_row"):
        assert bool((out[0] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("group,D,dtype", [
    (32, 128, torch.bfloat16),   # group * D over what one block holds
    (1, 36, torch.bfloat16),     # a 72-byte head row: not whole 16-byte loads
])
def test_paged_attention_kernel_rejects_shapes_over_its_limits(cuda, group, D, dtype):
    q = torch.zeros(1, group, D, device="cuda", dtype=dtype)
    kp = torch.zeros(4, 16, 1, D, device="cuda", dtype=dtype)
    tbl = torch.zeros(1, 2, dtype=torch.int32, device="cuda")
    lens = torch.ones(1, dtype=torch.int32, device="cuda")
    before = kernels.launches["paged_attention"]
    with pytest.raises(RuntimeError, match="invalid argument"):
        pg_ops.paged_attention(q, kp, kp, tbl, lens)
    assert kernels.launches["paged_attention"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["q", "k_pool"])
def test_paged_attention_kernel_rejects_unaligned_views(cuda, which):
    """A contiguous view that starts 4 bytes into its storage is refused
    before launch (the kernel's 16-byte loads would fault)."""
    shapes = {"q": (2, 4, 64), "k_pool": (8, 16, 4, 64)}
    args = {n: torch.zeros(s, device="cuda") for n, s in shapes.items()}
    n = math.prod(shapes[which])
    args[which] = torch.zeros(n + 1, device="cuda")[1:].view(shapes[which])
    tbl = torch.zeros(2, 2, dtype=torch.int32, device="cuda")
    lens = torch.ones(2, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="16-byte"):
        pg_ops.paged_attention(args["q"], args["k_pool"], args["k_pool"], tbl, lens)


@pytest.mark.cuda
def test_paged_attention_kernel_rejects_fp8_pages(cuda):
    q = torch.zeros(1, 2, 64, device="cuda")
    kp = torch.zeros(4, 16, 2, 64, device="cuda").to(torch.float8_e4m3fn)
    tbl = torch.zeros(1, 2, dtype=torch.int32, device="cuda")
    lens = torch.ones(1, dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError):
        pg_ops.paged_attention(q, kp, kp, tbl, lens)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32, torch.bfloat16, torch.uint8])
def test_block_copy_kernel_matches_plain(cuda, dtype):
    g = torch.Generator(device="cuda").manual_seed(0)
    width = 1001 if dtype == torch.uint8 else 1000   # uint8: not 16-byte blocks
    pool = (torch.rand(64, width, generator=g, device="cuda") * 100).to(dtype)
    src, dst = list(range(0, 20)), list(range(30, 50))
    plain = block_copy_ref(pool.clone(), torch.tensor([src, dst]).T)
    before = kernels.launches["block_copy"]
    out = pud_ops.pool_block_copy(pool, src, dst)
    torch.cuda.synchronize()
    assert kernels.launches["block_copy"] == before + 1
    assert torch.equal(out, plain)
