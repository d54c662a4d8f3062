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
from repro_torch.kernels.flash_attention import ops as fl_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pg_ops  # noqa: E402
from repro_torch.kernels.paged_attention.ref import paged_attention_ref  # noqa: E402
from repro_torch.kernels.pud_bulk import ops as pud_ops  # noqa: E402
from repro_torch.kernels.pud_bulk.ref import block_copy_ref, bulk_op_ref  # noqa: E402

# the reference's tolerances: 2e-5 f32 (paged and flash attention), 2e-2 bf16
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
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", PAGED_CASES[:3], ids=lambda c: "-".join(map(str, c.values())))
def test_paged_attention_kernel_rejects_fp8_pages(cuda, case, q_dtype):
    """fp8 e4m3 pages (``kv_cache_dtype="float8_e4m3fn"``) are taken, as
    the reference kernel casts any page type to f32: the kernel matches the
    plain version on the same fp8 pages at 2e-2, with the output in q's type.
    (Until fp8 pages were ported this test checked that they were refused.)"""
    q, kp, vp, tbl, lens = [torch.from_numpy(a).cuda() for a in _paged_inputs(2, **case)]
    q = q.to(q_dtype)
    kp, vp = kp.to(torch.float8_e4m3fn), vp.to(torch.float8_e4m3fn)
    out = pg_ops.paged_attention(q, kp, vp, tbl, lens)
    torch.cuda.synchronize()
    B, Hq, D = q.shape
    plain = paged_attention_ref(
        q.reshape(B, kp.shape[2], -1, D), kp, vp, tbl, lens, scale=D ** -0.5,
    ).reshape(q.shape)
    assert out.dtype == q_dtype
    assert (out.float() - plain.float()).abs().max().item() < 2e-2


@pytest.mark.cuda
def test_paged_attention_kernel_rejects_fp8_q(cuda):
    kp = torch.zeros(4, 16, 2, 64, device="cuda").to(torch.float8_e4m3fn)
    tbl = torch.zeros(1, 2, dtype=torch.int32, device="cuda")
    lens = torch.ones(1, dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError):
        pg_ops.paged_attention(kp[0, :1].reshape(1, 2, 64), kp, kp, tbl, lens)


# the reference's flash tests (tests/test_kernels.py) and the main path's shapes
FLASH_CASES = [
    (2, 4, 2, 64, 64, 32, True, torch.float32),
    (1, 8, 1, 100, 100, 64, True, torch.float32),
    (2, 4, 4, 32, 96, 80, False, torch.float32),
    (1, 2, 2, 1, 200, 128, False, torch.float32),
    (1, 4, 2, 128, 128, 64, True, torch.bfloat16),
    (1, 48, 1, 33, 33, 128, True, torch.float32),
    (2, 4, 2, 64, 64, 32, True, torch.bfloat16),
    (2, 4, 4, 32, 96, 80, False, torch.bfloat16),
    (1, 2, 2, 1, 200, 128, False, torch.bfloat16),
    (1, 48, 1, 33, 33, 128, True, torch.bfloat16),
    (1, 4, 2, 70, 130, 40, True, torch.bfloat16),    # D not a multiple of 16: CUDA cores
    (1, 4, 4, 130, 70, 64, True, torch.bfloat16),    # Sq > Sk, causal
    (2, 32, 8, 256, 256, 128, True, torch.bfloat16),
    (1, 4, 4, 77, 0, 64, False, torch.float32),      # no keys: zeros
]


def _flash_inputs(seed, B, Hq, Hkv, Sq, Sk, D, dtype):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).cuda().to(dtype)
            for s in ((B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D))]


def _flash_check(q, k, v, causal):
    before = kernels.launches["flash_attention"]
    out = fl_ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert kernels.launches["flash_attention"] == before + 1
    plain = attention_ref(q, k, v, causal=causal)
    assert out.dtype == q.dtype and out.shape == q.shape
    err = (out.float() - plain.float()).abs().max().item() if out.numel() else 0.0
    assert err < TOL[q.dtype], err
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal,dtype", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(cuda, B, Hq, Hkv, Sq, Sk, D, causal, dtype):
    _flash_check(*_flash_inputs(3, B, Hq, Hkv, Sq, Sk, D, dtype), causal)
    if dtype == torch.bfloat16:
        assert fl_ops.last_path == ("mma" if D % 16 == 0 else "simt")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_on_transposed_views(cuda, dtype):
    """The model hands (B, S, H, D) tensors transposed to (B, H, S, D): the
    kernel reads them through their strides and writes an output laid out
    like q, so transposing it back is contiguous."""
    rng = np.random.default_rng(4)
    q, k, v = [torch.from_numpy(rng.normal(size=(2, 75, h, 64)).astype(np.float32)).cuda()
               .to(dtype).transpose(1, 2) for h in (8, 2, 2)]
    out = _flash_check(q, k, v, True)
    assert out.transpose(1, 2).is_contiguous()


@pytest.mark.cuda
def test_flash_attention_raises_under_autograd(cuda):
    q, k, v = _flash_inputs(5, 1, 2, 2, 8, 8, 32, torch.float32)
    q.requires_grad_(True)
    before = kernels.launches["flash_attention"]
    with pytest.raises(RuntimeError, match="forward-only"):
        fl_ops.flash_attention(q, k, v)
    assert kernels.launches["flash_attention"] == before
    with torch.no_grad():
        _flash_check(q, k, v, True)


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


@pytest.mark.cuda
def test_block_copy_kernel_with_chained_moves(cuda):
    """A source that is another pair's destination (as compaction plans chain
    moves) is read as it was before the call: the pairs run as one launch
    per wave of disjoint blocks and match the plain version."""
    g = torch.Generator(device="cuda").manual_seed(1)
    pool = torch.rand(32, 256, generator=g, device="cuda")
    src, dst = [14, 12, 10, 9, 5, 6], [10, 0, 4, 3, 6, 7]
    plain = block_copy_ref(pool.clone(), torch.tensor([src, dst]).T)
    before = kernels.launches["block_copy"]
    pud_ops.pool_block_copy(pool, src, dst)
    torch.cuda.synchronize()
    assert kernels.launches["block_copy"] == before + 2
    assert torch.equal(pool, plain)


BULK_OPS = {"zero": (pud_ops.pud_zero, 1), "copy": (pud_ops.pud_copy, 1),
            "not": (pud_ops.pud_not, 1), "and": (pud_ops.pud_and, 2),
            "or": (pud_ops.pud_or, 2), "xor": (pud_ops.pud_xor, 2),
            "maj": (pud_ops.pud_maj, 3)}


def _bulk_inputs(shape, dtype, n, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    if dtype == torch.bool:
        return [torch.randint(0, 2, shape, generator=g, device="cuda").bool() for _ in range(n)]
    raw = [torch.randint(0, 256, (math.prod(shape) * dtype.itemsize,), generator=g,
                         device="cuda", dtype=torch.uint8) for _ in range(n)]
    return [r.view(dtype).view(shape) for r in raw]


def _check_bulk(op, xs):
    fn, arity = BULK_OPS[op]
    before = kernels.launches["bulk_op"]
    out = fn(*xs[:arity])
    torch.cuda.synchronize()
    assert kernels.launches["bulk_op"] == before + 1
    plain = bulk_op_ref(*xs[:arity], op=op)
    assert out.shape == xs[0].shape and out.dtype == xs[0].dtype
    assert torch.equal(out.view(torch.uint8), plain.contiguous().view(torch.uint8)), op


@pytest.mark.cuda
@pytest.mark.parametrize("op", sorted(BULK_OPS))
@pytest.mark.parametrize("dtype", [torch.int32, torch.uint32, torch.int8, torch.uint8])
@pytest.mark.parametrize("shape", [(8, 128), (100,), (3, 5, 7), (1000, 3), (4097, 33)])
def test_bulk_op_kernel_matches_plain_bit_exactly(cuda, op, dtype, shape):
    _check_bulk(op, _bulk_inputs(shape, dtype, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("op", sorted(BULK_OPS))
def test_bulk_op_kernel_on_bool_keeps_bools_valid(cuda, op):
    xs = _bulk_inputs((1000,), torch.bool, 3)
    _check_bulk(op, xs)
    out = BULK_OPS[op][0](*xs[:BULK_OPS[op][1]])
    assert int(out.view(torch.uint8).max()) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("op", sorted(BULK_OPS))
def test_bulk_op_kernel_on_unaligned_views(cuda, op):
    """Operands that start 1 byte into their storage take the byte path."""
    base = _bulk_inputs((3, 10_001), torch.uint8, 1)[0]
    xs = [base[i, 1:] for i in range(3)]
    assert all(x.data_ptr() % 16 for x in xs)
    _check_bulk(op, xs)


@pytest.mark.cuda
def test_bulk_op_kernel_over_2_gib(cuda):
    """Byte counts past 2**31 need 64-bit indexing."""
    n = 2 ** 31 + 4099
    x = torch.full((n,), 0xA5, dtype=torch.uint8, device="cuda")
    x[-5:] = torch.arange(5, dtype=torch.uint8, device="cuda")
    y = torch.full((n,), 0x3C, dtype=torch.uint8, device="cuda")
    out = pud_ops.pud_xor(x, y)
    torch.cuda.synchronize()
    assert int((out[:-5] != 0x99).sum()) == 0
    assert out[-5:].tolist() == [v ^ 0x3C for v in range(5)]
    del out
    out = pud_ops.pud_not(x)
    torch.cuda.synchronize()
    assert int((out[:-5] != 0x5A).sum()) == 0
    assert out[-5:].tolist() == [v ^ 0xFF for v in range(5)]


@pytest.mark.cuda
def test_bulk_op_kernel_rejects_mismatched_operands(cuda):
    x = torch.zeros(100, dtype=torch.int32, device="cuda")
    before = kernels.launches["bulk_op"]
    with pytest.raises(ValueError, match="differ"):
        pud_ops.pud_and(x, torch.zeros(101, dtype=torch.int32, device="cuda"))
    with pytest.raises(ValueError, match="differ"):
        pud_ops.pud_or(x, torch.zeros(100, dtype=torch.int64, device="cuda"))
    with pytest.raises(ValueError, match="differ"):
        pud_ops.pud_xor(x, torch.zeros(100, dtype=torch.int32))
    assert kernels.launches["bulk_op"] == before
