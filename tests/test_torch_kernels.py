"""The port's kernel wrappers against the reference's Pallas kernels.

On the CPU each wrapper takes its plain PyTorch version; these tests hold
that version against the reference's Pallas kernel (interpret mode) and its
jnp oracle.  The CUDA kernels themselves run only on a card: see
tests/test_torch_cuda.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention import ops as ref_pg_ops  # noqa: E402
from repro.kernels.pud_bulk import ops as ref_pud_ops  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pg_ops  # noqa: E402
from repro_torch.kernels.pud_bulk import ops as pud_ops  # noqa: E402
from repro_torch.kernels.pud_bulk.ref import block_copy_ref  # noqa: E402

TOL_F32 = 2e-5   # the reference's own paged-attention tolerance (f32)


def _paged_inputs(seed, B, Hq, Hkv, D, nb, bs, maxb, zero_len_row=False, lens=None):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Hq, D)).astype(np.float32)
    kp = rng.normal(size=(nb, bs, Hkv, D)).astype(np.float32)
    vp = rng.normal(size=(nb, bs, Hkv, D)).astype(np.float32)
    lens = rng.integers(1, maxb * bs, size=(B,)) if lens is None else np.array(lens)
    if zero_len_row:
        lens[0] = 0
    tbl = np.full((B, maxb), -1, np.int32)
    for b in range(B):
        need = -(-int(lens[b]) // bs)
        tbl[b, :need] = rng.choice(nb, size=need, replace=False)
    return q, kp, vp, tbl, lens.astype(np.int32)


PAGED_CASES = [
    # the reference's shapes (tests/test_kernels.py), then an empty row and
    # a 16-head query group
    dict(B=2, Hq=8, Hkv=2, D=64, nb=32, bs=16, maxb=6),
    dict(B=1, Hq=4, Hkv=4, D=128, nb=16, bs=8, maxb=4),
    dict(B=3, Hq=16, Hkv=1, D=32, nb=64, bs=16, maxb=8),
    dict(B=3, Hq=8, Hkv=2, D=64, nb=32, bs=16, maxb=6, zero_len_row=True),
    dict(B=2, Hq=32, Hkv=2, D=64, nb=32, bs=16, maxb=5),
    # the served groups (granite_moe_3b_a800m's 3, qwen2_vl_72b's 8,
    # granite_34b's 48) at D 64 and 128, with lengths on both sides of the
    # 16-token pages and of the card's 64-token splits
    *[dict(B=4, Hq=group * Hkv, Hkv=Hkv, D=D, nb=40, bs=16, maxb=9, lens=lens)
      for group, Hkv in ((3, 2), (8, 2), (48, 1)) for D in (64, 128)
      for lens in ([1, 16, 17, 65] if D == 64 else [15, 63, 64, 129],)],
]


@pytest.mark.parametrize("case", PAGED_CASES, ids=lambda c: "-".join(map(str, c.values())))
def test_paged_attention_plain_matches_reference_kernel(case):
    q, kp, vp, tbl, lens = _paged_inputs(0, **case)
    jargs = [jnp.asarray(a) for a in (q, kp, vp, tbl, lens)]
    ref_kernel = np.asarray(ref_pg_ops.paged_attention(*jargs, use_kernel=True))
    ref_plain = np.asarray(ref_pg_ops.paged_attention(*jargs, use_kernel=False))
    before = kernels.launches["paged_attention"]
    ours = pg_ops.paged_attention(*[torch.from_numpy(a) for a in (q, kp, vp, tbl, lens)])
    assert kernels.launches["paged_attention"] == before   # CPU: plain version
    assert ours.shape == q.shape and ours.dtype == torch.float32
    assert np.abs(ours.numpy() - ref_kernel).max() < TOL_F32
    assert np.abs(ours.numpy() - ref_plain).max() < TOL_F32
    if case.get("zero_len_row"):
        assert np.all(ours.numpy()[0] == 0.0)


@pytest.mark.parametrize("bad", ["heads", "devices"])
def test_paged_attention_rejects_bad_inputs(bad):
    q, kp, vp, tbl, lens = [torch.from_numpy(a) for a in _paged_inputs(0, **PAGED_CASES[0])]
    if bad == "heads":       # 8 query heads over 3 KV heads
        kp, vp = kp[:, :, :1].expand(-1, -1, 3, -1), vp[:, :, :1].expand(-1, -1, 3, -1)
    else:                    # the pools on another device than q
        kp, vp = kp.to("meta"), vp.to("meta")
    with pytest.raises(ValueError):
        pg_ops.paged_attention(q, kp, vp, tbl, lens)


BLOCK_CASES = [(16, 32, 4), (8, 256, 3), (32, 48, 1)]   # tests/test_kernels.py


def _as_jnp(x, dtype):
    return jnp.asarray(x, jnp.bfloat16) if dtype == "bfloat16" else jnp.asarray(x)


def _as_torch(x, dtype):
    t = torch.from_numpy(x)
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _bits(x):
    """Exact comparison key: the raw bytes as an integer array."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.itemsize == 2 else x


@pytest.mark.parametrize("dtype", ["int32", "float32", "bfloat16"])
@pytest.mark.parametrize("nb,elems,npairs", BLOCK_CASES)
def test_block_copy_plain_matches_reference_kernel(dtype, nb, elems, npairs):
    rng = np.random.default_rng(nb * 1000 + elems)
    if dtype == "int32":
        pool = rng.integers(0, 100, size=(nb, elems)).astype(np.int32)
    else:
        pool = rng.normal(size=(nb, elems)).astype(np.float32)
    perm = rng.permutation(nb)
    src = perm[:npairs].astype(np.int32)
    dst = perm[npairs:2 * npairs].astype(np.int32)
    jpool = _as_jnp(pool, dtype)
    ref_kernel = ref_pud_ops.pool_block_copy(
        jpool, jnp.asarray(src), jnp.asarray(dst), use_kernel=True)
    ref_plain = ref_pud_ops.pool_block_copy(
        jpool, jnp.asarray(src), jnp.asarray(dst), use_kernel=False)
    tpool = _as_torch(pool, dtype)
    before = kernels.launches["block_copy"]
    out = pud_ops.pool_block_copy(tpool, src, dst)
    assert out is tpool                                   # in place
    assert kernels.launches["block_copy"] == before
    np.testing.assert_array_equal(_bits(out), _bits(ref_kernel))
    np.testing.assert_array_equal(_bits(out), _bits(ref_plain))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_copy_layer_folded_pool(dtype):
    """The fork path: a (L, nb, bs, KV, hd) pool viewed as (L*nb, ...) with
    per-layer offsets on the block indices; unlisted blocks stay bit-equal."""
    L_, nb, bs, KV, hd = 3, 16, 4, 2, 8
    rng = np.random.default_rng(7)
    pool = rng.normal(size=(L_, nb, bs, KV, hd)).astype(np.float32)
    src = np.array([1, 2, 3], np.int64)
    dst = np.array([9, 10, 12], np.int64)
    offs = (np.arange(L_) * nb)[:, None]
    src_all = (src[None] + offs).reshape(-1)
    dst_all = (dst[None] + offs).reshape(-1)
    ref = ref_pud_ops.pool_block_copy(
        _as_jnp(pool, dtype).reshape((L_ * nb, bs, KV, hd)),
        jnp.asarray(src_all), jnp.asarray(dst_all), use_kernel=True,
    ).reshape(pool.shape)
    tpool = _as_torch(pool, dtype)
    before = tpool.clone()
    pud_ops.pool_block_copy(tpool.view(L_ * nb, bs, KV, hd), src_all, dst_all)
    np.testing.assert_array_equal(_bits(tpool), _bits(ref))
    untouched = np.setdiff1d(np.arange(nb), dst)
    assert torch.equal(tpool[:, untouched], before[:, untouched])
    assert torch.equal(tpool[:, dst], before[:, src])


@pytest.mark.parametrize("src,dst", [
    ([1, 2], [2, 1]),        # moves in a cycle (a chain is taken: test_torch_trace.py)
    ([1, 2], [3, 3]),        # a destination repeats
    ([1, 2], [3, 16]),       # out of range
    ([1, 2], [3]),           # lengths differ
])
def test_block_copy_rejects_bad_index_lists(src, dst):
    pool = torch.zeros(16, 4)
    with pytest.raises(ValueError):
        pud_ops.pool_block_copy(pool, src, dst)


def test_block_copy_ref_is_a_parallel_copy():
    pool = torch.arange(12.0).reshape(6, 2)
    block_copy_ref(pool, torch.tensor([[0, 3], [1, 4], [0, 5]]))
    assert pool.tolist() == [[0, 1], [2, 3], [4, 5], [0, 1], [2, 3], [0, 1]]
