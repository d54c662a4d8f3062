"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  The kernels have no CPU mode, so every test here skips without a
CUDA device.  This file imports no JAX, so it runs on a machine without it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.configs.base import RunShape  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels.decay_attention import ops as dc_ops  # noqa: E402
from repro_torch.kernels.decay_attention.ref import (  # noqa: E402
    chunked_decay_ref,
    decay_attention_ref,
)
from repro_torch.kernels.flash_attention import ops as fl_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pg_ops  # noqa: E402
from repro_torch.kernels.paged_attention.ref import paged_attention_ref  # noqa: E402
from repro_torch.kernels.pud_bulk import ops as pud_ops  # noqa: E402
from repro_torch.kernels.pud_bulk.ref import block_copy_ref, bulk_op_ref  # noqa: E402
from repro_torch.core.kv_pool import KVPoolConfig, PagedKVPool  # noqa: E402
from repro_torch.graphs import GraphCache, decode_step_jit  # noqa: E402
from repro_torch.launch.inputs import make_batch  # noqa: E402
from repro_torch.models import linear_scan  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.transformer import LM  # noqa: E402
from repro_torch.serve.engine import MaintenanceConfig, Request, ServeEngine  # noqa: E402
from repro_torch.serve.paged_runner import paged_decode_step, paged_decode_step_jit  # noqa: E402
from repro_torch.tree import flatten, tree_map, unflatten  # noqa: E402

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


def _paged_plain(q, kp, vp, tbl, lens):
    """The plain version: (out (B, Hq, D), lse (B, Hkv, group))."""
    B, Hq, D = q.shape
    out, lse = paged_attention_ref(
        q.reshape(B, kp.shape[2], -1, D), kp, vp, tbl, lens, scale=D ** -0.5, return_lse=True,
    )
    return out.reshape(q.shape), lse


def _check_paged(out, lse, q, kp, vp, tbl, lens, tol):
    """Output within ``tol`` of the plain version (bf16 also within one
    ulp), length-0 rows zero, the LSE within 2e-5 of max(1, |lse|) and -inf
    where the plain one is."""
    plain, plain_lse = _paged_plain(q, kp, vp, tbl, lens)
    assert out.dtype == q.dtype and out.shape == q.shape
    diff = (out.float() - plain.float()).abs()
    assert diff.max().item() < tol
    if q.dtype == torch.bfloat16:
        # both round the same f32 result: at most one bf16 ulp apart
        assert bool((diff <= 2.0 ** -7 * plain.float().abs() + 1e-5).all())
    empty = lens <= 0
    assert bool((out[empty] == 0).all())
    assert lse.dtype == torch.float32 and lse.shape == plain_lse.shape
    inf = torch.isneginf(plain_lse)
    assert torch.equal(torch.isneginf(lse), inf) and bool(inf[empty].all())
    if bool((~inf).any()):
        rel = (lse - plain_lse).abs() / plain_lse.abs().clamp_min(1.0)
        assert rel[~inf].max().item() < 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", PAGED_CASES, ids=lambda c: "-".join(map(str, c.values())))
def test_paged_attention_kernel_matches_plain(cuda, case, dtype):
    q, kp, vp, tbl, lens = [torch.from_numpy(a).cuda() for a in _paged_inputs(1, **case)]
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    before = kernels.launches["paged_attention"]
    out, lse = pg_ops.paged_attention(q, kp, vp, tbl, lens, return_lse=True)
    torch.cuda.synchronize()
    assert kernels.launches["paged_attention"] == before + 1
    _check_paged(out, lse, q, kp, vp, tbl, lens, TOL[dtype])
    if case.get("zero_len_row"):
        assert bool((out[0] == 0).all())


def _split_inputs(seed, group, D, dtype, bs=16, maxb=12, Hkv=2):
    """Lengths at the kernel's split boundaries (k x split and +-1), 0, 1,
    the whole table and past it (clamped); rows past their length keep
    stale, non -1 table entries or -1, alternately."""
    split = pg_ops.split_tokens(bs)
    cap = maxb * bs
    lens = sorted({0, 1, cap, cap + 7} | {x for k in range(1, cap // split + 1)
                                           for x in (k * split - 1, k * split, k * split + 1)
                                           if 0 < x <= cap})
    rng = np.random.default_rng(seed)
    B, nb = len(lens), len(lens) * maxb + 8
    q = rng.normal(size=(B, Hkv * group, D)).astype(np.float32)
    kp = rng.normal(size=(nb, bs, Hkv, D)).astype(np.float32)
    vp = rng.normal(size=(nb, bs, Hkv, D)).astype(np.float32)
    tbl = np.full((B, maxb), -1, np.int32)
    perm = rng.permutation(nb)
    for b, n in enumerate(lens):
        need = min(maxb, -(-n // bs))
        tbl[b, :need] = perm[b * maxb:b * maxb + need]
        if b % 2:
            tbl[b, need:] = perm[b * maxb + need:(b + 1) * maxb]   # stale entries
    page_dt = torch.float8_e4m3fn if dtype == "fp8" else dtype
    q_dt = torch.bfloat16 if dtype == "fp8" else dtype
    T = lambda a, dt: torch.from_numpy(a).cuda().to(dt)  # noqa: E731
    return (T(q, q_dt), T(kp, page_dt), T(vp, page_dt),
            torch.from_numpy(tbl).cuda(), torch.tensor(lens, dtype=torch.int32).cuda())


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("group", [1, 4, 16, 48])    # 48: granite_34b's MQA group
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, "fp8"], ids=str)
def test_paged_attention_kernel_at_split_boundaries(cuda, dtype, group, D):
    q, kp, vp, tbl, lens = _split_inputs(7, group, D, dtype)
    out, lse = pg_ops.paged_attention(q, kp, vp, tbl, lens, return_lse=True)
    torch.cuda.synchronize()
    _check_paged(out, lse, q, kp, vp, tbl, lens, TOL.get(dtype, 2e-2))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,group,D", [
    (torch.float32, 4, 256),      # 64 slices a row: two a lane
    (torch.bfloat16, 2, 512),
    (torch.bfloat16, 1, 1024),    # four a lane
    (torch.float32, 2, 1024),     # eight a lane
    (torch.float32, 1, 2048),     # sixteen a lane
    ("fp8", 1, 512),              # 32 slices, but wider than one TMA box
], ids=str)
def test_paged_attention_kernel_takes_wide_rows(cuda, dtype, group, D):
    """Rows the TMA path does not take load straight into registers."""
    q, kp, vp, tbl, lens = _split_inputs(9, group, D, dtype, maxb=6, Hkv=1)
    out, lse = pg_ops.paged_attention(q, kp, vp, tbl, lens, return_lse=True)
    torch.cuda.synchronize()
    _check_paged(out, lse, q, kp, vp, tbl, lens, TOL.get(dtype, 2e-2))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,group,bs,D", [
    (torch.bfloat16, 1, 2, 16),   # 64-byte pages of one head
    (torch.bfloat16, 4, 4, 8),
    (torch.float32, 1, 1, 16),
    ("fp8", 2, 4, 16),
    (torch.bfloat16, 1, 4, 16),   # 128 bytes: the smallest page the TMA path takes
], ids=str)
def test_paged_attention_kernel_takes_small_pages(cuda, dtype, group, bs, D):
    """Pages of one head under 128 bytes, which TMA cannot land aligned in
    shared memory, load straight into registers."""
    q, kp, vp, tbl, lens = _split_inputs(10, group, D, dtype, bs=bs, maxb=160 // bs)
    out, lse = pg_ops.paged_attention(q, kp, vp, tbl, lens, return_lse=True)
    torch.cuda.synchronize()
    _check_paged(out, lse, q, kp, vp, tbl, lens, TOL.get(dtype, 2e-2))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel_short_rows_order_the_stream(cuda, dtype):
    """Every length within one split: the split kernel writes each row
    itself and the combine merges nothing.  A kernel queued right after the
    call on the same stream, with no host sync between, still reads the
    call's results (each call has its own q, so a stale read shows)."""
    rng = np.random.default_rng(11)
    B, Hkv, D, bs, maxb = 128, 32, 64, 16, 16
    split = pg_ops.split_tokens(bs)
    nb = B * maxb
    kp = torch.from_numpy(rng.normal(size=(nb, bs, Hkv, D)).astype(np.float32)).cuda().to(dtype)
    vp = torch.from_numpy(rng.normal(size=(nb, bs, Hkv, D)).astype(np.float32)).cuda().to(dtype)
    tbl = torch.from_numpy(rng.permutation(nb).reshape(B, maxb).astype(np.int32)).cuda()
    lens = torch.from_numpy(rng.integers(0, split + 1, size=B).astype(np.int32)).cuda()
    qs = [torch.from_numpy(rng.normal(size=(B, Hkv, D)).astype(np.float32)).cuda().to(dtype)
          for _ in range(8)]
    torch.cuda.synchronize()
    read = []
    for q in qs:
        out, lse = pg_ops.paged_attention(q, kp, vp, tbl, lens, return_lse=True)
        read.append((out.clone(), lse.clone()))
    torch.cuda.synchronize()
    for q, (out, lse) in zip(qs, read):
        _check_paged(out, lse, q, kp, vp, tbl, lens, TOL[dtype])


def _paged_decode_shape(dtype, Hkv, group, D, seed):
    """A decode call of 8 sequences on ``Hkv`` KV heads of ``D`` (a group of
    ``group``), 16-token pages, lengths 64-1024; fp8 pages take bf16 q.
    Checked against the plain version, the LSE too."""
    rng = np.random.default_rng(seed)
    B, bs, maxb = 8, 16, 64
    nb = B * maxb
    lens = rng.integers(64, 1025, size=B).astype(np.int32)
    tbl = np.full((B, maxb), -1, np.int32)
    perm = rng.permutation(nb)
    for b, n in enumerate(lens):
        need = -(-int(n) // bs)
        tbl[b, :need] = perm[b * maxb:b * maxb + need]
    page_dt = torch.float8_e4m3fn if dtype == "fp8" else dtype
    q_dt = torch.bfloat16 if dtype == "fp8" else dtype
    T = lambda a, dt: torch.from_numpy(a).cuda().to(dt)  # noqa: E731
    q = T(rng.normal(size=(B, Hkv * group, D)).astype(np.float32), q_dt)
    kp = T(rng.normal(size=(nb, bs, Hkv, D)).astype(np.float32), page_dt)
    vp = T(rng.normal(size=(nb, bs, Hkv, D)).astype(np.float32), page_dt)
    tbl, lens = torch.from_numpy(tbl).cuda(), torch.from_numpy(lens).cuda()
    out, lse = pg_ops.paged_attention(q, kp, vp, tbl, lens, return_lse=True)
    torch.cuda.synchronize()
    _check_paged(out, lse, q, kp, vp, tbl, lens, TOL.get(dtype, 2e-2))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, "fp8"], ids=str)
def test_paged_attention_kernel_at_granite_moe_decode_shape(cuda, dtype):
    """granite_moe_3b_a800m's decode call: q (8, 24, 64) on 8 KV heads (a
    group of 3); f32, bf16, and fp8 pages with bf16 q; the LSE too."""
    _paged_decode_shape(dtype, Hkv=8, group=3, D=64, seed=23)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, "fp8"], ids=str)
def test_paged_attention_kernel_at_qwen2_vl_decode_shape(cuda, dtype):
    """qwen2_vl_72b's decode call: q (8, 64, 128) on 8 KV heads (a group of
    8 x 128); f32, bf16, and fp8 pages with bf16 q; the LSE too."""
    _paged_decode_shape(dtype, Hkv=8, group=8, D=128, seed=24)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel_replays_in_a_cuda_graph(cuda, dtype):
    """One call captured in a CUDA graph, then the lengths and the table
    changed in place and the graph replayed: the replay matches the plain
    version on the new lengths, so the call reads neither on the host."""
    q, kp, vp, tbl, lens = _split_inputs(8, 4, 64, dtype)
    new_tbl, new_lens = tbl.flip(0).contiguous(), lens.flip(0).contiguous()
    assert not torch.equal(new_lens, lens)
    pg_ops.paged_attention(q, kp, vp, tbl, lens, return_lse=True)    # build, warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, lse = pg_ops.paged_attention(q, kp, vp, tbl, lens, return_lse=True)
    graph.replay()
    torch.cuda.synchronize()
    _check_paged(out, lse, q, kp, vp, tbl, lens, TOL[dtype])
    tbl.copy_(new_tbl)
    lens.copy_(new_lens)
    graph.replay()
    torch.cuda.synchronize()
    _check_paged(out, lse, q, kp, vp, new_tbl, new_lens, TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel_replays_granite_34b_group_in_a_cuda_graph(cuda, dtype):
    """The MQA 48/1 call captured in a CUDA graph and replayed after the
    lengths and the table change in place."""
    q, kp, vp, tbl, lens = _split_inputs(13, 48, 128, dtype, Hkv=1)
    new_tbl, new_lens = tbl.flip(0).contiguous(), lens.flip(0).contiguous()
    pg_ops.paged_attention(q, kp, vp, tbl, lens, return_lse=True)    # build, warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, lse = pg_ops.paged_attention(q, kp, vp, tbl, lens, return_lse=True)
    graph.replay()
    torch.cuda.synchronize()
    _check_paged(out, lse, q, kp, vp, tbl, lens, TOL[dtype])
    tbl.copy_(new_tbl)
    lens.copy_(new_lens)
    graph.replay()
    torch.cuda.synchronize()
    _check_paged(out, lse, q, kp, vp, new_tbl, new_lens, TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("group,D,dtype", [
    (1, 4096, torch.bfloat16),   # a row wider than the widest instance (2048 values)
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
    out, lse = pg_ops.paged_attention(q, kp, vp, tbl, lens, return_lse=True)
    torch.cuda.synchronize()
    assert out.dtype == q_dtype
    _check_paged(out, lse, q, kp, vp, tbl, lens, 2e-2)


# the group path's edges: lengths around its 64-token splits and the 16-token pages
GROUP_LENS = [0, 1, 15, 16, 17, 63, 64, 65, 1024]


def _group_inputs(seed, group, Hkv, D, pages, lens=GROUP_LENS, bs=16, maxb=64):
    rng = np.random.default_rng(seed)
    B, nb = len(lens), len(lens) * maxb
    q = torch.from_numpy(rng.normal(size=(B, Hkv * group, D)).astype(np.float32)).cuda()
    kp, vp = (torch.from_numpy(rng.normal(size=(nb, bs, Hkv, D)).astype(np.float32)).cuda()
              for _ in range(2))
    tbl = np.full((B, maxb), -1, np.int32)
    perm = rng.permutation(nb)
    for b, n in enumerate(lens):
        need = -(-n // bs)
        tbl[b, :need] = perm[b * maxb:b * maxb + need]
    page_dt = torch.float8_e4m3fn if pages == "fp8" else torch.bfloat16
    return (q.to(torch.bfloat16), kp.to(page_dt), vp.to(page_dt), torch.from_numpy(tbl).cuda(),
            torch.tensor(lens, dtype=torch.int32, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("pages", ["bf16", "fp8"])
@pytest.mark.parametrize("group,Hkv,D", [(3, 8, 64), (8, 8, 128), (48, 1, 128), (2, 4, 64),
                                         (64, 1, 64)])
def test_paged_attention_group_path_at_served_groups(cuda, group, Hkv, D, pages):
    """bf16 q with a group of two or more at D 64 or 128 takes the group
    path (granite_moe_3b_a800m's 3 x 64, qwen2_vl_72b's 8 x 128, granite_34b's
    48 x 128, and two more), over bf16 and fp8 pages: within 2e-2 and one
    bf16 ulp of the plain version, the LSE too, length-0 rows zero."""
    args = _group_inputs(group * D, group, Hkv, D, pages)
    before = kernels.launches["paged_attention:group"]
    out, lse = pg_ops.paged_attention(*args, return_lse=True)
    torch.cuda.synchronize()
    assert pg_ops.last_path == "group" and kernels.launches["paged_attention:group"] == before + 1
    _check_paged(out, lse, *args, 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["split", "group"])
def test_paged_attention_either_path_when_asked(cuda, path):
    """``_launch(path=...)`` runs the path asked for (the bench times both):
    the group path at a group of one, the split path at a group of 8."""
    group = 1 if path == "group" else 8
    q, kp, vp, tbl, lens = _group_inputs(3, group, 4, 64, "bf16")
    out, lse = pg_ops._launch(q.reshape(len(GROUP_LENS), 4, group, 64), kp, vp, tbl, lens,
                              64 ** -0.5, path=path)
    torch.cuda.synchronize()
    assert pg_ops.last_path == path
    _check_paged(out.reshape(q.shape), lse, q, kp, vp, tbl, lens, 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,group,D,path", [
    (torch.bfloat16, 3, 64, "group"), (torch.bfloat16, 48, 128, "group"),
    (torch.bfloat16, 64, 64, "group"), (torch.bfloat16, 65, 64, "split"),
    (torch.bfloat16, 1, 128, "split"), (torch.bfloat16, 8, 32, "split"),
    (torch.float32, 8, 64, "split"),
])
def test_paged_attention_route_and_workspace(cuda, dtype, group, D, path):
    """The source's routing rule, and the f32 workspace behind the LSE: the
    split path's partials, none on the group path."""
    assert pg_ops.route(dtype, group, D) == path
    taken = pg_ops._PATHS.index(path)
    floats = pg_ops._workspace_floats(taken, 2, 4, group, D, 16, 8)
    assert (floats == 0) == (path == "group")
    q = torch.zeros(2, 4, group, D, dtype=dtype, device="cuda")
    kp = torch.zeros(16, 16, 4, D, dtype=dtype, device="cuda")
    tbl = torch.zeros(2, 8, dtype=torch.int32, device="cuda")
    lens = torch.tensor([5, 0], dtype=torch.int32, device="cuda")
    pg_ops._launch(q, kp, kp, tbl, lens, 0.125)
    assert pg_ops.last_path == path


@pytest.mark.cuda
def test_paged_attention_group_path_replays_in_a_cuda_graph(cuda):
    """One group-path call captured in a CUDA graph and replayed twice with
    new lengths and tables: each replay matches the plain version."""
    q, kp, vp, tbl, lens = _group_inputs(9, 8, 8, 128, "bf16", lens=[300] * 8)
    pg_ops.paged_attention(q, kp, vp, tbl, lens, return_lse=True)    # build, warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, lse = pg_ops.paged_attention(q, kp, vp, tbl, lens, return_lse=True)
    assert pg_ops.last_path == "group"
    base = tbl.clone()
    for step, new in enumerate(([1, 64, 65, 200, 1000, 1024, 0, 129], [1024, 513, 2, 64, 0, 17, 300, 800])):
        lens.copy_(torch.tensor(new, dtype=torch.int32))
        tbl.copy_(base.roll(step + 1, 0))
        graph.replay()
        torch.cuda.synchronize()
        _check_paged(out, lse, q, kp, vp, tbl, lens, 2e-2)


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
    # the wgmma path's edges (bf16, D = 64)
    (1, 1, 1, 64, 64, 64, True, torch.bfloat16),     # one tile
    (2, 4, 2, 200, 333, 64, True, torch.bfloat16),   # ragged Sq and Sk
    (2, 4, 2, 200, 333, 64, False, torch.bfloat16),
    (1, 4, 4, 300, 130, 64, True, torch.bfloat16),   # Sq > Sk, causal, ragged
    (2, 4, 4, 100, 1, 64, True, torch.bfloat16),     # Sk = 1
    (2, 4, 4, 100, 1, 64, False, torch.bfloat16),
    (2, 4, 4, 1, 300, 64, False, torch.bfloat16),    # Sq = 1
    (2, 4, 4, 1, 300, 64, True, torch.bfloat16),
    (2, 32, 8, 384, 384, 64, True, torch.bfloat16),  # GQA 32/8
    # the same edges at D = 128 (mistral_nemo_12b, chatglm3_6b, granite_34b)
    (1, 1, 1, 128, 128, 128, True, torch.bfloat16),   # one tile
    (2, 4, 2, 200, 333, 128, True, torch.bfloat16),   # ragged Sq and Sk
    (2, 4, 2, 200, 333, 128, False, torch.bfloat16),
    (1, 4, 4, 300, 130, 128, True, torch.bfloat16),   # Sq > Sk, causal, ragged
    (2, 4, 4, 100, 1, 128, True, torch.bfloat16),     # Sk = 1
    (2, 4, 4, 100, 1, 128, False, torch.bfloat16),
    (2, 4, 4, 1, 300, 128, False, torch.bfloat16),    # Sq = 1
    (2, 4, 4, 1, 300, 128, True, torch.bfloat16),
    (2, 32, 8, 1024, 1024, 128, True, torch.bfloat16),  # GQA 32/8
    (1, 48, 1, 512, 512, 128, True, torch.bfloat16),    # MQA 48/1 (granite_34b)
    # the tf32x3 path's edges (f32) at D = 64 and 128, then a D that is no
    # multiple of 8 (CUDA cores)
    *[(B, Hq, Hkv, Sq, Sk, D, causal, torch.float32) for D in (64, 128)
      for B, Hq, Hkv, Sq, Sk, causal in (
          (1, 1, 1, D, D, True),          # one tile
          (2, 4, 2, 200, 333, True),      # ragged Sq and Sk
          (2, 4, 2, 200, 333, False),
          (1, 4, 4, 300, 130, True),      # Sq > Sk, causal, ragged
          (2, 4, 4, 100, 1, True),        # Sk = 1
          (2, 4, 4, 1, 300, False),       # Sq = 1
          (2, 4, 4, 1, 300, True),
          (1, 4, 4, 77, 0, True),         # no keys: zeros
          (1, 48, 1, 256, 256, True),     # MQA 48/1 (granite_34b)
          (2, 32, 8, 384, 384, True),     # GQA 32/8 (mistral_nemo_12b)
      )],
    (1, 4, 2, 70, 130, 36, True, torch.float32),     # D not a multiple of 8: CUDA cores
]


def _expected_path(D, dtype):
    """The routing rule for contiguous (16-byte aligned) inputs."""
    if dtype != torch.bfloat16:
        return "tf32x3" if D % 8 == 0 and D <= 128 else "simt"
    return "wgmma" if D in (64, 128) else "mma" if D % 16 == 0 else "simt"


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
    assert fl_ops.last_path == _expected_path(D, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S", [(1, 1000), (2, 2048)])
def test_flash_attention_kernel_at_qwen2_vl_heads(cuda, B, S, causal):
    """qwen2_vl_72b's attention: q of 64 heads over k/v of 8 (a group of
    8), D = 128, bf16, on the ``wgmma`` path."""
    before = kernels.launches["flash_attention:wgmma"]
    _flash_check(*_flash_inputs(5, B, 64, 8, S, S, 128, torch.bfloat16), causal)
    assert fl_ops.last_path == "wgmma" and kernels.launches["flash_attention:wgmma"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_on_transposed_views(cuda, dtype, D):
    """The model hands (B, S, H, D) tensors transposed to (B, H, S, D): the
    kernel reads them through their strides and writes an output laid out
    like q, so transposing it back is contiguous."""
    rng = np.random.default_rng(4)
    q, k, v = [torch.from_numpy(rng.normal(size=(2, 75, h, D)).astype(np.float32)).cuda()
               .to(dtype).transpose(1, 2) for h in (8, 2, 2)]
    out = _flash_check(q, k, v, True)
    assert out.transpose(1, 2).is_contiguous()
    assert fl_ops.last_path == _expected_path(D, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("which", ["base", "row_stride"])
def test_flash_attention_routes_unaligned_bf16_to_mma(cuda, which, D):
    """The wgmma path takes 16-byte aligned bases and strides only: q at a
    4-byte offset, or a row stride of D + 4 elements, keeps mma.sync."""
    q, k, v = _flash_inputs(6, 1, 4, 2, 96, 160, D, torch.bfloat16)
    if which == "base":
        q = torch.cat([q.new_zeros(2), q.flatten()])[2:].view(q.shape)
    else:   # rows of D + 4 elements: only 8-byte aligned
        q = torch.cat([q, q.new_zeros(1, 4, 96, 4)], -1)[..., :D]
    _flash_check(q, k, v, True)
    assert fl_ops.last_path == "mma"


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("which", ["k_base", "v_row_stride"])
def test_flash_attention_routes_unaligned_f32_to_simt(cuda, which, D):
    """The tf32x3 path copies K and V rows in 16-byte chunks: k at a 4-byte
    offset, or V rows of D + 2 floats, go to the CUDA cores."""
    q, k, v = _flash_inputs(8, 1, 4, 2, 96, 160, D, torch.float32)
    if which == "k_base":
        k = torch.cat([k.new_zeros(1), k.flatten()])[1:].view(k.shape)
    else:   # rows of D + 2 floats: only 8-byte aligned
        v = torch.cat([v, v.new_zeros(1, 2, 160, 2)], -1)[..., :D]
    _flash_check(q, k, v, True)
    assert fl_ops.last_path == "simt"


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("scale", [-0.3, 0.0, 2.5])
def test_flash_attention_tf32x3_with_other_scales(cuda, scale, D):
    """The tf32x3 path folds the scale into q before it splits it; negative,
    zero and large scales are as right as the plain version.  Both are held
    to a float64 oracle: at scale 2.5 the scores reach about 30, where
    float32's own rounding of them moves the plain output about 3e-5 (4e-5
    at D = 128) from float64, so the kernel is held to the larger of 2e-5
    and the plain version's own distance."""
    q, k, v = _flash_inputs(9, 2, 4, 2, 200, 333, D, torch.float32)
    out = fl_ops.flash_attention(q, k, v, causal=True, scale=scale)
    torch.cuda.synchronize()
    assert fl_ops.last_path == "tf32x3"
    plain = attention_ref(q, k, v, causal=True, scale=scale)
    kk, vv = (t.double().repeat_interleave(2, 1) for t in (k, v))
    sc = torch.einsum("bhqd,bhkd->bhqk", q.double(), kk) * scale
    sc = sc.masked_fill(torch.arange(333, device="cuda") > torch.arange(200, device="cuda")[:, None],
                        float("-inf"))
    oracle = torch.softmax(sc, -1) @ vv
    plain_err = (plain.double() - oracle).abs().max().item()
    assert (out.double() - oracle).abs().max().item() < max(TOL[torch.float32], plain_err)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("scale", [-0.3, 0.0, 2.5])
def test_flash_attention_kernel_with_other_scales(cuda, scale, D):
    """The wgmma path folds a positive scale into its exponent and keeps a
    separate softmax for the others; both match the plain version."""
    q, k, v = _flash_inputs(7, 2, 4, 2, 200, 333, D, torch.bfloat16)
    out = fl_ops.flash_attention(q, k, v, causal=True, scale=scale)
    torch.cuda.synchronize()
    assert fl_ops.last_path == "wgmma"
    plain = attention_ref(q, k, v, causal=True, scale=scale)
    assert (out.float() - plain.float()).abs().max().item() < TOL[torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_on_rising_scores(cuda, causal, D):
    """Keys moved along q's common direction by an amount that grows with
    their position over the first half of the keys: each key tile's row
    max passes the last one's by about ``rise`` in base-2 units there and
    by nothing after, so O is rescaled by factors far from 1 and then
    by 1."""
    rise, key_tile = 12.0, 128       # base-2 units of score a tile of the kernel's keys
    rng = np.random.default_rng(13)
    q = rng.normal(size=(2, 4, 300, D)) + 2.0    # q . 1 is about 2 D
    k = rng.normal(size=(2, 2, 1024, D))
    v = rng.normal(size=(2, 2, 1024, D))
    steps = np.minimum(np.arange(1024), 512)
    k = k + (steps * rise / (math.log2(math.e) * 2.0 * D ** 0.5 * key_tile))[:, None]
    q, k, v = [torch.from_numpy(a.astype(np.float32)).cuda().to(torch.bfloat16) for a in (q, k, v)]
    _flash_check(q, k, v, causal)
    assert fl_ops.last_path == "wgmma"


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


# -- decay attention ---------------------------------------------------------------

DECAY_TOL = 2e-3    # the reference's (tests/test_kernel_decay.py), f32
# tests/test_kernel_decay.py's shapes (B, S, H, dk, dv, bonus), its
# three-chunk state carry, and the model shapes (rwkv6: 64/64 with the bonus;
# zamba2 smoke: 16/16)
DECAY_CASES = [
    (2, 64, 2, 16, 16, False),
    (1, 100, 3, 32, 32, True),
    (2, 32, 1, 8, 24, True),
    (1, 33, 2, 64, 64, False),
    (1, 96, 1, 16, 16, "carry"),
    (2, 300, 4, 64, 64, True),
    (2, 77, 6, 16, 16, False),
]


def _decay_inputs(B, S, H, dk, dv, bonus, seed=0):
    """The reference kernel test's inputs (a constant decay of -0.05 for the
    state carry), made with numpy, on the card."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, dk))
    k = rng.normal(size=(B, S, H, dk)) * 0.3
    v = rng.normal(size=(B, S, H, dv))
    lw = (np.full((B, S, H, dk), -0.05) if bonus == "carry"
          else -np.abs(rng.normal(size=(B, S, H, dk))) * 0.3)
    u = rng.normal(size=(H, dk)) * 0.2 if bonus is True else None
    return [None if a is None else torch.from_numpy(a.astype(np.float32)).cuda()
            for a in (q, k, v, lw, u)]


def _rows16(t):
    """d contiguous, a 16-byte aligned base, the other strides on 16 bytes
    (a dimension of size 1 exempt): what the tensor-core paths' copies read."""
    item = t.element_size()
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(t.shape[i] == 1 or (t.stride(i) * item) % 16 == 0 for i in range(3)))


def _decay_path(q, k, v, lw):
    """The path the wrapper's rule gives (ops.py): the scalar form when q
    and k are stride 0 over heads and log_w over the state dim, else the
    vector form; bfloat16 on ``scalar_tc`` / ``vector_tc``; float32 on their
    ``_f32`` siblings when d is a multiple of 4 and the rows are whole 16
    bytes, else on ``simt``."""
    scalar = q.stride(2) == 0 and k.stride(2) == 0 and lw.stride(3) == 0
    form = "scalar_tc" if scalar else "vector_tc"
    if q.dtype == torch.bfloat16:
        return form
    rows = all(_rows16(t) for t in (q, k, v) + (() if scalar else (lw,)))
    return form + "_f32" if rows and q.shape[3] % 4 == 0 and v.shape[3] % 4 == 0 else "simt"


def _decay_check(q, k, v, lw, u=None, h0=None, tol=DECAY_TOL):
    before = kernels.launches["decay_attention"]
    path = _decay_path(q, k, v, lw)
    on_path = kernels.launches[f"decay_attention:{path}"]
    y, hT = dc_ops.decay_attention(q, k, v, lw, bonus=u, initial_state=h0, return_state=True)
    torch.cuda.synchronize()
    assert kernels.launches["decay_attention"] == before + 1
    assert dc_ops.last_path == path and kernels.launches[f"decay_attention:{path}"] == on_path + 1
    py, ph = chunked_decay_ref(q, k, v, lw, bonus=u, initial_state=h0, return_state=True)
    assert y.dtype == q.dtype and y.shape == v.shape and hT.dtype == torch.float32
    scale = max(1.0, py.float().abs().max().item()) if q.dtype == torch.bfloat16 else 1.0
    assert (y.float() - py.float()).abs().max().item() < tol * scale
    assert (hT - ph).abs().max().item() < DECAY_TOL * max(1.0, ph.abs().max().item())
    return y, hT


@pytest.mark.cuda
@pytest.mark.parametrize("case", DECAY_CASES, ids=lambda c: "-".join(map(str, c)))
def test_decay_attention_kernel_matches_plain(cuda, case):
    q, k, v, lw, u = _decay_inputs(*case)
    y, hT = _decay_check(q, k, v, lw, u)
    if q.shape[1] <= 100:   # and the sequential oracle at the reference's tolerance
        oy, oh = decay_attention_ref(q, k, v, lw, bonus=u, return_state=True)
        assert (y - oy).abs().max().item() < DECAY_TOL
        assert (hT - oh).abs().max().item() < DECAY_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("bonus", [False, True])
def test_decay_attention_kernel_carries_an_initial_state(cuda, bonus):
    q, k, v, lw, u = _decay_inputs(2, 70, 3, 32, 24, bonus, seed=1)
    h0 = torch.randn(2, 3, 32, 24, generator=torch.Generator(device="cuda").manual_seed(2),
                     device="cuda")
    _decay_check(q, k, v, lw, u, h0)
    # two calls chaining the state equal one call
    y1, s1 = dc_ops.decay_attention(q[:, :40], k[:, :40], v[:, :40], lw[:, :40], bonus=u,
                                    initial_state=h0, return_state=True)
    y2, s2 = dc_ops.decay_attention(q[:, 40:], k[:, 40:], v[:, 40:], lw[:, 40:], bonus=u,
                                    initial_state=s1, return_state=True)
    y, s = dc_ops.decay_attention(q, k, v, lw, bonus=u, initial_state=h0, return_state=True)
    assert (torch.cat([y1, y2], 1) - y).abs().max().item() < DECAY_TOL
    assert (s2 - s).abs().max().item() < DECAY_TOL * max(1.0, s.abs().max().item())


# (dtype, B, S, H, ns, hd, with h0, bonus): a small f32 case; bf16 at
# zamba2's width (112 heads, state and head 64) with a ragged S and an
# initial state; and bf16 with a bonus, which the scalar-decay path also
# takes, at a head count its 2-head blocks do not divide and dk 32
STRIDE0_CASES = [
    (torch.float32, 2, 75, 8, 16, 32, False, False),
    (torch.bfloat16, 2, 300, 112, 64, 64, True, False),
    (torch.bfloat16, 1, 100, 5, 32, 64, True, True),
    (torch.float32, 2, 300, 112, 64, 64, True, False),
    (torch.float32, 1, 100, 5, 32, 64, True, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", STRIDE0_CASES, ids=lambda c: "-".join(map(str, c[1:])) + (
    "-" + str(c[0]).split(".")[-1]))
def test_decay_attention_kernel_on_stride0_views(cuda, case):
    """Mamba2's call: C and B broadcast over heads (slices of one wider row,
    as ``xBC``), the per-head decay over the state dim, v a fresh tensor; a
    ragged S; the state chained over two calls equals one call."""
    dtype, B, S, H, ns, hd, with_h0, bonus = case
    g = torch.Generator(device="cuda").manual_seed(3)
    xBC = torch.randn(B, S, 3 * ns, generator=g, device="cuda")
    xBC[..., ns:2 * ns] *= 0.3
    xBC = xBC.to(dtype)
    Cp, Bp = xBC[..., :ns], xBC[..., ns:2 * ns]
    q, k = Cp[:, :, None].expand(B, S, H, ns), Bp[:, :, None].expand(B, S, H, ns)
    dt = torch.rand(B, S, H, generator=g, device="cuda") * (2 if with_h0 else 1)
    lw = (-dt)[..., None].expand(B, S, H, ns)
    v = torch.randn(B, S, H, hd, generator=g, device="cuda").to(dtype)
    h0 = torch.randn(B, H, ns, hd, generator=g, device="cuda") if with_h0 else None
    u = torch.randn(H, ns, generator=g, device="cuda") * 0.2 if bonus else None
    assert q.stride(2) == 0 and lw.stride(3) == 0
    tol = DECAY_TOL if dtype == torch.float32 else 2e-2
    y, s = _decay_check(q, k, v, lw, u, h0=h0, tol=tol)
    cut = 2 * 32 + 5
    y1, s1 = dc_ops.decay_attention(q[:, :cut], k[:, :cut], v[:, :cut], lw[:, :cut], bonus=u,
                                    initial_state=h0, return_state=True)
    y2, s2 = dc_ops.decay_attention(q[:, cut:], k[:, cut:], v[:, cut:], lw[:, cut:], bonus=u,
                                    initial_state=s1, return_state=True)
    scale = max(1.0, y.float().abs().max().item()) if dtype == torch.bfloat16 else 1.0
    assert (torch.cat([y1, y2], 1).float() - y.float()).abs().max().item() < tol * scale
    assert (s2 - s).abs().max().item() < DECAY_TOL * max(1.0, s.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("bonus,lw_scale", [(False, 1), (True, 1), (True, 4)],
                         ids=["bonus=False", "bonus=True", "bonus-at-the-clip"])
def test_decay_attention_kernel_bf16(cuda, bonus, lw_scale):
    """bf16 q, k, v (the model path's type), f32 log_w, an initial state:
    within 2e-2 of the plain version's scale, the rule of the bf16 flash
    rows; with the bonus also at the clip (log_w * 4 reaches -1.8, so the
    factored decays reach e^(+-57.6))."""
    q, k, v, lw, u = _decay_inputs(2, 130, 4, 64, 64, bonus, seed=4)
    h0 = torch.randn(2, 4, 64, 64, generator=torch.Generator(device="cuda").manual_seed(5),
                     device="cuda")
    _decay_check(q.bfloat16(), k.bfloat16(), v.bfloat16(), lw * lw_scale, u, h0, tol=2e-2)


def _scalar_views(B, S, H, ns, hd, dtype=torch.float32, dt_scale=1.0, seed=3, lead=0):
    """Mamba2's call: C and B slices of one wider row (``lead`` floats
    before them), broadcast over heads; the per-head decay over the state."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    xBC = torch.randn(B, S, lead + 2 * ns, generator=g, device="cuda")
    xBC[..., lead + ns:] *= 0.3
    xBC = xBC.to(dtype)
    q = xBC[:, :, None, lead:lead + ns].expand(B, S, H, ns)
    k = xBC[:, :, None, lead + ns:].expand(B, S, H, ns)
    lw = (-torch.rand(B, S, H, generator=g, device="cuda") * dt_scale)[..., None].expand(B, S, H, ns)
    v = torch.randn(B, S, H, hd, generator=g, device="cuda").to(dtype)
    return q, k, v, lw


# (form, dk, dv): widths 16, 32 and 64 with dk != dv, and 4 (the least f32 width)
F32_WIDTHS = [(f, dk, dv) for f in ("vector", "scalar")
              for dk, dv in ((16, 32), (32, 64), (64, 16), (64, 64), (4, 12))]


@pytest.mark.cuda
@pytest.mark.parametrize("case", F32_WIDTHS, ids=lambda c: "-".join(map(str, c)))
def test_decay_attention_f32_paths_at_each_width(cuda, case):
    """Both f32 tensor-core paths at d 16/32/64 (dk != dv) and 4, a ragged
    S, an initial state and the final state, the bonus on the vector form:
    within 2e-3 of the plain chunked form, and of the sequential oracle."""
    form, dk, dv = case
    g = torch.Generator(device="cuda").manual_seed(dk + dv)
    if form == "vector":
        q, k, v, lw, u = _decay_inputs(2, 77, 3, dk, dv, True, seed=dk)
    else:
        q, k, v, lw = _scalar_views(2, 77, 3, dk, dv, seed=dk)
        u = None
    h0 = torch.randn(2, 3, dk, dv, generator=g, device="cuda")
    y, hT = _decay_check(q, k, v, lw, u, h0)
    assert dc_ops.last_path == f"{form}_tc_f32"
    oy, oh = decay_attention_ref(q, k, v, lw, bonus=u, initial_state=h0, return_state=True)
    assert (y - oy).abs().max().item() < DECAY_TOL
    assert (hT - oh).abs().max().item() < DECAY_TOL * max(1.0, oh.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["vector", "scalar"])
@pytest.mark.parametrize("decay", ["at-the-clip", "times4"])
def test_decay_attention_f32_paths_at_the_clip(cuda, form, decay):
    """log_w pinned past the clip (every step -1.8: the factored decays
    reach e^(+-57.6) in a chunk) and the reference statistics times 4:
    within 2e-3 of the plain chunked form and of the sequential oracle."""
    if form == "vector":
        q, k, v, lw, u = _decay_inputs(2, 130, 4, 64, 64, True, seed=4)
        lw = torch.full_like(lw, -2.0) if decay == "at-the-clip" else lw * 4
    else:
        q, k, v, lw = _scalar_views(2, 130, 4, 64, 64, dt_scale=4.0)
        u = None
        if decay == "at-the-clip":
            lw = torch.full(lw.shape[:3], -2.0, device="cuda")[..., None].expand(lw.shape)
    h0 = torch.randn(q.shape[0], q.shape[2], 64, 64, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(5))
    y, hT = _decay_check(q, k, v, lw, u, h0)
    assert dc_ops.last_path == f"{form}_tc_f32"
    oy, oh = decay_attention_ref(q, k, v, lw, bonus=u, initial_state=h0, return_state=True)
    assert (y - oy).abs().max().item() < DECAY_TOL
    assert (hT - oh).abs().max().item() < DECAY_TOL * max(1.0, oh.abs().max().item())


# views at the 16-byte edge: (what, build from contiguous f32 q, k, v, lw, path)
EDGE_VIEWS = [
    ("rows padded by 16 bytes", lambda t: torch.zeros(*t.shape[:3], t.shape[3] + 4,
                                                      device="cuda")[..., :t.shape[3]].copy_(t),
     "vector_tc_f32"),
    ("base 16 bytes in", lambda t: torch.zeros(t.numel() + 4, device="cuda")[4:]
     .view(t.shape).copy_(t), "vector_tc_f32"),
    ("base 4 bytes in", lambda t: torch.zeros(t.numel() + 1, device="cuda")[1:]
     .view(t.shape).copy_(t), "simt"),
    ("rows padded by 8 bytes", lambda t: torch.zeros(*t.shape[:3], t.shape[3] + 2,
                                                     device="cuda")[..., :t.shape[3]].copy_(t),
     "simt"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("edge", EDGE_VIEWS, ids=lambda e: e[0])
def test_decay_attention_f32_views_at_the_16_byte_edge(cuda, edge):
    """f32 views whose rows sit on whole 16 bytes take the tensor-core path,
    those a few bytes off take ``simt``; both hold the plain chunked form."""
    what, make, want = edge
    q, k, v, lw, u = _decay_inputs(2, 45, 3, 16, 16, True, seed=7)
    views = [make(t) for t in (q, k, v, lw)]
    y, hT = _decay_check(*views, u)
    assert dc_ops.last_path == want
    y0, h0 = dc_ops.decay_attention(q, k, v, lw, bonus=u, return_state=True)
    assert (y - y0).abs().max().item() < DECAY_TOL and (hT - h0).abs().max().item() < DECAY_TOL


@pytest.mark.cuda
def test_decay_attention_f32_paths_count_and_refuse(cuda):
    """Each f32 path counts its own launches, raises under autograd before
    launching, and a tensor-core launch that the C entry refuses (d past 64,
    a vector view sent to the scalar path) raises: no fallback."""
    import ctypes

    from repro_torch.kernels import _build

    vec = _decay_inputs(1, 40, 2, 16, 16, True)
    sca = _scalar_views(1, 40, 2, 16, 16)
    kernels.reset_launches()
    dc_ops.decay_attention(*vec[:4], bonus=vec[4])
    dc_ops.decay_attention(*sca)
    dc_ops.decay_attention(*sca)
    assert kernels.launches["decay_attention:vector_tc_f32"] == 1
    assert kernels.launches["decay_attention:scalar_tc_f32"] == 2
    assert kernels.launches["decay_attention"] == 3
    for views in (vec[:4], sca):
        q = views[0].clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match="forward-only"):
            dc_ops.decay_attention(q, *views[1:4])
    assert kernels.launches["decay_attention"] == 3
    lib = _build.library("decay_attention")
    fn = lib.decay_attention_f32
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.POINTER(ctypes.c_longlong)] * 2 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    q = torch.zeros(1, 40, 2, 68, device="cuda")
    out = torch.empty(1, 40, 2, 68, device="cuda")
    strides = (ctypes.c_longlong * 20)(*(q.stride(i) for _ in range(5) for i in range(4)))
    stream = torch.cuda.current_stream().cuda_stream
    for dims, path in (((1, 40, 2, 68, 68), 4), ((1, 40, 2, 64, 64), 3), ((1, 40, 2, 68, 68), 3)):
        status = fn(q.data_ptr(), q.data_ptr(), q.data_ptr(), q.data_ptr(), None, None,
                    out.data_ptr(), None, (ctypes.c_longlong * 5)(*dims), strides, 0, path, stream)
        assert status != 0, (dims, path)
        with pytest.raises(RuntimeError, match="CUDA error"):
            _build.check(lib, status, "decay_attention")


@pytest.mark.cuda
@pytest.mark.parametrize("arch,path", [("zamba2_7b", "scalar_tc"), ("rwkv6_7b", "vector_tc")])
def test_decay_attention_model_views_take_their_path(cuda, arch, path):
    """The smoke model's own calls (``mamba2.py``'s C/B slices of ``xBC``
    and broadcast decay; ``rwkv6.py``'s reshaped projections and f32 decay)
    take the tensor-core path of their family, in bfloat16 and in float32
    (its ``_f32`` sibling); every launch of a ``prefill_logits`` forward
    counts there."""
    for dtype, want in (("bfloat16", path), ("float32", f"{path}_f32")):
        cfg = dataclasses.replace(get_config(arch).smoke(), dtype=dtype)
        model = LM(cfg, remat=None)
        params = model.init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
        tokens = torch.randint(0, cfg.vocab_size, (2, 70), device="cuda",
                               generator=torch.Generator(device="cuda").manual_seed(1))
        batch = {"tokens": tokens, "positions": torch.arange(70, device="cuda")[None].expand(2, 70)}
        kernels.reset_launches()
        with torch.no_grad():
            logits = model.prefill_logits(params, batch)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(logits.float()).all())
        n = kernels.launches["decay_attention"]
        assert n == cfg.n_layers and kernels.launches[f"decay_attention:{want}"] == n
        assert dc_ops.last_path == want


@pytest.mark.cuda
def test_decay_attention_raises_under_autograd(cuda):
    q, k, v, lw, u = _decay_inputs(1, 40, 2, 16, 16, True)
    q.requires_grad_(True)
    before = kernels.launches["decay_attention"]
    with pytest.raises(RuntimeError, match="forward-only"):
        dc_ops.decay_attention(q, k, v, lw, bonus=u)
    assert kernels.launches["decay_attention"] == before


@pytest.mark.cuda
def test_decay_attention_kernel_rejects_what_it_cannot_take(cuda):
    q, k, v, lw, u = _decay_inputs(1, 40, 2, 16, 16, True)
    wide, wide_w = _decay_inputs(1, 40, 2, 65, 16, False)[0], _decay_inputs(1, 40, 2, 65, 16,
                                                                            False)[3]
    before = kernels.launches["decay_attention"]
    with pytest.raises(ValueError, match="dk and dv"):
        dc_ops.decay_attention(wide, wide, v, wide_w)
    with pytest.raises(ValueError, match="dk and dv"):
        dc_ops.decay_attention(q, k, _decay_inputs(1, 40, 2, 16, 65, False)[2], lw)
    with pytest.raises(TypeError):
        dc_ops.decay_attention(q.half(), k.half(), v.half(), lw)
    with pytest.raises(TypeError):
        dc_ops.decay_attention(q, k.bfloat16(), v, lw)
    with pytest.raises(TypeError):
        dc_ops.decay_attention(q, k, v, lw.bfloat16())
    with pytest.raises(TypeError):
        dc_ops.decay_attention(q, k, v, lw, bonus=u.bfloat16())
    with pytest.raises(ValueError, match="several devices"):
        dc_ops.decay_attention(q, k, v, lw.cpu())
    assert kernels.launches["decay_attention"] == before


@pytest.mark.cuda
def test_chunked_decay_attention_dispatch_on_the_card(cuda):
    """Outside autograd the model path's chunked form launches the kernel;
    under autograd it takes the plain math, which carries gradients."""
    q, k, v, lw, u = _decay_inputs(2, 50, 2, 16, 16, True)
    before = kernels.launches["decay_attention"]
    with torch.no_grad():
        y = linear_scan.chunked_decay_attention(q, k, v, lw, bonus=u)
    assert kernels.launches["decay_attention"] == before + 1
    q.requires_grad_(True)
    y_plain = linear_scan.chunked_decay_attention(q, k, v, lw, bonus=u)
    y_plain.sum().backward()
    assert kernels.launches["decay_attention"] == before + 1
    assert q.grad is not None and bool(torch.isfinite(q.grad).all())
    assert (y - y_plain.detach()).abs().max().item() < DECAY_TOL


# -- the decode steps as CUDA graphs ------------------------------------------

def _dense_smoke(dtype, seed=0):
    cfg = dataclasses.replace(get_config("stablelm_1_6b").smoke(), dtype=dtype,
                              kv_cache_dtype=dtype)
    model = LM(cfg, remat=None)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    return model, params


def _paged_pools(cfg, seed, nb=48, bs=8):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (cfg.n_layers, nb, bs, cfg.n_kv_heads, cfg.hd)
    dt = getattr(torch, cfg.kv_cache_dtype)
    return (torch.randn(shape, generator=gen, device="cuda").to(dt),
            torch.randn(shape, generator=gen, device="cuda").to(dt))


def _decode_inputs(cfg, B, seed, nb=48, bs=8, maxb=6):
    """Host arrays of one decode step: tokens, positions, table, lengths."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, maxb * bs, B).astype(np.int32)
    tbl = np.full((B, maxb), -1, np.int32)
    for b, n in enumerate(lens):
        need = -(-int(n) // bs)
        tbl[b, :need] = rng.choice(nb, size=need, replace=False)
    toks = rng.integers(0, cfg.vocab_size, (B, 1))
    return toks, (lens - 1)[:, None].astype(np.int64), tbl, lens


def _eager_step(params, cfg, kp, vp, toks, pos, tbl, lens):
    t = [torch.from_numpy(a).cuda() for a in (toks, pos, tbl, lens)]
    return paged_decode_step(params, cfg, t[0], t[1], kp, vp, t[2], t[3])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B", [1, 3, 8])
def test_paged_decode_step_graph_is_bit_equal_to_eager(cuda, B, dtype):
    """The graphed step replayed on new tokens, positions, table and
    lengths gives eager's logits, new_k and new_v bit for bit, from one
    capture."""
    model, params = _dense_smoke(dtype)
    cfg = model.cfg
    kp, vp = _paged_pools(cfg, 1)
    graphs = GraphCache()
    for seed in range(3):
        host = _decode_inputs(cfg, B, seed)
        got = [t.clone() for t in paged_decode_step_jit(params, cfg, *host[:2], kp, vp,
                                                        *host[2:], graphs=graphs)]
        want = _eager_step(params, cfg, kp, vp, *host)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
    assert graphs.captures == 1


@pytest.mark.cuda
def test_paged_decode_step_graph_counts_its_launches_per_replay(cuda):
    """Capture (and its warm-up) counts nothing; every replay adds one
    paged-attention launch a layer, as the eager step does."""
    model, params = _dense_smoke("bfloat16")
    cfg = model.cfg
    kp, vp = _paged_pools(cfg, 1)
    graphs = GraphCache()
    kernels.reset_launches()
    for step in range(1, 5):
        toks, pos, tbl, lens = _decode_inputs(cfg, 3, step)
        paged_decode_step_jit(params, cfg, toks, pos, kp, vp, tbl, lens, graphs=graphs)
        assert kernels.launches["paged_attention"] == step * cfg.n_layers
    path = pg_ops.last_path
    assert sum(n for k, n in kernels.launches.items() if ":" not in k) == 4 * cfg.n_layers
    assert kernels.launches[f"paged_attention:{path}"] == 4 * cfg.n_layers
    assert graphs.captures == 1 and graphs.steps[next(iter(graphs.steps))].launches == {
        "paged_attention": cfg.n_layers, f"paged_attention:{path}": cfg.n_layers}


@pytest.mark.cuda
def test_paged_decode_step_graph_recaptures_for_new_params_batch_or_pool(cuda):
    """A new params dict, batch size or pool gets its own capture, and the
    replay follows the new one (never a stale graph); a key seen before
    replays its graph.  Once a pool is freed, its step is retired at the
    next capture."""
    model, params = _dense_smoke("float32")
    cfg = model.cfg
    _, other = _dense_smoke("float32", seed=5)
    kp, vp = _paged_pools(cfg, 1)
    kp2, vp2 = _paged_pools(cfg, 2)
    graphs = GraphCache()
    cases = [(params, 3, kp, vp, 1), (params, 3, kp, vp, 1), (other, 3, kp, vp, 2),
             (other, 2, kp, vp, 3), (other, 2, kp2, vp2, 4), (params, 3, kp, vp, 4)]
    for i, (p, B, k, v, captures) in enumerate(cases):
        host = _decode_inputs(cfg, B, i)
        got = [t.clone() for t in paged_decode_step_jit(p, cfg, *host[:2], k, v, *host[2:],
                                                        graphs=graphs)]
        want = _eager_step(p, cfg, k, v, *host)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert graphs.captures == captures
    assert len(graphs.steps) == 4
    del cases, k, v, kp2, vp2
    toks, pos, tbl, lens = _decode_inputs(cfg, 1, 9)
    paged_decode_step_jit(params, cfg, toks, pos, kp, vp, tbl, lens, graphs=graphs)
    assert graphs.captures == 5 and len(graphs.steps) == 4


@pytest.mark.cuda
def test_graph_cache_captures_again_once_every_step_is_retired(cuda):
    """Engines in turn over one model, each freed before the next starts
    (as the trace and chaos runners share their smoke model): the next
    capture retires every step, and PyTorch releases the cache's memory
    pool with their graphs, so the cache captures into a new pool (into the
    released one, PyTorch's allocator failed an internal assert).  Every
    engine's ids equal an eager engine's."""
    import gc

    model, params = _dense_smoke("float32")
    cfg = model.cfg
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(0, cfg.vocab_size, 10).tolist(), 6) for _ in range(4)]
    captures = 0
    for num_blocks in (8, 16, 8):
        pool_cfg = KVPoolConfig(
            num_blocks=num_blocks, block_size=4, kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
            n_layers=cfg.n_layers, max_seqs=2, max_blocks_per_seq=8, blocks_per_arena=8,
            dtype="float32")
        ids = {}
        for jit in (True, False):
            eng = ServeEngine(model, params, pool_cfg, device="cuda", jit=jit)
            for rid, (prompt, n) in enumerate(reqs):
                eng.submit(Request(rid=rid, prompt=prompt, max_new=n))
            while eng.step():
                pass
            ids[jit] = {r.rid: r.out for r in eng.done}
            del eng
            gc.collect()
        assert len(ids[True]) == len(reqs) and ids[True] == ids[False]
        assert model._cuda_graphs.captures > captures
        captures = model._cuda_graphs.captures


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graphed_engine_after_fork_and_compaction_equals_eager(cuda, dtype):
    """Two engines over one model and params, graphed (the default) and
    eager, with watermark compaction and a fork part-way: the same ids and
    host metrics, and the pools bit for bit, so every replay after a fork
    or a compaction, and every step's one scatter of its tokens' K/V,
    matched eager; f32 and bf16.  The graphed engine's pools kept their
    storage (the graphs read them where they are)."""
    model, params = _dense_smoke(dtype)
    cfg = model.cfg
    pool_cfg = KVPoolConfig(
        num_blocks=64, block_size=8, kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
        n_layers=cfg.n_layers, max_seqs=4, max_blocks_per_seq=16, blocks_per_arena=16,
        dtype=dtype)
    maint = MaintenanceConfig(free_low=0.9, frag_high=0.05, contig_low=0.999, max_moves=64,
                              every=2)
    rng = np.random.default_rng(7)
    reqs = [(rng.integers(0, cfg.vocab_size, int(rng.integers(3, 40))).tolist(),
             int(rng.integers(2, 12))) for _ in range(9)]
    engines = {}
    for jit in (True, False):
        eng = ServeEngine(model, params, pool_cfg, device="cuda", jit=jit, maintenance=maint)
        ptrs = (eng.pool.k.data_ptr(), eng.pool.v.data_ptr())
        for rid, (prompt, n) in enumerate(reqs):
            eng.submit(Request(rid=rid, prompt=prompt, max_new=n))
        forked = False
        while eng.step():
            if not forked and eng.steps >= 3 and eng.live and eng.pool.occupancy()["free_slots"]:
                child = eng.pool.fork(min(eng.live))
                assert child is not None
                eng.pool.release(child)
                forked = True
        assert forked and (eng.pool.k.data_ptr(), eng.pool.v.data_ptr()) == ptrs
        engines[jit] = eng
    a, b = engines[True], engines[False]
    assert len(a.done) == 9 and a.compaction_passes > 0
    assert {r.rid: r.out for r in a.done} == {r.rid: r.out for r in b.done}
    ma, mb = a.metrics(), b.metrics()
    # only the graph cache's own counters tell the graphed engine apart
    graph_keys = {"graph_captures", "graph_capture_ms"}
    assert {k: v for k, v in ma.items() if k not in graph_keys} == {
        k: v for k, v in mb.items() if k not in graph_keys}
    assert ma["graph_captures"] == a.graphs.captures and mb["graph_captures"] == 0
    assert (ma["kv_write_calls"], ma["kv_rows_written"]) == (ma["steps"], ma["tokens"])
    assert torch.equal(a.pool.k, b.pool.k) and torch.equal(a.pool.v, b.pool.v)
    assert a.graphs is model._cuda_graphs and a.graphs.captures >= 1 and b.graphs is None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float8_e4m3fn"])
def test_batched_token_write_equals_one_at_a_time(cuda, dtype):
    """The pool's one scatter a decode step on the card, at a ``decode_32``
    -like batch (24 layers, 32 rows, one left out, bf16 K/V as the model
    makes them): K and V bit-equal to the same writes one token and layer at
    a time."""
    L, B, KV, hd = 24, 32, 4, 64
    kw = dict(num_blocks=512, block_size=16, kv_heads=KV, head_dim=hd, n_layers=L,
              max_seqs=B, max_blocks_per_seq=16, blocks_per_arena=64, dtype=dtype)
    batched, single = (PagedKVPool(KVPoolConfig(**kw), device="cuda") for _ in range(2))
    lens = np.random.default_rng(4).integers(1, 250, B).tolist()
    slots = [batched.admit(n) for n in lens]
    assert [single.admit(n) for n in lens] == slots
    gen = torch.Generator(device="cuda").manual_seed(4)
    new_k, new_v = (torch.randn(L, B, KV, hd, generator=gen, device="cuda").bfloat16()
                    for _ in range(2))
    rows = [bi for bi in range(B) if bi != 7]
    batched.write_token_kv([(bi, *batched.token_position(slots[bi])) for bi in rows], None,
                           new_k, new_v)
    for bi in rows:
        for li in range(L):
            single.write_token_kv(slots[bi], li, new_k[li, bi], new_v[li, bi])
    for x, y in ((batched.k, single.k), (batched.v, single.v)):
        assert torch.equal(x.view(torch.uint8), y.view(torch.uint8))
    block, off = batched.token_position(slots[7])
    assert bool(batched.k.view(torch.uint8).any())
    assert not bool(batched.k[:, block, off].view(torch.uint8).any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_graphed_decode_equals_eager(cuda, dtype):
    """rwkv6's one-token ``decode_step`` as a graph, from a copy of the same
    prompt cache as eager: 8 greedy steps with bit-equal logits, the states
    written in place bit-equal, one capture."""
    cfg = dataclasses.replace(get_config("rwkv6_7b").smoke(), dtype=dtype)
    model = LM(cfg, remat=None)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (3, 40), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(1))
    cache = model.init_cache(3, 48, device="cuda")
    with torch.no_grad():
        logits, cache = model.decode_step(
            params, {"tokens": tokens, "positions": torch.arange(40, device="cuda")[None]
                     .expand(3, 40)}, cache)
    caches = {mode: {"layers": type(cache["layers"])(*(t.clone() for t in cache["layers"])),
                     "len": cache["len"]} for mode in ("eager", "graph")}
    toks = {mode: logits.argmax(-1)[:, None] for mode in caches}
    steps = {"eager": lambda b, c: model.decode_step(params, b, c),
             "graph": lambda b, c: decode_step_jit(model, params, b, c)}
    with torch.no_grad():
        for t in range(8):
            pos = torch.full((3, 1), 40 + t, device="cuda")
            out = {}
            for mode, step in steps.items():
                lg, caches[mode] = step({"tokens": toks[mode], "positions": pos}, caches[mode])
                out[mode] = lg.clone()
                toks[mode] = lg.argmax(-1)[:, None]
            assert torch.equal(out["graph"], out["eager"])
    assert caches["graph"]["len"] == caches["eager"]["len"] == 48
    assert all(torch.equal(a, b) for a, b in zip(caches["graph"]["layers"],
                                                 caches["eager"]["layers"]))
    assert model._cuda_graphs.captures == 1


# -- the MoE family's decode step as a CUDA graph -------------------------------

def _moe_smoke(dtype, seed=0):
    cfg = dataclasses.replace(get_config("granite_moe_1b_a400m").smoke(), dtype=dtype,
                              kv_cache_dtype=dtype)
    model = LM(cfg, remat=None)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    return model, params


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B", [1, 3, 8])
def test_moe_paged_decode_step_graph_is_bit_equal_to_eager(cuda, B, dtype):
    """The MoE step (sorts, index adds, gathers; no host sync) is captured
    once, and each replay on new inputs gives eager's logits, new_k and
    new_v bit for bit: every kept slot has a buffer row of its own, so the
    atomic scatter is exact."""
    model, params = _moe_smoke(dtype)
    cfg = model.cfg
    kp, vp = _paged_pools(cfg, 1)
    graphs = GraphCache()
    for seed in range(3):
        host = _decode_inputs(cfg, B, seed)
        got = [t.clone() for t in paged_decode_step_jit(params, cfg, *host[:2], kp, vp,
                                                        *host[2:], graphs=graphs)]
        want = _eager_step(params, cfg, kp, vp, *host)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
    assert graphs.captures == 1


@pytest.mark.cuda
def test_moe_graph_replays_new_routes_bit_equal_to_eager(cuda, monkeypatch):
    """Replays whose tokens route to other experts than the captured step's
    (the eager steps' expert ids differ step to step) stay bit-equal to
    eager."""
    model, params = _moe_smoke("bfloat16")
    cfg = model.cfg
    kp, vp = _paged_pools(cfg, 1)
    graphs = GraphCache()
    route, routes = moe._route, []

    def recording(*args):
        out = route(*args)
        routes[-1].append(out[2].clone())
        return out

    for seed in range(4):
        host = _decode_inputs(cfg, 8, 10 + seed)
        got = [t.clone() for t in paged_decode_step_jit(params, cfg, *host[:2], kp, vp,
                                                        *host[2:], graphs=graphs)]
        routes.append([])
        with monkeypatch.context() as m:
            m.setattr(moe, "_route", recording)
            want = _eager_step(params, cfg, kp, vp, *host)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert graphs.captures == 1 and all(len(r) == cfg.n_layers for r in routes)
    for a, b in zip(routes, routes[1:]):
        assert not all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_moe_paged_decode_step_does_not_sync_the_host(cuda):
    """Eagerly, with CUDA's sync debug mode set to raise: the MoE step (its
    routing, dispatch and combine) reads nothing back to the host."""
    model, params = _moe_smoke("bfloat16")
    cfg = model.cfg
    kp, vp = _paged_pools(cfg, 1)
    dev = [torch.from_numpy(a).cuda() for a in _decode_inputs(cfg, 8, 3)]
    _eager_step(params, cfg, kp, vp, *_decode_inputs(cfg, 8, 3))   # warm up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            out = paged_decode_step(params, cfg, dev[0], dev[1], kp, vp, dev[2], dev[3])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(out[0]).all())


# -- the vlm family's decode step as a CUDA graph -------------------------------

def _vlm_smoke(dtype, seed=0):
    cfg = dataclasses.replace(get_config("qwen2_vl_72b").smoke(), dtype=dtype,
                              kv_cache_dtype=dtype)
    model = LM(cfg, remat=None)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    return model, params


def _pos3(pos):
    """(B, 1) host positions -> (B, 1, 3), t = h = w, as the engine's."""
    return np.repeat(pos[..., None], 3, axis=-1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B", [1, 3, 8])
def test_vlm_paged_decode_step_graph_is_bit_equal_to_eager(cuda, B, dtype):
    """The M-RoPE step at (B, 1, 3) positions, captured once: each replay on
    new inputs gives eager's logits, new_k and new_v bit for bit."""
    model, params = _vlm_smoke(dtype)
    cfg = model.cfg
    kp, vp = _paged_pools(cfg, 1)
    graphs = GraphCache()
    for seed in range(3):
        toks, pos, tbl, lens = _decode_inputs(cfg, B, seed)
        host = (toks, _pos3(pos), tbl, lens)
        got = [t.clone() for t in paged_decode_step_jit(params, cfg, *host[:2], kp, vp,
                                                        *host[2:], graphs=graphs)]
        want = _eager_step(params, cfg, kp, vp, *host)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
    assert graphs.captures == 1


@pytest.mark.cuda
def test_vlm_graph_replays_new_positions_with_a_new_rotation(cuda):
    """A replay with the same tokens, table and lengths but each stream's
    position moved: the first layer's new K (rotated) changes and its V
    does not, and the whole step equals eager's at the new positions.  Each
    stream is read: moving t alone changes K too."""
    model, params = _vlm_smoke("bfloat16")
    cfg = model.cfg
    kp, vp = _paged_pools(cfg, 1)
    graphs = GraphCache()
    toks, pos, tbl, lens = _decode_inputs(cfg, 8, 4)
    base = _pos3(pos)
    outs = []
    for shift in ((0, 0, 0), (5, 5, 5), (5, 0, 0)):
        host = (toks, base + np.asarray(shift, np.int64), tbl, lens)
        got = [t.clone() for t in paged_decode_step_jit(params, cfg, *host[:2], kp, vp,
                                                        *host[2:], graphs=graphs)]
        want = _eager_step(params, cfg, kp, vp, *host)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        outs.append(got)
    assert graphs.captures == 1
    for moved in outs[1:]:
        assert not torch.equal(moved[1][0], outs[0][1][0])
        assert torch.equal(moved[2][0], outs[0][2][0])
    assert not torch.equal(outs[1][1][0], outs[2][1][0])


@pytest.mark.cuda
def test_vlm_and_dense_graphs_in_one_cache_never_share_a_capture(cuda):
    """A vlm and a dense model of the same shapes (3 layers, 2 KV heads of
    32) decode through one ``GraphCache`` on pools of one shape: two
    captures, each step bit-equal to its own eager step."""
    vlm, vlm_params = _vlm_smoke("bfloat16")
    cfg_d = dataclasses.replace(get_config("mistral_nemo_12b").smoke(), dtype="bfloat16",
                                kv_cache_dtype="bfloat16")
    dense = LM(cfg_d, remat=None)
    dense_params = dense.init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    kp, vp = _paged_pools(vlm.cfg, 1)
    graphs = GraphCache()
    toks, pos, tbl, lens = _decode_inputs(vlm.cfg, 3, 6)
    for model, params, p in ((vlm, vlm_params, _pos3(pos)), (dense, dense_params, pos),
                             (vlm, vlm_params, _pos3(pos))):
        got = [t.clone() for t in paged_decode_step_jit(params, model.cfg, toks, p, kp, vp,
                                                        tbl, lens, graphs=graphs)]
        want = _eager_step(params, model.cfg, kp, vp, toks, p, tbl, lens)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert graphs.captures == 2


# -- the encdec family (seamless_m4t_medium) --------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Se", [2048, 1000, 1500])
@pytest.mark.parametrize("kind", ["encoder", "cross_decode"])
def test_flash_attention_kernel_at_encdec_shapes(cuda, kind, Se, dtype):
    """seamless_m4t_medium's flash shapes in the model's layout, non-causal:
    the encoder's (and the cross-attention prefill's) q/k/v (4, 16, Se, 64),
    and a decode step's cross-attention, q (8, 16, 1, 64) against k/v
    (8, 16, Se, 64) sliced out of a stacked (L, B, Se, H, D) cross cache,
    at the full shape and at ragged encoder lengths; ``wgmma`` in bf16,
    ``tf32x3`` in f32."""
    rng = np.random.default_rng(Se)
    B, Sq = (4, Se) if kind == "encoder" else (8, 1)
    q = torch.from_numpy(rng.normal(size=(B, Sq, 16, 64)).astype(np.float32)).cuda().to(dtype)
    kv = torch.from_numpy(rng.normal(size=(2, 3, B, Se, 16, 64)).astype(np.float32)).cuda()
    k, v = kv.to(dtype)[:, 1]
    out = _flash_check(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), False)
    assert out.transpose(1, 2).is_contiguous()
    assert fl_ops.last_path == _expected_path(64, dtype)


def _encdec_smoke():
    """The smoke seamless_m4t_medium (f32, head width 32), its weights drawn
    on the CPU from a seeded generator, and 2 sequences' 6-token prompts
    over 10 frames."""
    cfg = get_config("seamless_m4t_medium").smoke()
    tree = LM(cfg).init(torch.Generator().manual_seed(3), device="cpu")
    gen = torch.Generator().manual_seed(4)
    tokens = torch.randint(0, cfg.vocab_size, (2, 6), generator=gen)
    enc = torch.randn(2, 10, cfg.d_model, generator=gen) * 0.02
    return cfg, tree, tokens, enc


def _encdec_greedy(model, params, tokens, enc, new=10):
    """The prompt, then ``new`` greedy steps over the split cache with the
    cross cache filled from the encoder, on a recent ring as long as the
    prompt (flushed when full): (ids, last logits)."""
    B, P = tokens.shape
    cache = model.init_cache(B, P + new, enc_len=enc.shape[1], recent_size=P,
                             device=tokens.device)
    with torch.no_grad():
        enc_out = model._run_encoder(params, enc)
        for li in range(model.cfg.n_layers):
            k, v = model._encoder_kv({n: t[li] for n, t in params["decoder"]["xattn"].items()},
                                     enc_out)
            cache["layers"]["cross"][0][li], cache["layers"]["cross"][1][li] = k, v
        tok, pos, ids = tokens, torch.arange(P, device=tokens.device).expand(B, P), []
        for t in range(new):
            logits, cache = model.decode_step(params, {"tokens": tok, "positions": pos}, cache)
            if cache["len_rec"] == cache["layers"]["self"]["recent"][0].shape[2]:
                cache = model.flush_cache(cache)
            tok = logits.argmax(-1)[:, None]
            ids.append(tok)
            pos = torch.full((B, 1), P + t, device=tokens.device)
    return torch.cat(ids, 1).cpu(), logits


@pytest.mark.cuda
def test_encdec_smoke_on_the_card_matches_cpu(cuda):
    """The smoke encdec model through the flash kernel (``pallas``, f32:
    ``tf32x3``) on the card against the CPU (the kernel's plain version),
    same weights: ``prefill_logits`` within 1e-4 of their scale, with one
    flash launch an encoder layer and two a decoder layer; greedy ids over
    the cross cache equal."""
    cfg, tree, tokens, enc = _encdec_smoke()
    model = LM(cfg, attn_impl="pallas", remat=None)
    out = {}
    for dev in ("cuda", "cpu"):
        params = tree_map(lambda t: t.to(dev), tree)
        batch = {"tokens": tokens.to(dev), "enc_embeds": enc.to(dev),
                 "positions": torch.arange(6, device=dev).expand(2, 6)}
        kernels.reset_launches()
        with torch.no_grad():
            logits = model.prefill_logits(params, batch)
        want = cfg.enc_layers + 2 * cfg.n_layers if dev == "cuda" else 0
        assert kernels.launches["flash_attention"] == kernels.launches[
            "flash_attention:tf32x3"] == want
        ids, _ = _encdec_greedy(model, params, tokens.to(dev), enc.to(dev))
        out[dev] = (logits.cpu(), ids)
    scale = max(1.0, out["cpu"][0].abs().max().item())
    assert (out["cuda"][0] - out["cpu"][0]).abs().max().item() < 1e-4 * scale
    assert torch.equal(out["cuda"][1], out["cpu"][1])


class _Products(TorchDispatchMode):
    """Counts the unbatched matrix products a region runs (``mm``, ``addmm``,
    a ``bmm`` with an operand broadcast over its batch)."""

    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in ("mm", "addmm") or (name == "bmm" and 0 in (args[0].stride(0),
                                                               args[1].stride(0))):
            self.mm += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.cuda
def test_encdec_remat_dots_on_the_card(cuda):
    """``remat="dots"`` on the card at a moderate shape (seamless_m4t_medium
    at full width cut to 2 encoder and 2 decoder layers, bf16, 4 x 512
    tokens over 512 frames, chunked attention): gradients equal to
    ``remat=None``'s (within 1e-6 of each leaf's largest), the backward
    recomputing no unbatched product, and a lower peak than without remat."""
    cfg = dataclasses.replace(get_config("seamless_m4t_medium"), n_layers=2, enc_layers=2)
    params = LM(cfg).init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    batch = make_batch(cfg, RunShape("t", 512, 4, "train"), seed=0)
    flat, tdef = flatten(params)
    res = {}
    for remat in (None, "dots"):
        model = LM(cfg, attn_impl="chunked", remat=remat)
        lv = [p.detach().requires_grad_(True) for p in flat]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        counter = _Products()
        loss = model.train_loss(unflatten(tdef, lv), batch)
        with counter:
            grads = torch.autograd.grad(loss, lv)
        torch.cuda.synchronize()
        res[remat] = (grads, counter.mm, torch.cuda.max_memory_allocated() - base)
        del loss
    (g0, mm0, peak0), (g1, mm1, peak1) = res[None], res["dots"]
    for a, b in zip(g0, g1):
        assert (a.float() - b.float()).abs().max().item() <= 1e-6 * max(
            a.float().abs().max().item(), 1e-3)
    assert mm1 == mm0 > 0
    assert peak1 < peak0, (peak1, peak0)


# -- the GEMV offload model and the evaluation runners on the card ------------

def _gemv_placements(shapes, seed=3, prealloc_huge=32):
    from repro_torch.core.allocators import PhysicalMemory
    from repro_torch.core.dram import AddressMap
    from repro_torch.trace import gemv

    out = {}
    for al in gemv.ALLOCATORS:
        amap = AddressMap()
        out[al] = (amap, gemv.build_placement(shapes, al, PhysicalMemory(amap, seed=seed),
                                              prealloc_huge=prealloc_huge))
    return out


def _gemv_check(shapes, placements, seed):
    """Every matrix's partitioned product on the card bit-equal to one whole
    ``torch.mv`` on the card and to the CPU's partitioned product."""
    from repro_torch.trace import gemv

    rng = np.random.default_rng(seed)
    for name, (n_out, d_in) in shapes.items():
        w = rng.integers(-8, 8, size=(n_out, d_in)).astype(np.float32)
        x = rng.integers(-8, 8, size=(d_in,)).astype(np.float32)
        wc, xc = torch.from_numpy(w).cuda(), torch.from_numpy(x).cuda()
        for al, (amap, placement) in placements.items():
            y = gemv.gemv_execute(wc, xc, *placement[name], amap)
            assert y.is_cuda and y.dtype == torch.float32
            assert torch.equal(y, torch.mv(wc, xc)), (al, name)
            assert np.array_equal(y.cpu().numpy(),
                                  gemv.gemv_execute(w, x, *placement[name], amap)), (al, name)


@pytest.mark.cuda
def test_gemv_execute_on_the_card_is_bit_exact_at_smoke_shapes(cuda):
    from repro_torch.trace import gemv

    shapes = gemv.weight_shapes(get_config("stablelm_1_6b").smoke())
    picked = {n: shapes[n] for n in ("L0/attn/wq", "L1/mlp/w_out", "lm_head")}
    _gemv_check(picked, _gemv_placements(shapes), seed=7)


@pytest.mark.cuda
def test_gemv_execute_on_the_card_is_bit_exact_at_one_full_width_matrix(cuda):
    """Full-width stablelm_1_6b's ``w_out`` (2048 x 5632, 46 MB f32) placed
    alone with each allocator, PUMA's pool holding it and its accumulator."""
    from repro_torch.core.allocators import HUGE_PAGE

    shapes = {"L0/mlp/w_out": (2048, 5632)}
    n_huge = -(-2 * 2048 * 5632 * 4 // HUGE_PAGE)
    _gemv_check(shapes, _gemv_placements(shapes, prealloc_huge=n_huge), seed=8)


def _load_bench(name):
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "benchmarks" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["torch_trace_bench", "torch_chaos_bench"])
def test_gemv_runner_records_on_the_card_equal_the_cpu(cuda, name):
    bench, records = _load_bench(name), _load_bench("torch_records")

    def records_on(device):
        out = bench.bench(smoke=True, device=device)
        return out[0] if isinstance(out, tuple) else out

    assert records.differing(records_on("cuda"), records_on("cpu"), bench.WALL_CLOCK) == []


@pytest.mark.cuda
def test_a_deleted_graphed_serve_frees_its_memory_without_a_cycle_collection(cuda):
    """A graphed serve of the smoke stablelm_1_6b with watermark compaction
    holds its model, params, pool and graphs in no reference cycle: with
    the cycle collector off, deleting the engine, the model and the params
    returns ``memory_allocated`` to where it started (cuBLAS's per-stream
    workspaces, which each capture's new streams add, cleared both times)."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    start = torch.cuda.memory_allocated()
    gc.disable()
    try:
        model, params = _dense_smoke("bfloat16")
        cfg = model.cfg
        pool_cfg = KVPoolConfig(
            num_blocks=64, block_size=8, kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
            n_layers=cfg.n_layers, max_seqs=4, max_blocks_per_seq=16, blocks_per_arena=16,
            dtype="bfloat16")
        maint = MaintenanceConfig(free_low=0.9, frag_high=0.05, contig_low=0.999,
                                  max_moves=64, every=2)
        eng = ServeEngine(model, params, pool_cfg, device="cuda", jit=True, maintenance=maint)
        rng = np.random.default_rng(11)
        for rid in range(6):
            eng.submit(Request(rid=rid, prompt=rng.integers(0, cfg.vocab_size,
                                                            int(rng.integers(3, 40))).tolist(),
                               max_new=int(rng.integers(2, 12))))
        while eng.step():
            pass
        assert len(eng.done) == 6 and model._cuda_graphs.captures > 0
        assert torch.cuda.memory_allocated() > start
        del eng, model, params
        torch.cuda.synchronize()
        torch._C._cuda_clearCublasWorkspaces()
        assert torch.cuda.memory_allocated() == start
    finally:
        gc.enable()
