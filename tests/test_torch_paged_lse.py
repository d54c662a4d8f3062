"""The paged-attention wrapper's log-sum-exp output (``return_lse=True``)
against the reference runner's ``_paged_lse``, on the CPU.

The port's decode step takes the past log-sum-exp from the paged-attention
call itself (the kernel's second output on the card, the plain version's on
the CPU) where the reference recomputes it with a second gather
(``repro.serve.paged_runner._paged_lse``).  Both must give the same numbers:
within 2e-5 of max(1, |lse|), and -inf on both sides for a length-0 row.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.serve.paged_runner import _paged_lse as ref_paged_lse  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pg_ops  # noqa: E402

from test_torch_kernels import PAGED_CASES, _paged_inputs  # noqa: E402

TOL = 2e-5   # of max(1, |lse|): the reference's f32 paged-attention tolerance


def _lse_err(ours: np.ndarray, ref: np.ndarray) -> float:
    """Max error over max(1, |ref|); -inf entries must sit at the same places."""
    inf = np.isneginf(ref)
    assert np.array_equal(np.isneginf(ours), inf)
    if inf.all():
        return 0.0
    ours, ref = ours[~inf], ref[~inf]
    return float((np.abs(ours - ref) / np.maximum(1.0, np.abs(ref))).max())


@pytest.mark.parametrize("case", PAGED_CASES, ids=lambda c: "-".join(map(str, c.values())))
def test_plain_lse_matches_reference_paged_lse(case):
    q, kp, vp, tbl, lens = _paged_inputs(3, **case)
    D = q.shape[-1]
    ref = np.asarray(ref_paged_lse(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(tbl),
                                   jnp.asarray(lens), D ** -0.5))
    before = kernels.launches["paged_attention"]
    out, lse = pg_ops.paged_attention(*[torch.from_numpy(a) for a in (q, kp, vp, tbl, lens)],
                                      return_lse=True)
    assert kernels.launches["paged_attention"] == before   # CPU: plain version
    B, Hq, _ = q.shape
    Hkv = kp.shape[2]
    assert lse.shape == (B, Hkv, Hq // Hkv) and lse.dtype == torch.float32
    assert _lse_err(lse.numpy(), ref) < TOL
    if case.get("zero_len_row"):
        assert np.isneginf(lse.numpy()[0]).all()


@pytest.mark.parametrize("case", PAGED_CASES, ids=lambda c: "-".join(map(str, c.values())))
def test_return_lse_leaves_the_output_unchanged(case):
    args = [torch.from_numpy(a) for a in _paged_inputs(4, **case)]
    out, _ = pg_ops.paged_attention(*args, return_lse=True)
    assert torch.equal(out, pg_ops.paged_attention(*args))


@pytest.mark.parametrize("extra", [0, 5])
def test_plain_lse_over_lengths_past_the_table(extra):
    """Lengths at and past max_blocks * block_size (the kernel clamps them to
    the table) and a stale, non -1 table entry past a row's length."""
    case = dict(B=3, Hq=8, Hkv=2, D=64, nb=32, bs=16, maxb=6)
    q, kp, vp, tbl, lens = _paged_inputs(5, **case)
    lens[0] = case["maxb"] * case["bs"] + extra
    tbl[0] = np.arange(case["maxb"])
    lens[1] = 17
    tbl[1, 2:] = 31                       # stale entries past the length
    ref = np.asarray(ref_paged_lse(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(tbl),
                                   jnp.asarray(lens), 64 ** -0.5))
    _, lse = pg_ops.paged_attention(*[torch.from_numpy(a) for a in (q, kp, vp, tbl, lens)],
                                    return_lse=True)
    assert _lse_err(lse.numpy(), ref) < TOL
