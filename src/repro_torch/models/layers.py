"""Shared building blocks: norms, MLPs, embeddings."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import sharding as shd
from repro_torch.models.params import ParamDef

# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def norm_defs(cfg: ModelConfig, d: int | None = None) -> Dict:
    d = d or cfg.d_model
    if cfg.norm == "layernorm":
        return {
            "scale": ParamDef((d,), ("embed_tp",), init="ones", f32=True),
            "bias": ParamDef((d,), ("embed_tp",), init="zeros", f32=True),
        }
    return {"scale": ParamDef((d,), ("embed_tp",), init="ones", f32=True)}


def apply_norm(p: Dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm (with "bias") or RMSNorm over the last dim, in f32, cast back
    to x's dtype: ``(x - mean) * rsqrt(var + eps) * scale + bias``, or
    ``x * rsqrt(mean(x^2) + eps) * scale`` (:class:`_Norm`).  Under a mesh
    on each rank's batch shard inside ``shard_map``: DTensor would resolve
    the backward's partial sums where its rules choose (gathering the batch
    and repeating the next products on every rank)."""
    params = (p["scale"],) + ((p["bias"],) if "bias" in p else ())

    def local(x, scale, bias=None):
        return _Norm.apply(x, scale, bias, eps)

    mesh = shd.region_mesh(x)
    if mesh is None:
        return local(x, *params)
    batch = shd.filter_spec(shd.logical_spec("batch"), x.shape[:1], mesh)[0]
    spec = shd.P(batch, *(None,) * (x.dim() - 1))
    return shd.shard_map(local, mesh=mesh, in_specs=(spec,) + (shd.P(None),) * len(params),
                         out_specs=spec)(x, *params)


#: the f32 temporaries of the norm's and the vocab-parallel loss's row loops
#: hold at most this many bytes (a chunk of rows at a time)
CHUNK_BYTES = 1 << 26


def _row_chunks(rows: torch.Tensor):
    """Slices of the first dim of a (rows, width) tensor, each at most
    ``CHUNK_BYTES`` of f32."""
    n, width = rows.shape
    step = max(1, CHUNK_BYTES // (4 * width))
    return [slice(r, r + step) for r in range(0, n, step)]


def _f32_copy(x: torch.Tensor) -> torch.Tensor:
    """``x.float()`` as a tensor of its own, to be worked in place."""
    xf = x.float()
    return xf.clone() if xf is x else xf


class _Norm(torch.autograd.Function):
    """The norm's formula op for op, a chunk of rows at a time
    (``CHUNK_BYTES``), each on its f32 copy worked in place; the backward
    keeps x in its own dtype, the f32 mean and reciprocal RMS (..., 1) and
    the scale, and recomputes x-hat from them, a chunk at a time."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        d = x.shape[-1]
        rows = x.reshape(-1, d)
        out = x.new_empty(x.shape)
        out_rows = out.view(-1, d)
        # the row statistics in the type of the f32 copies
        rstd = rows.new_empty((rows.shape[0], 1), dtype=rows[:0].float().dtype)
        mu = None if bias is None else torch.empty_like(rstd)
        for c in _row_chunks(rows):
            xf = _f32_copy(rows[c])
            if bias is not None:
                m = xf.mean(-1, keepdim=True)
                xf.sub_(m)
                rs = torch.rsqrt((xf ** 2).mean(-1, keepdim=True) + eps)
                mu[c] = m
            else:
                rs = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
            rstd[c] = rs
            xf.mul_(rs).mul_(scale)
            if bias is not None:
                xf.add_(bias)
            out_rows[c] = xf
        lead = x.shape[:-1] + (1,)
        ctx.save_for_backward(x, None if mu is None else mu.view(lead), rstd.view(lead), scale)
        return out

    @staticmethod
    def backward(ctx, g):
        x, mu, rstd, scale = ctx.saved_tensors
        d = x.shape[-1]
        rows, g = x.reshape(-1, d), g.reshape(-1, d)
        mu = None if mu is None else mu.reshape(-1, 1)
        rstd = rstd.reshape(-1, 1)
        dx = x.new_empty(x.shape)
        dx_rows = dx.view(-1, d)
        dscale = dbias = None
        for c in _row_chunks(rows):
            xhat = _f32_copy(rows[c])
            if mu is not None:
                xhat.sub_(mu[c])
            xhat.mul_(rstd[c])
            gf = _f32_copy(g[c])
            part = (gf * xhat).sum(0)
            dscale = part if dscale is None else dscale.add_(part)
            if mu is not None:
                part = gf.sum(0)
                dbias = part if dbias is None else dbias.add_(part)
            gf.mul_(scale)                                  # the gradient of x-hat
            proj = (gf * xhat).mean(-1, keepdim=True)
            if mu is not None:
                gf.sub_(gf.mean(-1, keepdim=True))
            dx_rows[c] = gf.sub_(xhat.mul_(proj)).mul_(rstd[c])
        return dx, dscale, dbias, None


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------

def _axes(entry) -> tuple:
    """A spec entry's mesh axes: () for None."""
    return () if entry is None else entry if isinstance(entry, tuple) else (entry,)


def column_parallel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``, x (..., d) and w (d, n).  Under a mesh each rank computes
    its slice of the n columns over the tensor-parallel axis ("heads"'
    rule), whether or not w's spec splits them, and the result keeps them
    split: a product whose columns no axis splits ("embed_tp", KV heads
    that do not divide the axis) is otherwise done whole on every rank of
    it.  The rank's slice of w is cut from the rows it holds; the rows are
    reached whichever way moves fewer bytes: the slice gathered over the
    rows' FSDP axis and multiplied by the rank's batch shard (training's
    many rows), or x's d split over that axis and the partial products
    reduce-scattered onto the batch (decode's few).  Inside ``shard_map``
    with explicit collectives; ``x @ w`` without a mesh, on a one-rank axis,
    or where the columns do not divide it."""
    mesh = shd.region_mesh(w)
    tp = shd.logical_spec("heads")[0]
    if (mesh is None or tp is None or shd.axis_size(tp) == 1
            or w.shape[1] % shd.axis_size(tp)):
        return x @ w
    w_spec = shd.spec_of(w)
    x_spec = shd.spec_of(x) if isinstance(x, DTensor) else shd.P(*[None] * x.dim())
    rows_ax, batch = w_spec[0], x_spec[0]
    rows_axes, batch_axes = _axes(rows_ax), _axes(batch)
    if (w_spec[1] not in (None, tp) or any(e is not None for e in x_spec[1:])
            or tp in rows_axes + batch_axes):
        return x @ w
    rest = tuple(a for a in batch_axes if a not in rows_axes)
    n_rest, n_rows = shd.axis_size(rest) if rest else 1, shd.axis_size(rows_ax) if rows_ax else 1
    d, cols = w.shape[0], w.shape[1] // shd.axis_size(tp)
    rows = x.numel() // d // n_rest   # the rows one group of the rows' axis holds
    mid = (None,) * (x.dim() - 2)

    def spec(axes, last=None):
        return shd.P(None if not axes else axes[0] if len(axes) == 1 else axes, *mid, last)

    w_in = shd.P(rows_ax, tp)
    if not rows_axes or (set(rows_axes) <= set(batch_axes)
                         and d * cols <= rows * (d // n_rows + cols)):
        def gathered(xl, wl):
            return xl @ (shd.all_gather(wl, rows_ax, 0) if rows_ax else wl)

        return shd.shard_map(gathered, mesh=mesh, in_specs=(spec(batch_axes), w_in),
                             out_specs=spec(batch_axes, tp))(x, w)
    scatter = x.shape[0] // n_rest % n_rows == 0

    def contracted(xl, wl):
        y = xl @ wl
        return shd.psum_scatter(y, rows_ax, 0) if scatter else shd.psum(y, rows_ax)

    return shd.shard_map(contracted, mesh=mesh, in_specs=(spec(rest, rows_ax), w_in),
                         out_specs=spec(rest + rows_axes if scatter else rest, tp))(x, w)


# ---------------------------------------------------------------------------
# dense MLP
# ---------------------------------------------------------------------------

def mlp_defs(cfg: ModelConfig) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.activation == "swiglu":
        return {
            "wg": ParamDef((d, f), ("embed", "mlp")),
            "wu": ParamDef((d, f), ("embed", "mlp")),
            "wo": ParamDef((f, d), ("mlp", "embed")),
        }
    return {
        "wu": ParamDef((d, f), ("embed", "mlp")),
        "bu": ParamDef((f,), ("mlp",), init="zeros"),
        "wo": ParamDef((f, d), ("mlp", "embed")),
        "bo": ParamDef((d,), ("embed_tp",), init="zeros"),
    }


def apply_mlp(p: Dict, x: torch.Tensor) -> torch.Tensor:
    if "wg" in p:
        h = F.silu(x @ p["wg"]) * (x @ p["wu"])
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ p["wu"] + p["bu"], approximate="tanh")
    out = h @ p["wo"]
    if "bo" in p:
        out = out + p["bo"]
    return out


# ---------------------------------------------------------------------------
# embeddings / logits
# ---------------------------------------------------------------------------

def pad_vocab(cfg: ModelConfig, mult: int = 2048) -> int:
    """Pad the vocab to a multiple of ``mult`` (the reference's layout: the
    logits and the engine's argmax run over the padded vocab)."""
    return -(-cfg.vocab_size // mult) * mult


def embed_defs(cfg: ModelConfig) -> Dict:
    v = pad_vocab(cfg)
    out = {"tok": ParamDef((v, cfg.d_model), ("vocab", "embed"), init="embed", scale=0.02)}
    if not cfg.tie_embeddings:
        out["head"] = ParamDef((cfg.d_model, v), ("embed", "vocab"))
    return out


def _vocab_axis(spec, dim: int):
    """The mesh axis that splits the vocab dim ``dim`` of ``spec``, or None
    where nothing splits it (no divisible spec, or an axis of one rank)."""
    axis = spec[dim]
    return None if axis is None or shd.axis_size(axis) == 1 else axis


def embed_tokens(p: Dict, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    mesh = shd.region_mesh(p["tok"])
    if mesh is None:
        return p["tok"].to(dtype)[tokens]
    # vocab-parallel: each rank holds its vocab slice of the table whole in
    # "embed" (gathered over the FSDP axis only), looks up the tokens that
    # fall in it, zeros for the others, and the slices' rows are summed over
    # the vocab axis.  (DTensor's index over a sharded table, and its
    # backward's index_put, lack sound sharding rules in PyTorch 2.11.)
    batch = shd.filter_spec(shd.logical_spec("batch"), tokens.shape, mesh)[0]
    tok_spec = shd.filter_spec(shd.P(shd.logical_spec("vocab")[0], None), p["tok"].shape, mesh)
    axis = _vocab_axis(tok_spec, 0)

    def local(table, tok):
        table = table.to(dtype)
        if axis is None:
            return table[tok]
        vl = table.shape[0]
        i = tok - shd.axis_index(axis) * vl
        inside = ((i >= 0) & (i < vl))[..., None]
        return shd.psum(torch.where(inside, table[i.clamp(0, vl - 1)], 0), axis)

    return shd.shard_map(local, mesh=mesh, in_specs=(tok_spec, shd.P(batch, None)),
                         out_specs=shd.P(batch, None, None))(p["tok"], tokens)


def logits_from(p: Dict, x: torch.Tensor) -> torch.Tensor:
    if "head" in p:
        return x @ p["head"]
    return x @ p["tok"].T


def token_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-token cross entropy over the last dim, in f32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    return lse - torch.gather(logits, -1, targets.long()[..., None])[..., 0]


class _VocabParallelNLL(torch.autograd.Function):
    """The per-token cross entropy of a rank's vocab slice of the logits
    inside ``shard_map``: the softmax's max gathered over ``axis``, its sum
    and the target's logit summed over it, in f32 on one copy of the slice
    worked in place.  Saved for the backward: the logits in their own
    dtype, the f32 LSE (global), and the rank's target index, clamped, with
    its in-range mask.  The backward is ``g * (softmax - onehot)`` cast to
    the logits' dtype, a chunk of rows at a time (``CHUNK_BYTES``); it
    needs no collective: the LSE is global, and g is the same on every rank
    of the vocab axis."""

    @staticmethod
    def forward(ctx, logits, t, axis):
        lf = _f32_copy(logits)
        vl = lf.shape[-1]
        m = shd.all_gather(lf.amax(-1, keepdim=True), axis, 2).amax(-1)
        i = t.long() - shd.axis_index(axis) * vl
        inside = (i >= 0) & (i < vl)
        i = i.clamp(0, vl - 1)
        ll = torch.gather(lf, -1, i[..., None])[..., 0]
        lse = torch.log(shd.psum(lf.sub_(m[..., None]).exp_().sum(-1), axis)) + m
        del lf
        ctx.save_for_backward(logits, lse, i, inside)
        return lse - shd.psum(torch.where(inside, ll, 0.0), axis)

    @staticmethod
    def backward(ctx, g):
        logits, lse, i, inside = ctx.saved_tensors
        vl = logits.shape[-1]
        rows = logits.reshape(-1, vl)
        out = torch.empty_like(rows)
        lse, i, off, g = (a.reshape(-1, 1) for a in (lse, i, -inside.to(lse.dtype), g))
        for c in _row_chunks(rows):
            p = _f32_copy(rows[c])
            p.sub_(lse[c]).exp_().scatter_add_(-1, i[c], off[c])
            out[c] = p.mul_(g[c])
        return out.view(logits.shape), None, None


def nll_from(p: Dict, x: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """``token_nll(logits_from(p, x), targets)``: (B, S) f32.  Under a mesh
    the head product runs inside the loss, vocab-parallel: each rank
    multiplies its batch shard of x by its vocab slice of the head (whole
    in "embed", gathered over the FSDP axis), and the softmax's max, its
    sum and the target's logit are combined over the vocab axis.  No rank
    holds more logits than its batch shard by its vocab slice, and the
    head's gradient returns as a partial sum over the batch's axis,
    reduce-scattered to the parameter's shard."""
    mesh = shd.region_mesh(x)
    if mesh is None:
        return token_nll(logits_from(p, x), targets)
    vocab = shd.logical_spec("vocab")[0]
    key, vdim = ("head", 1) if "head" in p else ("tok", 0)
    w_spec = shd.filter_spec(shd.P(None, vocab) if vdim else shd.P(vocab, None), p[key].shape,
                             mesh)
    axis = _vocab_axis(w_spec, vdim)
    batch = shd.filter_spec(shd.logical_spec("batch"), x.shape[:1], mesh)[0]

    def local(xl, w, t):
        logits = logits_from({key: w}, xl)
        if axis is None:
            return token_nll(logits, t)
        return _VocabParallelNLL.apply(logits, t, axis)

    return shd.shard_map(local, mesh=mesh,
                         in_specs=(shd.P(batch, None, None), w_spec, shd.P(batch, None)),
                         out_specs=shd.P(batch, None))(x, p[key], targets)
