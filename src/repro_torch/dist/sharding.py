"""Logical-axis sharding on DTensor: mesh registry + MaxText-style axis rules.

Model code names *logical* axes ("batch", "embed", "kv_seq", ...); this
module maps them onto whatever mesh is active.  Everything degrades to a
no-op when no mesh is set — ``constraint`` returns its input itself — so the
single-card path (serving, its CUDA graphs, the card's phases) runs the
exact same model code as a sharded train step.

Key pieces:

* ``set_mesh``/``use_mesh``/``get_mesh`` — a process-global active mesh, a
  ``torch.distributed.device_mesh.DeviceMesh`` with ``mesh_dim_names``
  (``use_mesh`` is the scoped context-manager form).
* ``PARAM_RULES``/``ACT_RULES`` — mutable logical->mesh-axis dictionaries
  (parameter axes vs activation axes).  ``override_rules`` /
  ``override_param_rules`` scope an update and restore on exit.
* :class:`P` — the port's ``PartitionSpec``: one entry per tensor dim,
  ``None``, a mesh axis name, or a tuple of names (one dim sharded over
  several mesh dims, in mesh order).
* ``logical_spec(*names)`` — a spec for the active mesh, with the "pod"
  data-parallel axis prepended to the batch entry on multi-pod meshes.
* ``filter_spec(spec, shape, mesh)`` — divisibility filter: any entry whose
  mesh-axis product does not evenly divide its dim is dropped to ``None``,
  so no placement is ever uneven; short specs are padded with ``None``.
* :class:`Sharding` — ``(mesh, spec)``, the ``NamedSharding`` counterpart;
  its ``placements`` are ``Shard(d)`` on each mesh dim that spec entry d
  names, else ``Replicate()``.
* ``shardings_for`` / ``axes_to_shardings`` — tree helpers producing
  ``Sharding`` trees for parameter specs and logical-axis-name trees;
  ``device_put`` distributes a tree of tensors by such a tree.
* ``region_mesh`` -- the guard of every ``shard_map`` region of the model
  code: the mesh to run it on, or None, where the plain path runs.
* ``shard_map`` and the differentiable collectives ``all_gather``,
  ``psum``, ``psum_scatter`` and ``pmean`` — a local function over
  ``to_local()`` shards, rebuilt with ``DTensor.from_local``;
  ``axis_index`` / ``axis_size``, the rank's place along a mesh axis inside
  it; ``spec_of``, the spec a DTensor is placed by.
* ``spmd()`` — the context the model runs in under a mesh: plain tensors
  (masks, positions, scalars) take part in DTensor ops as replicated.

Nothing here starts a process group; the mesh's builder does
(``launch/mesh.py``).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import tree as pytree

__all__ = [
    "PARAM_RULES",
    "ACT_RULES",
    "P",
    "Sharding",
    "shard_map",
    "region_mesh",
    "all_gather",
    "psum",
    "psum_scatter",
    "pmean",
    "axis_index",
    "axis_size",
    "get_mesh",
    "set_mesh",
    "use_mesh",
    "spmd",
    "axis_names",
    "mesh_sizes",
    "logical_spec",
    "filter_spec",
    "placements_for",
    "spec_of",
    "constraint",
    "shardings_for",
    "axes_to_shardings",
    "device_put",
    "flatten",
    "unflatten",
    "gather_dim",
    "override_rules",
    "override_param_rules",
]


class P(tuple):
    """A partition spec: ``P("data", None)``, ``P(("pod", "data"))``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


#: logical parameter axis -> mesh axis (or tuple of axes, or None=replicated).
#: "embed" carries FSDP ("data"); the tensor-parallel dims ride "model".
PARAM_RULES: Dict[str, Any] = {
    "embed": "data",
    "embed_tp": None,
    "mlp": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "vocab": "model",
    "experts": None,
    "state": None,
    "conv": None,
    "layers": None,
}

#: logical activation axis -> mesh axis.
ACT_RULES: Dict[str, Any] = {
    "batch": "data",
    "seq": None,
    "seq_res": None,
    "kv_seq": "model",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "vocab": "model",
}

_ACTIVE_MESH = None


def get_mesh():
    """The active mesh, or None (=> every helper becomes a passthrough)."""
    return _ACTIVE_MESH


def set_mesh(mesh) -> None:
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


@contextlib.contextmanager
def use_mesh(mesh):
    """Scoped ``set_mesh``: restores the previous mesh on exit."""
    global _ACTIVE_MESH
    prev, _ACTIVE_MESH = _ACTIVE_MESH, mesh
    try:
        yield mesh
    finally:
        _ACTIVE_MESH = prev


_SPMD_DEPTH = 0


@contextlib.contextmanager
def spmd():
    """Under a mesh, let plain tensors join DTensor ops as replicated (the
    masks, positions and schedule scalars the model builds locally); no-op
    without one.  Nests: only the outermost entry switches the mode (DTensor's
    ``implicit_replication`` turns it off on any exit)."""
    global _SPMD_DEPTH
    if get_mesh() is None or _SPMD_DEPTH:
        yield
        return
    _SPMD_DEPTH += 1
    try:
        with implicit_replication():
            yield
    finally:
        _SPMD_DEPTH -= 1


def axis_names(mesh) -> Tuple[str, ...]:
    """The mesh's axis names (a ``DeviceMesh``'s ``mesh_dim_names``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def mesh_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def _rule_entry(name: Optional[str], mesh, rules: Dict[str, Any]) -> Any:
    """Resolve one logical axis name to a spec entry under ``mesh``."""
    if name is None:
        return None
    rule = rules.get(name)
    if rule is None:
        return None
    axes: Tuple[str, ...] = rule if isinstance(rule, tuple) else (rule,)
    if name == "batch" and mesh is not None and "pod" in axis_names(mesh) and "pod" not in axes:
        # multi-pod meshes carry pure data parallelism on the leading "pod"
        # axis; batch entries absorb it transparently.
        axes = ("pod",) + axes
    if mesh is not None:
        axes = tuple(a for a in axes if a in axis_names(mesh))
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def logical_spec(*names: Optional[str]) -> P:
    """Partition spec for logical activation axes under the active mesh."""
    mesh = get_mesh()
    return P(*[_rule_entry(n, mesh, ACT_RULES) for n in names])


def filter_spec(spec, shape: Tuple[int, ...], mesh) -> P:
    """Drop spec entries that do not evenly divide the tensor shape."""
    sizes = mesh_sizes(mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        if all(a in sizes for a in axes):
            prod = 1
            for a in axes:
                prod *= sizes[a]
            if prod and dim % prod == 0:
                out.append(entry)
                continue
        out.append(None)
    return P(*out)


def placements_for(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each mesh
    dim that entry d names, ``Replicate()`` on the others.  An entry that
    names several mesh dims must list them in mesh order (DTensor splits a
    dim over mesh dims outermost first)."""
    names = axis_names(mesh)
    owner: Dict[str, int] = {}
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec entry {entry} is not in the mesh's order {names}")
        for a in axes:
            if a in owner:
                raise ValueError(f"mesh axis {a!r} shards two dims of {spec}")
            owner[a] = dim
    return tuple(Shard(owner[n]) if n in owner else Replicate() for n in names)


def spec_of(x: DTensor) -> P:
    """The spec a DTensor is placed by (``placements_for``'s inverse; a
    partial sum counts as replicated)."""
    names = axis_names(x.device_mesh)
    entries = [[] for _ in range(x.dim())]
    for n, pl in zip(names, x.placements):
        if pl.is_shard():
            entries[pl.dim % x.dim()].append(n)
    return P(*(None if not e else e[0] if len(e) == 1 else tuple(e) for e in entries))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """``NamedSharding``'s counterpart: a mesh and a partition spec."""

    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        return placements_for(self.spec, self.mesh)


def constraint(x, *names: Optional[str]):
    """Redistribute a DTensor by logical axis names (the reference's
    ``with_sharding_constraint``); ``x`` itself with no mesh active or for a
    plain tensor (the single-card path)."""
    mesh = get_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    spec = filter_spec(logical_spec(*names), x.shape, mesh)
    return x.redistribute(mesh, placements_for(spec, mesh))


def _map_specs(fn, specs, tree):
    if isinstance(specs, P):
        return fn(specs, tree)
    return {k: _map_specs(fn, specs[k], tree[k]) for k in specs}


def shardings_for(specs: Any, abs_tree: Any, mesh) -> Any:
    """Spec tree (e.g. from ``spec_tree``) -> ``Sharding`` tree,
    divisibility-filtered against the matching tensors' shapes."""
    return _map_specs(lambda s, a: Sharding(mesh, filter_spec(s, tuple(a.shape), mesh)),
                      specs, abs_tree)


def _is_axes_leaf(x) -> bool:
    # a leaf is a per-dim tuple of logical axis names, e.g. (None, "batch",
    # "kv_seq", None, None) — or () for scalar leaves.  Containers (dicts,
    # NamedTuples of such tuples) keep getting traversed.
    return x is None or (type(x) is tuple and all(e is None or isinstance(e, str) for e in x))


def _axes_leaves(node) -> list:
    if _is_axes_leaf(node):
        return [node]
    if isinstance(node, dict):
        return [leaf for k in sorted(node) for leaf in _axes_leaves(node[k])]
    return [leaf for child in node for leaf in _axes_leaves(child)]


def axes_to_shardings(axes: Any, abs_tree: Any, mesh) -> Any:
    """Tree of logical-axis-name tuples -> tree of ``Sharding`` (a leaf
    without a shape, such as a cache length, is a scalar)."""
    abs_leaves, treedef = pytree.flatten(abs_tree)
    axes_leaves = _axes_leaves(axes)
    if len(axes_leaves) != len(abs_leaves):
        raise ValueError(f"{len(axes_leaves)} axes leaves for {len(abs_leaves)} tensors")
    out = []
    for ax, a in zip(axes_leaves, abs_leaves):
        spec = P(*[_rule_entry(n, mesh, ACT_RULES) for n in (ax or ())])
        out.append(Sharding(mesh, filter_spec(spec, tuple(getattr(a, "shape", ())), mesh)))
    return pytree.unflatten(treedef, out)


def device_put(tree: Any, shardings: Any) -> Any:
    """Each tensor of ``tree`` distributed by the matching ``Sharding`` (every
    rank holds the same whole tensor; it keeps its own shard)."""
    return pytree.tree_map(lambda t, s: distribute_tensor(t, s.mesh, s.placements), tree, shardings)


def gather_dim(x: torch.Tensor, dim: int) -> torch.Tensor:
    """A DTensor with ``dim`` whole on every rank (its other placements
    kept); ``x`` itself for a plain tensor."""
    if not isinstance(x, DTensor):
        return x
    dim %= x.dim()
    return x.redistribute(x.device_mesh, [Replicate() if pl.is_shard(dim) else pl
                                          for pl in x.placements])


def _unflatten(x: DTensor, dim: int, sizes) -> DTensor:
    n = 1
    for i, pl in enumerate(x.placements):
        if pl.is_shard(dim):
            n *= x.device_mesh.size(i)
    return (x if sizes[0] % n == 0 else gather_dim(x, dim)).unflatten(dim, sizes)


def _flatten(x: DTensor, start: int, end: int) -> DTensor:
    for d in range(start + 1, end + 1):
        x = gather_dim(x, d)
    return x.flatten(start, end)


class _Flatten(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, start, end):
        ctx.start, ctx.sizes = start, tuple(x.shape[start:end + 1])
        return _flatten(x, start, end)

    @staticmethod
    def backward(ctx, g):
        return _unflatten(g, ctx.start, ctx.sizes), None, None


class _Unflatten(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, sizes):
        ctx.dim, ctx.n = dim, len(sizes)
        return _unflatten(x, dim, sizes)

    @staticmethod
    def backward(ctx, g):
        return _flatten(g, ctx.dim, ctx.dim + ctx.n - 1), None, None


def flatten(x: torch.Tensor, start: int, end: int) -> torch.Tensor:
    """``x.flatten(start, end)``; for a DTensor the layout views accept,
    both ways (see ``unflatten``)."""
    if not isinstance(x, DTensor):
        return x.flatten(start, end)
    return _Flatten.apply(x, start % x.dim(), end % x.dim())


def unflatten(x: torch.Tensor, dim: int, sizes) -> torch.Tensor:
    """``x.unflatten(dim, sizes)``.  DTensor splits a sharded dim only where
    its shards fall on ``sizes[0]``'s boundaries, and merges dims only where
    the inner ones are whole (GSPMD reshards where they are not): a DTensor
    is gathered along such a dim first, in the forward and in the backward
    alike."""
    if not isinstance(x, DTensor):
        return x.unflatten(dim, sizes)
    return _Unflatten.apply(x, dim % x.dim(), tuple(sizes))


# -- shard_map and its collectives ----------------------------------------------

def _group(axis):
    """The process group of the active mesh's ``axis`` (a name), or ``axis``
    itself (a process group)."""
    return get_mesh().get_group(axis) if isinstance(axis, str) else axis


def _wait(t: torch.Tensor) -> torch.Tensor:
    return funcol.wait_tensor(t) if isinstance(t, funcol.AsyncCollectiveTensor) else t


class _AllGather(torch.autograd.Function):
    """Tiled all-gather along ``dim``; its gradient is the reduce-scatter
    (the transpose JAX takes)."""

    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return _wait(funcol.all_gather_tensor(x.contiguous(), dim, _group(axis)))

    @staticmethod
    def backward(ctx, g):
        return _wait(funcol.reduce_scatter_tensor(g.contiguous(), "sum", ctx.dim,
                                                  _group(ctx.axis))), None, None


class _PSum(torch.autograd.Function):
    """All-reduce (sum).  The cotangent of the sum is the same on every rank,
    so each addend's gradient is that cotangent: the backward is the
    identity."""

    @staticmethod
    def forward(ctx, x, axis):
        return _wait(funcol.all_reduce(x.contiguous(), "sum", _group(axis)))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReduceScatter(torch.autograd.Function):
    """Reduce-scatter (sum) along ``dim``; its gradient is the all-gather."""

    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return _wait(funcol.reduce_scatter_tensor(x.contiguous(), "sum", dim, _group(axis)))

    @staticmethod
    def backward(ctx, g):
        return _wait(funcol.all_gather_tensor(g.contiguous(), ctx.dim,
                                              _group(ctx.axis))), None, None


def _axes(axis) -> tuple:
    return axis if isinstance(axis, tuple) else (axis,)


def all_gather(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """``jax.lax.all_gather(x, axis, axis=dim, tiled=True)`` inside a
    ``shard_map`` local function (several axes: the last one first)."""
    for a in reversed(_axes(axis)):
        x = _AllGather.apply(x, dim, a)
    return x


def psum(x: torch.Tensor, axis) -> torch.Tensor:
    """``jax.lax.psum`` over a mesh axis (or several, or a process group)."""
    for a in _axes(axis):
        x = _PSum.apply(x, a)
    return x


def psum_scatter(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """``jax.lax.psum_scatter(x, axis, scatter_dimension=dim, tiled=True)``
    inside a ``shard_map`` local function (several axes: the first one
    first, so that ``dim`` ends split over them in that order)."""
    for a in _axes(axis):
        x = _ReduceScatter.apply(x, dim, a)
    return x


def pmean(x: torch.Tensor, axis) -> torch.Tensor:
    """``jax.lax.pmean`` over a mesh axis (or several)."""
    sizes = mesh_sizes(get_mesh())
    for a in _axes(axis):
        x = _PSum.apply(x, a) / sizes[a]
    return x


def axis_size(axis) -> int:
    """``jax.lax.axis_size``: ranks along a mesh axis (or several) of the
    active mesh."""
    sizes = mesh_sizes(get_mesh())
    n = 1
    for a in _axes(axis):
        n *= sizes[a]
    return n


def axis_index(axis) -> int:
    """``jax.lax.axis_index`` inside a ``shard_map`` local function: which
    of ``axis``'s shards this rank holds (several axes: outermost first, as
    DTensor splits a dim over them)."""
    mesh, sizes = get_mesh(), mesh_sizes(get_mesh())
    idx = 0
    for a in _axes(axis):
        idx = idx * sizes[a] + mesh.get_local_rank(a)
    return idx


def region_mesh(*xs):
    """The mesh a ``shard_map`` region of the model code runs on: the active
    mesh where one of ``xs`` is a DTensor (given none, wherever a mesh is
    active), else None, and the caller runs its plain path, bit for bit the
    path without a mesh."""
    mesh = get_mesh()
    if mesh is None or (xs and not any(isinstance(x, DTensor) for x in xs)):
        return None
    return mesh


def shard_map(f, *, mesh, in_specs, out_specs, splits=()):
    """Run ``f`` on each rank's local shards and rebuild DTensors.

    Each input is redistributed to its spec and taken ``to_local()``; a
    plain tensor counts as replicated.  A mesh dim along which some input is
    sharded splits the work: there each rank's local function adds its own
    contribution, so a replicated input's gradient is the sum over the
    ranks (a partial sum, as the transpose of a replicated ``shard_map``
    input sums them).  Along a mesh dim that shards no input every rank
    computes the same, so the gradient is each rank's own.  An input's
    gradient is that spec's shard where the input is sharded.  (A local
    function that reassembles a sharded input whole, as an all-gather does,
    must not also take a replicated input along the same dim: it would be
    counted once a rank.)  ``splits`` names axes along which ``f`` splits
    the work itself, each rank taking its part of a replicated input by
    ``axis_index``: there too the gradients are summed.  ``f`` returns one
    tensor or a tuple, matched by ``out_specs``."""
    split = {a for e in (*(e for spec in in_specs for e in spec), *splits) if e is not None
             for a in _axes(e)}
    names = axis_names(mesh)

    def to_local(x, spec):
        pl = placements_for(spec, mesh)
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, mesh, [Replicate()] * len(pl), run_check=False)
        grad = tuple(p if p.is_shard() else Partial() if n in split else Replicate()
                     for p, n in zip(pl, names))
        return x.redistribute(mesh, pl).to_local(grad_placements=grad)

    def run(*args):
        local = [to_local(a, s) for a, s in zip(args, in_specs, strict=True)]
        outs = f(*local)
        single = isinstance(out_specs, P)
        res = tuple(DTensor.from_local(o, mesh, placements_for(s, mesh), run_check=False)
                    for o, s in zip((outs,) if single else outs,
                                    (out_specs,) if single else out_specs, strict=True))
        return res[0] if single else res

    return run


@contextlib.contextmanager
def override_rules(**updates):
    """Scoped ACT_RULES update (e.g. a shape-specific kv_seq placement)."""
    saved = dict(ACT_RULES)
    ACT_RULES.update(updates)
    try:
        yield
    finally:
        ACT_RULES.clear()
        ACT_RULES.update(saved)


@contextlib.contextmanager
def override_param_rules(**updates):
    """Scoped PARAM_RULES update (e.g. inference flips embed -> None)."""
    saved = dict(PARAM_RULES)
    PARAM_RULES.update(updates)
    try:
        yield
    finally:
        PARAM_RULES.clear()
        PARAM_RULES.update(saved)
