"""Op-record statistics: collective bytes, op census, HBM traffic, flops.

The reference (``repro/launch/hlo_stats.py``) parses the compiled
per-device HLO text.  The port has no HLO: :class:`OpRecorder`, a
``TorchDispatchMode``, writes an *op record* while a step runs once, and
the functions here read that record.  Each :class:`OpEntry` holds the aten
op, its result and operand shapes and dtypes, and its flops, all on the
local shard: the recorder lets DTensor run first (it returns
``NotImplemented`` for DTensor arguments, as ``CommDebugMode`` does), so it
sees the ops DTensor issues on each rank's ``_local_tensor`` and the
collectives it asks for.  What runs on every rank (replicated work) is
counted on every rank, as XLA's per-device cost analysis counts it.

* ``COLLECTIVES`` -- the reference's kind names.  A ``_c10d_functional``
  collective (or DTensor's ``shard_dim_alltoall``) is mapped onto them
  (all_gather_into_tensor -> all-gather, all_reduce -> all-reduce,
  reduce_scatter_tensor -> reduce-scatter, all_to_all_single and
  shard_dim_alltoall -> all-to-all); its result bytes per device are its
  size.  Its ``wait_tensor`` is not recorded, so each collective counts
  once, as the reference counts ``-start`` and skips ``-done``.  The kind
  is the one DTensor asks for, not what the process group does with it.
* ``collective_stats`` / ``total_collective_bytes`` -- the reference's, over
  the record.
* ``op_census`` -- counts by aten op name (``"mm"``, ``"bmm"``, ...) where
  the reference counts HLO opcodes (``dot``, ``fusion``).
* ``fused_bytes_estimate`` -- the reference's rules (its HLO opcodes mapped
  onto aten ops): products, sorts and concatenations move their result and
  operands; a copy that transposes or gathers a strided view (a ``clone``
  of a non-contiguous tensor) twice its result; gathers twice the result
  plus the indices; scatters twice the updates plus the indices (in
  place); reductions result plus input; elementwise ops and ``copy_`` are
  left out, as the reference assumes they fuse.  XLA's ``fusion`` ops,
  which the reference counts whole, have no counterpart in an eager step.
* ``bytes_accessed`` -- every recorded op's operands and result, unfused:
  what an eager step moves (XLA's ``bytes accessed`` of the unfused
  module).  Views and bare allocations (``empty``) move nothing and are
  not recorded.
* ``flops`` -- ``torch.utils.flop_counter``'s formulas applied to each op's
  local shapes (products and attention), with ops outside its registry
  decomposed as ``FlopCounterMode`` decomposes them; XLA also counts
  elementwise ops, so the port's count is lower.

The recorder also counts live bytes: every storage an op creates is live
until Python frees its last tensor (a weak reference's finalizer), and the
peak of that count is the step's peak memory on the local shard.

Within ``product_sites()`` it also notes, for each op with flops, the line
of model code that issued it (``OpEntry.site``), and ``repeated_products``
sets a sharded step's products beside those of the same step without a
mesh, line by line: which product the ranks repeat.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import re
import sys
import weakref
from collections import Counter
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

__all__ = ["COLLECTIVES", "OpEntry", "OpRecorder", "collective_stats",
           "total_collective_bytes", "op_census", "fused_bytes_estimate",
           "bytes_accessed", "flops", "tensor_bytes", "product_sites", "repeated_products"]

COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

#: collective op name (namespace.packet) -> the reference's kind
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "permute_tensor": "collective-permute",
    "send": "collective-permute",
    "recv": "collective-permute",
}
_COMM_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "c10d_functional",
                    "c10d", "_dtensor")
_ATEN_NAMESPACES = ("aten", "prims")
#: communication bookkeeping that moves no bytes of its own
_COMM_SKIP = ("wait_tensor", "_wrap_tensor_autograd")
#: allocations that write nothing
_ALLOCS = ("empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided")

_PRODUCTS = frozenset((
    "mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv", "dot", "vdot",
    "convolution", "_convolution", "convolution_backward", "_scaled_mm",
    "_scaled_dot_product_flash_attention", "_scaled_dot_product_efficient_attention",
    "_scaled_dot_product_cudnn_attention", "_scaled_dot_product_flash_attention_backward",
    "_scaled_dot_product_efficient_attention_backward",
    "_scaled_dot_product_cudnn_attention_backward",
))
_SORTS = frozenset(("sort", "topk", "cat"))
_GATHERS = frozenset(("index_select", "embedding", "gather", "index", "_unsafe_index",
                      "take"))
_SCATTERS = frozenset((
    "index_put_", "index_put", "_index_put_impl_", "_unsafe_index_put", "index_add_",
    "index_add", "index_copy_", "index_copy", "scatter_", "scatter", "scatter_add_",
    "scatter_add", "scatter_reduce_", "scatter_reduce",
))
_REDUCES = frozenset((
    "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin", "logsumexp", "prod",
    "var", "std", "var_mean", "std_mean", "linalg_vector_norm", "norm", "any", "all",
    "cumsum", "cumprod", "logcumsumexp", "_softmax", "_log_softmax",
    "_softmax_backward_data", "_log_softmax_backward_data",
))

Shape = Tuple[Tuple[int, ...], str]   # (shape, dtype name)


@functools.lru_cache(maxsize=None)
def _dtype_bytes(name: str) -> int:
    return torch.empty((), dtype=getattr(torch, name)).element_size()


def _nbytes(s: Shape) -> int:
    n = 1
    for d in s[0]:
        n *= int(d)
    return n * _dtype_bytes(s[1])


def tensor_bytes(t) -> int:
    """Bytes of one tensor's local shard (a DTensor's ``_local_tensor``)."""
    if isinstance(t, DTensor):
        t = t._local_tensor
    return t.numel() * t.element_size()


@dataclasses.dataclass(frozen=True)
class OpEntry:
    """One op of the record.  ``op`` is ``"namespace.packet.overload"``
    (``"aten.mm.default"``); ``result`` and ``operands`` are (shape, dtype
    name) of each tensor, local to the rank; ``transposes`` marks a copy
    whose input was not contiguous (the reference's ``transpose``);
    ``site``, recorded within ``product_sites()`` for an op with flops: the
    lines of model code that issued it, outermost first, joined by " > "
    (for a backward product, those of the forward op it is the gradient
    of, and " (grad)" after them)."""

    op: str
    result: Tuple[Shape, ...]
    operands: Tuple[Shape, ...] = ()
    flops: int = 0
    transposes: bool = False
    site: str = ""

    @property
    def namespace(self) -> str:
        return self.op.split(".")[0]

    @property
    def name(self) -> str:
        return self.op.split(".")[1]

    @property
    def overload(self) -> str:
        parts = self.op.split(".")
        return parts[2] if len(parts) > 2 else "default"

    @property
    def collective(self):
        """The reference's kind, or None for an op that is no collective."""
        if self.namespace not in _COMM_NAMESPACES:
            return None
        if self.name not in _COLLECTIVE_OPS:
            raise ValueError(f"{self.op}: a collective with no counterpart among {COLLECTIVES}")
        return _COLLECTIVE_OPS[self.name]


def _shapes(tree) -> Tuple[Shape, ...]:
    return tuple((tuple(t.shape), str(t.dtype).split(".")[-1])
                 for t in _pytree.tree_leaves(tree) if isinstance(t, torch.Tensor))


_DETAILED: List[list] = []   # the recorder lists of the open peak_detail()s


@contextlib.contextmanager
def peak_detail():
    """Within it, each new ``OpRecorder`` also keeps the storages live when
    its peak was reached, each with the shape, dtype and op of the tensor
    that made it, and is appended to the list this yields; its
    ``peak_live(n)`` gives the n largest.  How a tensor that every rank
    holds whole shows itself (``scripts/dryrun_vs_reference.py``)."""
    recorders: list = []
    _DETAILED.append(recorders)
    try:
        yield recorders
    finally:
        _DETAILED.pop()


_SITES = [False]   # whether a product_sites() is open
_MODELS = os.sep + os.path.join("repro_torch", "models") + os.sep
_TRACEBACK_LINE = re.compile(r'File "([^"]+)", line (\d+)')


@contextlib.contextmanager
def product_sites():
    """Within it, each ``OpRecorder`` notes the model line of each op with
    flops (``OpEntry.site``).  Autograd keeps the forward's stack on each
    node it makes (anomaly mode, without its NaN checks), so a backward
    product is put down to the forward line it is the gradient of."""
    prev, _SITES[0] = _SITES[0], True
    try:
        with torch.autograd.set_detect_anomaly(True, check_nan=False):
            yield
    finally:
        _SITES[0] = prev


_GRAD = " (grad)"


def _short(path: str, line) -> str:
    return f"{path[path.index(_MODELS) + len(os.sep + 'repro_torch' + os.sep):]}:{line}"


def _site() -> str:
    """The lines of model code on the stack, outermost first, joined by
    " > "; with none there (a backward), those of the forward op whose
    autograd node runs, and "(grad)" after them."""
    chain = []
    f = sys._getframe(2)
    while f is not None:
        if _MODELS in f.f_code.co_filename:
            chain.append(_short(f.f_code.co_filename, f.f_lineno))
        f = f.f_back
    if chain:
        return " > ".join(reversed(chain))
    node = torch._C._current_autograd_node()
    for line in (node.metadata.get("traceback_") if node is not None else None) or ():
        m = _TRACEBACK_LINE.search(line)
        if m and _MODELS in m.group(1):
            chain.append(_short(m.group(1), m.group(2)))
    return " > ".join(chain) + _GRAD if chain else "?"


class OpRecorder(TorchDispatchMode):
    """Records every op on plain (local) meta tensors, a step's abstract
    inputs and what it makes of them, and counts their live bytes.

    ``track(tree)`` counts tensors that exist before the step (its
    arguments) as live.  Made inside ``peak_detail()``, it also keeps the
    storages live when the peak was reached (``peak_live``).  Neither
    recorded nor counted: the ops DTensor's sharding propagation runs on
    fake tensors, and those whose results lie on another device (DTensor's
    bookkeeping of rank maps and offsets on the host, which it caches, so
    that the first step of a process would count more than the next)."""

    def __init__(self):
        super().__init__()
        self.record: List[OpEntry] = []
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: Dict[int, int] = {}
        self._read: set = set()
        self._what: Optional[Dict[int, tuple]] = None
        if _DETAILED:
            _DETAILED[-1].append(self)
            self._what, self._at_peak = {}, {}

    # -- live bytes -----------------------------------------------------------
    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def _alloc(self, t: torch.Tensor, op: str = "argument") -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        if self._what is not None:
            self._what[key] = (tuple(t.shape), str(t.dtype).split(".")[-1], op)
            if self.live_bytes > self.peak_bytes:
                self._at_peak = {k: (b,) + self._what[k] for k, b in self._live.items()}
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def peak_live(self, n: int) -> List[tuple]:
        """The ``n`` largest storages live at the peak: (bytes, shape, dtype,
        op), largest first (a recorder made inside ``peak_detail()``)."""
        return sorted(self._at_peak.values(), key=lambda e: -e[0])[:n]

    def track(self, tree) -> None:
        for t in _pytree.tree_leaves(tree):
            if isinstance(t, DTensor):
                t = t._local_tensor
            if isinstance(t, torch.Tensor):
                self._alloc(t)

    def was_read(self, t) -> bool:
        """Whether some op took ``t``'s storage (a DTensor's local one) as an
        operand: a step argument no op takes is one ``jax.jit`` prunes."""
        if isinstance(t, DTensor):
            t = t._local_tensor
        return id(t.untyped_storage()) in self._read

    # -- dispatch ---------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented   # let DTensor issue its local ops
        if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None:
            return func(*args, **kwargs)   # DTensor's shape propagation
        if func not in flop_registry and not isinstance(func, torch._ops.HigherOrderOperator):
            # FlopCounterMode's rule, so that the two count the same ops
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        operands = [a for a in _pytree.tree_leaves((args, kwargs)) if isinstance(a, torch.Tensor)]
        self._read.update(id(a.untyped_storage()) for a in operands)
        out = func(*args, **kwargs)
        outs = [t for t in _pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor) and t.device.type == "meta"]
        ns, name = func.namespace, func._overloadpacket.__name__
        for t in outs:
            self._alloc(t, f"{ns}.{name}")
        if (not outs or func.is_view or name in _ALLOCS
                or (ns in _COMM_NAMESPACES and name in _COMM_SKIP)):
            return out
        fl = 0
        if func._overloadpacket in flop_registry:
            fl = int(flop_registry[func._overloadpacket](*args, **kwargs, out_val=out))
        transposes = name == "clone" and not operands[0].is_contiguous()
        self.record.append(OpEntry(f"{ns}.{name}.{func._overloadname}", _shapes(outs),
                                   _shapes(operands), fl, transposes,
                                   _site() if fl and _SITES[0] else ""))
        return out


# -- reading a record ----------------------------------------------------------------

def collective_stats(record: Iterable[OpEntry]) -> Dict[str, Dict[str, float]]:
    """Per collective kind: {count, bytes} (result bytes, per device)."""
    out: Dict[str, Dict[str, float]] = {k: {"count": 0, "bytes": 0} for k in COLLECTIVES}
    for e in record:
        kind = e.collective
        if kind is None:
            continue
        out[kind]["count"] += 1
        out[kind]["bytes"] += sum(_nbytes(s) for s in e.result)
    return out


def total_collective_bytes(record: Iterable[OpEntry]) -> float:
    return sum(v["bytes"] for v in collective_stats(record).values())


def op_census(record: Iterable[OpEntry], ops: Sequence[str] = ("mm", "bmm", "addmm")) -> Counter:
    c: Counter = Counter({op: 0 for op in ops})
    for e in record:
        if e.name in c:
            c[e.name] += 1
    return c


def _moves(e: OpEntry) -> bool:
    return e.namespace not in _COMM_NAMESPACES


def fused_bytes_estimate(record: Iterable[OpEntry]) -> float:
    """Fusion-aware HBM-traffic estimate (the reference's rules; see the
    module docstring).  An op outside aten's namespace (a custom kernel) is
    the reference's ``custom-call``: result plus operands."""
    total = 0.0
    for e in record:
        if not _moves(e) or not e.result:
            continue
        res = sum(_nbytes(s) for s in e.result)
        ops_ = [_nbytes(s) for s in e.operands]
        name = e.name
        if e.namespace not in _ATEN_NAMESPACES or name in _PRODUCTS or name in _SORTS:
            total += res + sum(ops_)
        elif name == "clone":
            if e.transposes:
                total += 2 * res
        elif name == "embedding_dense_backward":
            total += 2 * ops_[0] + ops_[1]   # a scatter-add of the gradient rows
        elif name in _GATHERS:
            total += 2 * res + sum(ops_[1:])
        elif name in _SCATTERS:
            total += 2 * ops_[-1] + sum(ops_[1:-1])
        elif name in _REDUCES and not (name in ("max", "min") and e.overload == "other"):
            total += res + (ops_[0] if ops_ else 0)
    return float(total)


def bytes_accessed(record: Iterable[OpEntry]) -> float:
    """Every recorded op's operands and result, unfused (collectives apart)."""
    return float(sum(sum(_nbytes(s) for s in e.result + e.operands)
                     for e in record if _moves(e)))


def flops(record: Iterable[OpEntry]) -> float:
    return float(sum(e.flops for e in record))


def _expansion(local: Tuple[Shape, ...], whole: Tuple[Shape, ...]):
    """How many times ``whole``'s operands hold ``local``'s (each dim a
    multiple), or None where they cannot be shards of them."""
    if len(local) != len(whole):
        return None
    n = 1
    for (ls, ld), (ws, wd) in zip(local, whole):
        if ld != wd or len(ls) != len(ws) or any(w % max(l, 1) for l, w in zip(ls, ws)):
            return None
        for l, w in zip(ls, ws):
            n *= w // max(l, 1)
    return n


def _shared_lines(a: str, b: str) -> int:
    """How many lines of model code two sites share from the outermost
    (-1 where one is a backward and the other not)."""
    if a.endswith(_GRAD) != b.endswith(_GRAD):
        return -1
    n = 0
    for x, y in zip(a.removesuffix(_GRAD).split(" > "), b.removesuffix(_GRAD).split(" > ")):
        if x != y:
            break
        n += 1
    return n


def repeated_products(record: Iterable[OpEntry], whole: Iterable[OpEntry], ranks: int,
                      n: int) -> List[Dict[str, Any]]:
    """The ``n`` largest groups of a sharded step's products by ``ranks`` x
    their flops, a group being the ops of one (site, op, local operands),
    each beside the matching group of the same step without a mesh
    (``whole``): the one whose site shares the most lines of model code with
    the group's (a sharded path may reach the product through a
    ``shard_map`` of its own), then of the same op, then whose operands the
    local ones are shards of the fewest times over.  ``ratio`` is ``ranks``
    x the group's flops over the matching group's; ``site_ratio`` the same
    over all the groups of the two sites (DTensor may run one product as
    ``mm`` in one layer and ``bmm`` in another).  1 where the ranks do the
    product once between them.  Both records are made within
    ``product_sites()``."""
    def groups(rec):
        out: Dict[tuple, list] = {}
        for e in rec:
            if e.flops:
                g = out.setdefault((e.site, e.op, e.operands), [0, 0])
                g[0] += 1
                g[1] += e.flops
        return out

    def site_flops(gs):
        out: Dict[str, int] = {}
        for (site, _, _), (_, fl) in gs.items():
            out[site] = out.get(site, 0) + fl
        return out

    mine, theirs = groups(record), groups(whole)
    mine_sites, their_sites = site_flops(mine), site_flops(theirs)
    rows = []
    for (site, op, operands), (count, fl) in mine.items():
        fits = [(-_shared_lines(site, k[0]), k[1] != op, x if x is not None else float("inf"), k)
                for k in theirs for x in (_expansion(operands, k[2]),)]
        match = min(fits)[3] if fits else None
        rows.append({"site": site, "op": op, "operands": operands, "count": count,
                     "ranks_flops": ranks * fl,
                     "whole_site": match and match[0], "whole_op": match and match[1],
                     "whole_operands": match and match[2],
                     "whole_flops": theirs[match][1] if match else None,
                     "ratio": ranks * fl / theirs[match][1] if match else None,
                     "site_ratio": (ranks * mine_sites[site] / their_sites[match[0]]
                                    if match else None)})
    return sorted(rows, key=lambda r: -r["ranks_flops"])[:n]
