"""Typed error taxonomy for the PUMA stack.

PUMA's central behaviour is *graceful degradation*: a misaligned operand
pair falls back to the host CPU instead of failing the operation.  The same
discipline applies to the software stack — every failure an allocator, the
translation layer, the PUD executor, or the serving engine can hit is a
*typed*, catchable condition, never a bare ``ValueError``/``MemoryError``
whose meaning depends on the call site.

The taxonomy is deliberately multiple-inheritance-compatible with the
builtin types the seed code raised, so existing callers (and tests) that
catch ``MemoryError`` or ``ValueError`` keep working:

* :class:`PumaAllocError` **is a** ``MemoryError`` — allocation failures;
  :class:`PoolExhausted` and its leaves distinguish which pool ran dry
  (PUD region pool, huge-page pool, base-page budget, KV tile pool).
* :class:`TranslationError` **is a** ``ValueError`` — VA->PA translation
  on unmapped/out-of-range offsets.
* :class:`PudExecError` **is a** ``RuntimeError`` — an in-DRAM op failed
  mid-flight (injected RowClone fault, blacklisted subarray).
* :class:`RequestRejected` — the serving engine explicitly refused work it
  can never (or no longer) serve; :class:`DeadlineExceeded` is the
  per-request deadline/cancellation leaf.
* :class:`InvariantViolation` **is an** ``AssertionError`` — the invariant
  checker (:mod:`repro_torch.robustness.invariants`) found pool-state corruption
  (extent overlap, double free, leak).

Errors carry structured context via keyword fields (``req``, ``subarray``,
``wanted``/``free``, ...) so chaos benchmarks and stall reports can
aggregate failures without parsing messages.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

__all__ = [
    "PumaError",
    "PumaAllocError",
    "PoolExhausted",
    "HugePageExhausted",
    "BasePageExhausted",
    "TilePoolExhausted",
    "DoubleFree",
    "TranslationError",
    "PudExecError",
    "RowCloneFault",
    "RequestRejected",
    "DeadlineExceeded",
    "ClientCancelled",
    "EngineStalled",
    "InvariantViolation",
    "JournalReplayError",
]


class PumaError(Exception):
    """Root of the PUMA error taxonomy.

    ``ctx`` holds machine-readable context (counts, ids, addresses) so
    reports aggregate failures structurally rather than by message text.
    """

    def __init__(self, message: str = "", **ctx: Any):
        super().__init__(message)
        self.ctx: Dict[str, Any] = ctx

    def __str__(self) -> str:  # message first, context appended when present
        base = super().__str__()
        if not self.ctx:
            return base
        kv = ", ".join(f"{k}={v!r}" for k, v in sorted(self.ctx.items()))
        return f"{base} [{kv}]" if base else f"[{kv}]"


# -- allocation ---------------------------------------------------------------

class PumaAllocError(PumaError, MemoryError):
    """An allocation request could not be satisfied."""


class PoolExhausted(PumaAllocError):
    """A memory pool ran out of capacity (possibly transiently).

    ``injected=True`` marks failures induced by a
    :class:`~repro_torch.robustness.faults.FaultInjector` — the retry/backoff
    fallback chain treats those as transient.
    """

    def __init__(self, message: str = "", *, injected: bool = False, **ctx: Any):
        super().__init__(message, **ctx)
        self.injected = injected


class HugePageExhausted(PoolExhausted):
    """The boot-time huge-page reservation is empty (or injector-denied)."""


class BasePageExhausted(PoolExhausted):
    """The 4 KB base-page free budget is empty — the end of the fallback
    chain; there is no cheaper tier below base pages."""


class TilePoolExhausted(PoolExhausted):
    """The device-side tile/KV-block pool has no free tiles."""


class DoubleFree(PumaError, KeyError):
    """A handle/allocation was freed that is not live (double free or
    foreign pointer) — KeyError-compatible with the seed behaviour."""


# -- translation --------------------------------------------------------------

class TranslationError(PumaError, ValueError):
    """VA->PA translation failed: unmapped offset, out-of-range region, or
    an empty (zero-extent) allocation — ValueError-compatible with the seed
    raises so existing ``pytest.raises(ValueError)`` pins still hold."""


# -- PUD execution ------------------------------------------------------------

class PudExecError(PumaError, RuntimeError):
    """An in-DRAM operation failed to complete in DRAM."""


class RowCloneFault(PudExecError):
    """A RowClone/Ambit row operation faulted mid-flight.  ``permanent=True``
    means the subarray should be blacklisted and its rows remapped."""

    def __init__(self, message: str = "", *, subarray: int = -1,
                 permanent: bool = False, **ctx: Any):
        super().__init__(message, subarray=subarray, **ctx)
        self.subarray = subarray
        self.permanent = permanent


# -- serving ------------------------------------------------------------------

class RequestRejected(PumaError):
    """The serving engine explicitly refused a request (admission control,
    capacity, starvation).  ``rid`` identifies the request."""

    def __init__(self, message: str = "", *, rid: Optional[int] = None, **ctx: Any):
        super().__init__(message, rid=rid, **ctx)
        self.rid = rid


class DeadlineExceeded(RequestRejected):
    """A request's per-request deadline elapsed before completion."""


class ClientCancelled(RequestRejected):
    """The client withdrew the request (``ServeEngine.cancel``) before it
    completed — early cancellation, not an engine-side failure."""


class EngineStalled(PumaError):
    """The engine made no progress: nothing live, nothing admissible, work
    still queued.  Carries the stall report for diagnosis."""

    def __init__(self, message: str = "", *, report: Optional[Dict] = None, **ctx: Any):
        super().__init__(message, **ctx)
        self.report = report or {}


# -- invariants ---------------------------------------------------------------

class InvariantViolation(PumaError, AssertionError):
    """Pool-state corruption detected by the invariant checker."""


class JournalReplayError(PumaError, RuntimeError):
    """A journal event could not be applied during forced replay — the log
    is corrupt (truncated mid-event, tampered payload) or is being replayed
    against a machine with different geometry than the one that wrote it."""
