"""Fault injection, typed failures, invariant auditing, the journal and the
compaction engine.

Import structure: :mod:`repro_torch.robustness.errors` and
:mod:`repro_torch.robustness.faults` are dependency-free (the core layers
import *them*), while ``invariants``, ``journal`` and ``compaction`` inspect
the core pools and therefore import core.  To keep ``repro_torch.core.* ->
repro_torch.robustness.errors`` acyclic, those three load lazily via
``__getattr__``.
"""
from repro_torch.robustness.errors import (  # noqa: F401
    BasePageExhausted,
    ClientCancelled,
    DeadlineExceeded,
    DoubleFree,
    EngineStalled,
    HugePageExhausted,
    InvariantViolation,
    JournalReplayError,
    PoolExhausted,
    PudExecError,
    PumaAllocError,
    PumaError,
    RequestRejected,
    RowCloneFault,
    TilePoolExhausted,
    TranslationError,
)
from repro_torch.robustness.faults import FaultInjector, FaultPlan, FaultStats  # noqa: F401

_LAZY_INVARIANTS = ("InvariantReport", "check_allocator", "check_tile_pool",
                    "check_kv_pool", "check_engine")
_LAZY_JOURNAL = ("Event", "Journal", "snapshot_allocator", "restore_allocator",
                 "snapshot_pool", "restore_pool", "replay_allocator",
                 "replay_pool", "replay_kv_pool", "allocator_digest",
                 "pool_digest", "kv_pool_digest")
_LAZY_COMPACTION = ("Move", "CompactionPlan", "CompactionReport",
                    "plan_allocator_compaction", "compact_allocator",
                    "plan_pool_compaction", "compact_pool")

__all__ = [
    "PumaError", "PumaAllocError", "PoolExhausted", "HugePageExhausted",
    "BasePageExhausted", "TilePoolExhausted", "DoubleFree",
    "TranslationError", "PudExecError", "RowCloneFault", "RequestRejected",
    "DeadlineExceeded", "ClientCancelled", "EngineStalled", "InvariantViolation",
    "JournalReplayError",
    "FaultPlan", "FaultStats", "FaultInjector",
    *_LAZY_INVARIANTS, *_LAZY_JOURNAL, *_LAZY_COMPACTION,
]


def __getattr__(name):
    if name in _LAZY_INVARIANTS:
        from repro_torch.robustness import invariants

        return getattr(invariants, name)
    if name in _LAZY_JOURNAL:
        from repro_torch.robustness import journal

        return getattr(journal, name)
    if name in _LAZY_COMPACTION:
        from repro_torch.robustness import compaction

        return getattr(compaction, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
