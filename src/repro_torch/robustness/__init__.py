"""Typed failures and seeded fault injection.

:mod:`repro_torch.robustness.errors` and :mod:`repro_torch.robustness.faults`
are dependency-free; the core layers import *them*.  The invariant auditors,
the journal and the compaction engine are not ported yet (ROADMAP.md).
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

__all__ = [
    "PumaError", "PumaAllocError", "PoolExhausted", "HugePageExhausted",
    "BasePageExhausted", "TilePoolExhausted", "DoubleFree",
    "TranslationError", "PudExecError", "RowCloneFault", "RequestRejected",
    "DeadlineExceeded", "ClientCancelled", "EngineStalled", "InvariantViolation",
    "JournalReplayError",
    "FaultPlan", "FaultStats", "FaultInjector",
]
