"""repro_torch.trace — the trace recorder and replay executor.

* :mod:`repro_torch.trace.record` — a versioned, seed-deterministic recorder
  that hooks :class:`~repro_torch.serve.engine.ServeEngine`,
  :class:`~repro_torch.core.kv_pool.PagedKVPool` and
  :class:`~repro_torch.core.controller.DramController` and emits a
  per-channel op trace as JSONL with a pinned schema.
* :mod:`repro_torch.trace.replay` — a replay executor that re-prices a trace
  through :mod:`repro_torch.core.pud` + :mod:`repro_torch.core.controller`
  bit-exactly, independent of the live engine.

:mod:`repro_torch.trace.gemv` is the Tracegen-style GEMV/MoE offload
model: it places every decode weight matrix with each of the four
allocators, prices the decode matvec stream as PUD ``mac`` ops, and
computes the partitioned product ``W @ x`` with ``torch.mv`` on the
weight's device.  :mod:`repro_torch.trace.serve_trace` glues the recorder
onto the fixed-seed serving scenarios.  The recorder, replay and the
offload model's pricing are numpy host code, the reference's with imports
re-pointed.
"""
from repro_torch.trace import gemv
from repro_torch.trace.record import SCHEMA_VERSION, TraceRecorder, TraceSchemaError
from repro_torch.trace.replay import ReplayResult, parse_trace, replay_trace

__all__ = [
    "gemv",
    "SCHEMA_VERSION",
    "TraceRecorder",
    "TraceSchemaError",
    "ReplayResult",
    "parse_trace",
    "replay_trace",
]
