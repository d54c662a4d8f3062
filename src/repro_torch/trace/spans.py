"""Spans: the program's time at its layer boundaries, on the host's clock
and, where the work runs on a card, on the device's.

A span is one interval: its name, its start and end from
``time.perf_counter_ns()``, and the span it ran inside (its parent); where
there is one, also the request id (``rid``) or the engine clock
(``clock``), and any attributes the caller sets::

    with spans.span("engine.prefill", device=dev, rid=req.rid) as s:
        s.set(tokens=n)
        ...

Closed spans are kept in memory, in a ring of ``RING`` entries.  Beside
it, per-name totals: the count, the total ns and the self ns (a span's
time minus the part of it its children cover).  Nothing is written to a
file: :func:`summary` gives the totals, :func:`trees` the ring's spans
grouped by the span at their root.

**Parts.**  ``part(name)`` makes a timer for segments of work that a loop
interleaves with other work, such as the engine's token K/V writes between
each slot's bookkeeping: made once, entered once a segment.  It is not a
span of its own: as the span open where the part was made closes, the
segments' ns are added to its attribute ``name`` and covered as a child's,
and the totals count the part once.

**Device time.**  A span given a CUDA ``device`` also records a pair of
timing events on the current stream (none while the stream captures a
graph), taken from a pool.  Nothing waits for them: a pair is read once
both have completed, when :func:`summary` or :func:`trees` is called or
when the ring wraps over its span, and its events go back to the pool
(so a run holds at most two events a device span of the ring).
Its elapsed time is the stretch of the device's timeline between the two
marks, so it holds any wait of the device for the host inside the span.
On the CPU a span's device time is None.

**The profiler's clock.**  While a ``torch.profiler`` profile is active,
each span and part also opens a profiler range under its own name, and
the span is marked ``profiled``.  The range is a host-side record
(``_RecordFunctionFast``): it shows in ``prof.events()`` and the Chrome
trace beside the kernels, and adds no annotation to the device's timeline
that a reader of the device's activity would count as work.  Whether a
profiler is active is read from the profiler's own flag once a span (and
once a part, as it is made), and no range is opened otherwise.  :func:`wall_ns` maps a ring time onto the
wall clock of the profiler's event times (offsets from
``kineto_results.trace_start_ns()``), by an anchor pair taken at start-up
and again at the first span that sees a profiler.

One recorder serves the process (``RECORDER``); it is on from import.
``enable(False)`` turns it off, after which a span costs one branch.
Spans nest by a stack, so record from one thread.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict, List, Optional

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler

__all__ = ["OFF", "RECORDER", "RING", "Recorder", "Span", "enable", "part", "reset", "span",
           "summary", "trees", "wall_ns"]

#: closed spans the ring keeps
RING = 1 << 16

_now = time.perf_counter_ns


class _Totals:
    __slots__ = ("count", "total_ns", "self_ns", "device_count", "device_ns")

    def __init__(self):
        self.count = self.total_ns = self.self_ns = 0
        self.device_count = self.device_ns = 0


class Span:
    """One interval; a context manager that records it on exit."""

    __slots__ = ("id", "name", "parent", "root", "rid", "clock", "attrs", "start", "end",
                 "child_ns", "profiled", "device_ns", "_rec", "_device", "_events", "_stream",
                 "_range", "_parts")

    def __init__(self, rec: "Recorder", name: str, device, rid, clock):
        self._rec = rec
        self.name = name
        self.rid = rid
        self.clock = clock
        self.attrs: Dict[str, object] = {}
        self._device = device is not None and device.type == "cuda"
        self._parts: Optional[List[Part]] = None

    @property
    def self_ns(self) -> int:
        return self.end - self.start - self.child_ns

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        rec = self._rec
        stack = rec.stack
        parent = stack[-1] if stack else None
        self.id = rec.opened
        rec.opened += 1
        self.parent = parent.id if parent is not None else None
        self.root = parent.root if parent is not None else self.id
        self.child_ns = 0
        self.device_ns = None
        self.profiled = _autograd_profiler._is_profiler_enabled
        self._range = None
        if self.profiled:
            if not rec.profiling:
                rec.anchor = (time.time_ns(), _now())
            self._range = _RecordFunctionFast(self.name)
            self._range.__enter__()
        rec.profiling = self.profiled
        stack.append(self)
        self._events = None
        if self._device and not torch.cuda.is_current_stream_capturing():
            # looked up once, and not by torch.cuda.current_stream(), which costs
            # a few times as much
            self._stream = torch.accelerator.current_stream()
            self._events = rec._take_events()
            self._events[0].record(self._stream)
        self.start = _now()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = end = _now()
        rec = self._rec
        if self._events is not None:
            self._events[1].record(self._stream)
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        if self._parts is not None:
            for p in self._parts:
                self.child_ns += p.ns
                self.attrs[p.name] = self.attrs.get(p.name, 0) + p.ns
                t = rec._totals(p.name)
                t.count += 1
                t.total_ns += p.ns
                t.self_ns += p.ns
        stack = rec.stack
        stack.pop()
        dur = end - self.start
        if stack:
            stack[-1].child_ns += dur
        t = rec.totals.get(self.name) or rec._totals(self.name)
        t.count += 1
        t.total_ns += dur
        t.self_ns += dur - self.child_ns
        if self._events is not None:
            rec.unread.append(self)
        i = rec.closed % RING
        old = rec.ring[i]
        if old is not None and rec.unread and rec.unread[0] is old and rec._read(old):
            rec.unread.popleft()            # the ring wraps over a span whose pair completed
        rec.ring[i] = self
        rec.closed += 1
        return False


class Part:
    """A timer of segments for the span open where it was made, which sums
    them as it closes (see the module's notes); one object serves every
    segment, and whether a profiler runs is read once, as it is made."""

    __slots__ = ("name", "ns", "start", "_range")

    def __init__(self, span: Span, name: str):
        self.name = name
        self.ns = 0
        self._range = _RecordFunctionFast(name) if _autograd_profiler._is_profiler_enabled else None
        if span._parts is None:
            span._parts = [self]
        else:
            span._parts.append(self)

    def __enter__(self) -> "Part":
        if self._range is not None:
            self._range.__enter__()
        self.start = _now()
        return self

    def __exit__(self, *exc) -> bool:
        self.ns += _now() - self.start
        if self._range is not None:
            self._range.__exit__(None, None, None)
        return False


class _Off:
    """What :func:`span` and :func:`part` hand out while recording is off."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


#: a span that records nothing, for a phase that has no work
OFF = _Off()


class Recorder:
    """The ring, the per-name totals, the open spans and the event pool."""

    def __init__(self):
        self.on = True
        self.stack: List[Span] = []
        self.events: List[torch.cuda.Event] = []     # the pool of free timing events
        self.reset()
        self.anchor = (time.time_ns(), _now())
        self.profiling = False

    def reset(self) -> None:
        """Forget every closed span and total; open spans close as usual."""
        self.ring: List[Optional[Span]] = [None] * RING
        self.unread: Deque[Span] = deque()  # spans whose event pair is not read, oldest first
        self.totals: Dict[str, _Totals] = {}
        self.opened = 0                 # spans opened: the next span's id
        self.closed = 0                 # spans closed: the next ring slot, mod RING

    def _totals(self, name: str) -> _Totals:
        t = self.totals.get(name)
        if t is None:
            t = self.totals[name] = _Totals()
        return t

    def _take_events(self) -> List[torch.cuda.Event]:
        ev = self.events
        if len(ev) >= 2:
            return [ev.pop(), ev.pop()]
        return [torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)]

    def _read(self, s: Span) -> bool:
        """``s``'s device time, once both of its events have completed."""
        a, b = s._events
        if not (a.query() and b.query()):
            return False
        s.device_ns = round(a.elapsed_time(b) * 1e6)
        t = self._totals(s.name)
        t.device_count += 1
        t.device_ns += s.device_ns
        self.events.extend(s._events)
        s._events = None
        return True

    def collect(self) -> None:
        """Read every event pair that has completed."""
        self.unread = deque(s for s in self.unread if not self._read(s))

    def summary(self) -> Dict[str, Dict[str, object]]:
        """By name: ``count``, ``total_ms``, ``self_ms`` and, for spans
        with device time, ``device_ms`` over ``device_count`` of them (else
        None)."""
        self.collect()
        return {name: {"count": t.count, "total_ms": t.total_ns / 1e6,
                       "self_ms": t.self_ns / 1e6,
                       "device_ms": t.device_ns / 1e6 if t.device_count else None,
                       "device_count": t.device_count}
                for name, t in self.totals.items()}

    def trees(self) -> List[List[Span]]:
        """The ring's spans by root, oldest root first: each list holds the
        root span, then its descendants in the order they closed.  A tree
        whose root is still open, or has left the ring, is left out."""
        self.collect()
        groups: Dict[int, List[Span]] = {}
        for i in range(max(0, self.closed - RING), self.closed):
            s = self.ring[i % RING]
            groups.setdefault(s.root, []).append(s)
        # a root closes after everything under it
        return [[g[-1]] + g[:-1] for root, g in groups.items() if g[-1].id == root]

    def wall_ns(self, perf_ns: int) -> int:
        """A ``perf_counter_ns`` time of the ring as ``time.time_ns``."""
        wall, perf = self.anchor
        return perf_ns - perf + wall


RECORDER = Recorder()


def enable(on: bool = True) -> None:
    """Turn recording on or off (it starts on)."""
    RECORDER.on = bool(on)


def span(name: str, *, device: Optional[torch.device] = None, rid=None, clock=None):
    """A span named ``name``, to open with ``with``; ``device`` (a
    ``torch.device``) a CUDA device for device time as well."""
    if not RECORDER.on:
        return OFF
    return Span(RECORDER, name, device, rid, clock)


def part(name: str):
    """A timer of segments, summed into the attribute ``name`` of the span
    open now as that span closes; enter it with ``with`` once a segment.
    Made outside any span, it records nothing."""
    if not RECORDER.on or not RECORDER.stack:
        return OFF
    return Part(RECORDER.stack[-1], name)


def summary() -> Dict[str, Dict[str, object]]:
    return RECORDER.summary()


def trees() -> List[List[Span]]:
    return RECORDER.trees()


def reset() -> None:
    RECORDER.reset()


def wall_ns(perf_ns: int) -> int:
    return RECORDER.wall_ns(perf_ns)
