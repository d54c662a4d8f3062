"""The reduction of a profiled stretch (``torch.profiler``) to numbers.

* ``busy_s``: the union of the intervals in which a kernel, copy or memset
  ran on the device; ``window_s`` the stretch's length on the host clock.
* ``device_s``: each device operation's summed time, by full name.
* ``idle_by_span``: the device's idle gaps inside the stretch, each put to
  the innermost harness span (``portbench.*``, see ``serve.py``) that was
  open on the host at the gap's midpoint, summed by span.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Sequence, Tuple

import torch

from portbench.serve import SPAN

#: the harness's spans from the innermost out; a gap in none is "harness"
SPAN_ORDER = ("kv_write", "graph_replay", "prefill", "batch", "train_step", "step")


def merge(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sorted, disjoint union of ``(start, end)`` intervals."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def gaps(busy: Sequence[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The parts of [lo, hi] that no interval of ``busy`` (merged) covers."""
    out, t = [], lo
    for a, b in busy:
        if b <= lo or a >= hi:
            continue
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if t < hi:
        out.append((t, hi))
    return out


class _Spans:
    """Non-overlapping host spans of one name, searchable by time."""

    def __init__(self, spans: List[Tuple[float, float]]):
        self.spans = sorted(spans)
        self.starts = [a for a, _ in self.spans]

    def holds(self, t: float) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and self.spans[i][1] >= t


def label_gaps(idle: Sequence[Tuple[float, float]],
               host: Dict[str, List[Tuple[float, float]]]) -> Dict[str, float]:
    """Seconds of ``idle`` (us intervals) by the innermost host span open at
    each gap's midpoint."""
    found = {name: _Spans(host.get(name, [])) for name in SPAN_ORDER}
    out: Dict[str, float] = {}
    for a, b in idle:
        mid = (a + b) / 2
        name = next((n for n in SPAN_ORDER if found[n].holds(mid)), "harness")
        out[name] = out.get(name, 0.0) + (b - a) / 1e6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def summarize(prof, stretch_s: float, steps: int, paged_lens: List[List[int]]) -> Dict:
    events = prof.events()
    # the device's own operations; the harness's spans also show on the
    # device's timeline, as annotations, and are left out
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.name.startswith(SPAN)]
    host: Dict[str, List[Tuple[float, float]]] = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith(SPAN):
            host.setdefault(e.name[len(SPAN):], []).append(
                (e.time_range.start, e.time_range.end))
    busy = merge([(e.time_range.start, e.time_range.end) for e in device])
    by_name: Dict[str, float] = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e6
    stretch = host.get("stretch", [])
    if stretch:
        lo, hi = stretch[0]
        idle = label_gaps(gaps(busy, lo, hi), host)
    else:
        idle = {}
    return {
        "window_s": stretch_s,
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "device_s": dict(sorted(by_name.items(), key=lambda kv: -kv[1])),
        "idle_by_span": idle,
        "steps": steps,
        "paged_lens": paged_lens,
    }


def breakdown(profile: Dict) -> Dict:
    """The result line's ``breakdown``: the ten device operations that took
    most time, and the idle time by host span, in seconds."""
    return {
        "device_ops": [[name[:120], s] for name, s in list(profile["device_s"].items())[:10]],
        "idle_gaps": [[name, s] for name, s in list(profile["idle_by_span"].items())[:10]],
    }


def idle_share(ctx):
    """The profiled stretch's idle share of the device, in %; None where no
    device operation was traced."""
    p = ctx.obs.profile
    if not p or p["busy_s"] <= 0 or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
