"""Deterministic serving-traffic generation + open-loop scenario runner.

PUMA's figure of merit — the fraction of work executable in-DRAM under
allocator-controlled placement — has to hold up under *realistic serving
traffic*, not just synthetic churn (PiDRAM's lesson: end-to-end PuM claims
are only as good as the workloads that drive them).  This module is the
workload side of that argument:

* **Arrival processes** (:class:`ArrivalSpec`) — steady (fixed-rate),
  Poisson (exponential inter-arrival), and bursty (geometric-gap request
  clusters), all seeded and integer-stepped so a fixed seed reproduces the
  exact same request stream byte-for-byte.
* **Traffic classes** (:class:`TenantSpec`) — per-tenant prompt/decode
  length distributions, deadlines, and early-cancellation rates.
  :func:`tenant_from_arch` derives a tenant's shape deterministically from
  a config-registry architecture (bigger models → longer prompts/decodes),
  so multi-tenant mixes are "drawn from the registry" rather than invented
  per-benchmark.  Prompt lengths come from small *discrete bucket sets*:
  every distinct prefill length is a fresh XLA trace, so bounded buckets
  keep thousand-request scenarios tractable on the CPU smoke model.
* **Scenarios** (:class:`Scenario`, :func:`build_scenario`) — the named,
  fixed-seed scenario registry the serving benchmark and CI gate share:
  ``steady``, ``bursty``, ``long_context``, ``multi_tenant``,
  ``cancel_heavy``.
* **Open-loop runner** (:func:`play`) — submits each request at its
  arrival tick (arrivals do not wait for the engine — open-loop, so queue
  delay is *measured*, not hidden), fires client cancellations on
  schedule, samples occupancy/queue depth per step through
  ``ServeEngine.step_hooks``, drains, and folds everything into one
  JSON-friendly metrics record (:func:`summarize`).

Throughput is reported against the deterministic :class:`SimCost` serving-
time model (wall clock is not reproducible; the benchmark gate wants
byte-identical reruns).  Wall-clock numbers stay on stdout only.

Conservation contract (the property tests' anchor): after a drained run,
``submitted == done + rejected + cancelled`` — the engine never silently
drops a generated request, whatever the scenario does to it.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.robustness import RequestRejected
from repro_torch.serve.engine import Request, ServeEngine

__all__ = [
    "ArrivalSpec",
    "TenantSpec",
    "RequestSpec",
    "Scenario",
    "SimCost",
    "SCENARIO_NAMES",
    "tenant_from_arch",
    "build_scenario",
    "play",
    "summarize",
]


# ---------------------------------------------------------------------------
# arrival processes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ArrivalSpec:
    """When requests show up, in engine-clock ticks.

    ``rate`` is mean requests per tick for ``steady``/``poisson``;
    ``bursty`` emits clusters of ``burst_size`` at one tick separated by
    ~``burst_gap``-tick geometric gaps (an on/off source: idle, then a
    thundering herd — the worst case for admission and pool pressure).
    """

    kind: str = "steady"            # steady | poisson | bursty
    rate: float = 0.5
    burst_size: int = 8
    burst_gap: float = 24.0

    def arrivals(self, rng: np.random.Generator, n: int) -> List[int]:
        """``n`` non-decreasing integer arrival ticks (deterministic in
        ``rng`` state — callers pass a freshly seeded generator)."""
        if n <= 0:
            return []
        if self.kind == "steady":
            return [int(i / self.rate) for i in range(n)]
        if self.kind == "poisson":
            gaps = rng.exponential(1.0 / self.rate, size=n)
            return [int(t) for t in np.floor(np.cumsum(gaps))]
        if self.kind == "bursty":
            out: List[int] = []
            t = 0
            while len(out) < n:
                out.extend([t] * min(self.burst_size, n - len(out)))
                t += 1 + int(rng.exponential(self.burst_gap))
            return out
        raise ValueError(f"unknown arrival kind {self.kind!r}")


# ---------------------------------------------------------------------------
# traffic classes (tenants)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One traffic class: who is sending and what their requests look like.

    ``prompt_lens``/``max_new_lens`` are discrete bucket sets sampled
    uniformly (bounded XLA shape variety — see module docstring).
    ``cancel_rate`` is the probability a request is withdrawn by the client
    ``cancel_window`` ticks after submission; ``deadline_steps`` attaches
    the engine-enforced QoS deadline.
    """

    name: str
    weight: float = 1.0
    prompt_lens: Tuple[int, ...] = (8, 12, 16)
    max_new_lens: Tuple[int, ...] = (3, 4)
    deadline_steps: Optional[int] = None
    cancel_rate: float = 0.0
    cancel_window: Tuple[int, int] = (2, 12)   # inclusive tick range


def tenant_from_arch(
    name: str,
    *,
    weight: float = 1.0,
    cap_tokens: int = 64,
    deadline_steps: Optional[int] = None,
    cancel_rate: float = 0.0,
) -> TenantSpec:
    """Derive a tenant's traffic shape from a config-registry architecture.

    The mapping is deterministic and monotone in model size: the decimal
    magnitude of the *full* (non-smoke) parameter count sets a scale class,
    and prompt/decode bucket lengths grow with it (a 34B-class tenant sends
    ~3x the context of a 1.6B-class one).  ``cap_tokens`` clamps prompts so
    every request stays admissible on the benchmark pool.
    """
    from repro_torch.configs.registry import get_config

    cfg = get_config(name)
    scale = 1 + min(3, max(0, int(math.log10(max(cfg.n_params(), 10))) - 9))
    lens = sorted({min(cap_tokens, 4 * scale * k) for k in (1, 2, 3)})
    max_new = (3, 4) if scale < 2 else (4, 6)
    return TenantSpec(
        name=name,
        weight=weight,
        prompt_lens=tuple(lens),
        max_new_lens=max_new,
        deadline_steps=deadline_steps,
        cancel_rate=cancel_rate,
    )


# ---------------------------------------------------------------------------
# request streams / scenarios
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RequestSpec:
    """One fully materialized request of a generated stream."""

    rid: int
    arrive_step: int
    tenant: str
    prompt: Tuple[int, ...]
    max_new: int
    deadline_steps: Optional[int] = None
    cancel_after: Optional[int] = None     # ticks after submission

    def to_request(self) -> Request:
        return Request(
            rid=self.rid,
            prompt=list(self.prompt),
            max_new=self.max_new,
            deadline_steps=self.deadline_steps,
            tenant=self.tenant,
        )


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named, seeded traffic scenario: arrival process x tenant mix.

    ``pool`` carries the KV-pool overrides the benchmark applies when it
    builds the engine for this scenario (e.g. ``n_channels=2`` for the
    multi-tenant mix), so a scenario is self-describing end to end.
    """

    name: str
    seed: int
    arrival: ArrivalSpec
    tenants: Tuple[TenantSpec, ...]
    n_requests: int
    vocab: int = 64
    max_steps: int = 20_000
    pool: Tuple[Tuple[str, int], ...] = ()
    description: str = ""

    def pool_overrides(self) -> Dict[str, int]:
        return dict(self.pool)

    def generate(self) -> List[RequestSpec]:
        """Materialize the stream — same seed, same bytes, every time."""
        rng = np.random.default_rng(self.seed)
        arrive = self.arrival.arrivals(rng, self.n_requests)
        weights = np.asarray([t.weight for t in self.tenants], float)
        weights = weights / weights.sum()
        specs: List[RequestSpec] = []
        for rid, at in enumerate(arrive):
            tn = self.tenants[int(rng.choice(len(self.tenants), p=weights))]
            plen = int(tn.prompt_lens[int(rng.integers(len(tn.prompt_lens)))])
            max_new = int(tn.max_new_lens[int(rng.integers(len(tn.max_new_lens)))])
            prompt = tuple(int(x) for x in rng.integers(0, self.vocab, plen))
            cancel_after = None
            if tn.cancel_rate > 0.0 and rng.random() < tn.cancel_rate:
                lo, hi = tn.cancel_window
                cancel_after = int(rng.integers(lo, hi + 1))
            specs.append(RequestSpec(
                rid=rid, arrive_step=at, tenant=tn.name, prompt=prompt,
                max_new=max_new, deadline_steps=tn.deadline_steps,
                cancel_after=cancel_after,
            ))
        return specs


#: the registry the serving benchmark, its CI gate, and the tests share.
SCENARIO_NAMES: Tuple[str, ...] = (
    "steady", "bursty", "long_context", "multi_tenant", "cancel_heavy",
)


def build_scenario(name: str, *, smoke: bool = False) -> Scenario:
    """The fixed-seed scenario registry (``--smoke`` shrinks request counts
    for CI; seeds and distribution shapes stay identical)."""
    n = 36 if smoke else 400
    interactive = TenantSpec("interactive", prompt_lens=(8, 12, 16),
                             max_new_lens=(3, 4))
    if name == "steady":
        return Scenario(
            name=name, seed=901, n_requests=n,
            arrival=ArrivalSpec("steady", rate=0.5),
            tenants=(interactive,),
            pool=(("num_blocks", 32), ("max_seqs", 4)),
            description="closed-form baseline: one request every 2 ticks",
        )
    if name == "bursty":
        return Scenario(
            name=name, seed=902, n_requests=n,
            arrival=ArrivalSpec("bursty", burst_size=8, burst_gap=24.0),
            tenants=(TenantSpec("bursty", prompt_lens=(8, 12, 16),
                                max_new_lens=(6, 8)),),
            # half the steady pool, 6 decode lanes: a full burst admits more
            # sequences than the pool can grow, so decode-time extends
            # collide -> preemption + recompute-on-resume under load
            pool=(("num_blocks", 16), ("max_seqs", 6),
                  ("blocks_per_arena", 8)),
            description="thundering herds: 8-request bursts, ~24-tick gaps, "
                        "half-size pool (queueing + preemption pressure)",
        )
    if name == "long_context":
        return Scenario(
            name=name, seed=903, n_requests=max(8, (2 * n) // 3),
            arrival=ArrivalSpec("poisson", rate=1.0),
            tenants=(TenantSpec("long_context", prompt_lens=(24, 32, 40),
                                max_new_lens=(3, 4)),),
            # 4 live seqs want up to ~24 blocks: decode-time extends collide
            pool=(("num_blocks", 24), ("max_seqs", 4),
                  ("blocks_per_arena", 8)),
            description="prompt-heavy Poisson traffic near the block ceiling",
        )
    if name == "multi_tenant":
        return Scenario(
            name=name, seed=904, n_requests=n,
            arrival=ArrivalSpec("poisson", rate=0.5),
            tenants=(
                tenant_from_arch("stablelm_1_6b", weight=3.0, cap_tokens=40),
                tenant_from_arch("chatglm3_6b", weight=2.0, cap_tokens=40),
                tenant_from_arch("granite_34b", weight=1.0, cap_tokens=40,
                                 deadline_steps=160),
            ),
            pool=(("num_blocks", 48), ("max_seqs", 4), ("n_channels", 2),
                  ("blocks_per_arena", 8)),
            description="registry-derived mix on a 2-channel striped pool",
        )
    if name == "cancel_heavy":
        return Scenario(
            name=name, seed=905, n_requests=n,
            arrival=ArrivalSpec("poisson", rate=0.6),
            tenants=(
                TenantSpec("impatient", weight=2.0, prompt_lens=(8, 12, 16),
                           max_new_lens=(6, 8), cancel_rate=0.45,
                           cancel_window=(1, 4)),
                TenantSpec("deadline", weight=1.0, prompt_lens=(8, 16),
                           max_new_lens=(6, 8), deadline_steps=6),
            ),
            pool=(("num_blocks", 32), ("max_seqs", 4)),
            description="45% client cancellations + tight engine deadlines",
        )
    raise ValueError(
        f"unknown scenario {name!r} (have {', '.join(SCENARIO_NAMES)})"
    )


# ---------------------------------------------------------------------------
# deterministic serving-time model
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SimCost:
    """Serving-time model: fixed per-step overhead, linear per-token decode
    and prefill costs, plus the engine's priced maintenance passes.  Purely
    a function of deterministic engine counters, so tokens/s derived from
    it is byte-reproducible (unlike wall clock)."""

    step_overhead_ns: float = 2_000.0
    decode_token_ns: float = 500.0
    prefill_token_ns: float = 150.0

    def total_ns(self, eng: ServeEngine) -> float:
        return (
            self.step_overhead_ns * eng.clock
            + self.decode_token_ns * eng.tokens_decoded
            + self.prefill_token_ns * eng.tokens_prefilled
            + eng.maintenance_ns
        )


# ---------------------------------------------------------------------------
# open-loop runner
# ---------------------------------------------------------------------------

def _pct(vals: Sequence[float], q: float) -> Optional[float]:
    return round(float(np.percentile(vals, q)), 4) if vals else None


def play(
    eng: ServeEngine,
    specs: Sequence[RequestSpec],
    *,
    max_steps: int = 20_000,
    sample_every: int = 1,
    cost: SimCost = SimCost(),
) -> Dict[str, object]:
    """Drive ``specs`` through ``eng`` open-loop and return the scenario
    metrics record (see :func:`summarize`).

    Arrivals are submitted the moment the engine clock reaches their tick
    — never gated on engine readiness — and client cancellations fire on
    their own schedule.  Submission-time rejections (never-admissible
    requests) are caught and stay in the engine's ledger.  After the last
    arrival the engine is drained, so the conservation identity holds on
    the returned record.
    """
    pending = deque(sorted(specs, key=lambda s: (s.arrive_step, s.rid)))
    cancels: List[Tuple[int, int]] = []    # (due_tick, rid) min-heap
    samples: List[Dict[str, float]] = []

    def sampler(_eng: ServeEngine, sample: Dict[str, float]) -> None:
        if int(sample["clock"]) % sample_every == 0:
            samples.append(sample)

    eng.step_hooks.append(sampler)
    try:
        for _ in range(max_steps):
            while pending and pending[0].arrive_step <= eng.clock:
                spec = pending.popleft()
                try:
                    eng.submit(spec.to_request())
                except RequestRejected:
                    pass                   # recorded in eng.rejected
                else:
                    if spec.cancel_after is not None:
                        heapq.heappush(
                            cancels, (eng.clock + spec.cancel_after, spec.rid)
                        )
            while cancels and cancels[0][0] <= eng.clock:
                _, rid = heapq.heappop(cancels)
                eng.cancel(rid)            # no-op if already finished
            alive = eng.step()
            if not alive and not pending and not cancels:
                break
    finally:
        eng.step_hooks.remove(sampler)
    return summarize(eng, specs, samples, cost)


def summarize(
    eng: ServeEngine,
    specs: Sequence[RequestSpec],
    samples: Sequence[Dict[str, float]],
    cost: SimCost = SimCost(),
) -> Dict[str, object]:
    """Fold a finished run into the scenario metrics record: the ledger,
    sim-time throughput, queue/completion latency percentiles (in engine
    ticks), pool-occupancy stats, and the paper's contiguity analogue."""
    finished = list(eng.done) + list(eng.rejected) + list(eng.cancelled)
    queue_waits = [
        float(r.admit_clock - r.submit_clock)
        for r in finished if r.admit_clock >= 0
    ]
    completions = [
        float(r.finish_clock - r.submit_clock)
        for r in eng.done if r.finish_clock >= 0
    ]
    tenants = sorted({s.tenant for s in specs})
    per_tenant = {
        t: sum(1 for r in eng.done if r.tenant == t) for t in tenants
    }
    occ = [s["used_fraction"] for s in samples]
    depth = [s["queued"] for s in samples]
    batch = [s["live"] for s in samples]
    # contiguity/balance only mean something while sequences are live (a
    # drained pool trivially reports 1.0) — average over the loaded steps.
    loaded = [s for s in samples if s["live"] > 0]
    contig = [s["contiguity"] for s in loaded]
    balance = [s["channel_balance"] for s in loaded]
    dpt = [s["descriptors_per_tile"] for s in loaded]
    met = eng.metrics()
    sim_ns = cost.total_ns(eng)
    sim_s = sim_ns / 1e9
    return {
        "n": len(specs),
        "submitted": eng.submitted,
        "done": len(eng.done),
        "rejected": len(eng.rejected),
        "cancelled": len(eng.cancelled),
        "preemptions": eng.preemptions,
        "conservation_ok": (
            eng.submitted
            == len(eng.done) + len(eng.rejected) + len(eng.cancelled)
            and not eng.queue and not eng.live
        ),
        "tokens": eng.tokens_decoded,
        "tokens_prefilled": eng.tokens_prefilled,
        "clock": eng.clock,
        "sim_ns": round(sim_ns, 3),
        "tokens_per_s": round(eng.tokens_decoded / sim_s, 3) if sim_s else 0.0,
        "p50_queue_steps": _pct(queue_waits, 50),
        "p99_queue_steps": _pct(queue_waits, 99),
        "p50_complete_steps": _pct(completions, 50),
        "p99_complete_steps": _pct(completions, 99),
        "occupancy_mean": round(float(np.mean(occ)), 4) if occ else 0.0,
        "occupancy_peak": round(float(np.max(occ)), 4) if occ else 0.0,
        "queue_depth_peak": int(max(depth)) if depth else 0,
        "batch_mean": round(float(np.mean(batch)), 4) if batch else 0.0,
        "contiguity": round(float(np.mean(contig)), 4) if contig else 1.0,
        "contiguity_min": round(float(np.min(contig)), 4) if contig else 1.0,
        "descriptors_per_tile": round(float(np.mean(dpt)), 4) if dpt else 0.0,
        "channel_balance": round(float(np.mean(balance)), 4) if balance else 1.0,
        "channels": int(met["channels"]),
        "frag_end": round(met["frag"], 4),
        "injected_misses": int(met["injected_misses"]),
        "compaction_passes": int(met["compaction_passes"]),
        "blocks_migrated": int(met["blocks_migrated"]),
        "maintenance_ns": round(met["maintenance_ns"], 3),
        "done_by_tenant": per_tenant,
    }
