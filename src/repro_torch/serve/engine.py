"""Continuous-batching serving engine over the PUMA paged KV pool.

Lifecycle per step:

  1. **admit** — pull queued requests while pool blocks + seq slots allow;
     PUMA placement (worst-fit first allocation) assigns prompt blocks.
     Admission scans a bounded *lookahead window* of the queue, so one
     large head-of-line request cannot starve small requests behind it.
  2. **prefill** — teacher-forced pass with a split scratch cache, then the
     per-layer K/V pages are scattered into the pool blocks.
  3. **decode** — one fused step for every live sequence via
     ``paged_decode_step`` (block tables + seq_lens), greedy sampling.
  4. **bookkeeping** — new-token K/V written to the PUMA-chosen block
     (``extend`` keeps arena locality), finished sequences release blocks.

Degraded mode — no request is ever silently dropped: ``submit`` rejects
never-admissible requests with :class:`~repro_torch.robustness.RequestRejected`;
``deadline_steps`` cancels with :class:`~repro_torch.robustness.DeadlineExceeded`;
a failed decode-time ``extend`` preempts the youngest live sequence, which
later recomputes its KV from ``prompt + out[:-1]`` and continues bit-exactly;
a batch that stays empty with a non-empty queue for more than
``stall_patience`` steps rejects the stuck requests with a stall report.

Background maintenance: with a :class:`MaintenanceConfig`, a compaction
pass (:meth:`PagedKVPool.compact`) runs after a step whenever a watermark
trips, rate-limited; its moves go through the block-copy kernel and never
change generation.

The host logic is the reference engine's, line for line, so schedules match.
One departure: an ``mrope`` config (the vlm family) gets (1, S, 3) positions
in prefill and (B, 1, 3) in decode, t = h = w = the token's index, the
layout of the reference's own model tests; the reference engine passes its
2-D positions there too, which its M-RoPE misreads (ROADMAP.md, fault 6).
The model runs on ``device`` (default ``"cuda"``; without a card the caller
must ask for ``"cpu"``).  With ``jit=True`` (the default, as the
reference's) the decode step on the card replays a CUDA graph per batch
size (``paged_decode_step_jit``), cached on the model so that every engine
over the same model and params shares them; ``jit=False``, and every step
on the CPU, runs it eagerly.  Prefill is eager either way: each prompt
length would need a capture of its own.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import TYPE_CHECKING, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.kv_pool import KVPoolConfig, PagedKVPool
from repro_torch.robustness import (
    ClientCancelled,
    DeadlineExceeded,
    EngineStalled,
    RequestRejected,
)
from repro_torch.graphs import graph_cache
from repro_torch.serve.paged_runner import paged_decode_step_jit

if TYPE_CHECKING:
    from repro_torch.robustness.faults import FaultInjector


@dataclasses.dataclass(frozen=True)
class MaintenanceConfig:
    """Watermarks for the background compaction hook in :meth:`ServeEngine.step`.

    A pass triggers when the pool's free-tile fraction falls below
    ``free_low`` *or* its fragmentation rises above ``frag_high`` *or* the
    live block tables' mean contiguous-run fraction falls below
    ``contig_low`` — but at most once every ``every`` engine clock ticks, so
    maintenance cannot monopolise the step loop.  ``max_moves`` bounds one
    pass; the pass cost (RowClone rows + host copies, see
    :func:`repro_torch.core.pud.price_migration`) lands in the engine's
    ``maintenance_ns`` counter.
    """

    free_low: float = 0.25
    frag_high: float = 0.5
    contig_low: float = 0.85
    max_moves: int = 32
    every: int = 4


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    # robustness / QoS fields
    deadline_steps: Optional[int] = None   # engine-clock budget from submit
    status: str = "queued"                 # queued|running|done|rejected|cancelled
    submit_clock: int = 0
    admit_clock: int = -1
    finish_clock: int = -1                 # clock at done/rejected/cancelled
    tenant: Optional[str] = None           # traffic class (loadgen bookkeeping)
    preemptions: int = 0
    error: Optional[Exception] = None

    def ctx_tokens(self) -> int:
        """Tokens whose KV must exist before the next decode step — the
        prompt plus all-but-the-last generated token (the last one is the
        next decode *input*).  This is what a resume-after-preemption
        prefill recomputes."""
        return len(self.prompt) + max(0, len(self.out) - 1)


class ServeEngine:
    def __init__(
        self,
        model,
        params,
        pool_cfg: KVPoolConfig,
        *,
        device="cuda",
        jit: bool = True,           # decode as a CUDA graph per batch size on
                                    # the card (False = eager)
        eos_id: Optional[int] = None,
        injector: Optional["FaultInjector"] = None,
        admission_lookahead: int = 8,
        stall_patience: int = 3,
        maintenance: Optional[MaintenanceConfig] = None,
        trace=None,
    ):
        cfg = model.cfg
        assert pool_cfg.kv_heads == cfg.n_kv_heads and pool_cfg.head_dim == cfg.hd
        assert pool_cfg.n_layers == cfg.n_layers
        self.device = resolve_device(device)
        weights_on = params["embed"]["tok"].device
        if weights_on.type != self.device.type:
            raise ValueError(f"params live on {weights_on}, the engine on {self.device}")
        self.model = model
        self.cfg = cfg
        self.params = params
        self.pool = PagedKVPool(pool_cfg, injector=injector, device=self.device)
        self.jit = jit
        self.graphs = graph_cache(model) if jit else None
        self.eos_id = eos_id
        self.admission_lookahead = max(1, admission_lookahead)
        self.stall_patience = max(1, stall_patience)
        self.queue: Deque[Request] = deque()
        self.live: Dict[int, Request] = {}     # slot -> request
        self.done: List[Request] = []
        self.rejected: List[Request] = []
        self.cancelled: List[Request] = []
        self.steps = 0                          # decode steps (batch advanced)
        self.clock = 0                          # every step() call, incl. stalls
        self.tokens_decoded = 0
        self.tokens_prefilled = 0               # teacher-forced KV-fill tokens
        self.preemptions = 0
        self.submitted = 0
        self._stall_steps = 0
        #: step-level metric hooks: each callable gets ``(engine, sample)``
        #: after every :meth:`step`, where ``sample`` is :meth:`step_sample`.
        self.step_hooks: List = []
        # background maintenance (watermark-triggered compaction)
        self.maintenance = maintenance
        self.maintenance_ns = 0.0
        self.compaction_passes = 0
        self.blocks_migrated = 0
        self._last_maintenance = -(10 ** 9)
        #: trace recorder, shared with the pool (None = no tracing overhead)
        self.trace = trace
        self.pool.trace = trace
        self._step_writes: List = []   # (slot, block) token writes this step

    # -- submission -----------------------------------------------------------
    def submit(self, req: Request) -> None:
        """Queue a request; raises :class:`RequestRejected` immediately if it
        can *never* be admitted (so no work is silently parked forever)."""
        self.submitted += 1
        req.submit_clock = self.clock
        total_blocks = self.pool.blocks_for(len(req.prompt) + req.max_new)
        if not req.prompt:
            err = RequestRejected("empty prompt", rid=req.rid)
        elif total_blocks > self.pool.capacity_blocks:
            err = RequestRejected(
                "request can never be admitted: prompt+max_new exceeds the "
                "per-sequence block ceiling",
                rid=req.rid, blocks_needed=total_blocks,
                capacity_blocks=self.pool.capacity_blocks,
            )
        else:
            self.queue.append(req)
            return
        req.status = "rejected"
        req.error = err
        req.finish_clock = self.clock
        self.rejected.append(req)
        raise err

    def cancel(self, rid: int) -> bool:
        """Client-side early cancellation: drop ``rid`` from the queue or the
        live batch (releasing its KV blocks).  Returns False when the request
        is not in flight."""
        for i, req in enumerate(self.queue):
            if req.rid == rid:
                del self.queue[i]
                self._cancel(req, ClientCancelled(
                    "cancelled by client while queued", rid=rid,
                    waited=self.clock - req.submit_clock,
                ))
                return True
        for slot, req in list(self.live.items()):
            if req.rid == rid:
                del self.live[slot]
                self.pool.release(slot)
                req.slot = None
                self._cancel(req, ClientCancelled(
                    "cancelled by client mid-decode", rid=rid,
                    decoded=len(req.out),
                ))
                return True
        return False

    # -- degraded-mode bookkeeping --------------------------------------------
    def _reject(self, req: Request, err: RequestRejected) -> None:
        req.status = "rejected"
        req.error = err
        req.finish_clock = self.clock
        self.rejected.append(req)

    def _cancel(self, req: Request, err: Exception) -> None:
        req.status = "cancelled"
        req.error = err
        req.finish_clock = self.clock
        self.cancelled.append(req)

    def _sweep_deadlines(self) -> None:
        now = self.clock
        for i in range(len(self.queue) - 1, -1, -1):
            req = self.queue[i]
            if req.deadline_steps is not None and now - req.submit_clock > req.deadline_steps:
                del self.queue[i]
                self._cancel(req, DeadlineExceeded(
                    "deadline expired while queued",
                    rid=req.rid, deadline_steps=req.deadline_steps,
                    waited=now - req.submit_clock,
                ))
        expired = [
            s for s, r in self.live.items()
            if r.deadline_steps is not None and now - r.submit_clock > r.deadline_steps
        ]
        for slot in expired:
            req = self.live.pop(slot)
            self.pool.release(slot)
            req.slot = None
            self._cancel(req, DeadlineExceeded(
                "deadline expired mid-decode",
                rid=req.rid, deadline_steps=req.deadline_steps,
                decoded=len(req.out),
            ))

    def _pick_victim(self, exclude: int) -> Optional[int]:
        """Preemption victim: the youngest live sequence (blocks allocated
        most recently — LRU over allocation time, cheapest to recompute)."""
        candidates = [s for s in self.live if s != exclude]
        if not candidates:
            return None
        return max(candidates, key=lambda s: (self.live[s].admit_clock, s))

    def _preempt(self, slot: int) -> None:
        req = self.live.pop(slot)
        self.pool.release(slot)
        req.slot = None
        req.status = "queued"
        req.preemptions += 1
        self.preemptions += 1
        self.queue.appendleft(req)   # resume first: it already holds progress

    def _append_with_recovery(self, slot: int, *, allow_preempt: bool = True) -> bool:
        """`append_token` with transient-fault retries and preemption.

        Transient injected misses are retried; true exhaustion preempts the
        youngest *other* sequence and retries.  ``allow_preempt=False`` is
        the admission-time mode: a sequence that is only being prefilled
        must never evict sequences holding decode progress.
        """
        for _ in range(3):
            if self.pool.append_token(slot):
                return True
            if self.pool.pool.free_tiles() > 0:
                continue                      # injected transient miss
            if not allow_preempt:
                return False
            victim = self._pick_victim(exclude=slot)
            if victim is None:
                return False
            self._preempt(victim)
        return self.pool.append_token(slot)

    # -- background maintenance ------------------------------------------------
    def _maybe_maintain(self) -> None:
        """Run one compaction pass when a watermark trips (rate-limited)."""
        mc = self.maintenance
        if mc is None or self.clock - self._last_maintenance < mc.every:
            return
        pool = self.pool.pool
        total = pool.total_tiles
        free_frac = pool.free_tiles() / total if total else 1.0
        frag = pool.fragmentation()
        contig = self.pool.contiguity_report()["mean_contiguous_fraction"]
        if free_frac > mc.free_low and frag < mc.frag_high and contig > mc.contig_low:
            return
        self._last_maintenance = self.clock
        report = self.pool.compact(max_moves=mc.max_moves)
        if report is not None and report.executed:
            self.compaction_passes += 1
            self.blocks_migrated += report.executed
            self.maintenance_ns += report.total_ns

    # -- prefill --------------------------------------------------------------
    def _prefill(self, req: Request) -> bool:
        """Teacher-forced KV fill over ``prompt + out[:-1]`` — identical for
        a fresh request (out empty) and a preempted one resuming
        (recompute-on-resume).  Returns False if the request had to be
        rejected (pathological: pool cannot host the sampled token)."""
        cfg = self.cfg
        ctx = req.prompt + req.out[:-1]
        toks = torch.tensor([[int(t) for t in ctx]], dtype=torch.long, device=self.device)
        S = toks.shape[1]
        pos = torch.arange(S, dtype=torch.long, device=self.device)[None]
        if cfg.rope == "mrope":             # text tokens: t = h = w = index
            pos = pos[..., None].expand(1, S, 3)
        cache = self.model.init_cache(1, S, recent_size=S, device=self.device)
        batch = {"tokens": toks, "positions": pos}
        logits, cache = self.model.decode_step(self.params, batch, cache)
        self.tokens_prefilled += S
        # prompt KV lands in the recent ring (split cache, len_main == 0)
        k, v = cache["layers"]["recent"]            # (L, 1, S, KV, hd)
        for li in range(cfg.n_layers):
            self.pool.write_prompt_kv(req.slot, li, k[li, 0, :S], v[li, 0, :S])
        if self.trace is not None:
            self.trace.on_prefill(
                req.slot, req.rid, S, self.pool.tiles_of(req.slot)
            )
        if not req.out:
            req.out.append(int(torch.argmax(logits[0])))
        # account the pending token: it becomes the next decode input.
        # allow_preempt=False — admission must never evict decode progress.
        if not self._append_with_recovery(req.slot, allow_preempt=False):
            slot = req.slot
            self.pool.release(slot)
            del self.live[slot]
            req.slot = None
            self._reject(req, RequestRejected(
                "KV pool cannot host the sampled token", rid=req.rid,
            ))
            return False
        return True

    # -- one engine step ---------------------------------------------------------
    def step(self) -> bool:
        """Admit + decode one token for all live seqs. False when idle.

        After the step, every registered ``step_hooks`` callable receives
        ``(engine, step_sample())``, each its own copy."""
        if self.trace is not None:
            self._step_writes = []
            d0 = self.tokens_decoded
        alive = self._step()
        if self.trace is not None:
            self.trace.on_step(
                self.clock, self.tokens_decoded - d0, self._step_writes
            )
        if self.step_hooks:
            sample = self.step_sample()
            for hook in list(self.step_hooks):
                hook(self, dict(sample))
        return alive

    def _step(self) -> bool:
        self.clock += 1
        self._sweep_deadlines()

        # 1) admit — bounded lookahead so a large head request cannot starve
        #    admissible smaller requests behind it
        idx = 0
        scanned = 0
        while idx < len(self.queue) and scanned < self.admission_lookahead:
            req = self.queue[idx]
            slot = self.pool.admit(req.ctx_tokens())
            if slot is None:
                idx += 1
                scanned += 1
                continue
            # prefill appends the sampled token immediately: if that needs a
            # growth block the pool doesn't have, leave the request queued.
            if (self.pool.pool.free_tiles() == 0
                    and self.pool.blocks_for(req.ctx_tokens() + 1)
                    > self.pool.blocks_for(req.ctx_tokens())):
                self.pool.release(slot)
                idx += 1
                scanned += 1
                continue
            del self.queue[idx]
            req.slot = slot
            req.status = "running"
            req.admit_clock = self.clock
            self.live[slot] = req
            self._prefill(req)

        if not self.live:
            if not self.queue:
                return False
            # empty batch, non-empty queue: a stall.  Tolerate a few steps
            # (transient injected faults resolve), then fail loudly.
            self._stall_steps += 1
            if self._stall_steps > self.stall_patience:
                report = self.stall_report()
                while self.queue:
                    req = self.queue.popleft()
                    self._reject(req, RequestRejected(
                        "engine stalled: request not admissible with an idle pool",
                        rid=req.rid,
                        blocks_needed=self.pool.blocks_for(req.ctx_tokens()),
                        report=report,
                    ))
                self._stall_steps = 0
                return False
            # stalled admission is exactly when defrag helps most
            self._maybe_maintain()
            return True
        self._stall_steps = 0

        # 2) fused decode for all live sequences
        slots = sorted(self.live)
        cfg = self.cfg
        tbl_full = self.pool.block_table()
        lens_full = self.pool.seq_lens()
        tokens = np.array([[self.live[s].out[-1]] for s in slots], np.int64)
        positions = np.array([[lens_full[s] - 1] for s in slots], np.int64)
        if cfg.rope == "mrope":
            positions = np.repeat(positions[..., None], 3, axis=-1)

        # graphed, these are the graph's own outputs: consumed below, before
        # the next replay
        logits, new_k, new_v = paged_decode_step_jit(
            self.params, cfg, tokens, positions, self.pool.k, self.pool.v,
            tbl_full[slots], lens_full[slots], graphs=self.graphs,
        )
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()

        # 3) write current-token KV into PUMA-placed blocks, advance seqs
        for bi, slot in enumerate(slots):
            if slot not in self.live:
                continue                    # preempted earlier this loop
            req = self.live[slot]
            for li in range(cfg.n_layers):
                self.pool.write_token_kv(slot, li, new_k[li, bi], new_v[li, bi])
            if self.trace is not None:
                self._step_writes.append(
                    (slot, self.pool.block_of_token(slot))
                )
            tok = int(nxt[bi])
            self.tokens_decoded += 1
            finished = (
                len(req.out) + 1 >= req.max_new
                or (self.eos_id is not None and tok == self.eos_id)
            )
            req.out.append(tok)
            if finished:
                self.pool.release(slot)
                del self.live[slot]
                req.slot = None
                req.status = "done"
                req.finish_clock = self.clock
                self.done.append(req)
            elif not self._append_with_recovery(slot):
                self.pool.release(slot)
                del self.live[slot]
                req.slot = None
                self._reject(req, RequestRejected(
                    "KV pool cannot host the next token", rid=req.rid,
                    decoded=len(req.out),
                ))
        self.steps += 1
        self._maybe_maintain()
        return bool(self.live or self.queue)

    def drain(self, max_steps: int = 10_000) -> List[Request]:
        """Step until idle without raising (rejections/cancellations stay
        recorded rather than aborting the run)."""
        for _ in range(max_steps):
            if not self.step():
                break
        return self.done

    def run_for(self, n_steps: int) -> bool:
        """Time-sliced run: advance at most ``n_steps`` engine ticks; returns
        the last ``step()`` result (False = engine went idle)."""
        alive = True
        for _ in range(max(0, n_steps)):
            alive = self.step()
            if not alive:
                break
        return alive

    def run(self, max_steps: int = 10_000, raise_on_error: bool = True) -> List[Request]:
        self.drain(max_steps)
        if raise_on_error:
            if self.queue or self.live:
                raise EngineStalled(
                    "serving loop ended with unfinished work",
                    report=self.stall_report(),
                )
            for r in self.rejected:
                if r.error is not None:
                    raise r.error
        return self.done

    # -- introspection --------------------------------------------------------
    def stall_report(self) -> Dict[str, object]:
        """Snapshot of why the engine is (or was) unable to make progress."""
        return {
            "clock": self.clock,
            "steps": self.steps,
            "queued": [
                {"rid": r.rid, "blocks_needed": self.pool.blocks_for(r.ctx_tokens()),
                 "preemptions": r.preemptions}
                for r in self.queue
            ],
            "live": len(self.live),
            "free_tiles": self.pool.pool.free_tiles(),
            "total_tiles": self.pool.pool.total_tiles,
            "free_slots": len(self.pool._free_slots),
            "done": len(self.done),
            "rejected": len(self.rejected),
            "cancelled": len(self.cancelled),
            "preemptions": self.preemptions,
        }

    def step_sample(self) -> Dict[str, float]:
        """One step-granular metric sample (what ``step_hooks`` receive):
        queue/batch depth, pool occupancy, live block-table contiguity and
        the degraded-mode counters.  All floats."""
        occ = self.pool.occupancy()
        rep = self.pool.contiguity_report()
        return {
            "contiguity": rep["mean_contiguous_fraction"],
            "descriptors_per_tile": rep["descriptors_per_tile"],
            "channel_balance": rep["channel_balance"],
            "clock": float(self.clock),
            "steps": float(self.steps),
            "live": float(len(self.live)),
            "queued": float(len(self.queue)),
            "free_tiles": occ["free_tiles"],
            "used_fraction": occ["used_fraction"],
            "tokens_decoded": float(self.tokens_decoded),
            "tokens_prefilled": float(self.tokens_prefilled),
            "done": float(len(self.done)),
            "rejected": float(len(self.rejected)),
            "cancelled": float(len(self.cancelled)),
            "preemptions": float(self.preemptions),
        }

    def metrics(self) -> Dict[str, float]:
        rep = self.pool.contiguity_report()
        rep.update(
            clock=float(self.clock),
            steps=float(self.steps),
            tokens=float(self.tokens_decoded),
            tokens_prefilled=float(self.tokens_prefilled),
            submitted=float(self.submitted),
            done=float(len(self.done)),
            queue_depth=float(len(self.queue)),
            used_fraction=self.pool.occupancy()["used_fraction"],
            frag=self.pool.pool.fragmentation(),
            align_hits=float(self.pool.pool.stats.align_hits),
            align_misses=float(self.pool.pool.stats.align_misses),
            rejected=float(len(self.rejected)),
            cancelled=float(len(self.cancelled)),
            preemptions=float(self.preemptions),
            injected_misses=float(self.pool.pool.stats.injected_misses),
            maintenance_ns=float(self.maintenance_ns),
            compaction_passes=float(self.compaction_passes),
            blocks_migrated=float(self.blocks_migrated),
        )
        return rep

    def channel_occupancy(self) -> Dict[str, object]:
        """Per-channel block occupancy of the paged KV pool."""
        return self.pool.channel_occupancy()
