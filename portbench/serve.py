"""Drives the program's serving engine through one run of a serving cell.

Set-up (counted in ``setup_s``): the engine over the harness's weights and
the mix's pool, then the mix's warm-up requests, which capture every
decode graph the window will replay (closed loop: the first round, all
slots at once; open loop: one request a slot, finishing one a step, so
every batch size from the slots down to one).

The window: ``ServeEngine.submit`` and ``ServeEngine.step`` and nothing
else, for ``seconds`` of host clock.  A closed loop's client sends its next
request as soon as its last one is done; an open loop submits each request
at its due time.  A token reaches the client when the step that made it
returns (the engine reads it back to the host there), and is stamped then.

With ``trace``, host spans are timed during the window (steps with a
``synchronize``, the K/V writes, the prefills, and the lengths each decode
step reads), and after it a fixed stretch of ``trace_steps`` steps runs
under ``torch.profiler`` at the same load.  An open loop then keeps
stepping, with arrivals going on, until every request due in the window
has finished (at most ``WAIT_S``), so that a late answer is timed and not
lost.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import torch

WAIT_S = 60.0          # how long an open loop waits past the window for its answers
SPAN = "portbench."    # prefix of the harness's spans in a profile


@dataclasses.dataclass
class Record:
    """One request as its client sees it."""
    rid: int
    prompt: List[int]
    max_new: int
    due: float                  # host clock: when it was due (closed loop: sent)
    in_window: bool
    req: object = None          # the engine's Request
    times: List[float] = dataclasses.field(default_factory=list)  # each token's arrival
    failed: bool = False

    @property
    def done(self) -> bool:
        return getattr(self.req, "status", None) == "done"


@dataclasses.dataclass
class Observations:
    """What a run of a serving cell saw; the metric readers read it."""
    setup_s: float = 0.0
    window_s: float = 0.0
    end: float = 0.0                        # host clock when the run stopped waiting for answers
    queued_at_close: int = 0                # requests waiting for a slot as the window closed
    records: List[Record] = dataclasses.field(default_factory=list)
    window_tokens: int = 0                  # tokens that reached clients in the window
    steps: int = 0                          # engine steps in the window
    spans: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    decode_flops: float = 0.0               # model flops of the window's decoded tokens
    train_flops: float = 0.0                # model flops of the window's train steps
    prefill_flops: float = 0.0
    prefill_tokens: int = 0
    decode_steps: int = 0                   # steps that decoded, in the window
    engine: Dict[str, float] = dataclasses.field(default_factory=dict)
    profile: Optional[Dict] = None          # the profiled stretch (profiling.summarize)
    memory_peak_bytes: int = 0


class Server:
    """One engine, its clients and their records."""

    def __init__(self, engine, mix: Dict, plan, request_cls, *, arch, cuda: bool):
        self.engine = engine
        self.mix = mix
        self.plan = plan
        self.Request = request_cls
        self.arch = arch
        self.cuda = cuda
        self.obs = Observations()
        self.active: List[Record] = []
        self.next_req = 0
        self.clients: List[Optional[Record]] = []
        self.t_open = 0.0
        self.close_at = float("inf")
        self.measure = False                # inside the window
        self.trace = False
        self.profiling = False              # inside the profiled stretch
        self.paged_lens: List = []          # lengths each profiled decode step read

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    # -- sending ------------------------------------------------------------------
    def submit(self, prompt, max_new, due, in_window) -> Record:
        rec = Record(rid=len(self.obs.records), prompt=prompt, max_new=max_new, due=due,
                     in_window=in_window)
        rec.req = self.Request(rid=rec.rid, prompt=list(prompt), max_new=max_new)
        self.obs.records.append(rec)
        try:
            self.engine.submit(rec.req)
        except Exception:  # noqa: BLE001 - a rejected request is counted, not raised
            rec.failed = True
            return rec
        self.active.append(rec)
        return rec

    def send_due(self, now: float) -> None:
        """Open loop: every request due by ``now``; closed loop: the next
        request of each client whose last one is done."""
        p = self.plan
        if self.mix["kind"] == "open":
            while self.next_req < len(p.offsets) and self.t_open + p.offsets[self.next_req] <= now:
                due = self.t_open + p.offsets[self.next_req]
                prompt, n = p.requests[self.next_req]
                self.submit(prompt, n, due, due < self.close_at)
                self.next_req += 1
            return
        for c, rec in enumerate(self.clients):
            if rec.failed or rec.req.status not in ("queued", "running"):
                if self.next_req >= len(p.requests):
                    raise RuntimeError("the mix's request list ran out: raise its 'requests'")
                prompt, n = p.requests[self.next_req]
                self.next_req += 1
                self.clients[c] = self.submit(prompt, n, now, now < self.close_at)

    # -- stepping -----------------------------------------------------------------
    def step(self) -> None:
        eng = self.engine
        fill = eng.tokens_prefilled
        t0 = time.perf_counter()
        eng.step()
        if self.trace and self.measure:
            self.sync()
        t1 = time.perf_counter()
        if self.measure:
            self.obs.steps += 1
            if self.trace and eng.tokens_prefilled == fill:
                self.obs.spans.setdefault("step_no_admit", []).append(t1 - t0)
        still = []
        for rec in self.active:
            n = len(rec.req.out)
            if n > len(rec.times):
                if self.measure:
                    self.obs.window_tokens += n - len(rec.times)
                rec.times.extend([t1] * (n - len(rec.times)))
            if rec.req.status in ("queued", "running"):
                still.append(rec)
            elif rec.req.status != "done":
                rec.failed = True
        self.active = still

    def idle(self) -> bool:
        return not self.engine.live and not self.engine.queue

    def wait_for_next(self) -> None:
        """Open loop with nothing to do: sleep until the next request is due."""
        p = self.plan
        if self.next_req < len(p.offsets):
            delay = self.t_open + p.offsets[self.next_req] - time.perf_counter()
            if delay > 0:
                time.sleep(delay)

    def iterate(self) -> None:
        self.send_due(time.perf_counter())
        if self.idle():
            self.wait_for_next()
            return
        self.step()

    # -- phases --------------------------------------------------------------------
    def warm_up(self) -> None:
        """Every decode graph the window replays, captured here."""
        now = time.perf_counter()
        if self.mix["kind"] == "closed":
            self.clients = [self.submit(p, n, now, False) for p, n in self.plan.warmup]
            self.step()                     # admits every client, captures the batch's graph
            return
        for p, n in self.plan.warmup:
            self.submit(p, n, now, False)
        while not self.idle():
            self.step()
        self.sync()

    def window(self, seconds: float) -> None:
        self.sync()
        self.t_open = time.perf_counter()
        self.close_at = self.t_open + seconds
        self.measure = True
        while time.perf_counter() < self.close_at:
            self.iterate()
        self.sync()
        self.measure = False
        self.obs.queued_at_close = len(self.engine.queue)
        self.obs.window_s = time.perf_counter() - self.t_open

    def finish(self) -> None:
        """Open loop: step on, arrivals going on, until every request due in
        the window is done or ``WAIT_S`` has passed; the rest failed."""
        if self.mix["kind"] != "open":
            self.obs.end = time.perf_counter()
            return
        deadline = time.perf_counter() + WAIT_S
        while time.perf_counter() < deadline and any(
                r.in_window and not r.done and not r.failed for r in self.obs.records):
            self.iterate()
        self.sync()
        self.obs.end = time.perf_counter()
        for r in self.obs.records:
            if r.in_window and not r.done:
                r.failed = True

    # -- trace-mode spans -----------------------------------------------------------
    def instrument(self, engine_module) -> None:
        """Wrap the engine's prefill, its pool's K/V writes and the decode
        step it calls, to time them (host clock) in the window and name
        them as spans in the profiled stretch."""
        eng, obs, a = self.engine, self.obs, self.arch
        from portbench import flops

        prefill, write = eng._prefill, eng.pool.write_token_kv
        decode = engine_module.paged_decode_step_jit
        rf = torch.profiler.record_function

        def timed_prefill(req):
            n = req.ctx_tokens()
            with rf(SPAN + "prefill"):
                t0 = time.perf_counter()
                out = prefill(req)
                self.sync()
                dt = time.perf_counter() - t0
            if self.measure:
                obs.spans.setdefault("prefill", []).append(dt)
                obs.prefill_tokens += n
                obs.prefill_flops += flops.prefill_flops(a, n)
            return out

        def timed_write(*args):
            if self.profiling:
                with rf(SPAN + "kv_write"):
                    return write(*args)
            t0 = time.perf_counter()
            write(*args)
            if self.measure:
                obs.spans.setdefault("kv_write", []).append(time.perf_counter() - t0)

        def counted_decode(*args, **kwargs):
            lens = args[7]                       # seq_lens, host array, the current token counted
            if self.measure:
                obs.decode_steps += 1
                obs.decode_flops += sum(flops.decode_token_flops(a, int(n)) for n in lens)
            if self.profiling:
                self.paged_lens.append([int(n) - 1 for n in lens])
                with rf(SPAN + "graph_replay"):
                    return decode(*args, **kwargs)
            return decode(*args, **kwargs)

        eng._prefill = timed_prefill
        eng.pool.write_token_kv = timed_write
        engine_module.paged_decode_step_jit = counted_decode
        self.trace = True

    def profile_stretch(self, steps: int) -> Dict:
        """``steps`` engine steps at the same load under ``torch.profiler``."""
        from portbench import profiling
        self.sync()
        self.profiling = True
        self.paged_lens = []
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        n = 0
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            with torch.profiler.record_function(SPAN + "stretch"):
                while n < steps:
                    self.send_due(time.perf_counter())
                    if self.idle():
                        if self.next_req >= len(self.plan.offsets):
                            break
                        self.wait_for_next()
                        continue
                    with torch.profiler.record_function(SPAN + "step"):
                        self.step()
                    n += 1
                self.sync()
            stretch_s = time.perf_counter() - t0
        self.profiling = False
        return profiling.summarize(prof, stretch_s, steps, self.paged_lens)
