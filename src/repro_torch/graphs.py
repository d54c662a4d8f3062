"""CUDA graphs of the decode steps: the port's counterpart of the
reference's ``jax.jit`` of ``paged_decode_step`` and ``LM.decode_step``.

A decode step at batch 8 is a few thousand small launches whose host cost
outweighs their device time.  A CUDA graph records them once and replays
them with one launch.  The reference compiles a step once per shape; here a
step is captured once per key (its batch, the identity of the params and of
the device tensors it reads and writes) and replayed on whatever its static
inputs hold.

:func:`graph_cache` keeps the captured steps on the model, as the
reference keeps ``model._jit_decode_step``, so every engine over the same
model and params shares them.  All graphs of one cache draw on one memory
pool, so the batch sizes of a serve do not each hold a copy of the
activations.  The price of sharing the pool: a graph's outputs are its own
tensors, overwritten by the next replay of any graph of the cache, so the
caller consumes them before that replay.

A step is keyed on the identity of what it reads, so replacing a params
dict, a pool or a cache gets a new capture and never replays a stale one.
A captured step holds the params strongly and the pools and caches weakly:
once an engine's pool or a cache is freed, the steps that read it are
retired at the next capture, so engines that come and go over one model do
not keep their pools alive.  When that retires every step, the memory pool
goes with their graphs and the next capture starts a new one.  Capture or replay errors raise; nothing falls
back to the eager step.  CPUs have no graphs: the callers run their step
eagerly on CPU tensors.

``kernels.launches`` counts in Python, where a wrapper launches its kernel,
so a replay would count nothing.  Capture records each kernel's count of
one step and every replay adds it.  The warm-up calls before a capture run
the kernels eagerly; their counts are taken back, as a part of the capture.
"""
from __future__ import annotations

import time
import weakref
from typing import Callable, Dict, Hashable, Sequence

import numpy as np
import torch

from repro_torch import kernels

__all__ = ["CapturedStep", "GraphCache", "HostInputs", "decode_step_jit", "graph_cache"]

#: eager calls on a side stream before a capture (PyTorch's graph recipe):
#: they initialise cuBLAS's workspace and every lazily built kernel
WARMUP = 2


class CapturedStep:
    """``fn()`` captured in one CUDA graph into the memory ``pool``, under
    ``torch.no_grad``.

    ``inputs`` are the static inputs the caller loads before each replay.
    ``written`` lists tensors ``fn`` updates in place (a recurrent state):
    they are restored after the warm-up calls, so capturing leaves them as
    it found them.  ``keep`` is held for the graph's life; the step is
    ``alive`` while every tensor of ``weak`` is (``fn`` is not kept)."""

    def __init__(self, fn: Callable, *, pool, inputs=None,
                 written: Sequence[torch.Tensor] = (), keep=(),
                 weak: Sequence[torch.Tensor] = ()):
        counts = dict(kernels.launches)
        snapshot = [t.clone() for t in written]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.no_grad():
            with torch.cuda.stream(side):
                for _ in range(WARMUP):
                    fn()
            torch.cuda.current_stream().wait_stream(side)
            for t, s in zip(written, snapshot):
                t.copy_(s)
            del snapshot
            kernels.launches.update(counts)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, pool=pool):
                self.outputs = fn()
        self.launches = {k: n - counts[k] for k, n in kernels.launches.items() if n != counts[k]}
        kernels.launches.update(counts)
        self.inputs = inputs
        self.keep = keep
        self._weak = [weakref.ref(t) for t in weak]

    def alive(self) -> bool:
        return all(r() is not None for r in self._weak)

    def replay(self):
        """Run the graph on the current stream; returns its own outputs."""
        self.graph.replay()
        for k, n in self.launches.items():
            kernels.launches[k] += n
        return self.outputs


class HostInputs:
    """Device buffers a graph reads, loaded from pinned host staging with
    copies that do not block the host."""

    def __init__(self, arrays: Sequence[np.ndarray], device):
        self.host = [torch.from_numpy(np.ascontiguousarray(a)).pin_memory() for a in arrays]
        self.tensors = [h.to(device) for h in self.host]
        self.copied = torch.cuda.Event()
        self.copied.record()

    def load(self, arrays: Sequence[np.ndarray]) -> None:
        # the previous load's copies must have read the staging first
        self.copied.synchronize()
        for h, a in zip(self.host, arrays):
            dst = h.numpy()
            if a.shape != dst.shape or a.dtype != dst.dtype:
                raise ValueError(f"input {a.dtype}{a.shape} does not fit the captured "
                                 f"{dst.dtype}{dst.shape}")
            dst[...] = a
        for h, d in zip(self.host, self.tensors):
            d.copy_(h, non_blocking=True)
        self.copied.record()


class GraphCache:
    """Captured steps by key, in one memory pool; counts its captures and
    their wall time (warm-up included)."""

    def __init__(self):
        self.steps: Dict[Hashable, CapturedStep] = {}
        self.pool = None
        self.captures = 0
        self.capture_ms = 0.0

    def get(self, key: Hashable, make: Callable[..., CapturedStep]) -> CapturedStep:
        """The step under ``key``; on first use ``make(pool)`` captures it,
        after retiring the steps whose weakly held tensors are gone."""
        step = self.steps.get(key)
        if step is None or not step.alive():
            self.steps = {k: s for k, s in self.steps.items() if s.alive()}
            if not self.steps:
                # the graphs just retired were the pool's last users, and
                # PyTorch releases a pool with its last graph: capture into
                # a new one
                self.pool = torch.cuda.graph_pool_handle()
            t0 = time.perf_counter()
            step = make(self.pool)
            torch.cuda.synchronize()
            self.capture_ms += (time.perf_counter() - t0) * 1e3
            self.captures += 1
            self.steps[key] = step
        return step


def graph_cache(model) -> GraphCache:
    """The model's graph cache, made on first use."""
    cache = getattr(model, "_cuda_graphs", None)
    if cache is None:
        cache = model._cuda_graphs = GraphCache()
    return cache


def decode_step_jit(model, params, batch, cache):
    """``model.decode_step`` of one token for the ssm family (RWKV6) as a
    CUDA graph, the reference's ``jax.jit(model.decode_step)``; same
    arguments and results.

    One graph per (params, cache tensors, batch); the tokens and positions
    are copied into its static inputs and the cache's states are written in
    place by the replay.  ``cache["len"]`` advances on the host.  On CPU
    tensors the step runs eagerly.

    The hybrid family (Zamba2) is not captured: its split attention cache
    passes host-int lengths into the layer stack, which fix slice offsets,
    so each step would need a capture of its own; graphing it means
    attention over device lengths with a mask.  The dense family's split
    cache has the same limit (its engine decodes through
    ``paged_decode_step_jit`` instead).
    """
    if model.family != "ssm":
        raise NotImplementedError(
            f"{model.cfg.name}: only the ssm family's one-token step is captured; the "
            f"{model.family} family's split cache takes host-int lengths (ROADMAP.md)")
    tokens, positions = batch["tokens"], batch["positions"]
    if tokens.device.type != "cuda":
        return model.decode_step(params, batch, cache)
    if tokens.shape[1] != 1:
        raise ValueError(f"one-token steps only, got {tokens.shape[1]} tokens")
    state = tuple(cache["layers"])
    key = ("decode_step", id(params), tuple((t.data_ptr(), t.shape) for t in state),
           tuple(tokens.shape), tokens.dtype, tuple(positions.shape), positions.dtype)

    def make(pool):
        static = (tokens.clone(), positions.clone())
        step_cache = {"layers": cache["layers"], "len": cache["len"]}
        return CapturedStep(
            lambda: model.decode_step(
                params, {"tokens": static[0], "positions": static[1]}, step_cache)[0],
            pool=pool, inputs=static, written=state, keep=(params,), weak=state)

    step = graph_cache(model).get(key, make)
    step.inputs[0].copy_(tokens)
    step.inputs[1].copy_(positions)
    new_cache = dict(cache)
    new_cache["len"] = cache["len"] + 1
    return step.replay(), new_cache
