"""Deterministic synthetic data pipeline.

Design goals of the 1000-node posture:

* **Deterministic addressing** — batch ``(step, dp_rank)`` is a pure function
  of those two integers (counter-based PRNG), so any host can regenerate any
  shard: restarts, elastic re-sharding, and straggler re-assignment need no
  data-state checkpoint beyond the step counter.
* **Packing** — documents of random length are packed into (B, S) with
  cross-document attention masking via loss masks (the packed-boundary mask).
* **Prefetch** — a background thread keeps ``prefetch`` batches ready.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, RunShape


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_per_shard: int
    mean_doc_len: int = 512
    seed: int = 1234


def _rng_for(cfg: DataConfig, step: int, dp_rank: int) -> np.random.Generator:
    # counter-based: independent stream per (step, shard)
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, dp_rank])
    )


def synth_batch(cfg: DataConfig, step: int, dp_rank: int) -> Dict[str, np.ndarray]:
    """Markov-ish synthetic tokens packed from variable-length documents."""
    rng = _rng_for(cfg, step, dp_rank)
    B, S = cfg.batch_per_shard, cfg.seq_len
    tokens = np.empty((B, S + 1), np.int32)
    mask = np.ones((B, S), np.float32)
    for b in range(B):
        pos = 0
        while pos < S + 1:
            dl = int(rng.integers(cfg.mean_doc_len // 2, cfg.mean_doc_len * 2))
            dl = min(dl, S + 1 - pos)
            # low-entropy doc: random walk over vocab so loss can decrease
            start = rng.integers(0, cfg.vocab_size)
            steps = rng.integers(-3, 4, size=dl)
            doc = (start + np.cumsum(steps)) % cfg.vocab_size
            tokens[b, pos : pos + dl] = doc
            if pos > 0:
                mask[b, pos - 1] = 0.0  # don't predict across doc boundary
            pos += dl
    return {
        "tokens": tokens[:, :-1],
        "targets": tokens[:, 1:],
        "loss_mask": mask,
        "positions": np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy(),
    }


class DataIterator:
    """Prefetching iterator over deterministic shards."""

    def __init__(
        self,
        cfg: DataConfig,
        dp_rank: int = 0,
        start_step: int = 0,
        prefetch: int = 2,
    ):
        self.cfg = cfg
        self.dp_rank = dp_rank
        self.step = start_step
        self._q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            batch = synth_batch(self.cfg, step, self.dp_rank)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        step, batch = self._q.get()
        self.step = step + 1
        return step, batch

    def close(self):
        self._stop.set()


def batch_for_shape(
    cfg: ModelConfig, shape: RunShape, step: int = 0, dp_rank: int = 0
) -> Dict[str, np.ndarray]:
    dcfg = DataConfig(
        vocab_size=cfg.vocab_size,
        seq_len=shape.seq_len,
        batch_per_shard=shape.global_batch,
    )
    return synth_batch(dcfg, step, dp_rank)
