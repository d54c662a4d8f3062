"""Fault-tolerant training loop.

* **checkpoint/restart** — atomic checkpoints every ``ckpt_every`` steps;
  on start, auto-resume from the latest complete one (params, optimizer
  moments, data step counter).
* **failure recovery** — a step that raises (injectable via
  ``failure_hook`` for tests) rolls back to the last checkpoint and replays;
  the deterministic data pipeline makes the replay bit-exact.  Unlike the
  reference, a step that fails again after such a recovery raises: the
  reference replays it without end, so that a deterministic fault (a kernel
  or CUDA error, or ``grad_compression=True``, whose step wants an error
  state the loop never passes) would hang the run.
* **straggler mitigation** — per-step wall time is tracked with an EMA;
  steps slower than ``straggler_factor`` x EMA are logged and counted.

Checkpoints store whole (unsharded) tensors, so a run may resume on another
device.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.data.pipeline import DataConfig, DataIterator
from repro_torch.optim import adamw as opt_mod
from repro_torch.train.step import build_train_step


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_keep: int = 3
    log_every: int = 10
    accum_steps: int = 1
    grad_compression: bool = False
    straggler_factor: float = 3.0


class Trainer:
    def __init__(
        self,
        model,
        data_cfg: DataConfig,
        opt_cfg: opt_mod.AdamWConfig,
        tcfg: TrainerConfig,
        *,
        device="cuda",
        init_params: Optional[Callable[[], Any]] = None,
        failure_hook: Optional[Callable[[int], None]] = None,
        log: Callable[[str], None] = print,
    ):
        """``init_params`` returns fresh params (default: ``model.init(0)``
        on ``device``); it is called on start and on every recovery."""
        self.model = model
        self.data_cfg = data_cfg
        self.opt_cfg = opt_cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.init_params = init_params or (lambda: model.init(0, device=self.device))
        self.failure_hook = failure_hook
        self.log = log
        self.step_fn = build_train_step(
            model, opt_cfg,
            accum_steps=tcfg.accum_steps,
            grad_compression=tcfg.grad_compression,
        )
        self.metrics_history: list = []
        self.straggler_steps = 0
        self.recoveries = 0

    # -- state management -------------------------------------------------------
    def _fresh_state(self):
        params = self.init_params()
        return params, opt_mod.init_opt_state(params)

    def _save(self, step, params, opt_state):
        ckpt.save(
            self.tcfg.ckpt_dir, step,
            {"params": params, "opt": opt_state},
            keep=self.tcfg.ckpt_keep,
        )

    def _try_resume(self):
        last = ckpt.latest_step(self.tcfg.ckpt_dir)
        params, opt_state = self._fresh_state()
        if last is None:
            return 0, params, opt_state
        like = {"params": params, "opt": opt_state}
        state = ckpt.restore(self.tcfg.ckpt_dir, last, like)
        self.log(f"[trainer] resumed from step {last}")
        return last, state["params"], state["opt"]

    def _to_device(self, np_batch) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device) for k, v in np_batch.items()}

    # -- the loop -----------------------------------------------------------------
    def run(self) -> Dict[str, Any]:
        start_step, params, opt_state = self._try_resume()
        it = DataIterator(self.data_cfg, dp_rank=0, start_step=start_step)
        ema = None
        step = start_step
        failed = set()   # steps that raised once already
        try:
            while step < self.tcfg.total_steps:
                step, np_batch = next(it)
                if step >= self.tcfg.total_steps:
                    break
                batch = self._to_device(np_batch)
                t0 = time.perf_counter()
                try:
                    if self.failure_hook is not None:
                        self.failure_hook(step)
                    params, opt_state, metrics = self.step_fn(params, opt_state, batch)
                    metrics = {k: float(v) for k, v in metrics.items()}
                except Exception as e:  # noqa: BLE001 — node-failure recovery path
                    if step in failed:
                        self.log(f"[trainer] step {step} failed again ({e!r}); giving up")
                        raise
                    failed.add(step)
                    self.log(f"[trainer] step {step} failed ({e!r}); recovering")
                    self.recoveries += 1
                    it.close()
                    start_step, params, opt_state = self._try_resume()
                    it = DataIterator(self.data_cfg, dp_rank=0, start_step=start_step)
                    step = start_step
                    continue
                dt = time.perf_counter() - t0
                ema = dt if ema is None else 0.9 * ema + 0.1 * dt
                if dt > self.tcfg.straggler_factor * ema:
                    self.straggler_steps += 1
                    self.log(f"[trainer] straggler step {step}: {dt:.3f}s vs ema {ema:.3f}s")
                metrics["step_time"] = dt
                self.metrics_history.append((step, metrics))
                if step % self.tcfg.log_every == 0:
                    self.log(
                        f"[trainer] step {step} loss={metrics['loss']:.4f} "
                        f"gnorm={metrics['grad_norm']:.3f} {dt*1e3:.0f}ms"
                    )
                if (step + 1) % self.tcfg.ckpt_every == 0:
                    self._save(step + 1, params, opt_state)
            self._save(self.tcfg.total_steps, params, opt_state)
        finally:
            it.close()
        return {
            "params": params,
            "opt": opt_state,
            "history": self.metrics_history,
            "stragglers": self.straggler_steps,
            "recoveries": self.recoveries,
        }
