"""Drives the program's train step through one run of a training cell.

Set-up builds one object, the step of ``train/step.py:build_train_step``
(AdamW, updating the params and the optimizer state in place, as the
program's trainer does) over the program's model (``remat`` and
``attn_impl`` as the job states) and the harness's weights, and drives it
through the check's first steps by the same call the window makes; those
steps' losses, the first gradient as AdamW took it (its first moment after
one step, over 1 - beta1) and each leaf's change over the steps are kept
for the comparison.  The window then calls the same step on fresh batches
for ``seconds``, one ``synchronize`` a step.  Every batch is drawn on the
device from (seed, step): tokens uniform over the vocabulary, each row
different, the targets the next tokens.

A job file (``traffic/<job>.json``, ``kind`` "train") gives ``seq``,
``batch``, ``remat``, ``attn_impl``, ``optimizer`` (AdamW's fields),
``check_steps`` and ``trace_steps``.
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench import flops
from portbench.serve import SPAN, Observations


def tree_leaves(tree, path=()) -> List[Tuple[str, torch.Tensor]]:
    if isinstance(tree, torch.Tensor):
        return [(".".join(path), tree)]
    return [leaf for k, v in tree.items() for leaf in tree_leaves(v, path + (k,))]


def batch(job: Dict, seed: int, i: int, vocab: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step ``i``'s (tokens, targets), each (batch, seq) int64."""
    state = np.random.SeedSequence([int(seed), i]).generate_state(2, dtype=np.uint32)
    gen = torch.Generator(device=device).manual_seed(int(state[0]) << 32 | int(state[1]))
    t = torch.randint(0, vocab, (job["batch"], job["seq"] + 1), generator=gen, device=device)
    return t[:, :-1], t[:, 1:]


class Job:
    def __init__(self, model, params, job: Dict, seed: int, *, arch, device, cuda: bool):
        from repro_torch.optim import adamw
        from repro_torch.train.step import build_train_step
        self.job, self.seed, self.arch, self.device, self.cuda = job, seed, arch, device, cuda
        self.params = params
        self.ocfg = adamw.AdamWConfig(**job["optimizer"])
        self.opt_state = adamw.init_opt_state(params)
        self.step_fn = build_train_step(model, self.ocfg, donate=True)
        self.obs = Observations()
        self.next = 0
        self.program: Dict = {}

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def step(self):
        rf = torch.profiler.record_function
        with rf(SPAN + "batch"):
            tokens, targets = batch(self.job, self.seed, self.next, self.arch.vocab_size,
                                    self.device)
            pos = torch.arange(tokens.shape[1], device=self.device).expand_as(tokens)
        self.next += 1
        with rf(SPAN + "train_step"):
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state,
                {"tokens": tokens, "targets": targets, "positions": pos})
        self.sync()
        return metrics

    def first_steps(self) -> None:
        """The check's steps, through the window's own call."""
        p0 = {n: t.clone() for n, t in tree_leaves(self.params)}
        losses = []
        for i in range(self.job["check_steps"]):
            metrics = self.step()
            losses.append(float(metrics["loss"]))
            if i == 0:
                self.program["grad"] = {n: float(m.norm()) / (1 - self.ocfg.b1)
                                        for n, m in tree_leaves(self.opt_state.mu)}
        self.program["loss"] = losses
        self.program["change"] = {n: float((t.float() - p0[n].float()).norm())
                                  for n, t in tree_leaves(self.params)}

    def window(self, seconds: float) -> None:
        self.sync()
        t0 = time.perf_counter()
        close = t0 + seconds
        steps = 0
        while time.perf_counter() < close:
            self.step()
            steps += 1
        self.obs.window_s = time.perf_counter() - t0
        self.obs.steps = steps
        self.obs.window_tokens = steps * self.job["batch"] * self.job["seq"]
        self.obs.train_flops = steps * flops.train_step_flops(self.arch, self.job["batch"],
                                                               self.job["seq"])

    def profile_stretch(self, steps: int) -> Dict:
        from portbench import profiling
        self.sync()
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            with torch.profiler.record_function(SPAN + "stretch"):
                for _ in range(steps):
                    self.step()
            stretch_s = time.perf_counter() - t0
        return profiling.summarize(prof, stretch_s, steps, [])
