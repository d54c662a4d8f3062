"""The one traffic generator: a mix file (``traffic/<mix>.json``) and a seed
give the requests of a run.

Every seed gets the same prompt lengths, output lengths and arrival gaps,
in the same order; the run's seed draws the token ids (and the weights)
and which client takes which of the first round's requests.  So every
seed does the same work on other inputs, and two seeds' runs differ as
little as two runs of one seed.

Closed loop: the k-th request's prompt and output are the quantiles at
frac(0.5 + k * c) of the mix's distributions, with c a different
irrational for each (``sequence``): a low-discrepancy sequence that covers
the distribution evenly in every prefix.

Open loop: requests come in blocks of ``block``.  A block's arrival gaps
are the means of an exponential of the mix's rate over ``block`` strata of
equal probability, and its prompt and output lengths the quantiles at the
strata's midpoints; each block takes them in an order drawn once from the
mix's ``order`` (``shuffled``).  So a window that holds one block sees the
rate and the lengths of the mix exactly, and consecutive gaps and lengths
are as independent as a Poisson stream's: short gaps come in runs and
bursts form.

Mix keys (``kind`` "closed" or "open"; a training job, ``kind`` "train",
is read by ``train.py``):

* ``prompt`` / ``output``: ``{"dist": "uniform" | "log_uniform", "lo", "hi"}``
  in tokens, both ends included;
* ``requests``: how many requests the list holds (enough for the window
  and what follows it);
* closed loop: ``clients``, each sending its next request when its last
  one has finished; the first round's outputs are spread evenly over
  [2, output hi], so that the slots do not all finish together;
* open loop: ``rate`` (requests a second), ``arrival`` ("poisson"),
  ``block`` (requests a block: about the window's) and ``order`` (the
  seed of the blocks' order, fixed in the mix);
* ``slots``, ``pool``: the engine's sequence slots and KV pool;
* ``trace_steps``: engine steps of a traced run's profiled stretch;
* ``check``: ``{"requests": n}``, how many finished requests the
  comparison with the reference samples;
* ``smoke``: keys that replace these for the CPU rehearsal.
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np


def load(path: Path, smoke: bool = False) -> Dict:
    """The mix at ``path``; with ``smoke`` its ``smoke`` keys laid over it."""
    mix = json.loads(Path(path).read_text())
    if smoke:
        mix = {**mix, **mix.get("smoke", {})}
    mix.pop("smoke", None)
    return mix


def _quantile(spec: Dict, u: float) -> int:
    lo, hi = spec["lo"], spec["hi"]
    if spec["dist"] == "uniform":
        x = lo + u * (hi - lo)
    elif spec["dist"] == "log_uniform":
        x = math.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    else:
        raise ValueError(f"unknown distribution {spec['dist']!r}")
    return int(min(hi, max(lo, round(x))))


#: the steps of the closed loop's sequences: prompts, outputs
GOLDEN, SQRT2 = (math.sqrt(5) - 1) / 2, math.sqrt(2) - 1


def sequence(n: int, step: float) -> List[float]:
    """frac(0.5 + k * step) for k < n: points in (0, 1) that spread evenly
    over every prefix."""
    return [(0.5 + k * step) % 1.0 for k in range(n)]


def midpoints(n: int) -> np.ndarray:
    """The midpoints of ``n`` strata of equal probability in (0, 1)."""
    return (np.arange(n) + 0.5) / n


def exponential_means(n: int) -> np.ndarray:
    """The mean of an exponential of mean 1 within each of ``n`` strata of
    equal probability: they average to 1 exactly."""
    p = np.arange(n + 1) / n
    x = -np.log1p(-p[:-1])
    # (x + 1) e^-x is the integral of t e^-t from x on; it is 0 at the top
    tail = np.append((x + 1) * (1 - p[:-1]), 0.0)
    return (tail[:-1] - tail[1:]) * n


def shuffled(values: np.ndarray, n: int, rng: np.random.Generator) -> List[float]:
    """``n`` values: blocks of ``values``, each in an order drawn from ``rng``."""
    out: List[float] = []
    while len(out) < n:
        out += values[rng.permutation(len(values))].tolist()
    return out[:n]


@dataclasses.dataclass
class Plan:
    """What a run sends: ``requests`` (prompt tokens, max new tokens) in
    the order they are sent; ``warmup`` the set-up's requests; ``offsets``
    the open loop's due times in seconds from the window's start."""
    requests: List[Tuple[List[int], int]]
    warmup: List[Tuple[List[int], int]]
    offsets: List[float]


def plan(mix: Dict, seed: int, vocab_size: int) -> Plan:
    rng = np.random.default_rng(seed)
    n = mix["requests"]
    if mix["kind"] == "open":
        order = np.random.default_rng(mix["order"])
        u_prompt = shuffled(midpoints(mix["block"]), n, order)
        u_output = shuffled(midpoints(mix["block"]), n, order)
    else:
        u_prompt, u_output = sequence(n, GOLDEN), sequence(n, SQRT2)
    prompts = [_quantile(mix["prompt"], u) for u in u_prompt]
    outputs = [_quantile(mix["output"], u) for u in u_output]

    def tokens(k: int) -> List[int]:
        return rng.integers(0, vocab_size, int(k)).tolist()

    slots = mix["slots"]
    out_hi = mix["output"]["hi"]
    if mix["kind"] == "closed":
        c = mix["clients"]
        # in flight as the window opens: prompts from the shortest to the
        # longest, outputs spread over [2, output hi], in the sequences' order
        first_p = [_quantile(mix["prompt"], u) for u in sequence(c, GOLDEN)]
        first_p[0], first_p[1] = mix["prompt"]["lo"], mix["prompt"]["hi"]
        first_o = [round(2 + u * (out_hi - 2)) for u in sequence(c, SQRT2)]
        warmup = [(tokens(p), int(o)) for p, o in zip(first_p, first_o)]
        warmup = [warmup[i] for i in rng.permutation(c)]
        offsets: List[float] = []
    elif mix["kind"] == "open":
        # one request a slot, finishing one a step, so every batch size from
        # the slots down to one is captured; the longest prompt is among them
        lens = [mix["prompt"]["hi"]] + [mix["prompt"]["lo"]] * (slots - 1)
        warmup = [(tokens(p), 2 + i) for i, p in enumerate(lens)]
        if mix["arrival"] != "poisson":
            raise ValueError(f"unknown arrival process {mix['arrival']!r}")
        gaps = shuffled(exponential_means(mix["block"]) / mix["rate"], n, order)
        offsets = np.cumsum(gaps).tolist()
    else:
        raise ValueError(f"unknown traffic kind {mix['kind']!r}")
    requests = [(tokens(p), int(o)) for p, o in zip(prompts, outputs)]
    return Plan(requests=requests, warmup=warmup, offsets=offsets)
