"""How a serving cell's ``correct`` is decided.

Once the window has closed and the program's state is freed, a sample of
the finished requests, drawn from the seed and always holding the one with
most served tokens, is run through the reference that the configuration
names (``reference/<arch.reference>.py``, ``reference/model.py`` where it
names none; its ``logits``): one forward pass over each prompt and its
served tokens.  At each position
that produced a served token, the gap is how far that token's reference
logit lies below the reference's best; the number compared is the widest
gap over the sample (``logit_gap``).  Greedy decoding makes the served
token the program's own best, so the gap is zero wherever the two agree on
the order of the top logits and small where rounding swaps a near tie.

Besides: every request sent in the window has an answer (``failed``), and
every sampled answer has the length asked for (``short``).  Each number
has its limit in ``limits/<cell>.json``.

``control`` (off in a benchmark run) also runs the control: the same
reference rounded through float8 e4m3 at every product, reading the gap of
the token it puts first at the same positions (``control_gap``).

A training cell's numbers (``train_gaps``) come from ``reference/train.py``,
which runs the same configuration's reference.
"""
from __future__ import annotations

import statistics
import sys
import time
from typing import Dict, List

import numpy as np

from portbench import reference
from portbench.reference import model as ref_model


def sample(records, seed: int, k: int) -> List:
    """``k`` finished requests: the one with most served tokens, and the
    rest drawn from ``seed``."""
    done = [r for r in records if r.done]
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.req.out), len(r.prompt), -r.rid))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng([int(seed), 1])
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(pick.tolist())]


def compare(weights: Dict, arch, sampled, *, control: bool = False) -> Dict:
    """The reference's readings over ``sampled`` (see the module's text)."""
    ref_mod = reference.module(arch.reference)
    gaps: List[float] = []
    cgaps: List[float] = []
    short = 0
    t0 = time.perf_counter()
    for r in sampled:
        out = list(r.req.out)
        short += len(out) != r.max_new
        tokens = list(r.prompt) + out[:-1]
        rows = range(len(r.prompt) - 1, len(tokens))
        ref = ref_mod.logits(weights, arch, tokens, rows)
        gaps += ref_model.served_gaps(ref, out)
        if control:
            low = ref_mod.logits(weights, arch, tokens, rows, precision="fp8")
            cgaps += ref_model.control_gaps(ref, low)
    readings = {
        "logit_gap": max(gaps) if gaps else float("inf"),
        "short": short,
        "sampled_requests": len(sampled),
        "sampled_tokens": len(gaps),
        "reference_s": time.perf_counter() - t0,
    }
    if control:
        readings["control_gap"] = max(cgaps) if cgaps else None
    return readings


def train_gaps(got: Dict, ref: Dict) -> Dict:
    """A training cell's numbers against the reference ``ref``.  For each
    leaf, the gap between the program's norm and the reference's, over the
    larger of the reference's norm of that leaf and of the median leaf.
    Leaves whose reference gradient is under a thousandth of the median
    leaf's are left out: they move by round-off alone.  ``grad_gap``: the
    first gradient as AdamW takes it, at the worst leaf; ``grad_gap_large``:
    the same at the worst of the leaves whose reference gradient is at
    least the median leaf's, which leaves out the one leaf whose sum over
    the batch's rows in bf16 sets ``grad_gap`` (``layers.ln1.bias``), so
    that it is steady enough to separate the float8 control; ``change_gap``:
    the change over the steps, at the worst leaf.  Also read, not compared:
    the relative gap of the first step's loss and the largest over the
    steps."""
    loss = [abs(g - r) / abs(r) for g, r in zip(got["loss"], ref["loss"])]
    med_g = statistics.median(ref["grad"].values())
    moved = [n for n, r in ref["grad"].items() if r >= 1e-3 * med_g]
    grad = {n: abs(got["grad"][n] - ref["grad"][n]) / max(ref["grad"][n], med_g)
            for n in moved}
    large = {n: g for n, g in grad.items() if ref["grad"][n] >= med_g}
    med_c = statistics.median(ref["change"][n] for n in moved)
    change = {n: abs(got["change"][n] - ref["change"][n]) / max(ref["change"][n], med_c)
              for n in moved}
    return {"grad_gap": max(grad.values()), "grad_gap_large": max(large.values()),
            "change_gap": max(change.values()),
            "loss1_gap": loss[0], "loss_gap": max(loss),
            "worst_grad_leaf": max(grad, key=grad.get),
            "worst_change_leaf": max(change, key=change.get)}


def verdict(readings: Dict, failed: int, limits: Dict) -> Dict:
    """Each compared number beside its limit."""
    return {
        "logit_gap": {"value": readings["logit_gap"], "limit": limits["logit_gap"]},
        "failed": {"value": failed, "limit": 0},
        "short": {"value": readings["short"], "limit": 0},
    }


def correct(checks: Dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def print_checks(checks: Dict) -> None:
    """The compared numbers, each beside its limit, as the last lines on
    standard error."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
