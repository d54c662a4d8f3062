"""The traffic generator: a seed repeats its inputs, another seed draws
other tokens over the same sizes and arrivals."""
from pathlib import Path

import numpy as np
import pytest

from portbench import traffic

MIXES = Path(__file__).resolve().parents[1] / "traffic"
BIG_SEED = 2 ** 31 + 12345


@pytest.mark.parametrize("mix_name", ["decode_32", "long_prompt"])
def test_plan_repeats_and_differs(mix_name):
    mix = traffic.load(MIXES / f"{mix_name}.json", smoke=True)
    a = traffic.plan(mix, BIG_SEED, 500)
    b = traffic.plan(mix, BIG_SEED, 500)
    c = traffic.plan(mix, 7, 500)
    assert a == b
    assert [p for p, _ in a.requests] != [p for p, _ in c.requests]
    # the same sizes and arrivals in the same order, other token ids
    assert [(len(p), n) for p, n in a.requests] == [(len(p), n) for p, n in c.requests]
    assert a.offsets == c.offsets
    assert sorted((len(p), n) for p, n in a.warmup) == sorted((len(p), n) for p, n in c.warmup)
    assert all(0 <= t < 500 for p, _ in a.requests for t in p)


def test_lengths_stay_in_range():
    mix = traffic.load(MIXES / "decode_32.json")
    lo, hi = mix["prompt"]["lo"], mix["prompt"]["hi"]
    p = traffic.plan(mix, 1, 100)
    assert all(lo <= len(t) <= hi for t, _ in p.requests)
    assert all(mix["output"]["lo"] <= n <= mix["output"]["hi"] for _, n in p.requests)
    assert sorted(len(t) for t, _ in p.warmup)[0] == lo
    assert sorted(len(t) for t, _ in p.warmup)[-1] == hi


def test_every_prefix_covers_the_distribution():
    for step in (traffic.GOLDEN, traffic.SQRT2):
        u = traffic.sequence(1000, step)
        for n in (50, 100, 400):
            # each quarter of (0, 1) holds a quarter of any prefix, within 3 points
            for q in range(4):
                share = sum(q / 4 <= x < (q + 1) / 4 for x in u[:n]) / n
                assert abs(share - 0.25) <= 3 / n


def test_log_uniform_and_uniform_quantiles():
    uniform = {"dist": "uniform", "lo": 0, "hi": 100}
    assert [traffic._quantile(uniform, u) for u in (0.125, 0.375, 0.625, 0.875)] == [12, 38, 62, 88]
    # log-uniform over [1, 10000]: the median is 100
    assert traffic._quantile({"dist": "log_uniform", "lo": 1, "hi": 10000}, 0.5) == 100


def test_poisson_gaps_have_the_rate():
    mix = traffic.load(MIXES / "long_prompt.json")
    p = traffic.plan(dict(mix, requests=2000), 3, 100)
    b = mix["block"]
    # each block of requests spans block / rate seconds exactly
    ends = [0.0] + [p.offsets[k * b - 1] for k in range(1, 2000 // b + 1)]
    assert np.diff(ends) == pytest.approx([b / mix["rate"]] * (2000 // b), rel=1e-12)
    assert abs(traffic.exponential_means(b).mean() - 1.0) < 1e-12
    assert all(b > a for a, b in zip(p.offsets, p.offsets[1:]))


def test_open_loop_is_as_bursty_as_poisson():
    """Consecutive gaps (and prompt lengths) are not anti-correlated, and
    two short gaps in a row come as often as in a Poisson stream."""
    mix = traffic.load(MIXES / "long_prompt.json")
    n = 4000
    p = traffic.plan(dict(mix, requests=n), 1, 10)
    gaps = np.diff([0.0] + p.offsets) * mix["rate"]
    lens = np.array([len(t) for t, _ in p.requests], dtype=float)
    for x in (gaps, lens):
        assert abs(np.corrcoef(x[:-1], x[1:])[0, 1]) < 0.05
    short = gaps < -np.log(1 - 0.268)            # the shortest 26.8 % of exponential gaps
    pairs = np.mean(short[:-1] & short[1:])
    assert abs(pairs - 0.268 ** 2) < 0.02
    # another order gives other bursts over the same gaps
    q = traffic.plan(dict(mix, requests=n, order=mix["order"] + 1), 1, 10)
    assert q.offsets != p.offsets
    assert sorted(np.diff([0.0] + q.offsets)[:mix["block"]]) == \
        pytest.approx(sorted(np.diff([0.0] + p.offsets)[:mix["block"]]))


def test_open_warmup_covers_every_batch_size():
    mix = traffic.load(MIXES / "long_prompt.json")
    p = traffic.plan(mix, 1, 100)
    news = sorted(n for _, n in p.warmup)
    assert news == list(range(2, mix["slots"] + 2))
    assert max(len(t) for t, _ in p.warmup) == mix["prompt"]["hi"]
