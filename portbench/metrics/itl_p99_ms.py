"""itl_p99_ms: the 99th percentile of every gap between two consecutive
tokens of every request due in the window (host clock; two tokens that
reach the client with the same step are 0 apart).  The gaps have two
modes: a decode step (about 20 ms) and a step that also prefills someone's
prompt (100-400 ms), about one gap in sixteen at this load; the 95th
percentile sits on the edge between them and jumps from one to the other,
the 99th lies inside the second, with some forty gaps beyond it."""
from portbench.stats import percentile


def read(ctx):
    gaps = [(b - a) * 1e3 for r in ctx.obs.records if r.in_window
            for a, b in zip(r.times, r.times[1:])]
    return percentile(gaps, 99) if gaps else None
