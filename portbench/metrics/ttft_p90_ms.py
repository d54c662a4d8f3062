"""ttft_p90_ms: the 90th percentile, over every request due in the window,
of the time from its due time to its first token (host clock).  A request
that failed counts with the time from its due time to the end of the wait
for answers, so it lies beyond every answered one.  The 90th and not the
95th: a window holds about a hundred requests at this load, and the 90th
is the highest percentile with ten beyond it."""
from portbench.stats import percentile


def read(ctx):
    recs = [r for r in ctx.obs.records if r.in_window]
    if not recs:
        return None
    vals = [((r.times[0] if r.times and not r.failed else ctx.obs.end) - r.due) * 1e3
            for r in recs]
    return percentile(vals, 90)
