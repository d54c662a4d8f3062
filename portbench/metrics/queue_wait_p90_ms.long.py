"""queue_wait_p90_ms.long: the 90th percentile, over every request due in
the window, of its wait in the engine's queue: from ``ServeEngine.submit``
to its first admission, by the program's host stamps on each request
(``t_submit``, ``t_admit``).  A request never admitted waits until the end
of the wait for answers."""
from portbench.stats import percentile


def read(ctx):
    recs = [r for r in ctx.obs.records if r.in_window]
    if not recs or any(getattr(r.req, "t_submit", None) is None for r in recs):
        return None
    end = ctx.obs.end * 1e9
    waits = [((r.req.t_admit if r.req.t_admit is not None else end) - r.req.t_submit) / 1e6
             for r in recs]
    return percentile(waits, 90)
