"""decode_step_ms.decode: mean host time of the window's engine steps that
admitted no request, each ``ServeEngine.step()`` and a ``synchronize``
(harness clock, traced run)."""


def read(ctx):
    steps = ctx.obs.spans.get("step_no_admit", [])
    return sum(steps) / len(steps) * 1e3 if steps else None
