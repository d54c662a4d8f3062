"""readback_ms.decode: host ms a step in the engine's read-back of the
sampled tokens (``argmax(...).cpu()``, where the host waits for the card),
by the program's ``engine.readback`` spans, over the window's steps that
admitted no request (traced run)."""


def window(n):
    """The window's steps: the `n` root spans the program recorded just before
    the first one it recorded under the profiler, each as [root, *descendants]
    (empty for a program without the recorder)."""
    try:
        from repro_torch.trace import spans
    except ImportError:
        return []
    trees = spans.trees()
    first = next((i for i, t in enumerate(trees) if t[0].profiled), None)
    return trees[first - n:first] if first is not None and 0 < n <= first else []


def read(ctx):
    got = [s.end - s.start for t in window(ctx.obs.steps) if not t[0].attrs.get("admitted")
           for s in t[1:] if s.name == "engine.readback"]
    return sum(got) / len(got) / 1e6 if got else None
