"""kv_write_host_ms.decode: host ms a step in the engine's token K/V writes,
by the program's own spans: the ``engine.kv_write`` sum on each of the
window's ``engine.step`` spans that admitted no request, averaged (traced
run)."""


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
    steps = [t[0] for t in window(ctx.obs.steps) if not t[0].attrs.get("admitted")]
    return (sum(s.attrs.get("engine.kv_write", 0) for s in steps) / len(steps) / 1e6
            if steps else None)
