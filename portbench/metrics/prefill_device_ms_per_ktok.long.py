"""prefill_device_ms_per_ktok.long: device ms of the window's prefills, by
the CUDA events of the program's ``engine.prefill`` spans, per thousand of
the tokens they filled (traced run; none on the CPU)."""


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
    got = [s for t in window(ctx.obs.steps) for s in t[1:] if s.name == "engine.prefill"]
    tokens = sum(s.attrs.get("tokens", 0) for s in got)
    if not tokens or any(s.device_ns is None for s in got):
        return None
    return sum(s.device_ns for s in got) / 1e6 / tokens * 1e3
