"""decode_device_ms.decode: device ms a step of the decode call (staging and
graph replay), by the CUDA events of the program's ``engine.decode`` spans,
over the window's steps that admitted no request (traced run; none on the
CPU)."""


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
    got = [s.device_ns for t in window(ctx.obs.steps) if not t[0].attrs.get("admitted")
           for s in t[1:] if s.name == "engine.decode"]
    if not got or None in got:
        return None
    return sum(got) / len(got) / 1e6
