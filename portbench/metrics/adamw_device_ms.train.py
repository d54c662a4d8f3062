"""adamw_device_ms.train: device ms a train step in AdamW (its norm and clip
included), by the CUDA events of the program's ``train.optimizer`` spans,
over the window's steps, averaged (traced run; none on the CPU)."""


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
    steps = window(ctx.obs.steps)
    got = [s.device_ns for t in steps for s in t[1:] if s.name == "train.optimizer"]
    if not got or None in got:
        return None
    return sum(got) / len(steps) / 1e6
