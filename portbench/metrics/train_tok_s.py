"""train_tok_s: tokens the window's train steps took (every step's batch x
sequence), over the window's seconds (host clock, a ``synchronize`` after
each step)."""


def read(ctx):
    o = ctx.obs
    return o.window_tokens / o.window_s if o.window_s > 0 and o.window_tokens else None
