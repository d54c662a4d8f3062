"""out_tok_s: output tokens that reached their clients during the window,
over the window's seconds (host clock; every step of the window, prefills
included)."""


def read(ctx):
    o = ctx.obs
    return o.window_tokens / o.window_s if o.window_s > 0 else None
