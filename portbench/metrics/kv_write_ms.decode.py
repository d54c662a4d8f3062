"""kv_write_ms.decode: host time the engine spends in its pool's
``write_token_kv`` a decode step, summed over the window and divided by the
window's decode steps (harness clock around each call, traced run)."""


def read(ctx):
    writes, steps = ctx.obs.spans.get("kv_write", []), ctx.obs.decode_steps
    return sum(writes) / steps * 1e3 if writes and steps else None
