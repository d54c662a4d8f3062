"""prefill_ms_per_ktok.long: host time of the engine's prefills in the
window (each ``ServeEngine._prefill`` ending in a ``synchronize``), over the
prompt tokens they filled, per thousand tokens (traced run)."""


def read(ctx):
    o = ctx.obs
    spans = o.spans.get("prefill", [])
    return sum(spans) / o.prefill_tokens * 1e6 if spans and o.prefill_tokens else None
