"""prefill_mfu.long: model flops of the window's prefills
(``flops.prefill_flops``: weights for every prompt token, causal attention,
the last position's head) over the card's bf16 peak and the prefills'
summed host time, in % (traced run)."""
from portbench import peaks


def read(ctx):
    o = ctx.obs
    t = sum(o.spans.get("prefill", []))
    return 100.0 * o.prefill_flops / peaks.BF16_FLOPS / t if t > 0 else None
