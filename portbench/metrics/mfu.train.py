"""mfu.train: model flops of the window's train steps
(``flops.train_step_flops``: three times the forward's weights, head and
causal attention, without rematerialisation's recompute) over the card's
bf16 peak and the window's seconds, in %."""
from portbench import peaks


def read(ctx):
    o = ctx.obs
    return 100.0 * o.train_flops / peaks.BF16_FLOPS / o.window_s if o.train_flops else None
