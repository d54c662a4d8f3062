"""mfu.decode: model flops of the window's decoded tokens (weights and the
attention over each token's context, ``flops.decode_token_flops``) over
the card's bf16 peak and the window's seconds, in % (traced run)."""
from portbench import peaks


def read(ctx):
    o = ctx.obs
    if not o.decode_flops or o.window_s <= 0:
        return None
    return 100.0 * o.decode_flops / peaks.BF16_FLOPS / o.window_s
