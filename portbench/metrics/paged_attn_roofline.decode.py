"""paged_attn_roofline.decode: the paged-attention kernel's share of its
byte bound in the profiled stretch: the bytes its calls need
(``flops.paged_call_bytes``: K/V pages of each sequence's cached tokens read
once, q, output, LSE, tables; one call a layer a decode step) over the
card's HBM rate, divided by the summed device time of the kernel's launches
(split, combine and group kernels), in %."""
from portbench import flops, peaks

KERNELS = ("paged_split_kernel", "paged_combine_kernel", "decode_kernel")


def read(ctx):
    prof = ctx.obs.profile
    if not prof or not prof["paged_lens"]:
        return None
    t = sum(s for name, s in prof["device_s"].items() if any(k in name for k in KERNELS))
    if t <= 0:
        return None
    bs = ctx.mix["pool"]["block_size"]
    need = sum(flops.paged_call_bytes(ctx.arch, lens, bs) for lens in prof["paged_lens"])
    return 100.0 * need * ctx.arch.n_layers / peaks.HBM_BYTES_PER_S / t
