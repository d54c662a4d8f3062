"""Published peaks of the card the cells run on (NVIDIA H100 SXM data sheet,
dense rates without sparsity, at the 700 W power limit)."""

BF16_FLOPS = 989e12        # bf16 tensor cores
HBM_BYTES_PER_S = 3.35e12  # HBM3
