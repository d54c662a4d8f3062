"""The paper's own evaluated substrate: Ambit/RowClone PUD over an 8 GB
DDR system — not an LM; selected by the PUD micro-benchmarks.

``PumaPaperConfig`` exposes the DRAM organization — including the channel
and bank counts the channel-parallel executor scales over — as plain config
fields with the paper's defaults (one channel/rank of x64 devices,
8 banks x 1024 subarrays x 1024 rows x 1 KB rows = 8 GB).  The fields are
validated against :class:`~repro_torch.core.dram.DramGeometry` *and* both
interleave schemes at construction, so a bad channel/bank count fails with
a clear error here instead of silently mis-decoding addresses later.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.dram import (
    AddressMap,
    BANK_REGION_SCHEME,
    CACHELINE_INTERLEAVED_SCHEME,
    DramGeometry,
)

__all__ = ["PumaPaperConfig", "CONFIG"]


@dataclasses.dataclass(frozen=True)
class PumaPaperConfig:
    """DRAM organization knobs (paper §2(i) platform information)."""

    channels: int = 1
    ranks_per_channel: int = 1
    banks_per_rank: int = 8
    subarrays_per_bank: int = 1024
    rows_per_subarray: int = 1024       # paper footnote 1
    row_bytes_per_chip: int = 1024      # 1024 columns x 8 bits
    chips_per_rank: int = 1

    def geometry(self) -> DramGeometry:
        """The validated :class:`DramGeometry` for these fields."""
        return DramGeometry(**dataclasses.asdict(self))

    def address_map(self, scheme=None) -> AddressMap:
        return AddressMap(self.geometry(), scheme)

    def __post_init__(self):
        # Validate eagerly: every field must be a power of two (DramGeometry
        # checks that) and both interleave schemes must cover the resulting
        # address space exactly (AddressMap checks the bit budget).  A
        # mistyped channel/bank count dies here with the offending field
        # named, not later as a silent mis-decode.
        try:
            geo = self.geometry()
            for scheme in (BANK_REGION_SCHEME, CACHELINE_INTERLEAVED_SCHEME):
                AddressMap(geo, scheme)
        except (ValueError, AssertionError) as e:
            raise ValueError(
                f"invalid PUMA DRAM configuration {dataclasses.asdict(self)}: {e}"
            ) from e


CONFIG = PumaPaperConfig()
