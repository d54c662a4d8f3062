"""DRAM geometry, address interleaving, and physical-address decoding.

This module models the information PUMA obtains from the platform:

  (i)  the DRAM organization (row/column/bank/subarray sizes) — paper §2(i);
  (ii) the DRAM interleaving scheme, i.e. which physical-address bits select
       channel / rank / bank / row / column, optionally XOR-folded — the
       paper obtains this from an open-firmware device tree (§2(ii)) or by
       reverse engineering (RowHammer-RE literature [143-145]).

Terminology (paper footnote 1): a typical subarray has 1024 rows of 1024
columns per chip => 1 MB per subarray per chip.  At *rank* level (the
granularity the memory controller reads/writes), one logical "row" spans all
chips sharing a chip-select: with 8 x8 chips, a rank-row is 8 KB.  PUMA's
"memory region" is one rank-row — the granularity at which PUD operands must
be aligned and co-located.

Two interleaving schemes are provided:

* ``BANK_REGION_SCHEME`` (default — the paper's abstraction): consecutive
  physical addresses fill a whole row, then consecutive rows of the same
  bank, then banks/ranks/channels.  An aligned rank-row-sized PA chunk maps
  to exactly one (channel, rank, bank, subarray) — the global subarray ID is
  the concatenation ("OR of mask bits", §2) of those fields.

* ``CACHELINE_INTERLEAVED_SCHEME``: the common performance policy that
  stripes consecutive cache lines across channels and banks.  Here an
  aligned region is a *stripe* across banks at one row index; operands at
  equal region offsets still land in the same (channel, bank, column)
  byte-for-byte, so PUD executability reduces to matching subarray stripes.
  The same decode logic covers it because region bases zero the low
  channel/bank fields.

Decode fast path
----------------

``AddressMap`` precomputes every field's shift and mask at construction, so
scalar :meth:`AddressMap.decode` is straight bit arithmetic and
:meth:`AddressMap.region_subarrays` decodes a whole ``np.ndarray`` of
physical addresses with a handful of vectorized bit operations — the
translation layer the PUD planner, the PUMA pre-allocator, and the
benchmarks all batch through.  :meth:`AddressMap.region_subarray_table`
additionally memoizes the full region→global-subarray map (one ``int32``
per region, built lazily on first use) for O(1) repeated scalar lookups.
The scalar :meth:`AddressMap.region_subarray` keeps the original
one-address-at-a-time decode; property tests assert the two paths agree
under every interleave scheme.

Channel view
------------

The PUD executor is channel-parallel (one memory controller per channel,
HBM-PIM style — see :mod:`repro_torch.core.controller`), so the decode layer also
exposes the *channel* structure of the global-subarray space:

* :meth:`AddressMap.region_coords` — one vectorized pass producing the
  ``(channel, rank, bank, subarray)`` arrays for a batch of region PAs;
* :meth:`AddressMap.region_channels` — just the owning-channel array;
* :meth:`AddressMap.channel_of_subarray` — recover the channel from a
  global subarray ID without re-decoding.  The global ID is built
  channel-innermost (``((sa·B + bank)·R + rank)·C + channel``), so the
  channel is simply ``gsa % channels`` — scalar ints and numpy arrays both
  work.

Under ``BANK_REGION_SCHEME`` every region is owned by exactly one channel
and the PUD executor can run regions of different channels concurrently.
Under ``CACHELINE_INTERLEAVED_SCHEME`` a region *is* a stripe across all
channels (the channel bits sit below the region boundary and decode to 0),
so each row op already engages every channel at once and the partitioned
executor degenerates to the single-queue model — exactly the hardware
behaviour.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

__all__ = [
    "DramGeometry",
    "InterleaveScheme",
    "DramCoord",
    "AddressMap",
    "DEFAULT_GEOMETRY",
    "BANK_REGION_SCHEME",
    "CACHELINE_INTERLEAVED_SCHEME",
    "default_map",
]


def _is_pow2(x: int) -> bool:
    return x > 0 and (x & (x - 1)) == 0


def _log2(x: int) -> int:
    assert _is_pow2(x), f"{x} is not a power of two"
    return x.bit_length() - 1


@dataclasses.dataclass(frozen=True)
class DramGeometry:
    """Physical organization of the DRAM devices behind one memory node.

    Defaults follow the paper's evaluated system: 8 GB total, and footnote 1's
    "typical subarray" of 1024 rows x 1024 columns = 1 MB.  (The QEMU RISC-V
    target is modeled as one channel / one rank of x64 devices, so the
    chip-level and rank-level row coincide at 1 KB.)
    """

    channels: int = 1
    ranks_per_channel: int = 1
    banks_per_rank: int = 8
    subarrays_per_bank: int = 1024
    rows_per_subarray: int = 1024       # paper footnote 1
    row_bytes_per_chip: int = 1024      # 1024 columns x 8 bits (paper fn. 1)
    chips_per_rank: int = 1

    @property
    def row_bytes(self) -> int:
        """Rank-level row size = PUMA memory-region size (8 KB default)."""
        return self.row_bytes_per_chip * self.chips_per_rank

    @property
    def rows_per_bank(self) -> int:
        return self.subarrays_per_bank * self.rows_per_subarray

    @property
    def subarray_bytes(self) -> int:
        """Rank-level bytes held by one subarray (1 MB/chip x 8 chips)."""
        return self.rows_per_subarray * self.row_bytes

    @property
    def bank_bytes(self) -> int:
        return self.subarrays_per_bank * self.subarray_bytes

    @property
    def total_bytes(self) -> int:
        return (
            self.channels
            * self.ranks_per_channel
            * self.banks_per_rank
            * self.bank_bytes
        )

    @property
    def num_global_subarrays(self) -> int:
        return (
            self.channels
            * self.ranks_per_channel
            * self.banks_per_rank
            * self.subarrays_per_bank
        )

    @property
    def banks_per_channel(self) -> int:
        """Banks one channel's controller schedules across (rank x bank)."""
        return self.ranks_per_channel * self.banks_per_rank

    @property
    def subarrays_per_channel(self) -> int:
        """Global subarrays owned by one channel's controller."""
        return self.num_global_subarrays // self.channels

    @property
    def channel_bytes(self) -> int:
        return self.total_bytes // self.channels

    def __post_init__(self):
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if not _is_pow2(v):
                raise ValueError(f"DramGeometry.{f.name}={v} must be a power of 2")


@dataclasses.dataclass(frozen=True)
class DramCoord:
    channel: int
    rank: int
    bank: int
    subarray: int  # subarray index within the bank
    row: int       # row index within the subarray
    col: int       # byte offset within the rank-row

    def global_subarray(self, geo: DramGeometry) -> int:
        """Concatenated (channel, rank, bank, subarray) — the PUD locality unit.

        The paper builds this by OR-ing the masked channel/rank/bank/subarray
        bits of the physical address; since the fields occupy disjoint bit
        ranges this is exactly a concatenation.
        """
        g = self.subarray
        g = g * geo.banks_per_rank + self.bank
        g = g * geo.ranks_per_channel + self.rank
        g = g * geo.channels + self.channel
        return g


# Field names understood by InterleaveScheme.order, LSB -> MSB.
_FIELDS = ("col_lo", "col_hi", "channel", "bank", "rank", "row")


@dataclasses.dataclass(frozen=True)
class InterleaveScheme:
    """Which physical-address bit-fields select each DRAM coordinate.

    ``order`` lists fields from LSB to MSB.  ``row`` is the global row index
    within a bank; the subarray index is its high ``log2(subarrays_per_bank)``
    bits.  ``xor_row_into_bank`` models the common bank-XOR permutation
    (bank := bank_bits XOR low-row-bits) used by real controllers and
    recovered by RowHammer reverse-engineering; PUMA decodes through it.
    """

    order: Tuple[str, ...]
    col_lo_bytes: int = 64  # cache-line granule before the first split field
    xor_row_into_bank: bool = False

    def field_widths(self, geo: DramGeometry) -> List[Tuple[str, int]]:
        col_lo = min(self.col_lo_bytes, geo.row_bytes)
        widths = {
            "col_lo": _log2(col_lo),
            "col_hi": _log2(geo.row_bytes // col_lo),
            "channel": _log2(geo.channels),
            "bank": _log2(geo.banks_per_rank),
            "rank": _log2(geo.ranks_per_channel),
            "row": _log2(geo.rows_per_bank),
        }
        assert sorted(self.order) == sorted(_FIELDS), self.order
        return [(name, widths[name]) for name in self.order]


#: The paper's abstraction: rows of one bank are consecutive, so an aligned
#: rank-row chunk belongs to exactly one global subarray.
BANK_REGION_SCHEME = InterleaveScheme(
    order=("col_lo", "col_hi", "row", "bank", "rank", "channel")
)

#: Performance-oriented mapping: cache lines striped across channels/banks.
CACHELINE_INTERLEAVED_SCHEME = InterleaveScheme(
    order=("col_lo", "channel", "bank", "col_hi", "rank", "row")
)


class AddressMap:
    """Decodes physical addresses to DRAM coordinates under a scheme."""

    def __init__(self, geo: DramGeometry = None, scheme: InterleaveScheme = None):
        self.geo = geo or DEFAULT_GEOMETRY
        self.scheme = scheme or CACHELINE_INTERLEAVED_SCHEME
        self._fields = self.scheme.field_widths(self.geo)
        self._total_bits = sum(w for _, w in self._fields)
        if (1 << self._total_bits) != self.geo.total_bytes:
            raise ValueError(
                f"scheme covers 2^{self._total_bits} bytes but geometry has "
                f"{self.geo.total_bytes}"
            )
        # The PUD operand granularity: the smallest aligned PA chunk whose
        # bytes all share one row index — everything mapped below the row
        # field.  BANK_REGION: one rank-row.  CACHELINE_INTERLEAVED: the
        # row-*set* stripe (same row index across all banks/channels, which
        # the substrate operates bank-parallel).
        bits_below_row = 0
        for name, width in self._fields:
            if name == "row":
                break
            bits_below_row += width
        self._region_bytes = 1 << bits_below_row
        # Per-field shift/mask, computed once: decode becomes pure bit math.
        self._shifts = {}
        self._masks = {}
        shift = 0
        for name, width in self._fields:
            self._shifts[name] = shift
            self._masks[name] = (1 << width) - 1
            shift += width
        self._log_rows_per_sub = _log2(self.geo.rows_per_subarray)
        self._region_sa_table: Optional[np.ndarray] = None  # lazy memo

    @property
    def total_bytes(self) -> int:
        return self.geo.total_bytes

    def decode(self, pa: int) -> DramCoord:
        if not (0 <= pa < self.geo.total_bytes):
            raise ValueError(f"physical address {pa:#x} out of range")
        sh, mk = self._shifts, self._masks
        row_global = (pa >> sh["row"]) & mk["row"]
        bank = (pa >> sh["bank"]) & mk["bank"]
        if self.scheme.xor_row_into_bank:
            bank ^= row_global & (self.geo.banks_per_rank - 1)
        col = ((pa >> sh["col_lo"]) & mk["col_lo"]) | (
            ((pa >> sh["col_hi"]) & mk["col_hi"]) << mk["col_lo"].bit_length()
        )
        return DramCoord(
            channel=(pa >> sh["channel"]) & mk["channel"],
            rank=(pa >> sh["rank"]) & mk["rank"],
            bank=bank,
            subarray=row_global >> self._log_rows_per_sub,
            row=row_global & (self.geo.rows_per_subarray - 1),
            col=col,
        )

    # -- Region-level helpers (PUMA operates on rank-rows = memory regions) --

    @property
    def region_bytes(self) -> int:
        return self._region_bytes

    def region_is_aligned(self, pa: int) -> bool:
        """PUD operand rows must start exactly at a region boundary."""
        return pa % self._region_bytes == 0

    def region_subarray(self, pa: int) -> int:
        """Global subarray ID of the aligned region starting at ``pa``.

        For region-aligned bases the sub-region (column) fields are zero, so
        the decode yields the region's (channel, rank, bank, subarray) under
        BANK_REGION_SCHEME, and the subarray *stripe* under the cacheline-
        interleaved scheme — in both cases, equality of this ID across two
        aligned regions is exactly PUD operand compatibility.

        This is the scalar reference path (one full decode per call); batch
        callers should use :meth:`region_subarrays` and repeated scalar
        callers :meth:`region_subarray_table`.
        """
        return self.decode(pa).global_subarray(self.geo)

    def region_subarrays(self, pas: np.ndarray) -> np.ndarray:
        """Vectorized :meth:`region_subarray` over an array of addresses.

        Pure bit operations on int64 arrays — no per-element Python.  The
        inputs need not be region-aligned; sub-region bits are simply ignored
        (they sit below the row/bank/rank/channel fields by construction).
        """
        pas = np.asarray(pas, dtype=np.int64)
        geo = self.geo
        sh, mk = self._shifts, self._masks
        row = (pas >> sh["row"]) & mk["row"]
        bank = (pas >> sh["bank"]) & mk["bank"]
        if self.scheme.xor_row_into_bank:
            bank = bank ^ (row & (geo.banks_per_rank - 1))
        rank = (pas >> sh["rank"]) & mk["rank"]
        chan = (pas >> sh["channel"]) & mk["channel"]
        sa = row >> self._log_rows_per_sub
        g = (sa * geo.banks_per_rank + bank) * geo.ranks_per_channel + rank
        return g * geo.channels + chan

    def region_coords(
        self, pas: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Batch decode of ``(channel, rank, bank, subarray)`` per region PA.

        One vectorized pass (same bit-ops as :meth:`region_subarrays`, fields
        kept separate instead of concatenated) — the view the per-channel
        controllers and the channel-striping allocators consume.  Sub-region
        bits are ignored, so inputs need not be region-aligned.
        """
        pas = np.asarray(pas, dtype=np.int64)
        sh, mk = self._shifts, self._masks
        row = (pas >> sh["row"]) & mk["row"]
        bank = (pas >> sh["bank"]) & mk["bank"]
        if self.scheme.xor_row_into_bank:
            bank = bank ^ (row & (self.geo.banks_per_rank - 1))
        rank = (pas >> sh["rank"]) & mk["rank"]
        chan = (pas >> sh["channel"]) & mk["channel"]
        sa = row >> self._log_rows_per_sub
        return chan, rank, bank, sa

    def region_channels(self, pas: np.ndarray) -> np.ndarray:
        """Owning channel of each region PA (vectorized).

        Under BANK_REGION_SCHEME this is the single channel that executes
        PUD ops on the region; under CACHELINE_INTERLEAVED_SCHEME region
        bases zero the channel bits, so every region reports channel 0 — a
        region there is a stripe across *all* channels and the channel-
        partitioned executor collapses to one queue by construction.
        """
        pas = np.asarray(pas, dtype=np.int64)
        return (pas >> self._shifts["channel"]) & self._masks["channel"]

    def channel_of_subarray(self, gsa):
        """Channel owning a global subarray ID (scalar int or ndarray).

        ``DramCoord.global_subarray`` concatenates channel-innermost, so the
        channel is the low ``log2(channels)`` bits — no re-decode needed.
        """
        return gsa % self.geo.channels

    def region_subarray_table(self) -> np.ndarray:
        """Memoized region-index → global-subarray lookup (int32, lazy).

        Built once per ``AddressMap`` via the batch decode; indexing it with
        ``pa // region_bytes`` answers repeated scalar queries (e.g. PUMA's
        aligned-allocation hint walk) without re-decoding.
        """
        if self._region_sa_table is None:
            n = self.geo.total_bytes // self._region_bytes
            rpas = np.arange(n, dtype=np.int64) * self._region_bytes
            self._region_sa_table = self.region_subarrays(rpas).astype(np.int32)
        return self._region_sa_table

    def region_range(self, pa: int, nbytes: int) -> Tuple[np.ndarray, np.ndarray]:
        """Batch form of :meth:`regions_in_range`: ``(region_pas, subarrays)``
        as int64 arrays for every full region inside ``[pa, pa + nbytes)``."""
        rb = self._region_bytes
        first = -(-pa // rb)  # ceil
        last = (pa + nbytes) // rb
        if last <= first:
            empty = np.empty(0, dtype=np.int64)
            return empty, empty
        # the scalar path range-checked every decode; keep failing loudly
        # rather than letting the bit-ops alias out-of-range addresses
        if first < 0 or last * rb > self.geo.total_bytes:
            raise ValueError(
                f"region range [{pa:#x}, {pa + nbytes:#x}) exceeds "
                f"{self.geo.total_bytes:#x} bytes of physical memory"
            )
        rpas = np.arange(first, last, dtype=np.int64) * rb
        return rpas, self.region_subarrays(rpas)

    def regions_in_range(self, pa: int, nbytes: int) -> List[Tuple[int, int]]:
        """(region_pa, global_subarray) for every full region in [pa, pa+n)."""
        rpas, sas = self.region_range(pa, nbytes)
        return list(zip(rpas.tolist(), sas.tolist()))


DEFAULT_GEOMETRY = DramGeometry()


def default_map() -> AddressMap:
    return AddressMap(DEFAULT_GEOMETRY, CACHELINE_INTERLEAVED_SCHEME)
