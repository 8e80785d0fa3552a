"""Reconfigurable SRAM management model (paper §III-B).

The tile's SRAM serves as scratchpad and/or a direct-mapped cache backed by
the die's private HBM slice. We model the *hit rate* analytically from the
access structure the task model exposes (the paper's own simulator works at
the same level for energy):

* streaming arrays (CSR values / column indices, walked once per round in
  order) hit at ``1 - 1/elems_per_line`` — the next-line prefetcher (paper
  §III-B) pushes this to ~1 when enabled;
* irregularly indexed arrays (vertex state) behave like random access into
  the cached segment: hit rate ≈ min(1, cache_capacity / footprint) for a
  direct-mapped cache under uniform reuse (conflict misses folded into the
  capacity term — datasets are much larger than the cache).

Effective per-tile bandwidth (paper §V-B):
  BW_eff = SRAM_bw * hit + DRAM_bw_per_tile * (1 - hit)
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class SRAMConfig:
    kb_per_tile: int = 512            # Table II knob #3 (Fig. 5 sweeps it)
    line_bits: int = 512              # = DRAM controller bitline (§III-B)
    scratchpad_fraction: float = 0.25  # program + queues + pinned arrays
    prefetch: bool = True


@dataclass(frozen=True)
class DRAMConfig:
    present: bool = True               # packaging-time knob #6
    gb_per_die: float = 8.0            # HBM2E device per chiplet
    channels: int = 8
    gbps_per_channel: float = 64.0     # 8 x 64 GB/s (Table III)
    tiles_per_die: int = 1024          # 32x32 -> 128 tiles/channel


@dataclass
class CacheModel:
    sram: SRAMConfig
    dram: DRAMConfig

    # ---- capacity ------------------------------------------------------
    def cache_bytes(self) -> float:
        return self.sram.kb_per_tile * 1024 * (1 - self.sram.scratchpad_fraction)

    # ---- hit rates -------------------------------------------------------
    def stream_hit_rate(self, elem_bytes: int) -> float:
        per_line = (self.sram.line_bits // 8) / elem_bytes
        base = 1.0 - 1.0 / max(per_line, 1.0)
        return 1.0 - (1.0 - base) * (0.1 if self.sram.prefetch else 1.0)

    def random_hit_rate(self, footprint_bytes_per_tile: float) -> float:
        if not self.dram.present:
            return 1.0  # pure scratchpad: everything resident by construction
        cap = self.cache_bytes()
        if footprint_bytes_per_tile <= 0:
            return 1.0
        return min(1.0, cap / footprint_bytes_per_tile)

    def hit_rate(self, stream_bytes: float, random_bytes: float,
                 footprint_bytes_per_tile: float, elem_bytes: int = 8) -> float:
        """Weighted hit rate over the access mix of one round."""
        tot = stream_bytes + random_bytes
        if tot == 0:
            return 1.0
        return (self.stream_hit_rate(elem_bytes) * stream_bytes +
                self.random_hit_rate(footprint_bytes_per_tile) * random_bytes
                ) / tot

    # ---- bandwidth -------------------------------------------------------
    def sram_bw_bytes_per_ns(self) -> float:
        # 0.82ns access, line-width port (Table III)
        return (self.sram.line_bits / 8) / 0.82

    def dram_bw_per_tile_bytes_per_ns(self) -> float:
        if not self.dram.present:
            return 0.0
        total = self.dram.channels * self.dram.gbps_per_channel  # GB/s
        return total / self.dram.tiles_per_die                   # ~bytes/ns

    def effective_bw(self, hit: float) -> float:
        """bytes/ns per tile (paper §V-B formula)."""
        dram_bw = self.dram_bw_per_tile_bytes_per_ns()
        if not self.dram.present:
            return self.sram_bw_bytes_per_ns()
        return self.sram_bw_bytes_per_ns() * hit + dram_bw * (1 - hit)
