"""Table III constants + silicon-economics parameters (paper §IV-B/C):
the modelled DCRA chiplet, copied unchanged from ``repro/costmodel/
params.py``. The reference's roofline constants of its accelerator are
not copied: they describe no part of the DCRA model, and the port's
roofline, when it comes, carries the NVIDIA H100's own figures."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class MemoryModel:
    sram_density_mb_mm2: float = 3.5          # [89]
    sram_rw_latency_ns: float = 0.82
    sram_read_pj_bit: float = 0.18
    sram_write_pj_bit: float = 0.28
    cache_tag_pj: float = 6.3                  # read + compare [89][90]
    hbm_density_gb_mm2: float = 8.0 / 110.0    # 8GB / 110 mm^2 [46]
    hbm_channels: int = 8
    hbm_gbps_per_channel: float = 64.0
    hbm_rw_latency_ns: float = 50.0
    hbm_pj_bit: float = 3.7                    # [36][67]
    refresh_period_ms: float = 32.0
    refresh_pj_bit: float = 0.22


@dataclass(frozen=True)
class LinkModel:
    mcm_phy_areal_gbit_mm2: float = 690.0      # [6]
    mcm_phy_beach_gbit_mm: float = 880.0
    interposer_areal_gbit_mm2: float = 1070.0
    interposer_beach_gbit_mm: float = 1780.0
    d2d_latency_ns: float = 4.0                # <25mm [61]
    d2d_pj_bit: float = 0.55
    noc_wire_ps_mm: float = 50.0               # [38]
    noc_wire_pj_bit_mm: float = 0.15
    noc_router_latency_ps: float = 500.0
    noc_router_pj_bit: float = 0.1
    io_die_rxtx_latency_ns: float = 20.0       # PCIe 6.0 [76]
    off_package_pj_bit: float = 1.17           # up to 80mm [88]
    tile_pitch_mm: float = 0.75                # wire length per NoC hop


@dataclass(frozen=True)
class SiliconModel:
    wafer_cost_usd: float = 6047.0             # 300mm 7nm [32]
    wafer_diameter_mm: float = 300.0
    scribe_mm: float = 0.2
    edge_loss_mm: float = 4.0
    # the paper quotes "0.07 defects per mm^2" — industry convention (and the
    # only value consistent with the paper's own "255mm^2 die still achieves
    # good yield" claim) is per *cm^2*; stored here in per-mm^2 units.
    defects_per_mm2: float = 0.0007            # = 0.07 / cm^2, Murphy model
    interposer_cost_frac: float = 0.20         # of DCRA die price [85]
    substrate_cost_frac: float = 0.10
    bonding_overhead_frac: float = 0.05        # [45][80]
    hbm_usd_per_gb: float = 7.5                # educated guess (§IV-C)
    # area model (7nm): PU tile logic + router + PHY
    pu_area_mm2: float = 0.05                  # tiny in-order core
    router_area_mm2: float = 0.03
    phy_area_mm2_per_die: float = 20.0         # beachfront PHY share


@dataclass(frozen=True)
class ComputeModel:
    pu_freq_ghz: float = 1.0
    instr_per_cycle: float = 1.0               # paper §IV-B assumption
    pu_active_pj_instr: float = 5.0            # in-order RISC-V class [90]
    pu_idle_w: float = 0.0                     # clock-gated when no tasks


MEM = MemoryModel()
LINK = LinkModel()
SILICON = SiliconModel()
COMPUTE = ComputeModel()
