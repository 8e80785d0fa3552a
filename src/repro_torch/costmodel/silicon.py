"""Silicon + packaging cost model (paper §IV-C): Murphy yield, die cost,
interposer/substrate/bonding, HBM pricing. Decoupled from simulation so cost
can be re-priced post-run (the paper's stated design)."""
from __future__ import annotations

import math
from dataclasses import dataclass

from .params import MEM, SILICON, SiliconModel


def murphy_yield(area_mm2: float, defects_per_mm2: float) -> float:
    """Murphy's model: Y = ((1 - e^-AD) / (AD))^2."""
    ad = area_mm2 * defects_per_mm2
    if ad <= 0:
        return 1.0
    return ((1 - math.exp(-ad)) / ad) ** 2


def gross_dies_per_wafer(area_mm2: float, s: SiliconModel = SILICON) -> int:
    """Accounting for scribe lines and edge loss."""
    side = math.sqrt(area_mm2) + s.scribe_mm
    d = s.wafer_diameter_mm - 2 * s.edge_loss_mm
    # standard die-per-wafer estimate
    return int(math.pi * (d / 2) ** 2 / (side * side)
               - math.pi * d / math.sqrt(2 * side * side))


def die_cost_usd(area_mm2: float, s: SiliconModel = SILICON) -> float:
    gross = max(gross_dies_per_wafer(area_mm2, s), 1)
    good = max(gross * murphy_yield(area_mm2, s.defects_per_mm2), 1e-6)
    return s.wafer_cost_usd / good


def dcra_die_area_mm2(tiles: int, sram_kb_per_tile: int,
                      pus_per_tile: int = 1, noc_width_bits: int = 64,
                      freq_ghz: float = 1.0, s: SiliconModel = SILICON
                      ) -> float:
    """Area of one DCRA chiplet (tiles x (PU + SRAM + router) + PHY)."""
    sram_mm2 = (sram_kb_per_tile / 1024) / MEM.sram_density_mb_mm2
    pu_mm2 = s.pu_area_mm2 * pus_per_tile * (1.5 if freq_ghz > 1.0 else 1.0)
    router_mm2 = s.router_area_mm2 * (noc_width_bits / 64.0) * \
        (2.0 if freq_ghz > 1.0 else 1.0)
    return tiles * (sram_mm2 + pu_mm2 + router_mm2) + s.phy_area_mm2_per_die


@dataclass
class PackageCost:
    dcra_dies_usd: float
    hbm_usd: float
    interposer_usd: float
    substrate_usd: float
    bonding_usd: float

    @property
    def total(self) -> float:
        return (self.dcra_dies_usd + self.hbm_usd + self.interposer_usd
                + self.substrate_usd + self.bonding_usd)


def package_cost(n_dcra_dies: int, die_area_mm2: float,
                 hbm_gb_total: float, s: SiliconModel = SILICON
                 ) -> PackageCost:
    die_usd = die_cost_usd(die_area_mm2, s)
    dies = n_dcra_dies * die_usd
    hbm = hbm_gb_total * s.hbm_usd_per_gb
    # interposer only where HBM is bonded to a DCRA die (per HBM stack)
    n_hbm_stacks = hbm_gb_total / 8.0
    interposer = n_hbm_stacks * s.interposer_cost_frac * die_usd
    substrate = n_dcra_dies * s.substrate_cost_frac * die_usd
    bonding = s.bonding_overhead_frac * (dies + hbm + interposer + substrate)
    return PackageCost(dies, hbm, interposer, substrate, bonding)


def monolithic_wafer_cost(s: SiliconModel = SILICON) -> float:
    """Dalorex-style wafer-scale: one chip per wafer (paper §V-D)."""
    return s.wafer_cost_usd  # yield-insensitive comparison per the paper
