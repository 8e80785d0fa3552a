"""Declarative design space over DCRA's three configuration axes (§V–§VI).

A :class:`DesignPoint` is one fully-specified deployment:

* **pre-silicon** (fixed at die tapeout): tiles per die edge
  (``die_side``), NoC link width / frequency, SRAM per tile, PUs per tile;
* **package-time** (fixed at assembly): memory technology (pure-SRAM
  scratchpad vs HBM-backed cache, constants from
  :data:`repro_torch.costmodel.params.MEM`), DCRA dies per package;
* **compile-time** (free per launch): deployment grid (``grid_side`` —
  how many tiles the dataset is spread over), NoC topology (any of
  :data:`repro_torch.core.topology.TOPOLOGIES` — the software-reconfigurability
  claim), and input/output task-queue capacities (Table II knob #8).

A :class:`ConfigSpace` enumerates the cartesian product of per-axis value
tuples, filtered for geometric validity. Points convert losslessly to the
existing model types (``TileGrid`` / ``EngineConfig``) so the figure
benchmarks, the sweep CLI, and tests all share one code path.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from dataclasses import dataclass
from typing import Dict, Iterator, Tuple

from ..core.cache import DRAMConfig, SRAMConfig
from ..core.queues import QueueConfig
from ..core.task_engine import EngineConfig
from ..core.topology import TOPOLOGIES, TileGrid
from ..costmodel.params import MEM
from ..costmodel.silicon import PackageCost, dcra_die_area_mm2, package_cost

# Package-time memory technologies, parameterised from Table III (MEM).
# "sram": pure scratchpad (Dalorex-style, everything resident);
# "hbm":  per-die HBM device behind the reconfigurable SRAM cache.
MEM_TECHS: Dict[str, DRAMConfig] = {
    "sram": DRAMConfig(present=False),
    "hbm": DRAMConfig(present=True, channels=MEM.hbm_channels,
                      gbps_per_channel=MEM.hbm_gbps_per_channel),
}


@dataclass(frozen=True)
class DesignPoint:
    # ---- pre-silicon -----------------------------------------------------
    die_side: int = 16                 # tiles per die edge (die_side^2/die)
    noc_width_bits: int = 64
    noc_freq_ghz: float = 1.0
    sram_kb_per_tile: int = 512
    pus_per_tile: int = 1
    # ---- package-time ----------------------------------------------------
    mem_tech: str = "hbm"              # key into MEM_TECHS
    dies_per_package: int = 4
    # ---- compile-time ----------------------------------------------------
    grid_side: int = 32                # deployment: grid_side^2 tiles
    topology: str = "hier_torus"
    iq_capacity: int = 12              # per-channel input queue (tasks/round)
    oq_capacity: int = 12              # producer output queue (T3)
    # The MoE dispatch IQ knob (relative sizing: the
    # dispatch capacity factor IS the IQ axis, routed via QueueConfig).
    moe_capacity_factor: float = 1.25

    def __post_init__(self):
        if self.topology not in TOPOLOGIES:
            raise ValueError(f"unknown topology {self.topology!r}")
        if self.mem_tech not in MEM_TECHS:
            raise ValueError(f"unknown mem_tech {self.mem_tech!r}")

    # ---- conversions -----------------------------------------------------
    def grid(self) -> TileGrid:
        return TileGrid(self.grid_side, self.grid_side,
                        topology=self.topology,
                        die_rows=self.die_side, die_cols=self.die_side,
                        noc_width_bits=self.noc_width_bits,
                        noc_freq_ghz=self.noc_freq_ghz)

    def engine_config(self) -> EngineConfig:
        """The point as an ``EngineConfig``.

        ``QueueConfig`` is the single IQ source of truth: ``TaskEngine
        .route`` reads ``queues.channel_cap(task, ...)`` per round, so
        this point's ``iq_capacity`` bounds the analytic drop model
        directly — figure baselines are priced under bounded-IQ physics.
        """
        return EngineConfig(
            grid=self.grid(),
            queues=QueueConfig(default_iq=self.iq_capacity,
                               default_oq=self.oq_capacity,
                               oq_sizes={"T3": self.oq_capacity}),
            sram=SRAMConfig(kb_per_tile=self.sram_kb_per_tile),
            dram=MEM_TECHS[self.mem_tech],
            pus_per_tile=self.pus_per_tile)

    # ---- derived geometry / economics ------------------------------------
    @property
    def n_tiles(self) -> int:
        return self.grid_side ** 2

    @property
    def n_dies(self) -> int:
        return max(1, self.grid_side // self.die_side) ** 2

    @property
    def n_packages(self) -> int:
        return math.ceil(self.n_dies / self.dies_per_package)

    def die_area_mm2(self) -> float:
        return dcra_die_area_mm2(self.die_side ** 2, self.sram_kb_per_tile,
                                 self.pus_per_tile, self.noc_width_bits,
                                 self.noc_freq_ghz)

    def package_bill(self) -> PackageCost:
        """Cost of ONE (full) package at this point (the paper's $/package)."""
        dies = min(self.dies_per_package, self.n_dies)
        dram = MEM_TECHS[self.mem_tech]
        hbm_gb = dram.gb_per_die * dies if dram.present else 0.0
        return package_cost(dies, self.die_area_mm2(), hbm_gb)

    def moe_queues(self) -> QueueConfig:
        """The point's MoE dispatch sizing as a ``QueueConfig`` (pass to
        ``moe_dcra(..., queues=...)``) — same resolution path as the graph
        apps, no parallel capacity-factor knob."""
        return QueueConfig.for_moe_dispatch(self.moe_capacity_factor)

    def package_usd(self) -> float:
        return self.package_bill().total

    def system_usd(self) -> float:
        """Whole-deployment cost: packages are bought whole."""
        return self.package_usd() * self.n_packages

    # ---- identity / serialisation ----------------------------------------
    @property
    def stats_key(self) -> Tuple:
        """The sub-key that determines ``RunStats`` (routing is blind to
        link width/frequency, memory tech and OQ size — those only re-price
        the same task stream, the paper's decoupled-cost design)."""
        return (self.grid_side, self.die_side, self.topology,
                self.iq_capacity)

    @property
    def point_id(self) -> str:
        return (f"g{self.grid_side}_d{self.die_side}_{self.topology}"
                f"_w{self.noc_width_bits}_f{self.noc_freq_ghz:g}"
                f"_{self.mem_tech}_p{self.dies_per_package}"
                f"_s{self.sram_kb_per_tile}_iq{self.iq_capacity}"
                f"_oq{self.oq_capacity}_mcf{self.moe_capacity_factor:g}")

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "DesignPoint":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    def with_(self, **kw) -> "DesignPoint":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ConfigSpace:
    """Cartesian product of per-axis value tuples (invalid combos skipped).

    A combo is valid when the deployment grid tiles cleanly into dies
    (``grid_side % die_side == 0``); single-die deployments smaller than a
    die are allowed (``grid_side == die_side`` covers them).
    """
    # pre-silicon
    die_sides: Tuple[int, ...] = (16, 32)
    noc_width_bits: Tuple[int, ...] = (32, 64)
    noc_freq_ghz: Tuple[float, ...] = (1.0, 2.0)
    sram_kb_per_tile: Tuple[int, ...] = (512,)
    pus_per_tile: Tuple[int, ...] = (1,)
    # package-time
    mem_techs: Tuple[str, ...] = ("sram", "hbm")
    dies_per_package: Tuple[int, ...] = (4, 16)
    # compile-time
    grid_sides: Tuple[int, ...] = (32, 64)
    topologies: Tuple[str, ...] = TOPOLOGIES
    iq_capacities: Tuple[int, ...] = (12, 48)
    oq_capacities: Tuple[int, ...] = (12, 48)
    # MoE-only axis: consumed via DesignPoint.moe_queues() -> moe_dcra.
    # The graph-app Evaluator is blind to it, so widen this tuple only in
    # sweeps that actually run MoE cells — for graph-only sweeps extra
    # values just duplicate every record (identical metrics, and Pareto
    # keeps duplicate optima by design).
    moe_capacity_factors: Tuple[float, ...] = (1.25,)

    def points(self) -> Iterator[DesignPoint]:
        for (die, w, f, kb, pus, mem, dpp, side, topo, iq, oq, mcf) in \
                itertools.product(self.die_sides, self.noc_width_bits,
                                  self.noc_freq_ghz, self.sram_kb_per_tile,
                                  self.pus_per_tile, self.mem_techs,
                                  self.dies_per_package, self.grid_sides,
                                  self.topologies, self.iq_capacities,
                                  self.oq_capacities,
                                  self.moe_capacity_factors):
            if side % die != 0:
                continue
            yield DesignPoint(die_side=die, noc_width_bits=w,
                              noc_freq_ghz=f, sram_kb_per_tile=kb,
                              pus_per_tile=pus, mem_tech=mem,
                              dies_per_package=dpp, grid_side=side,
                              topology=topo, iq_capacity=iq, oq_capacity=oq,
                              moe_capacity_factor=mcf)

    def __len__(self) -> int:
        return sum(1 for _ in self.points())

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def quick(cls) -> "ConfigSpace":
        """Quick space: 24 points, every axis still exercised by ≥ 2
        values somewhere (topology ×3, width ×2, mem tech ×2, IQ ×2)."""
        return cls(die_sides=(16,), noc_width_bits=(32, 64),
                   noc_freq_ghz=(1.0,), sram_kb_per_tile=(512,),
                   mem_techs=("sram", "hbm"), dies_per_package=(4,),
                   grid_sides=(32,), topologies=TOPOLOGIES,
                   iq_capacities=(12, 48), oq_capacities=(12,))

    @classmethod
    def full(cls) -> "ConfigSpace":
        """The full sweep space (paper §V axes)."""
        return cls()
