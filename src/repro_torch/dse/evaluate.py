"""Analytic evaluation of design points (TaskEngine → perf → energy → $).

Two layers:

* the flat helpers (``run_app`` / ``evaluate`` / ``config_cost``) — run any
  ``EngineConfig`` through the analytic stack for one app × dataset; these
  are the primitives the figure benchmarks (``benchmarks/common.py``) have
  always used, now owned here so figure reproduction and DSE share one
  code path;
* :class:`Evaluator` — evaluates :class:`~repro_torch.dse.space.DesignPoint`\\ s
  across apps × datasets with **stats caching**: routing statistics depend
  only on ``DesignPoint.stats_key`` (grid, die size, topology, IQ), so
  points differing only in link width/frequency, memory tech, SRAM or OQ
  re-price a cached task stream instead of re-simulating it — the paper's
  own decoupling of simulation from cost (§IV-C).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.cache import DRAMConfig, SRAMConfig  # noqa: F401  (re-export)
from ..core.task_engine import EngineConfig, RunStats, TaskEngine
from ..costmodel import (dcra_die_area_mm2, package_cost, run_energy,
                         run_perf)
from ..sparse import apps, datasets
from .space import DesignPoint

APPS = ("sssp", "pagerank", "bfs", "wcc", "spmv", "histogram", "kcore")

# the k the analytic sweep peels at (deterministic; chosen so both quick
# datasets peel a real fraction of their vertices — a k no dataset peels
# at would make the kcore cell zero-traffic and its TEPS meaningless)
KCORE_K = 16


def load_datasets(scale: int = 12) -> Dict[str, object]:
    """The bundled dataset pair: RMAT-<scale> + a Wikipedia-like graph."""
    return {
        f"R{scale}": datasets.rmat(scale, edge_factor=16, seed=1),
        "WK": datasets.wiki_like(1 << (scale - 1), avg_degree=25),
    }


def run_app(app: str, engine: TaskEngine, g, rng_seed: int = 0):
    if app == "bfs":
        return apps.bfs(engine, g, root=0)
    if app == "sssp":
        return apps.sssp(engine, g, root=0)
    if app == "pagerank":
        return apps.pagerank(engine, g, iters=5)
    if app == "wcc":
        return apps.wcc(engine, g)
    if app == "spmv":
        x = np.random.default_rng(rng_seed).random(g.n)
        return apps.spmv(engine, g, x)
    if app == "histogram":
        if hasattr(g, "nnz"):      # graph stand-in: synthesize a stream
            els = datasets.histogram_data(g.nnz, max(g.n // 16, 64))
            return apps.histogram(engine, els, max(g.n // 16, 64))
        els = np.asarray(g)        # a raw element stream IS the dataset
        return apps.histogram(engine, els, max(int(els.max()) + 1, 64))
    if app == "kcore":
        if not hasattr(g, "nnz"):
            raise ValueError("kcore needs a graph dataset")
        return apps.kcore(engine, g, k=KCORE_K)
    raise ValueError(app)


@dataclass
class ConfigResult:
    teps: float
    teps_per_watt: float
    teps_per_dollar: float
    seconds: float
    energy_j: float
    cost_usd: float
    hops: int
    drops: int = 0
    messages: int = 0
    breakdown: object = None


def config_cost(cfg: EngineConfig) -> float:
    """One package holding every die of the deployment (legacy figure
    costing; :meth:`DesignPoint.package_bill` adds the dies-per-package
    axis on top of the same silicon model)."""
    g = cfg.grid
    tiles_per_die = g.die_rows * g.die_cols
    n_dies = max(1, g.n_tiles // tiles_per_die)
    area = dcra_die_area_mm2(tiles_per_die, cfg.sram.kb_per_tile,
                             cfg.pus_per_tile, g.noc_width_bits,
                             g.noc_freq_ghz)
    hbm_gb = cfg.dram.gb_per_die * n_dies if cfg.dram.present else 0.0
    return package_cost(n_dies, area, hbm_gb).total


def _dataset_terms(g) -> Tuple[int, float, float]:
    edges = g.nnz if hasattr(g, "nnz") else len(g)
    dbytes = g.memory_bytes() if hasattr(g, "memory_bytes") else edges * 8
    fanout = edges / max(getattr(g, "n", 1), 1)
    return edges, dbytes, fanout


def _price(stats: RunStats, cfg: EngineConfig, g,
           cost_usd: float) -> ConfigResult:
    edges, dbytes, fanout = _dataset_terms(g)
    perf = run_perf(stats, cfg, edges, dataset_bytes=dbytes, fanout=fanout)
    en = run_energy(stats, cfg, dataset_bytes=dbytes)
    watts = en.total_j / max(perf.seconds, 1e-12)
    return ConfigResult(
        teps=perf.teps,
        teps_per_watt=perf.teps / max(watts, 1e-12),
        teps_per_dollar=perf.teps / max(cost_usd, 1e-12),
        seconds=perf.seconds, energy_j=en.total_j, cost_usd=cost_usd,
        hops=stats.total_hops, drops=stats.total_drops,
        messages=stats.total_messages, breakdown=en)


def evaluate(cfg: EngineConfig, g, app: str,
             cost_usd: Optional[float] = None) -> ConfigResult:
    """Run one (config, dataset, app) cell through the analytic stack.

    Queue physics comes from ``cfg.queues`` alone: ``TaskEngine.route``
    bounds every round at ``queues.channel_cap(task, ...)``, so every
    caller prices the same bounded-IQ drop model
    (``QueueConfig.unbounded()`` restores the legacy stats when needed).
    """
    engine = TaskEngine(cfg, getattr(g, "n", len(np.atleast_1d(g))))
    _, stats = run_app(app, engine, g)
    if cost_usd is None:
        cost_usd = config_cost(cfg)
    return _price(stats, cfg, g, cost_usd)


def geomean(vals: List[float]) -> float:
    vals = [max(v, 1e-12) for v in vals]
    return math.exp(sum(math.log(v) for v in vals) / len(vals))


# ---------------------------------------------------------------------------
# DesignPoint evaluation
# ---------------------------------------------------------------------------

@dataclass
class PointResult:
    """Aggregate metrics of one design point over apps × datasets."""
    point: DesignPoint
    teps: float                     # geomean over cells
    watts: float                    # geomean over cells
    package_usd: float
    system_usd: float
    teps_per_watt: float
    teps_per_usd: float             # vs system cost
    seconds: float                  # geomean
    energy_j: float                 # total
    drops: int                      # total modeled IQ overflow
    messages: int
    per_cell: Dict[str, ConfigResult] = field(default_factory=dict)

    def to_dict(self) -> Dict:
        return {
            "point_id": self.point.point_id,
            "config": self.point.to_dict(),
            "metrics": {
                "teps_geomean": self.teps,
                "watts_geomean": self.watts,
                "package_usd": self.package_usd,
                "system_usd": self.system_usd,
                "teps_per_watt": self.teps_per_watt,
                "teps_per_usd": self.teps_per_usd,
                "seconds_geomean": self.seconds,
                "energy_j_total": self.energy_j,
                "drops_total": self.drops,
                "messages_total": self.messages,
            },
            "per_cell": {
                cell: {"teps": r.teps, "seconds": r.seconds,
                       "energy_j": r.energy_j, "drops": r.drops,
                       "messages": r.messages, "hops": r.hops}
                for cell, r in self.per_cell.items()
            },
        }


class Evaluator:
    """Evaluate design points analytically, caching routed task streams.

    ``datasets``: name → CSR (or element array); ``apps_list``: subset of
    :data:`APPS`. ``stats_for`` is also the hook the revalidation worker
    uses to get the exact analytic stream of a top-K winner.
    """

    def __init__(self, data: Dict[str, object],
                 apps_list: Sequence[str] = APPS):
        self.data = data
        self.apps_list = tuple(apps_list)
        self._stats: Dict[Tuple, RunStats] = {}

    def stats_for(self, point: DesignPoint, app: str,
                  dname: str) -> RunStats:
        key = point.stats_key + (app, dname)
        if key not in self._stats:
            g = self.data[dname]
            # the point's IQ axis flows through engine_config().queues —
            # QueueConfig is the only capacity source
            engine = TaskEngine(point.engine_config(),
                                getattr(g, "n", len(np.atleast_1d(g))))
            run_app(app, engine, g)
            self._stats[key] = engine.stats
        return self._stats[key]

    def evaluate_point(self, point: DesignPoint) -> PointResult:
        cfg = point.engine_config()
        system_usd = point.system_usd()
        per_cell: Dict[str, ConfigResult] = {}
        for dname, g in self.data.items():
            for app in self.apps_list:
                stats = self.stats_for(point, app, dname)
                per_cell[f"{app}:{dname}"] = _price(stats, cfg, g,
                                                    system_usd)
        teps = geomean([r.teps for r in per_cell.values()])
        watts = geomean([r.energy_j / max(r.seconds, 1e-12)
                         for r in per_cell.values()])
        return PointResult(
            point=point,
            teps=teps, watts=watts,
            package_usd=point.package_usd(), system_usd=system_usd,
            teps_per_watt=teps / max(watts, 1e-12),
            teps_per_usd=teps / max(system_usd, 1e-12),
            seconds=geomean([r.seconds for r in per_cell.values()]),
            energy_j=sum(r.energy_j for r in per_cell.values()),
            drops=sum(r.drops for r in per_cell.values()),
            messages=sum(r.messages for r in per_cell.values()),
            per_cell=per_cell)
