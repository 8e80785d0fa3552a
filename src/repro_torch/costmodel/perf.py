"""Performance model: RunStats -> cycles -> seconds -> TEPS (paper §IV-B).

Bulk-synchronous approximation of the Dalorex cycle-accurate NoC simulator
(the reference repository's model, copied unchanged): per round, time is the max of
  * compute+memory at the most-loaded tile (peak tasks x (instrs/f + stalls)),
  * injection serialization at the hottest tile,
  * bisection-bandwidth serialization of the remote traffic,
plus a pipelined-latency constant. Queue sizing (Table II #8) enters as a
producer-stall term: a task that fans out more messages than its OQ holds
stalls for the excess (paper Fig. 10 mechanism). Topology enters via
bisection width, hop counts (already topology-aware in RunStats), and a
congestion factor (meshes hotspot under uniform random traffic; tori do
not — paper §V-A / Dalorex observation).
"""
from __future__ import annotations

from dataclasses import dataclass

from ..core.cache import CacheModel
from ..core.task_engine import EngineConfig, RunStats
from .params import LINK

CONGESTION = {"mesh": 0.70, "torus": 1.0, "hier_torus": 1.1}
MSG_BITS = 128  # 2-word payload + header


@dataclass
class PerfResult:
    seconds: float
    cycles: float
    edges_processed: int

    @property
    def teps(self) -> float:
        return self.edges_processed / self.seconds if self.seconds else 0.0


IMBALANCE_WEIGHT = 0.2  # async task model amortizes part of the peak tile


def round_time_ns(r, cfg: EngineConfig, cache: CacheModel,
                  foot_tile: float, oq2: int, fanout: float) -> float:
    g = cfg.grid
    f_pu = cfg.pu_freq_ghz
    f_noc = g.noc_freq_ghz

    # ---- compute + memory at the most loaded tile ----------------------
    instr = 7.0
    bytes_per_task = ((r.stream_bytes + r.random_bytes)
                      / max(r.tasks_total, 1))
    hit = cache.hit_rate(r.stream_bytes, r.random_bytes, foot_tile)
    eff_bw = cache.effective_bw(hit)                  # bytes/ns/tile
    # producer stall: fanout beyond the OQ defers at ~1 msg/cycle
    stall_cyc = max(0.0, fanout - oq2) * 0.5
    per_task_ns = (instr + stall_cyc) / f_pu + bytes_per_task / eff_bw
    avg_tasks = r.tasks_total / g.n_tiles
    # barrier rounds expose the full peak (PageRank's epoch tail, §V-B);
    # otherwise the async task model amortizes stragglers across rounds.
    w = 1.0 if r.barrier else IMBALANCE_WEIGHT
    eff_tasks = avg_tasks + w * max(r.tasks_per_tile_peak - avg_tasks, 0.0)
    compute_ns = eff_tasks * per_task_ns / cfg.pus_per_tile

    # ---- network -------------------------------------------------------
    # IQ-overflow drops are retransmitted by the producer (the routing
    # layer's drop-and-retry semantics), so modeled drops inflate the
    # injection and bisection terms; zero drops leaves them untouched.
    # Drops are counted over ALL (src, dst) channels — local ones too —
    # so normalise by all routed tasks, not just the NoC-crossing ones.
    retry = 1.0 + r.drops / max(r.messages + r.local_msgs, 1)
    inj_hot = avg_tasks + w * max(r.tasks_per_tile_peak - avg_tasks, 0.0)
    inj_ns = inj_hot * retry * MSG_BITS / (g.noc_width_bits * f_noc)
    remote_bytes = r.payload_bytes * retry
    bisec = g.bisection_bytes_per_cycle() * f_noc * CONGESTION[g.topology]
    # hierarchical torus: the die-NoC carries inter-die traffic in parallel
    if g.topology == "hier_torus":
        n_dr, n_dc = g.dies
        die_noc_bpc = min(n_dr, n_dc) * 2 * g.noc_width_bits / 8.0
        bisec += die_noc_bpc * f_noc * 0.5
    bisec_ns = (remote_bytes / 2.0) / max(bisec, 1e-9)
    avg_hops = (r.hops / r.messages) if r.messages else 0.0
    lat_ns = avg_hops * LINK.noc_router_latency_ps / 1e3 + \
        (LINK.d2d_latency_ns if r.die_crossings else 0.0)

    return max(compute_ns, inj_ns, bisec_ns) + lat_ns


def run_perf(stats: RunStats, cfg: EngineConfig, edges: int,
             dataset_bytes: float = 0.0, fanout: float = 16.0) -> PerfResult:
    cache = CacheModel(cfg.sram, cfg.dram)
    foot_tile = dataset_bytes / cfg.grid.n_tiles if dataset_bytes else 0.0
    oq2 = cfg.queues.oq("T3")
    total_ns = 0.0
    for r in stats.rounds:
        total_ns += round_time_ns(r, cfg, cache, foot_tile, oq2, fanout)
    sec = total_ns * 1e-9
    return PerfResult(seconds=sec, cycles=total_ns * cfg.pu_freq_ghz,
                      edges_processed=edges)
