"""Energy model (paper §IV-B, Table III): NoC + memory + PU.

Consumes ``RunStats`` from the task engine. Components (paper Fig. 9):
* NoC     — router traversals + wire mm per hop + die-to-die crossings;
* memory  — SRAM at the modeled hit rate, HBM for misses (+ tag checks);
* PU      — instructions executed (clock-gated when idle, §V-D);
SRAM banks and HBM power down when idle (paper §V-D), so idle power is 0.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..core.cache import CacheModel
from ..core.task_engine import EngineConfig, RunStats
from .params import COMPUTE, LINK, MEM


@dataclass
class EnergyBreakdown:
    noc_j: float
    memory_j: float
    pu_j: float

    @property
    def total_j(self) -> float:
        return self.noc_j + self.memory_j + self.pu_j


def run_energy(stats: RunStats, cfg: EngineConfig,
               instr_per_task: float = 7.0,
               dataset_bytes: float = 0.0) -> EnergyBreakdown:
    cache = CacheModel(cfg.sram, cfg.dram)
    noc = 0.0
    mem = 0.0
    pu = 0.0
    foot_tile = dataset_bytes / cfg.grid.n_tiles if dataset_bytes else 0.0
    for r in stats.rounds:
        bits = r.payload_bytes * 8
        if r.messages:
            # dropped tasks are retransmitted (see perf.py): the retried
            # wire traffic burns NoC energy again; same all-channel
            # normalisation as perf.py's retry factor
            retry = 1.0 + r.drops / max(r.messages + r.local_msgs, 1)
            avg_hops = r.hops / r.messages
            per_msg_bits = bits / r.messages
            noc += r.messages * retry * per_msg_bits * (
                avg_hops * (LINK.noc_router_pj_bit
                            + LINK.noc_wire_pj_bit_mm * LINK.tile_pitch_mm))
            noc += r.die_crossings * retry * per_msg_bits * LINK.d2d_pj_bit
        # memory: stream + random access mix
        hit = cache.hit_rate(r.stream_bytes, r.random_bytes, foot_tile)
        total_bits = (r.stream_bytes + r.random_bytes) * 8
        mem += total_bits * (MEM.sram_read_pj_bit * hit
                             + MEM.hbm_pj_bit * (1 - hit))
        if cfg.dram.present:
            mem += (r.stream_bytes + r.random_bytes) / 64.0 * MEM.cache_tag_pj
        pu += r.tasks_total * instr_per_task * COMPUTE.pu_active_pj_instr
    return EnergyBreakdown(noc_j=noc * 1e-12, memory_j=mem * 1e-12,
                           pu_j=pu * 1e-12)
