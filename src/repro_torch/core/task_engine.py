"""DCRA task-based PGAS execution engine (paper §III + Dalorex model);
a numpy copy of ``repro/core/task_engine.py``.

Execution model: data arrays are statically partitioned over tiles
(cyclic PGAS layout). A *task* operates only on tile-local data; writing to
remote data spawns a task invocation routed to the owner tile. The engine
renders this bulk-synchronously: each round, all pending task invocations
are (1) routed (owner-bucketed), (2) applied with a reduction, (3) may spawn
the next round's tasks. Results are exact; the NoC/queue/memory behaviour
of the message-driven original is captured as per-round statistics that the
cost model converts to cycles/energy/dollars (the paper's own simulator is
the same instrumentation + model approach).

Delivery reductions are vectorised (bincount / ``minimum.at`` /
sort+reduceat) — no python loops over messages.

The statistics are the reference's, integer for integer, but a round is
counted by channel: the (src tile, dst tile) pairs are counted once
(``bincount`` when the round is dense in the T x T channels, else
``unique``), and hops and die crossings come from a table of every tile
pair of the grid (:func:`_pair_tables`, kept for grids of up to
``PAIR_TABLE_MAX`` pairs), so a round of 10^8 messages costs a few passes
over its tasks instead of the reference's ~30 per-message array
operations. A min delivery folds with ``np.minimum.at`` (the same
left-to-right fold, target first, as the reference's per-destination
``reduceat``).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .cache import CacheModel, DRAMConfig, SRAMConfig
from .queues import QueueConfig, QueueStats
from .topology import TileGrid

#: largest T x T grid whose tile-pair tables :func:`_pair_tables` keeps
#: (2048 tiles: two int64 tables of 32 MiB each)
PAIR_TABLE_MAX = 1 << 22


@functools.lru_cache(maxsize=16)
def _pair_tables(grid: TileGrid) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """``(hops, die crossings)`` of every (src, dst) tile pair, flat
    ``src * T + dst``, zero on the diagonal (a same-tile task crosses no
    link); ``None`` above ``PAIR_TABLE_MAX`` pairs."""
    t = grid.n_tiles
    if t * t > PAIR_TABLE_MAX:
        return None
    src = np.repeat(np.arange(t, dtype=np.int64), t)
    dst = np.tile(np.arange(t, dtype=np.int64), t)
    hops = np.asarray(grid.hops(src, dst), np.int64)
    die_x = np.asarray(grid.die_crossings(src, dst), np.int64)
    hops[src == dst] = 0
    die_x[src == dst] = 0
    hops.flags.writeable = die_x.flags.writeable = False   # shared by callers
    return hops, die_x


@dataclass
class EngineConfig:
    grid: TileGrid
    queues: QueueConfig = field(default_factory=QueueConfig)
    sram: SRAMConfig = field(default_factory=SRAMConfig)
    dram: DRAMConfig = field(default_factory=DRAMConfig)
    pus_per_tile: int = 1              # Table II knob #2 (Fig. 6)
    pu_freq_ghz: float = 1.0           # Fig. 7
    word_bytes: int = 8                # task payload word


@dataclass
class RoundStats:
    messages: int = 0
    payload_bytes: int = 0
    hops: int = 0
    die_crossings: int = 0
    local_msgs: int = 0                # same-tile (no NoC traversal)
    tasks_per_tile_peak: int = 0
    tasks_total: int = 0
    stream_bytes: float = 0.0
    random_bytes: float = 0.0
    drops: int = 0                     # IQ-overflow discards (modeled)
    barrier: bool = False              # epoch boundary (PageRank)


@dataclass
class RunStats:
    rounds: List[RoundStats] = field(default_factory=list)
    queue: QueueStats = field(default_factory=QueueStats)

    @property
    def total_messages(self) -> int:
        return sum(r.messages for r in self.rounds)

    @property
    def total_hops(self) -> int:
        return sum(r.hops for r in self.rounds)

    @property
    def total_tasks(self) -> int:
        return sum(r.tasks_total for r in self.rounds)

    @property
    def total_die_crossings(self) -> int:
        return sum(r.die_crossings for r in self.rounds)

    @property
    def total_drops(self) -> int:
        return sum(r.drops for r in self.rounds)


class TaskEngine:
    """Owner-computes execution over a virtual tile grid.

    All queue sizing comes from ``config.queues`` (:class:`QueueConfig`) —
    per-task IQ capacities bound every :meth:`route` round (Table II knob
    #8, Fig. 10); build the config with ``QueueConfig.unbounded()`` for the
    legacy unbounded statistics.
    """

    def __init__(self, config: EngineConfig, n_items: int):
        self.cfg = config
        self.n = n_items                       # global index space (vertices)
        self.T = config.grid.n_tiles
        self.cache = CacheModel(config.sram, config.dram)
        self.stats = RunStats()

    # ---- PGAS layout -----------------------------------------------------
    def owner(self, idx: np.ndarray) -> np.ndarray:
        """Cyclic layout: item i lives on tile i % T (Dalorex default).
        For T a power of two that is ``i & (T - 1)``, for every integer
        (floor modulo), and a cheaper pass over 10^8 ids."""
        if self.T & (self.T - 1) == 0:
            return idx & (self.T - 1)
        return idx % self.T

    # ---- message routing + delivery ---------------------------------------
    def route(self, task: str, src_idx: np.ndarray, dst_idx: np.ndarray,
              values: Optional[np.ndarray] = None,
              target: Optional[np.ndarray] = None, op: str = "add",
              payload_words: int = 2,
              stream_bytes_per_task: float = 0.0,
              random_bytes_per_task: float = 0.0) -> RoundStats:
        """Deliver one round of task invocations.

        src_idx/dst_idx: global item ids (message endpoints define tiles);
        values applied to ``target`` at dst_idx with reduction ``op``
        ('min'|'add'|'store'). Mutates ``target`` in place; returns stats.
        ``target=None`` records routing stats only (task-invocation
        messages whose effect is to spawn downstream tasks).

        The per-task IQ capacity resolves through
        ``self.cfg.queues.channel_cap(task, ...)`` — explicit entry counts
        (``iq_sizes`` / ``default_iq``) are honored exactly, and
        factor-sized tasks (``iq_factors``, the MoE-style relative knob)
        derive the same lane-aligned capacity the executable bucketing
        would, so a factor-based ``QueueConfig`` bounds the analytic model
        instead of silently disabling it. It models the bounded input
        queue the routing layer (:mod:`repro_torch.core.routing`)
        enforces: each (src tile -> dst tile)
        ingress channel accepts at most that many tasks per round; the
        overflow count is recorded in ``RoundStats.drops``. Same-tile
        (src == dst) channels are bounded too — the routing layer's
        ``bucket`` queues a shard's self-owned tasks through its own bucket
        at the same capacity, so charging the self channel here is what
        makes the analytic and executable drop counts agree *by
        construction* (held to the executable by the shardcheck
        revalidation, heavy self-traffic streams included). The
        reduction itself stays exact — drops are *modeled* traffic loss
        for the cost model.
        """
        # per-sender-tile task load mirrors the executable's e_local
        T = self.T
        cap = self.cfg.queues.channel_cap(task, -(-len(dst_idx) // T), T)
        g = self.cfg.grid
        src_t = self.owner(np.asarray(src_idx))
        dst_t = self.owner(np.asarray(dst_idx))
        chan = src_t * T + dst_t
        if len(chan) >= (T * T) >> 3:       # dense: one pass, no sort
            counts = np.bincount(chan, minlength=T * T)
            keys = np.flatnonzero(counts)
            per_chan = counts[keys]
            grid_counts = counts.reshape(T, T)
            in_per_tile = grid_counts.sum(0)
            out_per_tile = grid_counts.sum(1)
        else:                               # sparse: only touched channels
            keys, per_chan = np.unique(chan, return_counts=True)
            in_per_tile = np.bincount(dst_t, minlength=T)
            out_per_tile = np.bincount(src_t, minlength=T)
        tables = _pair_tables(g)
        if tables is None:
            remote = src_t != dst_t
            hops = int(g.hops(src_t[remote], dst_t[remote]).sum())
            die_x = int(g.die_crossings(src_t[remote], dst_t[remote]).sum())
        else:
            hops = int((per_chan * tables[0][keys]).sum())
            die_x = int((per_chan * tables[1][keys]).sum())
        n_local = int(per_chan[keys // T == keys % T].sum())

        msg_bytes = payload_words * self.cfg.word_bytes
        n_msgs = len(chan) - n_local
        rs = RoundStats(
            messages=n_msgs,
            payload_bytes=n_msgs * msg_bytes,
            hops=hops,
            die_crossings=die_x,
            local_msgs=n_local,
            tasks_total=len(dst_idx),
        )
        rs.tasks_per_tile_peak = int(in_per_tile.max(initial=0))
        if cap is not None:
            rs.drops = int(np.maximum(per_chan - cap, 0).sum())
        rs.stream_bytes = stream_bytes_per_task * len(dst_idx)
        rs.random_bytes = random_bytes_per_task * len(dst_idx)
        self.stats.queue.record(task, in_per_tile, out_per_tile)

        if target is not None:
            self._reduce(dst_idx, values, target, op)
        self.stats.rounds.append(rs)
        return rs

    def mark_barrier(self):
        """Tag the last round as an epoch barrier (PageRank §V-B tail)."""
        if self.stats.rounds:
            self.stats.rounds[-1].barrier = True

    @staticmethod
    def _reduce(dst_idx, values, target, op):
        dst_idx = np.asarray(dst_idx)
        if dst_idx.size == 0:      # empty round (e.g. frontier of leaves)
            return
        if op == "add":
            upd = np.bincount(dst_idx, weights=values.astype(np.float64),
                              minlength=target.shape[0])
            target += upd.astype(target.dtype)
        elif op == "min":
            # target first, then the values in order: the reference's
            # per-destination reduceat and minimum.at pick the same value
            np.minimum.at(target, dst_idx, values)
        elif op == "store":
            # deterministic overwrite: among duplicate destinations the
            # maximum value wins, independent of input (= routing) order —
            # the same winner the routed ``reduce_received`` picks.
            order = np.argsort(dst_idx, kind="stable")
            ds, vs = dst_idx[order], np.asarray(values)[order]
            first = np.flatnonzero(np.r_[True, ds[1:] != ds[:-1]])
            target[ds[first]] = np.maximum.reduceat(vs, first)
        else:
            raise ValueError(op)

    # ---- derived ---------------------------------------------------------
    def footprint_per_tile(self, total_bytes: float) -> float:
        return total_bytes / self.T
