"""The paper applications (§IV-A, plus k-core) on the DCRA task engine; a
numpy copy of ``repro/sparse/apps.py`` (a round's edge segments are
gathered with one index array rather than concatenated slice by slice:
the same arrays).

Task structure follows Dalorex/DCRA: pointer indirections split tasks —
  T1 (vertex task, at owner(v))      — spawns an edge-list lookup   [OQ1]
  T2 (edge task, at owner_E(seg))    — walks the edge segment (streaming,
                                        next-line prefetch), spawns per-edge
                                        updates                      [OQ2]
  T3 (update task, at owner(u))      — reduction on the owned element
Histogram has only two task types (paper Fig. 10 note).

Each app returns exact results (validated against sparse/ref.py) plus
``RunStats`` — message/hop/queue/memory traffic that the cost model converts
to cycles, joules and dollars.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from ..core.task_engine import EngineConfig, RunStats, TaskEngine
from .csr import CSR

# instruction-count profile per task (one instr/cycle, paper §IV-B);
# measured from the Dalorex artifact's task bodies (approximate).
INSTRS = {"T1": 6, "T2": 8, "T3": 5}
WORD = 8


def _owner_of_edge(engine: TaskEngine, g: CSR) -> np.ndarray:
    """Tile owning each vertex's edge segment (cyclic over the edge array)."""
    return (g.row_ptr[:-1] % engine.T).astype(np.int64)


def _expand(engine: TaskEngine, g: CSR, frontier: np.ndarray,
            values_per_v: np.ndarray, target: np.ndarray, op: str
            ) -> Tuple[np.ndarray, RunStats]:
    """One T1->T2->T3 round: frontier vertices push values along edges."""
    deg = g.degrees()[frontier]
    # OQ1: one edge-list lookup per frontier vertex (T1 -> T2).
    # dst is the edge-array index of the segment head (owner = idx % T).
    engine.route("T2", src_idx=frontier, dst_idx=g.row_ptr[frontier],
                 payload_words=2,
                 stream_bytes_per_task=8.0,        # row_ptr pair
                 random_bytes_per_task=8.0)        # vertex state
    # OQ2: per-edge update (T2 -> T3)
    starts = g.row_ptr[frontier]
    if len(frontier):
        # the frontier's edge segments, in order (one gather, no loop)
        edge = (np.repeat(starts - (np.cumsum(deg) - deg), deg)
                + np.arange(int(deg.sum())))
        nbr, wts = g.col_idx[edge], g.values[edge]
    else:
        nbr, wts = np.array([], np.int64), np.array([], np.float32)
    src_edge = np.repeat(g.row_ptr[frontier], deg)  # edge-segment identity
    vals = np.repeat(values_per_v, deg)
    if op == "min_plus_w":
        vals = vals + wts
        op = "min"
    elif op == "mul_add":
        vals = vals * wts
        op = "add"
    stats = engine.route(
        "T3", src_idx=src_edge, dst_idx=nbr.astype(np.int64),
        values=vals, target=target, op=op,
        payload_words=2,
        stream_bytes_per_task=8.0,                 # col_idx + weight
        random_bytes_per_task=8.0)                 # target element
    return nbr, stats


def bfs(engine: TaskEngine, g: CSR, root: int) -> Tuple[np.ndarray, RunStats]:
    dist = np.full(g.n, np.inf)
    dist[root] = 0
    frontier = np.array([root], np.int64)
    while len(frontier):
        before = dist.copy()
        _expand(engine, g, frontier, dist[frontier] + 1.0, dist, "min")
        frontier = np.flatnonzero(dist < before)
    out = np.where(np.isinf(dist), -1, dist).astype(np.int64)
    return out, engine.stats


def sssp(engine: TaskEngine, g: CSR, root: int) -> Tuple[np.ndarray, RunStats]:
    dist = np.full(g.n, np.inf)
    dist[root] = 0.0
    frontier = np.array([root], np.int64)
    while len(frontier):
        before = dist.copy()
        _expand(engine, g, frontier, dist[frontier], dist, "min_plus_w")
        frontier = np.flatnonzero(dist < before)
    return dist, engine.stats


def pagerank(engine: TaskEngine, g: CSR, damping: float = 0.85,
             iters: int = 20) -> Tuple[np.ndarray, RunStats]:
    deg = g.degrees().astype(np.float64)
    rank = np.full(g.n, 1.0 / g.n)
    all_v = np.arange(g.n, dtype=np.int64)
    active = all_v[deg > 0]
    for _ in range(iters):
        acc = np.zeros(g.n)
        contrib = np.where(deg > 0, rank / np.maximum(deg, 1), 0.0)
        _expand(engine, g, active, contrib[active], acc, "add")
        dangling = rank[deg == 0].sum()
        rank = (1 - damping) / g.n + damping * (acc + dangling / g.n)
        engine.mark_barrier()   # per-epoch sync: the §V-B imbalance tail
    return rank, engine.stats


def wcc(engine: TaskEngine, g: CSR) -> Tuple[np.ndarray, RunStats]:
    label = np.arange(g.n, dtype=np.float64)
    frontier = np.arange(g.n, dtype=np.int64)
    gt = g.transpose()
    while len(frontier):
        before = label.copy()
        _expand(engine, g, frontier, label[frontier], label, "min")
        _expand(engine, gt, frontier, label[frontier], label, "min")
        frontier = np.flatnonzero(label < before)
    return label.astype(np.int64), engine.stats


def spmv(engine: TaskEngine, g: CSR, x: np.ndarray
         ) -> Tuple[np.ndarray, RunStats]:
    """y = A @ x via owner-computes on x (paper: task at the x[j] owner)."""
    gt = g.transpose()           # columns of A = rows of A^T
    y = np.zeros(g.n)
    cols = np.arange(g.n, dtype=np.int64)
    active = cols[gt.degrees() > 0]
    _expand(engine, gt, active, x[active], y, "mul_add")
    return y, engine.stats


def kcore(engine: TaskEngine, g: CSR, k: int = 8
          ) -> Tuple[np.ndarray, RunStats]:
    """k-core decomposition: peel sub-``k`` vertices round by round, each
    removal routing unit degree-decrement tasks along both edge
    directions (the undirected view, like :func:`wcc`). Returns within-core
    degrees (-1 for peeled vertices) — matches ``ref.kcore_ref``."""
    gt = g.transpose()
    deg = (g.degrees() + gt.degrees()).astype(np.float64)
    alive = np.ones(g.n, bool)
    frontier = np.flatnonzero(alive & (deg < k))
    while len(frontier):
        dec = np.zeros(g.n)
        _expand(engine, g, frontier, np.ones(len(frontier)), dec, "add")
        _expand(engine, gt, frontier, np.ones(len(frontier)), dec, "add")
        alive[frontier] = False
        deg = deg - dec
        frontier = np.flatnonzero(alive & (deg < k))
    return np.where(alive, deg, -1).astype(np.int64), engine.stats


def histogram(engine: TaskEngine, elements: np.ndarray, n_bins: int
              ) -> Tuple[np.ndarray, RunStats]:
    counts = np.zeros(n_bins)
    idx = np.arange(len(elements), dtype=np.int64)
    engine.route("T2", src_idx=idx, dst_idx=elements.astype(np.int64),
                 values=np.ones(len(elements)), target=counts, op="add",
                 payload_words=2,
                 stream_bytes_per_task=8.0, random_bytes_per_task=8.0)
    return counts.astype(np.int64), engine.stats
