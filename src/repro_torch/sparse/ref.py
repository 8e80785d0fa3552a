"""Numpy oracles for BFS, SSSP and WCC (counterpart of
``repro/sparse/ref.py``), vectorised so that they run at RMAT-22.

Independent of the runtime: no owner layout, no routing, no torch.
"""
from __future__ import annotations

import numpy as np

from .csr import CSR


def _neighbours(g: CSR, frontier: np.ndarray) -> np.ndarray:
    """Concatenated out-neighbours of ``frontier`` (no per-vertex loop)."""
    starts = g.row_ptr[frontier]
    counts = g.row_ptr[frontier + 1] - starts
    offsets = np.repeat(starts - np.r_[0, np.cumsum(counts)[:-1]], counts)
    return g.col_idx[np.arange(int(counts.sum())) + offsets]


def bfs_ref(g: CSR, root: int) -> np.ndarray:
    """Hop count from root; -1 if unreachable."""
    dist = np.full(g.n, -1, np.int64)
    dist[root] = 0
    frontier = np.array([root])
    level = 0
    while len(frontier):
        level += 1
        reached = np.zeros(g.n, bool)
        reached[_neighbours(g, frontier)] = True
        frontier = np.flatnonzero(reached & (dist < 0))
        dist[frontier] = level
    return dist


def _min_into(n: int, idx: np.ndarray, vals: np.ndarray, order, starts):
    """Per-vertex minimum of ``vals`` over ``idx`` (inf where none), with
    ``order``/``starts`` the precomputed grouping of ``idx``."""
    out = np.full(n, np.inf)
    if len(idx):
        mins = np.minimum.reduceat(vals[order], starts)
        out[idx[order][starts]] = mins
    return out


def _grouping(idx: np.ndarray):
    order = np.argsort(idx, kind="stable")
    s = idx[order]
    starts = np.flatnonzero(np.r_[True, s[1:] != s[:-1]]) if len(s) else s
    return order, starts


def sssp_ref(g: CSR, root: int) -> np.ndarray:
    """Bellman-Ford shortest-path weights; inf if unreachable. Runs to the
    exact fixed point."""
    dist = np.full(g.n, np.inf)
    dist[root] = 0.0
    rows = g.row_of()
    w = g.values.astype(np.float64)
    order, starts = _grouping(g.col_idx)
    for _ in range(g.n):
        nd = np.minimum(dist, _min_into(g.n, g.col_idx, dist[rows] + w,
                                        order, starts))
        if np.array_equal(nd, dist):
            break
        dist = nd
    return dist


def wcc_ref(g: CSR) -> np.ndarray:
    """Min-label propagation over both edge directions."""
    label = np.arange(g.n, dtype=np.int64)
    rows = g.row_of()
    cols = g.col_idx.astype(np.int64)
    src, dst = np.concatenate([rows, cols]), np.concatenate([cols, rows])
    order, starts = _grouping(dst)
    while True:
        upd = np.minimum(label, _min_into(g.n, dst, label[src].astype(
            np.float64), order, starts)).astype(np.int64)
        if np.array_equal(upd, label):
            return label
        label = upd
