"""Plain graph references over a CSR's edge list (``rows``, ``cols``: the
source and target of every stored edge, int64): frontier BFS, PageRank
by power iteration, and connected components (the yardstick of what a
search from a root must traverse)."""
from __future__ import annotations

import torch


def bfs(rows, cols, n: int, root: int, drop_share: float = 0.0,
        gen=None):
    """Hop counts from ``root`` (int64, -1 where it does not reach) and the
    number of rounds a level-synchronous search takes, counting the last
    one, which finds nothing new. ``drop_share > 0`` drops that share of
    each round's edge visits (drawn from ``gen``): the control that
    breaks the dropless guarantee."""
    dev = rows.device
    dist = torch.full((n,), -1, dtype=torch.int64, device=dev)
    dist[root] = 0
    frontier = torch.zeros(n, dtype=torch.bool, device=dev)
    frontier[root] = True
    rounds = 0
    while True:
        rounds += 1
        active = frontier[rows]
        if drop_share > 0:
            active &= torch.rand(active.shape, generator=gen,
                                 device=dev) >= drop_share
        reached = cols[active]
        reached = reached[dist[reached] < 0]
        frontier = torch.zeros(n, dtype=torch.bool, device=dev)
        frontier[reached] = True
        if not bool(frontier.any()):
            return dist, rounds
        dist[frontier] = rounds


def pagerank(rows, cols, n: int, damping: float, iters: int,
             dtype=torch.float64):
    """``iters`` rounds of ``rank = (1 - d) / n + d * (in + dangling / n)``
    from ``1 / n``: ``in`` the sum over a vertex's in-edges of its
    source's rank over its out-degree, ``dangling`` the rank of the
    vertices without out-edges, all in ``dtype``."""
    dev = rows.device
    deg = torch.bincount(rows, minlength=n).to(dtype)
    rank = torch.full((n,), 1.0 / n, dtype=dtype, device=dev)
    sink = deg == 0
    for _ in range(int(iters)):
        contrib = torch.where(sink, torch.zeros((), dtype=dtype, device=dev),
                              rank / torch.clamp(deg, min=1))
        inflow = torch.zeros(n, dtype=dtype, device=dev).index_add_(
            0, cols, contrib[rows])
        dangling = rank[sink].sum()
        rank = (1.0 - damping) / n + damping * (inflow + dangling / n)
    return rank


def components(rows, cols, n: int):
    """The connected component of every vertex of a symmetric graph, as
    the least vertex id in it: min-label propagation with pointer
    jumping until nothing changes."""
    label = torch.arange(n, device=rows.device)
    while True:
        low = label.scatter_reduce(0, cols, label[rows], "amin")
        low = low[low]
        while True:
            nxt = low[low]
            if torch.equal(nxt, low):
                break
            low = nxt
        if torch.equal(low, label):
            return label
        label = low


def reached_edges(rows, cols, n: int):
    """Per vertex, the stored edges a search from it traverses: the sum of
    out-degrees over its component (int64 ``[n]``)."""
    label = components(rows, cols, n)
    deg = torch.bincount(rows, minlength=n)
    per_comp = torch.zeros(n, dtype=torch.int64, device=rows.device)
    per_comp.index_add_(0, label, deg)
    return per_comp[label]
