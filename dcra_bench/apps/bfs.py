"""GAP's BFS kernel: searches from roots drawn among the vertices of
non-zero degree, each a ``launch_program(BFS, ...)`` of the port."""
from __future__ import annotations

import torch

from dcra_bench.harness import Check
from dcra_bench.reference.graph import bfs, reached_edges

PROGRAM = "bfs"
NEEDS_ROOTS = True


def launch_params(traffic, roots, i: int) -> dict:
    return {"root": roots[i % len(roots)]}


def kept(states):
    """What a launch's answer keeps for the check: the hop counts
    (float64, inf where unreached)."""
    return states[0]


def work(rows, cols, n: int, launches, traffic) -> list:
    """Per launch, the stored directed edges whose source the root reaches
    (twice Graph500's undirected count)."""
    per_vertex = reached_edges(rows, cols, n)
    roots = torch.tensor([L.params["root"] for L in launches],
                         dtype=torch.int64, device=rows.device)
    return [int(v) for v in per_vertex[roots].cpu().tolist()]


def check(rows, cols, n: int, launches, sample, traffic, control=None):
    """Every vertex's hop count and the round count of each sampled
    search against the reference's, and every launch's drops.
    ``control`` (a share) runs the reference with that share of edge
    visits dropped in the port's place. -> ``(checks, failed launch
    indices)``."""
    wrong_total, round_gap, failed = 0, 0, set()
    gen = None
    if control:
        gen = torch.Generator(device=rows.device)
        gen.manual_seed(int(control["seed"]))
    for j in sample:
        L = launches[j]
        want, rounds = bfs(rows, cols, n, L.params["root"])
        if control:
            got, got_rounds = bfs(rows, cols, n, L.params["root"],
                                  drop_share=control["drop_share"], gen=gen)
        else:
            d = torch.from_numpy(L.kept).to(rows.device)
            got = torch.where(torch.isfinite(d), d, -1.0).to(torch.int64)
            got_rounds = L.stats.rounds
        wrong = int((got != want).sum())
        gap = abs(int(got_rounds) - int(rounds))
        if wrong or gap:
            failed.add(j)
        wrong_total += wrong
        round_gap = max(round_gap, gap)
    drops = 0
    for j, L in enumerate(launches):
        if L.stats.total_drops:
            failed.add(j)
        drops += L.stats.total_drops
    return ([Check("bfs_wrong_vertices", wrong_total, 0),
             Check("bfs_round_gap", round_gap, 0),
             Check("bfs_drops", drops, 0)], failed)
