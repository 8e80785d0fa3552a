"""PageRank as the port defines it (``torch_apps.PAGERANK``: fixed
rounds, damping, the dangling rank spread evenly), launched back to
back on the resident graph."""
from __future__ import annotations

import torch

from dcra_bench.harness import Check, worse
from dcra_bench.reference.graph import pagerank

PROGRAM = "pagerank"
NEEDS_ROOTS = False
#: the widest relative gap of a vertex's rank from the float64 reference
#: (float32 rounding of the sums): sound runs read at most 2.96e-5, the
#: bfloat16 control 0.988 (PERF.md gives the readings)
REL_GAP_LIMIT = 1e-2


def launch_params(traffic, roots, i: int) -> dict:
    return {"damping": float(traffic["damping"]),
            "iters": int(traffic["iters"])}


def kept(states):
    return states[0]


def work(rows, cols, n: int, launches, traffic) -> list:
    """Per launch, nnz x iterations: every edge carries a task a round."""
    return [int(rows.numel()) * int(traffic["iters"])] * len(launches)


def check(rows, cols, n: int, launches, sample, traffic, control=None):
    """The widest relative gap of any vertex's rank from the float64
    reference over the sampled launches, and every launch's drops.
    ``control`` runs the reference in bfloat16 in the port's place."""
    damping, iters = float(traffic["damping"]), int(traffic["iters"])
    want = pagerank(rows, cols, n, damping, iters, torch.float64)
    got_control = None
    if control:
        got_control = pagerank(rows, cols, n, damping, iters,
                               torch.bfloat16).double()
    gap, failed = 0.0, set()
    for j in sample:
        got = (got_control if control else
               torch.from_numpy(launches[j].kept).to(rows.device))
        g = float(((got - want).abs() / want).max())
        if not g <= REL_GAP_LIMIT:
            failed.add(j)
        gap = worse(gap, g)
    drops = 0
    for j, L in enumerate(launches):
        if L.stats.total_drops:
            failed.add(j)
        drops += L.stats.total_drops
    return ([Check("pagerank_rel_gap", gap, REL_GAP_LIMIT),
             Check("pagerank_drops", drops, 0)], failed)
