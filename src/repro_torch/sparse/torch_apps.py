"""BFS, SSSP and WCC as TaskPrograms on virtual shards (counterpart of
``repro/sparse/jax_apps.py:150-229, 343-408``).

Each rule sees the shard on the leading dimension: state ``[S, n_local]``
and ``src_slot [S, E_max]``, so a rule reads its shard's state with
``torch.gather(state, 1, src_slot)`` where the reference indexes
``state[src_slot]`` inside ``shard_map``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .csr import CSR
from .options import LaunchOptions
from .program import AppStats, TaskProgram, run_program


def _dist_init(g, params):
    dist = np.full(g.n, np.inf)
    dist[int(params["root"])] = 0.0
    return (dist,), (np.inf,)


def _label_init(g, params):
    return (np.arange(g.n, dtype=np.float64),), (np.inf,)


def _finite_frontier(ctx, state):
    return torch.isfinite(state[0])


def _all_frontier(ctx, state):
    return torch.ones_like(state[0], dtype=torch.bool)


def _hops_payload(ctx, state, src_slot, w):
    return torch.gather(state[0], 1, src_slot) + 1.0


def _weight_payload(ctx, state, src_slot, w):
    return torch.gather(state[0], 1, src_slot) + w


def _label_payload(ctx, state, src_slot, w):
    return torch.gather(state[0], 1, src_slot)


def _min_update(ctx, state, frontier, upd):
    new = torch.minimum(state[0], upd)
    return (new,), new < state[0]


BFS = TaskProgram(name="bfs", reduce_op="min", payload=_hops_payload,
                  init=_dist_init, frontier0=_finite_frontier,
                  update=_min_update, init_only=("root",))

SSSP = TaskProgram(name="sssp", reduce_op="min", payload=_weight_payload,
                   init=_dist_init, frontier0=_finite_frontier,
                   update=_min_update, max_rounds=256, init_only=("root",))

WCC = TaskProgram(name="wcc", reduce_op="min", payload=_label_payload,
                  init=_label_init, frontier0=_all_frontier,
                  update=_min_update, undirected=True)


def dcra_bfs(g: CSR, root: int, fabric, *,
             options: Optional[LaunchOptions] = None, max_rounds: int = 128,
             setup=None) -> Tuple[np.ndarray, AppStats]:
    """Distributed BFS: hop count from root, -1 if unreachable."""
    (d,), stats = run_program(BFS, g, fabric, options=options,
                              params={"root": int(root)},
                              max_rounds=max_rounds, setup=setup)
    return np.where(np.isfinite(d), d, -1).astype(np.int64), stats


def dcra_sssp(g: CSR, root: int, fabric, *,
              options: Optional[LaunchOptions] = None, max_rounds: int = 256,
              setup=None) -> Tuple[np.ndarray, AppStats]:
    """Distributed SSSP (frontier Bellman-Ford): inf if unreachable."""
    (d,), stats = run_program(SSSP, g, fabric, options=options,
                              params={"root": int(root)},
                              max_rounds=max_rounds, setup=setup)
    return d.astype(np.float64), stats


def dcra_wcc(g: CSR, fabric, *, options: Optional[LaunchOptions] = None,
             max_rounds: int = 128, setup=None
             ) -> Tuple[np.ndarray, AppStats]:
    """Distributed WCC via min-label propagation over both directions."""
    if g.n > (1 << 24):
        # labels ride the f32 payload; ids above 2^24 would collide
        raise ValueError(f"dcra_wcc supports up to 2^24 vertices, got {g.n}")
    (lab,), stats = run_program(WCC, g, fabric, options=options,
                                max_rounds=max_rounds, setup=setup)
    return lab.astype(np.int64), stats
