"""The seven apps as TaskPrograms on virtual shards (counterpart of
``repro/sparse/jax_apps.py:76-447``): BFS, SSSP, WCC, PageRank and
k-core as graph programs, SpMV and histogram as one-round streams, and
the serving tier's tenant-batched BFS and SSSP.

Each graph rule sees the shard on the leading dimension: state
``[S, n_local]`` and ``src_slot [S, E_max]``, so a rule reads its
shard's state with ``torch.gather(state, 1, src_slot)`` where the
reference indexes ``state[src_slot]`` inside ``shard_map``. The task
streams are built on the host with numpy, byte-identical to the
reference's, and copied to the device once.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels import ops
from .csr import CSR
from .options import LaunchOptions
# dcra_scatter is re-exported: callers address the one-round scatter
# through this module, as in the reference
from .program import (AppStats, TaskProgram, dcra_scatter,  # noqa: F401
                      run_program)


# ---------------------------------------------------------------------------
# task streams of the one-round scatter programs
# ---------------------------------------------------------------------------

def spmv_task_stream(g: CSR, x: np.ndarray, n_dev: int, seed: int = 0
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """The flat ``(dest, value)`` stream ``dcra_spmv`` routes: the edges
    shuffled once, ``value = A[r, c] * x[c]`` in float32, padded with
    ``dest = -1`` to a multiple of ``n_dev`` (shard ``d`` owns the
    contiguous slice ``d``)."""
    E = g.nnz
    perm = np.random.default_rng(seed).permutation(E)
    rows = g.row_of()[perm]
    cols = g.col_idx[perm]
    vals = g.values[perm].astype(np.float32)
    pad = -(-E // n_dev) * n_dev - E
    dest = np.concatenate([rows, np.full(pad, -1)]).astype(np.int32)
    eff = vals * np.asarray(x, np.float32)[cols]
    vals_eff = np.concatenate([eff, np.zeros(pad, np.float32)])
    return dest, vals_eff


def histogram_task_stream(elements: np.ndarray, n_dev: int
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """The flat ``(dest, value)`` stream ``dcra_histogram`` routes: one
    ``(bin, 1.0)`` task per element, padded as in
    :func:`spmv_task_stream`."""
    E = len(elements)
    pad = -(-E // n_dev) * n_dev - E
    dest = np.concatenate([np.asarray(elements),
                           np.full(pad, -1)]).astype(np.int32)
    vals = np.concatenate([np.ones(E, np.float32),
                           np.zeros(pad, np.float32)])
    return dest, vals


def _spmv_stream(data, params, n_dev, seed):
    g, x = data
    dest, vals = spmv_task_stream(g, x, n_dev, seed)
    return dest, vals, g.n


def _histogram_stream(data, params, n_dev, seed):
    elements, n_bins = data
    dest, vals = histogram_task_stream(elements, n_dev)
    return dest, vals, n_bins


def _histogram_local_reduce(data, dest, vals, n_items, device):
    """Single-shard reduce: the histogram kernel counts the task stream
    directly (``dest`` is the bin id; the -1 padding matches no bin),
    in place of the routed round. Its plain version on the CPU."""
    ids = torch.from_numpy(np.ascontiguousarray(dest, np.int32)).to(device)
    return ops.histogram(ids, n_items).cpu().numpy().astype(np.float32)


def _dist_init(g, params):
    dist = np.full(g.n, np.inf)
    dist[int(params["root"])] = 0.0
    return (dist,), (np.inf,)


def _multi_root_init(g, params):
    """Tenant-column init (``repro/sparse/jax_apps.py:156-173``): ``g`` is
    a tenant-expanded graph (vertex ``t * n + v`` is base vertex ``v`` in
    tenant ``t``'s column, :func:`repro_torch.serve.batching.tenant_graph`)
    and ``params["roots"]`` holds one root per tenant. A root outside
    ``[0, n)`` raises: it would seed another tenant's column."""
    roots = params["roots"]
    n = g.n // len(roots)
    dist = np.full(g.n, np.inf)
    for t, root in enumerate(roots):
        r = int(root)
        if not 0 <= r < n:
            raise ValueError(
                f"root {root} out of range [0, {n}) for tenant column {t}")
        dist[t * n + r] = 0.0
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

# the serving tier's fused multi-root launches: BFS's and SSSP's rules,
# one root per tenant column; roots are init-only, so every batch of one
# shape class reuses one round function
BATCHED_BFS = TaskProgram(name="bfs_batched", reduce_op="min",
                          payload=_hops_payload, init=_multi_root_init,
                          frontier0=_finite_frontier, update=_min_update,
                          init_only=("roots",))

BATCHED_SSSP = TaskProgram(name="sssp_batched", reduce_op="min",
                           payload=_weight_payload, init=_multi_root_init,
                           frontier0=_finite_frontier, update=_min_update,
                           max_rounds=256, init_only=("roots",))

WCC = TaskProgram(name="wcc", reduce_op="min", payload=_label_payload,
                  init=_label_init, frontier0=_all_frontier,
                  update=_min_update, undirected=True)


def _pr_init(g, params):
    deg = g.degrees().astype(np.float64)
    rank = np.full(g.n, 1.0 / g.n)
    return (rank, deg, np.ones(g.n)), (0.0, 0.0, 0.0)


def _pr_payload(ctx, state, src_slot, w):
    rank, deg, _ = state
    contrib = torch.where(deg > 0, rank / torch.clamp(deg, min=1.0), 0.0)
    return torch.gather(contrib, 1, src_slot)


def _pr_update(ctx, state, frontier, upd):
    """The reference's f32 arithmetic in its order: ``inv_n`` is a float32
    scalar; the Python-float damping terms are rounded to float32 where
    they meet a float32 tensor, as JAX's weak types are. ``inv_n`` is
    filled on the device: a tensor made from a host scalar would copy it
    from pageable memory, which waits for the card every round."""
    rank, deg, vmask = state
    damping = ctx.params["damping"]
    inv_n = torch.full((), 1.0 / ctx.n, dtype=torch.float32,
                       device=rank.device)
    dangling = ctx.gsum(torch.where((vmask > 0) & (deg == 0), rank, 0.0)
                        .sum(1, keepdim=True))
    rank2 = torch.where(vmask > 0, (1.0 - damping) * inv_n
                        + damping * (upd + dangling * inv_n), 0.0)
    return (rank2, deg, vmask), frontier


PAGERANK = TaskProgram(name="pagerank", reduce_op="add", mode="fixed",
                       active="all", payload=_pr_payload, init=_pr_init,
                       frontier0=_all_frontier, update=_pr_update)

SPMV = TaskProgram(name="spmv", reduce_op="add", mode="single",
                   default_capacity_factor=2.0, stream=_spmv_stream)

HISTOGRAM = TaskProgram(name="histogram", reduce_op="add", mode="single",
                        default_capacity_factor=2.0,
                        stream=_histogram_stream,
                        local_reduce=_histogram_local_reduce)


def _kcore_init(g, params):
    # undirected view: degree counts each stored direction (in + out)
    deg = (g.degrees() + g.transpose().degrees()).astype(np.float64)
    return (deg, np.ones(g.n)), (0.0, 0.0)


def _kcore_frontier0(ctx, state):
    deg, alive = state
    return (alive > 0) & (deg < ctx.params["k"])


def _unit_payload(ctx, state, src_slot, w):
    return torch.ones(src_slot.shape, dtype=torch.float32,
                      device=src_slot.device)


def _kcore_update(ctx, state, frontier, upd):
    deg, alive = state
    alive2 = torch.where(frontier, 0.0, alive)    # peeled this round
    deg2 = deg - upd                              # received decrements
    return (deg2, alive2), (alive2 > 0) & (deg2 < ctx.params["k"])


KCORE = TaskProgram(name="kcore", reduce_op="add", undirected=True,
                    payload=_unit_payload, init=_kcore_init,
                    frontier0=_kcore_frontier0, update=_kcore_update)


PROGRAMS = {p.name: p for p in (BFS, SSSP, WCC, PAGERANK, SPMV, HISTOGRAM,
                                KCORE)}


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


def dcra_pagerank(g: CSR, fabric, damping: float = 0.85, iters: int = 20,
                  *, options: Optional[LaunchOptions] = None, setup=None
                  ) -> Tuple[np.ndarray, AppStats]:
    """Distributed PageRank: ``iters`` owner-routed rounds, dangling mass
    redistributed uniformly each round (as the oracle)."""
    (rank, _, _), stats = run_program(
        PAGERANK, g, fabric, options=options,
        params={"damping": float(damping), "iters": int(iters)}, setup=setup)
    return rank, stats


def dcra_kcore(g: CSR, k: int, fabric, *,
               options: Optional[LaunchOptions] = None, max_rounds: int = 128,
               setup=None) -> Tuple[np.ndarray, AppStats]:
    """Distributed k-core by iterative peel: each vertex's within-core
    degree (in + out, each stored edge direction counted) or -1 if
    peeled out of the k-core."""
    (deg, alive), stats = run_program(
        KCORE, g, fabric, options=options, params={"k": float(k)},
        max_rounds=max_rounds, setup=setup)
    return np.where(alive > 0, deg, -1).astype(np.int64), stats


def dcra_spmv(g: CSR, x: np.ndarray, fabric, *,
              options: Optional[LaunchOptions] = None
              ) -> Tuple[np.ndarray, int]:
    """Distributed ``y = A @ x`` in one owner-routed round: ``(y [n]
    float32, dropped tasks)``. The capacity factor defaults to 2.0;
    ``options.seed`` fixes the edge shuffle; ``options.config`` resolves
    against ``g``."""
    y, stats = run_program(SPMV, (g, x), fabric, options=options,
                           dataset=g)
    return y, stats.total_drops


def dcra_histogram(elements: np.ndarray, n_bins: int, fabric, *,
                   options: Optional[LaunchOptions] = None
                   ) -> Tuple[np.ndarray, int]:
    """Distributed histogram in one owner-routed round (the histogram
    kernel on one shard): ``(counts [n_bins] float32, dropped tasks)``."""
    y, stats = run_program(HISTOGRAM, (elements, n_bins), fabric,
                           options=options, dataset=elements)
    return y, stats.total_drops
