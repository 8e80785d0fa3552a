"""The TaskProgram runtime on virtual shards (counterpart of
``repro/sparse/program.py:64-380, 606-964``, lockstep graph programs).

A :class:`TaskProgram` is an app's spec (payload rule, reduce op, update
rule, task class); :func:`run_program` owns queue and capacity
resolution, the flat vs pod/portal path, the cyclic owner layout, the
lockstep round loop with per-round :class:`AppStats`, and a cache of
round functions keyed like the reference's compile cache.

Layout: vertex ``v`` lives on shard ``v % S`` at local slot ``v // S``;
edges are partitioned by the owner of their source vertex. Shard state
is ``[S, n_local]`` float32, edges ``[S, E_max]``.

Not in this slice: stream programs (``mode="single"``,
``dcra_scatter``), ``round_mode="pipelined"``, ``config="auto"``, device
futures (``launch_program``) and the analytic twin; each raises or is
absent, and ``ROADMAP.md`` queues it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..core.fabric import Fabric
from ..core.queues import QueueConfig
from ..core.routing import (owner_route, owner_route_hier, reduce_received,
                            resolve_caps, resolve_route_impl)
from .options import LaunchOptions, resolve_options


# ---------------------------------------------------------------------------
# per-round instrumentation
# ---------------------------------------------------------------------------

@dataclass
class AppStats:
    """Per-round NoC counters of one run: ``messages`` counts routed
    (active) tasks per round, owner-local ones included; ``drops``
    counts IQ-overflow discards."""
    rounds: int
    messages: np.ndarray          # [rounds] int64
    drops: np.ndarray             # [rounds] int64

    @property
    def total_messages(self) -> int:
        return int(self.messages.sum())

    @property
    def total_drops(self) -> int:
        return int(self.drops.sum())


# ---------------------------------------------------------------------------
# the program spec
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Ctx:
    """What a program rule sees. Rules take torch tensors with the shard
    on the leading dimension; ``gsum`` sums per-shard values ``[S, ...]``
    over all shards and hands the total back to every shard (the
    reference's ``psum``)."""
    n: int                       # global item count
    n_dev: int
    params: Mapping
    gsum: Callable


def gsum(x: torch.Tensor) -> torch.Tensor:
    return x.sum(0, keepdim=True).expand_as(x)


@dataclass(frozen=True)
class TaskProgram:
    """Declarative spec of one graph app. ``init`` runs on the host
    (numpy, global order); ``frontier0`` / ``payload`` / ``update`` run
    on ``[S, ...]`` tensors. ``mode="while"`` runs while any frontier is
    non-empty (and ``r < max_rounds``), ``mode="fixed"`` runs
    ``params["iters"]`` rounds. ``init_only`` params feed ``init`` only
    and stay out of the cache key and the rules' ``Ctx``."""
    name: str
    reduce_op: str = "min"                 # "add" | "min" | "store"
    mode: str = "while"                    # "while" | "fixed"
    undirected: bool = False               # route both edge directions
    active: str = "frontier"               # "frontier" | "all" edges emit
    task: str = "T3"                       # QueueConfig task class
    default_capacity_factor: float = 4.0
    max_rounds: int = 128
    init_only: Tuple[str, ...] = ()
    init: Optional[Callable] = None        # (g, params) -> (states, fills)
    frontier0: Optional[Callable] = None   # (ctx, state) -> bool [S, n_local]
    payload: Optional[Callable] = None     # (ctx, state, src_slot, w) -> vals
    update: Optional[Callable] = None      # (ctx, state, frontier, upd)
    #                                      #   -> (state2, frontier2)


# ---------------------------------------------------------------------------
# cyclic owner layout (vertex v -> shard v % n_dev, slot v // n_dev)
# ---------------------------------------------------------------------------

def _owner_pack_np(arr, n_dev, fill):
    """A dense [n] array in cyclic-owner order (shard-major), padding
    slots ``fill``: ``(packed [n_local * n_dev] float64, valid)``."""
    arr = np.asarray(arr, np.float64)
    n = len(arr)
    n_local = -(-n // n_dev)
    idx = np.arange(n_local * n_dev)
    g = (idx % n_local) * n_dev + idx // n_local
    valid = g < n
    out = np.full(n_local * n_dev, fill, np.float64)
    out[valid] = arr[g[valid]]
    return out, valid


def from_owner_layout(y_sharded: np.ndarray, n: int, n_dev: int):
    """Inverse of :func:`_owner_pack_np`: [n_local * n_dev] -> [n]."""
    n_local = -(-n // n_dev)
    g = np.arange(n)
    return y_sharded[(g % n_dev) * n_local + g // n_dev]


# ---------------------------------------------------------------------------
# edge packing (host side, numpy: byte-identical to the reference)
# ---------------------------------------------------------------------------

def _pack_edges(rows, cols, wts, n_dev, seed=0):  # noqa: PLR0917
    """Partition edges by source owner: ``(src_slot, dst, w, E_max)``,
    each ``[n_dev * E_max]`` shard-major; padding edges carry dst = -1.
    One seeded shuffle, then a stable argsort by owner: the order within
    a shard is the admission order, so it must match the reference."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(rows))
    rows = rows[perm]
    own = (rows % n_dev).astype(np.int64)
    # a stable sort's permutation is unique: sorting a 16-bit copy (numpy
    # radix-sorts it) gives the reference's order, much faster at 10^8 edges
    order = np.argsort(own.astype(np.uint16) if n_dev <= 1 << 16 else own,
                       kind="stable")
    rows, take = rows[order], perm[order]
    counts = np.bincount(own, minlength=n_dev)
    E_max = max(8, int(counts.max(initial=0)))
    src_slot = np.zeros((n_dev, E_max), np.int32)
    dst = np.full((n_dev, E_max), -1, np.int32)
    w = np.zeros((n_dev, E_max), np.float32)
    lo = 0
    for s, c in enumerate(counts.tolist()):     # shard s: one sorted run
        run = slice(lo, lo + c)
        src_slot[s, :c] = rows[run] // n_dev
        dst[s, :c] = cols[take[run]]
        w[s, :c] = wts[take[run]]
        lo += c
    return src_slot.reshape(-1), dst.reshape(-1), w.reshape(-1), E_max


def _graph_setup(g, n_dev, undirected=False, seed=0):
    """``(n_local, src_slot, dst, w, E_max)`` of ``g`` on ``n_dev``
    shards. Pass it to :func:`run_program` as ``setup=`` to reuse one
    packing across launches."""
    rows, cols, wts = g.row_of(), g.col_idx.astype(np.int64), g.values
    if undirected:
        rows, cols = np.concatenate([rows, cols]), np.concatenate([cols,
                                                                   rows])
        wts = np.concatenate([wts, wts])
    src_slot, dst, w, E_max = _pack_edges(rows, cols, wts, n_dev, seed)
    n_local = -(-g.n // n_dev)
    return n_local, src_slot, dst, w, E_max


def _resolve_queues(prog: TaskProgram, queues, cap, capacity_factor):
    if queues is not None:
        return queues
    if cap is not None:
        return QueueConfig.from_cap(cap, prog.task)
    if capacity_factor is None:
        capacity_factor = prog.default_capacity_factor
    return QueueConfig.from_factor(capacity_factor, prog.task)


# ---------------------------------------------------------------------------
# the round-function cache
# ---------------------------------------------------------------------------

_CACHE: Dict[tuple, Callable] = {}
CACHE_STATS = {"hits": 0, "misses": 0, "kernel_traces": 0}


def cache_stats() -> Dict[str, int]:
    """Copy of the cache counters: a repeated same-shape launch is a
    ``hits`` increment with ``kernel_traces`` unchanged."""
    return dict(CACHE_STATS)


def clear_cache() -> None:
    _CACHE.clear()
    for k in CACHE_STATS:
        CACHE_STATS[k] = 0


def _cached(key, build):
    fn = _CACHE.get(key)
    if fn is None:
        CACHE_STATS["misses"] += 1
        fn = _CACHE[key] = build()
    else:
        CACHE_STATS["hits"] += 1
    return fn


def cache_keys() -> Tuple[tuple, ...]:
    return tuple(_CACHE)


# ---------------------------------------------------------------------------
# the runtime
# ---------------------------------------------------------------------------

def run_program(prog: TaskProgram, data, fabric: Fabric, *,
                options: Optional[LaunchOptions] = None,
                params: Optional[Mapping] = None,
                max_rounds: Optional[int] = None, setup=None):
    """Execute a graph :class:`TaskProgram` on ``fabric``: returns
    ``(state_arrays, AppStats)``, each state unpacked to global order as
    float64. ``setup`` is an optional precomputed :func:`_graph_setup`
    of ``data`` on this fabric (same ``undirected`` and seed)."""
    opts = resolve_options(options)
    if not isinstance(fabric, Fabric):
        raise TypeError(f"fabric must be a repro_torch Fabric, got "
                        f"{type(fabric).__name__}")
    if opts.config is not None:
        raise NotImplementedError(
            "config= needs the DSE/auto-configuration stack, not ported yet "
            "(ROADMAP queue 1, item 10)")
    if opts.round_mode != "lockstep":
        raise NotImplementedError(
            "round_mode='pipelined' is not ported yet (ROADMAP queue 1, "
            "item 5)")
    if prog.mode not in ("while", "fixed"):
        raise NotImplementedError(
            f"mode={prog.mode!r}: stream programs and dcra_scatter are not "
            f"ported yet (ROADMAP queue 1, item 4)")
    return _launch_graph(prog, data, fabric, opts, dict(params or {}),
                         max_rounds, setup)


def _launch_graph(prog: TaskProgram, g, fab: Fabric,  # noqa: PLR0917
                  opts: LaunchOptions, params, max_rounds, setup):
    n_dev, n = fab.n_devices, g.n
    if setup is None:
        setup = _graph_setup(g, n_dev, undirected=prog.undirected,
                             seed=opts.seed)
    n_local, src_slot, dst, w, E_max = setup
    if len(dst) != n_dev * E_max or n_local != -(-n // n_dev):
        raise ValueError("setup= was packed for another graph or fabric")
    queues = _resolve_queues(prog, opts.queues, opts.cap,
                             opts.capacity_factor)
    caps, pods = resolve_caps(fab, queues, prog.task, E_max, opts.axis,
                              opts.pod_axis, clamp=True)
    impl = resolve_route_impl(opts.route_impl if opts.route_impl is not None
                              else queues.route_impl)
    states0, fills = prog.init(g, params)
    packed = tuple(np.asarray(_owner_pack_np(s, n_dev, f)[0], np.float32)
                   for s, f in zip(states0, fills))
    if prog.mode == "fixed":
        rounds = int(params["iters"])
    else:
        rounds = int(max_rounds if max_rounds is not None
                     else prog.max_rounds)
    kparams = {k: v for k, v in params.items() if k not in prog.init_only}
    key = (prog, n, n_dev, n_local, E_max, opts.axis, opts.pod_axis, pods,
           caps, impl, rounds, opts.round_mode, len(packed),
           tuple(sorted(kparams.items())), fab.fabric_key())
    fn = _cached(key, lambda: _build_graph_fn(
        prog, pods, n_dev, n_local, n, caps, kparams, rounds, impl))

    def to_dev(a):
        return torch.from_numpy(a).to(fab.device).view(n_dev, -1)

    state, r, msgs, drops = fn(to_dev(src_slot).long(), to_dev(dst),
                               to_dev(w), *(to_dev(s) for s in packed))
    stats = AppStats(rounds=r,
                     messages=msgs[:r].cpu().numpy().astype(np.int64),
                     drops=drops[:r].cpu().numpy().astype(np.int64))
    states = tuple(np.asarray(from_owner_layout(
        s.reshape(-1).cpu().numpy(), n, n_dev), np.float64) for s in state)
    return states, stats


def _build_graph_fn(prog, pods, n_dev, n_local, n,  # noqa: PLR0917
                    caps, params, rounds, impl):
    """The lockstep round loop for one shape class: payload -> bucket ->
    all_to_all -> receive-reduce -> update, with the global message and
    drop counts per round. ``changed`` is read back to the host once per
    round (pipelined rounds, which avoid that, are a later slice)."""
    CACHE_STATS["kernel_traces"] += 1
    ctx = Ctx(n=n, n_dev=n_dev, params=params, gsum=gsum)

    def run(src_slot, dst, w, *state):
        owner = dst.clamp(min=0) % n_dev
        slot = dst.clamp(min=0) // n_dev
        evalid = dst >= 0

        def do_round(state, frontier):
            active = (torch.gather(frontier, 1, src_slot) & evalid
                      if prog.active == "frontier" else evalid)
            vals = prog.payload(ctx, state, src_slot, w).to(torch.float32)
            m = active.sum()
            if pods is None:
                recv_slot, recv_val, nd = owner_route(
                    vals, slot, owner, active, n_dev, caps[0], impl=impl)
            else:
                recv_slot, recv_val, nd = owner_route_hier(
                    vals, slot, owner, active, pods[0], pods[1], caps[0],
                    caps[1], impl=impl)
            upd = reduce_received(recv_slot, recv_val, n_local,
                                  prog.reduce_op, impl=impl)
            state2, frontier2 = prog.update(ctx, state, frontier, upd)
            return state2, frontier2, m, nd.sum()

        msgs = torch.zeros(rounds, dtype=torch.int32, device=dst.device)
        drops = torch.zeros(rounds, dtype=torch.int32, device=dst.device)
        frontier = prog.frontier0(ctx, state)
        r = 0
        while r < rounds:
            state, frontier, msgs[r], drops[r] = do_round(state, frontier)
            r += 1
            if prog.mode == "while" and not bool(frontier.any()):
                break
        return state, r, msgs, drops

    return run
