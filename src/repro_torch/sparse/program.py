"""The TaskProgram runtime on virtual shards (counterpart of
``repro/sparse/program.py:64-506, 606-964``, lockstep rounds).

A :class:`TaskProgram` is an app's spec (payload rule, reduce op, update
rule, task class, or a one-round task stream); :func:`run_program` owns
queue and capacity resolution, the flat vs pod/portal path, the cyclic
owner layout, the lockstep round loop with per-round :class:`AppStats`,
the one-round owner-routed scatter (:func:`dcra_scatter`) of stream
programs, and a cache of round functions keyed like the reference's
compile cache.

Layout: vertex ``v`` lives on shard ``v % S`` at local slot ``v // S``;
edges are partitioned by the owner of their source vertex. Shard state
is ``[S, n_local]`` float32, edges ``[S, E_max]``.

Not in this slice: ``round_mode="pipelined"`` for graph programs,
``config="auto"``, device futures (``launch_program``) and the analytic
twin; each raises or is absent, and ``ROADMAP.md`` queues it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..core.fabric import Fabric
from ..core.queues import QueueConfig
from ..core.routing import (owner_route, owner_route_hier, reduce_received,
                            resolve_caps, resolve_flat_cap,
                            resolve_route_impl)
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
    """Declarative spec of one app. Graph programs: ``init`` runs on the
    host (numpy, global order); ``frontier0`` / ``payload`` / ``update``
    run on ``[S, ...]`` tensors. ``mode="while"`` runs while any frontier
    is non-empty (and ``r < max_rounds``), ``mode="fixed"`` runs
    ``params["iters"]`` rounds. ``init_only`` params feed ``init`` only
    and stay out of the cache key and the rules' ``Ctx``.

    Stream programs (``mode="single"``) define ``stream`` only: one
    owner-routed round of host-built ``(dest, value)`` tasks. Their
    optional ``local_reduce`` replaces that round on one shard when no
    task can drop."""
    name: str
    reduce_op: str = "min"                 # "add" | "min" | "store"
    mode: str = "while"                    # "while" | "fixed" | "single"
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
    stream: Optional[Callable] = None      # (data, params, n_dev, seed)
    #                                      #   -> (dest, vals, n_items)
    # (data, dest, vals, n_items, device) -> y [n_items] numpy float32:
    # consulted by run_program on one shard with no pod axis, no explicit
    # route impl and a cap no task can overflow, so results are unchanged
    local_reduce: Optional[Callable] = None


# ---------------------------------------------------------------------------
# cyclic owner layout (vertex v -> shard v % n_dev, slot v // n_dev)
# ---------------------------------------------------------------------------

def owner_layout(arr, n_dev, fill=0.0):
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
    """Inverse of :func:`owner_layout`: [n_local * n_dev] -> [n]."""
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


def _resolve_queues(opts: LaunchOptions, task: str, default_factor: float
                    ) -> QueueConfig:
    """The IQ sizing of a launch: ``opts.queues``, else ``opts.cap``
    exactly, else ``opts.capacity_factor`` (``default_factor`` when
    unset), for ``task``."""
    if opts.queues is not None:
        return opts.queues
    if opts.cap is not None:
        return QueueConfig.from_cap(opts.cap, task)
    return QueueConfig.from_factor(default_factor if opts.capacity_factor
                                   is None else opts.capacity_factor, task)


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
# the one-round owner-routed scatter (stream programs; public API)
# ---------------------------------------------------------------------------

def dcra_scatter(dest, vals, n: int, fabric: Fabric, *,
                 options: Optional[LaunchOptions] = None, op: str = "add",
                 task: str = "T3"):
    """Owner-routed scatter-reduce in one NoC round.

    ``dest`` / ``vals`` ``[E]`` (numpy or tensors) are the tasks, shard
    ``d`` holding the contiguous slice ``[d*E/S, (d+1)*E/S)``; a task with
    ``dest < 0`` is padding. Item ``i`` is owned by shard ``i % S`` at
    slot ``i // S``. Returns ``(y, dropped)``: ``y [n_local * S]`` float32
    on the fabric's device in the cyclic owner layout (shard-major), and
    the 0-dim count of tasks dropped by a full queue.

    Sizing as in the reference: ``options.queues`` names the per-``task``
    IQ, ``options.cap`` is honoured exactly (flat path only),
    ``options.capacity_factor`` defaults to 1.5 here. ``round_mode`` has
    no effect: a scatter is a single round."""
    opts = resolve_options(options)
    if not isinstance(fabric, Fabric):
        raise TypeError(f"fabric must be a repro_torch Fabric, got "
                        f"{type(fabric).__name__}")
    n_dev = fabric.n_devices
    e_total = int(dest.shape[0])
    if e_total % n_dev or int(vals.shape[0]) != e_total:
        raise ValueError(f"dest and vals must be [E] with E a multiple of "
                         f"{n_dev}, got {tuple(dest.shape)} and "
                         f"{tuple(vals.shape)}")
    e_local = e_total // n_dev
    n_local = -(-n // n_dev)
    queues = _resolve_queues(opts, task, 1.5)
    caps, pods = resolve_caps(fabric, queues, task, e_local, opts.axis,
                              opts.pod_axis)
    impl = resolve_route_impl(opts.route_impl if opts.route_impl is not None
                              else queues.route_impl)
    key = ("scatter", op, n_local, n_dev, opts.axis, opts.pod_axis, pods,
           caps, impl, fabric.fabric_key(), e_total)
    fn = _cached(key, lambda: _build_scatter_fn(pods, n_dev, n_local, caps,
                                                op, impl))
    dest_t = torch.as_tensor(dest).to(fabric.device, torch.int32)
    vals_t = torch.as_tensor(vals).to(fabric.device, torch.float32)
    return fn(dest_t.view(n_dev, e_local), vals_t.view(n_dev, e_local))


def _build_scatter_fn(pods, n_dev, n_local, caps, op, impl):
    """One scatter round for one shape class: bucket by owner, exchange,
    fold at the owner by ``op``; returns ``(y flat, dropped)``."""
    CACHE_STATS["kernel_traces"] += 1

    def run(dest, vals):
        valid = dest >= 0                          # padding -> no task
        dest_c = dest.clamp(min=0)
        slot, owner = dest_c // n_dev, dest_c % n_dev
        if pods is None:
            recv_slot, recv_val, n_drop = owner_route(
                vals, slot, owner, valid, n_dev, caps[0], impl=impl)
        else:
            recv_slot, recv_val, n_drop = owner_route_hier(
                vals, slot, owner, valid, pods[0], pods[1], caps[0], caps[1],
                impl=impl)
        y = reduce_received(recv_slot, recv_val, n_local, op, impl=impl)
        return y.reshape(-1), n_drop.sum()

    return run


# ---------------------------------------------------------------------------
# the runtime
# ---------------------------------------------------------------------------

def run_program(prog: TaskProgram, data, fabric: Fabric, *,
                options: Optional[LaunchOptions] = None,
                params: Optional[Mapping] = None,
                max_rounds: Optional[int] = None, setup=None):
    """Execute a :class:`TaskProgram` on ``fabric``. Graph programs return
    ``(state_arrays, AppStats)``, each state unpacked to global order as
    float64; ``setup`` is an optional precomputed :func:`_graph_setup`
    of ``data`` on this fabric (same ``undirected`` and seed). Stream
    programs return ``(y [n_items] numpy float32, AppStats)`` of one
    round."""
    opts = resolve_options(options)
    if not isinstance(fabric, Fabric):
        raise TypeError(f"fabric must be a repro_torch Fabric, got "
                        f"{type(fabric).__name__}")
    if opts.config is not None:
        raise NotImplementedError(
            "config= needs the DSE/auto-configuration stack, not ported yet "
            "(ROADMAP queue 1, item 10)")
    if prog.mode == "single":
        return _launch_stream(prog, data, fabric, opts, dict(params or {}))
    if prog.mode not in ("while", "fixed"):
        raise ValueError(f"unknown program mode {prog.mode!r}")
    if opts.round_mode != "lockstep":
        raise NotImplementedError(
            "round_mode='pipelined' is not ported yet (ROADMAP queue 1, "
            "item 5)")
    return _launch_graph(prog, data, fabric, opts, dict(params or {}),
                         max_rounds, setup)


def _launch_stream(prog: TaskProgram, data, fab: Fabric,
                   opts: LaunchOptions, params):
    """One round of a stream program: the single-shard local reduce when
    it cannot change the result, else :func:`dcra_scatter`."""
    n_dev = fab.n_devices
    dest, vals, n_items = prog.stream(data, params, n_dev, opts.seed)
    queues = _resolve_queues(opts, prog.task, prog.default_capacity_factor)
    messages = np.array([int((dest >= 0).sum())], np.int64)
    # an explicit route_impl always runs the routed path: the local
    # reduce only replaces the default engine
    if (prog.local_reduce is not None and n_dev == 1
            and opts.pod_axis is None and opts.route_impl is None
            and queues.route_impl is None):
        e_local = len(dest)
        if resolve_flat_cap(queues, prog.task, e_local, n_dev) >= e_local:
            y = prog.local_reduce(data, dest, vals, n_items, fab.device)
            return y, AppStats(rounds=1, messages=messages,
                               drops=np.zeros(1, np.int64))
    y_sh, dropped = dcra_scatter(
        dest, vals, n_items, fab,
        options=LaunchOptions(axis=opts.axis, pod_axis=opts.pod_axis,
                              queues=queues, route_impl=opts.route_impl),
        op=prog.reduce_op, task=prog.task)
    y = from_owner_layout(y_sh.cpu().numpy(), n_items, n_dev)
    return y, AppStats(rounds=1, messages=messages,
                       drops=np.array([int(dropped)], np.int64))


def _launch_graph(prog: TaskProgram, g, fab: Fabric,  # noqa: PLR0917
                  opts: LaunchOptions, params, max_rounds, setup):
    n_dev, n = fab.n_devices, g.n
    if setup is None:
        setup = _graph_setup(g, n_dev, undirected=prog.undirected,
                             seed=opts.seed)
    n_local, src_slot, dst, w, E_max = setup
    if len(dst) != n_dev * E_max or n_local != -(-n // n_dev):
        raise ValueError("setup= was packed for another graph or fabric")
    queues = _resolve_queues(opts, prog.task, prog.default_capacity_factor)
    caps, pods = resolve_caps(fab, queues, prog.task, E_max, opts.axis,
                              opts.pod_axis, clamp=True)
    impl = resolve_route_impl(opts.route_impl if opts.route_impl is not None
                              else queues.route_impl)
    states0, fills = prog.init(g, params)
    packed = tuple(np.asarray(owner_layout(s, n_dev, f)[0], np.float32)
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
