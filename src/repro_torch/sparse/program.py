"""The TaskProgram runtime on virtual shards (counterpart of
``repro/sparse/program.py``).

A :class:`TaskProgram` is an app's spec (payload rule, reduce op, update
rule, task class, or a one-round task stream); :func:`run_program` owns
queue and capacity resolution, the flat vs pod/portal path, the cyclic
owner layout, the round loops with per-round :class:`AppStats` (lockstep,
or pipelined: see :func:`_build_graph_fn`), the one-round owner-routed
scatter (:func:`dcra_scatter`) of stream programs, and a cache of round
functions keyed like the reference's compile cache. A graph program's
launch is a device future (:func:`launch_program`,
:class:`ProgramLaunch`); :func:`run_program` is its ``result()``.

Layout: vertex ``v`` lives on shard ``v % S`` at local slot ``v // S``;
edges are partitioned by the owner of their source vertex. Shard state
is ``[S, n_local]`` float32, edges ``[S, E_max]``.

``options.config`` resolves the launch's deployment through
:func:`resolve_launch` (``"auto"``: the Pareto-guided selection of
:mod:`repro_torch.dse.autoconfig`): its pod/portal routing and its IQ
sizing folded onto the fabric's shards.

The analytic twin (:func:`program_rounds`, :func:`program_app_stats`)
runs a graph program's own rules on CPU tensors ``[S, n_local]`` with the
executable's packed-edge admission order and first-``cap``-per-channel
keep rule, kept-only updates, and replays each round's task stream
through :meth:`repro_torch.core.task_engine.TaskEngine.route`: its
per-round message and drop counts equal the executable's exactly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..core.fabric import Fabric
from ..core.queues import QueueConfig
from ..core.routing import (local_route_reduce, owner_route,
                            owner_route_finish, owner_route_hier,
                            owner_route_hier_start, owner_route_start,
                            reduce_received, resolve_caps, resolve_flat_cap,
                            resolve_hier_caps, resolve_route_impl)
from ..core.task_engine import EngineConfig, TaskEngine
from ..core.topology import TileGrid
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


def resolve_launch(config, g, app, objective="teps"):
    """An app's ``config`` as a ``LaunchConfig`` (or ``None``): ``"auto"``
    runs :func:`repro_torch.dse.autoconfig.autoconfigure` on ``g``, a
    ``LaunchConfig`` passes through, a ``DesignPoint`` is wrapped as an
    explicit choice. (Its conflicts with explicit IQ sizing are
    :meth:`LaunchOptions.resolve`'s.)"""
    if config is None:
        return None
    from ..dse.autoconfig import LaunchConfig, autoconfigure, launch_for
    if isinstance(config, str):
        if config != "auto":
            raise ValueError(f"unknown config {config!r} (expected 'auto', "
                             f"a LaunchConfig or a DesignPoint)")
        return autoconfigure(g, app, objective=objective)
    if isinstance(config, LaunchConfig):
        return config
    return launch_for(config, g, objective=objective)


def _launch_sizing(opts: LaunchOptions, lc, fab: Fabric, task: str,
                   default_factor: float, e_local: int
                   ) -> Tuple[Optional[str], QueueConfig]:
    """A launch's pod axis and IQ sizing: with a resolved ``LaunchConfig``
    the explicit pod axis, else the config's (:meth:`pod_axis_for`), and
    the config's queues folded onto the fabric's shards
    (:meth:`device_queues`); without one, ``opts``' own."""
    if lc is None:
        return opts.pod_axis, _resolve_queues(opts, task, default_factor)
    pod_axis = (opts.pod_axis if opts.pod_axis is not None
                else lc.pod_axis_for(fab))
    return pod_axis, lc.device_queues(fab.n_devices, e_local, task,
                                      pod=pod_axis is not None)


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


#: blocking host reads of device values inside the round loops since the
#: last :func:`reset_host_reads` (the lockstep loop's convergence test,
#: the pipelined loop's wait on a flag); ``chip_smoke.py`` reads it
HOST_READS = {"reads": 0}


def reset_host_reads() -> None:
    HOST_READS["reads"] = 0


def prewarm_program(prog: TaskProgram, data, fabric: Fabric, **kwargs
                    ) -> Tuple[tuple, ...]:
    """Build the round function of one (program, shape class, fabric)
    before traffic arrives: one throwaway :func:`run_program` launch
    (``kwargs`` as for it) whose new cache keys come back, ``()`` when
    the class was warm. Params in ``prog.init_only`` stay out of the
    key, so one pre-warm covers every later root."""
    before = set(_CACHE)
    run_program(prog, data, fabric, **kwargs)
    return tuple(k for k in _CACHE if k not in before)


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

def _check_launch(fabric) -> None:
    if not isinstance(fabric, Fabric):
        raise TypeError(f"fabric must be a repro_torch Fabric, got "
                        f"{type(fabric).__name__}")


def run_program(prog: TaskProgram, data, fabric: Fabric, *,
                options: Optional[LaunchOptions] = None,
                params: Optional[Mapping] = None,
                max_rounds: Optional[int] = None, setup=None,
                donate_states: bool = False, dataset=None):
    """Execute a :class:`TaskProgram` on ``fabric``. Graph programs return
    ``(state_arrays, AppStats)``, each state unpacked to global order as
    float64: the :meth:`ProgramLaunch.result` of :func:`launch_program`
    (``setup`` and ``donate_states`` as there). Stream programs return
    ``(y [n_items] numpy float32, AppStats)`` of one round.
    ``options.round_mode="pipelined"`` selects the pipelined round loop:
    the same states, rounds and per-round stats as lockstep.
    ``options.config`` is resolved against a graph program's graph, and
    against a stream program's ``dataset`` (its graph or element stream;
    ``data`` when not given)."""
    opts = resolve_options(options)
    _check_launch(fabric)
    if prog.mode == "single":
        return _launch_stream(prog, data, fabric, opts, dict(params or {}),
                              dataset)
    if prog.mode not in ("while", "fixed"):
        raise ValueError(f"unknown program mode {prog.mode!r}")
    return _launch_graph(prog, data, fabric, opts, dict(params or {}),
                         max_rounds, setup, donate_states).result()


def launch_program(prog: TaskProgram, data, fabric: Fabric, *,
                   options: Optional[LaunchOptions] = None,
                   params: Optional[Mapping] = None,
                   max_rounds: Optional[int] = None, setup=None,
                   donate_states: bool = False) -> "ProgramLaunch":
    """Launch a graph :class:`TaskProgram` without waiting for it: a
    :class:`ProgramLaunch` device future (``repro/sparse/program.py:
    573-603``). Cache key, admission and results are those of
    :func:`run_program`; only when the host waits differs. A
    ``mode="while"`` launch decides on the host when to stop, so it
    returns once its last round is enqueued, which is after the card
    has finished the round before it; a fixed one as soon as its rounds
    are enqueued.

    ``setup`` is a precomputed :func:`_graph_setup` of ``data`` on this
    fabric, as numpy (copied to the card through pinned staging) or
    :func:`resident_setup` (already there). ``donate_states=True`` gives
    the launch's input state tensors to its round loop, which reuses
    them for its states instead of holding them to the end (see
    :func:`_build_graph_fn`); it joins the cache key, only when set. Stream
    programs have no launch future: this raises for them."""
    if prog.mode == "single":
        raise ValueError("launch_program handles graph programs only; "
                         "stream programs run through run_program")
    opts = resolve_options(options)
    _check_launch(fabric)
    return _launch_graph(prog, data, fabric, opts, dict(params or {}),
                         max_rounds, setup, donate_states)


def _launch_stream(prog: TaskProgram, data, fab: Fabric,
                   opts: LaunchOptions, params, dataset=None):
    """One round of a stream program: the single-shard local reduce when
    it cannot change the result, else :func:`dcra_scatter`."""
    n_dev = fab.n_devices
    lc = resolve_launch(opts.config, data if dataset is None else dataset,
                        prog.name, opts.objective)
    dest, vals, n_items = prog.stream(data, params, n_dev, opts.seed)
    pod_axis, queues = _launch_sizing(opts, lc, fab, prog.task,
                                      prog.default_capacity_factor,
                                      len(dest) // n_dev)
    messages = np.array([int((dest >= 0).sum())], np.int64)
    # an explicit route_impl always runs the routed path: the local
    # reduce only replaces the default engine
    if (prog.local_reduce is not None and n_dev == 1
            and pod_axis is None and opts.route_impl is None
            and queues.route_impl is None):
        e_local = len(dest)
        if resolve_flat_cap(queues, prog.task, e_local, n_dev) >= e_local:
            y = prog.local_reduce(data, dest, vals, n_items, fab.device)
            return y, AppStats(rounds=1, messages=messages,
                               drops=np.zeros(1, np.int64))
    y_sh, dropped = dcra_scatter(
        dest, vals, n_items, fab,
        options=LaunchOptions(axis=opts.axis, pod_axis=pod_axis,
                              queues=queues, route_impl=opts.route_impl),
        op=prog.reduce_op, task=prog.task)
    y = from_owner_layout(y_sh.cpu().numpy(), n_items, n_dev)
    return y, AppStats(rounds=1, messages=messages,
                       drops=np.array([int(dropped)], np.int64))


# ---------------------------------------------------------------------------
# graph launches: edges and states onto the device, the device future
# ---------------------------------------------------------------------------

def resident_setup(setup, device) -> tuple:
    """A :func:`_graph_setup` moved onto ``device`` once: ``(n_local,
    src_slot [S, E_max] int64, dst [S, E_max] int32, w [S, E_max]
    float32, E_max)``. Launches given it as ``setup=`` copy no edges."""
    n_local, src_slot, dst, w, e_max = setup
    device = torch.device(device)

    def on(a):
        return torch.as_tensor(a).to(device).view(-1, e_max)
    return n_local, on(src_slot).long(), on(dst), on(w), e_max


def _to_device(arrays, device):
    """Host arrays onto ``device``: on the card through pinned staging
    and non-blocking copies, which return before the card has them (the
    staging must live until the launch's event: the second return
    value); on the CPU, views of the arrays."""
    host = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    if device.type != "cuda":
        return host, ()
    pins = [torch.empty(h.shape, dtype=h.dtype, pin_memory=True).copy_(h)
            for h in host]
    return [p.to(device, non_blocking=True) for p in pins], tuple(pins)


class ProgramLaunch:
    """One graph-program launch in flight: a device future
    (``repro/sparse/program.py:513-570``).

    * :meth:`is_ready` polls, never blocks: the launch's CUDA event has
      completed (always true on the CPU);
    * :meth:`block` waits for the device (``event.synchronize()``); a
      fault of the launch surfaces here and poisons this launch only;
    * :meth:`result` blocks, copies to the host and unpacks:
      ``(state_arrays, AppStats)``, bit-identical to :func:`run_program`.
      Idempotent; the device tensors and the staging are released on the
      first call."""

    def __init__(self, fab: Fabric, outs, n: int, n_states: int,
                 staging=()):
        self._fab, self._outs, self._staging = fab, outs, staging
        self._n, self._n_states = n, n_states
        self._result = None
        self._event = None
        if fab.device.type == "cuda":
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(fab.device))

    def is_ready(self) -> bool:
        if self._result is not None or self._event is None:
            return True
        return self._event.query()

    def block(self) -> "ProgramLaunch":
        if self._result is None and self._event is not None:
            self._event.synchronize()
        return self

    def result(self):
        if self._result is None:
            self.block()
            outs = self._outs
            state, (r, msgs, drops) = outs[:self._n_states], outs[-3:]
            r = int(r)
            stats = AppStats(
                rounds=r, messages=msgs[:r].cpu().numpy().astype(np.int64),
                drops=drops[:r].cpu().numpy().astype(np.int64))
            n_dev = self._fab.n_devices
            states = tuple(np.asarray(from_owner_layout(
                s.reshape(-1).cpu().numpy(), self._n, n_dev), np.float64)
                for s in state)
            self._result = (states, stats)
            self._outs = self._staging = None
        return self._result


def _launch_graph(prog: TaskProgram, g, fab: Fabric,  # noqa: PLR0917
                  opts: LaunchOptions, params, max_rounds, setup,
                  donate_states=False) -> ProgramLaunch:
    """Resolve, hit the round-function cache and enqueue the launch; the
    :class:`ProgramLaunch` it returns has not waited for the device."""
    n_dev, n = fab.n_devices, g.n
    lc = resolve_launch(opts.config, g, prog.name, opts.objective)
    if setup is None:
        setup = _graph_setup(g, n_dev, undirected=prog.undirected,
                             seed=opts.seed)
    n_local, src_slot, dst, w, E_max = setup
    if (int(np.prod(dst.shape)) != n_dev * E_max
            or n_local != -(-n // n_dev)):
        raise ValueError("setup= was packed for another graph or fabric")
    pod_axis, queues = _launch_sizing(opts, lc, fab, prog.task,
                                      prog.default_capacity_factor, E_max)
    caps, pods = resolve_caps(fab, queues, prog.task, E_max, opts.axis,
                              pod_axis, clamp=True)
    impl = resolve_route_impl(opts.route_impl if opts.route_impl is not None
                              else queues.route_impl)
    states0, fills = prog.init(g, params)
    packed = [np.asarray(owner_layout(s, n_dev, f)[0], np.float32)
              for s, f in zip(states0, fills)]
    if prog.mode == "fixed":
        rounds = int(params["iters"])
    else:
        rounds = int(max_rounds if max_rounds is not None
                     else prog.max_rounds)
    # no rounds, nothing to overlap (repro/sparse/program.py:743)
    round_mode = opts.round_mode if rounds > 0 else "lockstep"
    kparams = {k: v for k, v in params.items() if k not in prog.init_only}
    key = (prog, n, n_dev, n_local, E_max, opts.axis, pod_axis, pods,
           caps, impl, rounds, round_mode, len(packed),
           tuple(sorted(kparams.items())), fab.fabric_key())
    if donate_states:
        key = key + ("donate",)
    fn = _cached(key, lambda: _build_graph_fn(
        prog, pods, n_dev, n_local, n, caps, kparams, rounds, impl,
        round_mode, donate_states))
    if isinstance(dst, torch.Tensor):
        if dst.device != fab.device:
            raise ValueError(f"setup= lies on {dst.device}, the fabric on "
                             f"{fab.device}")
        edges, pins = (src_slot, dst, w), ()
    else:
        edges, pins = _to_device((src_slot, dst, w), fab.device)
        edges = [e.view(n_dev, E_max) for e in edges]
        edges[0] = edges[0].long()
    states, spins = _to_device(packed, fab.device)
    states = [s.view(n_dev, -1) for s in states]   # donation empties it
    outs = fn(*edges, states)
    return ProgramLaunch(fab, outs, n, len(packed), pins + spins)


class _HostFlags:
    """Booleans the pipelined loop posts from the device and reads back
    later: on the card a non-blocking copy into pinned host memory
    behind a CUDA event, read after waiting on that event; on the CPU
    read at once."""

    def __init__(self, rounds: int, device: torch.device):
        self._cuda = device.type == "cuda"
        self._host = torch.zeros(max(rounds, 1), dtype=torch.bool,
                                 pin_memory=self._cuda)
        self._events = {}

    def post(self, i: int, flag: torch.Tensor) -> None:
        self._host[i].copy_(flag, non_blocking=self._cuda)
        if self._cuda:
            ev = self._events[i] = torch.cuda.Event()
            ev.record()

    def read(self, i: int) -> bool:
        HOST_READS["reads"] += 1
        if self._cuda:
            self._events.pop(i).synchronize()
        return bool(self._host[i])


def _build_graph_fn(prog, pods, n_dev, n_local, n,  # noqa: PLR0917
                    caps, params, rounds, impl, round_mode="lockstep",
                    donate_states=False):
    """The round loop for one shape class. Two shapes, selected by
    ``round_mode``, with the same states, rounds and per-round stats:

    * ``"lockstep"``: payload -> bucket -> all_to_all -> receive-reduce
      -> update, with the global message and drop counts per round; a
      while-mode loop reads ``frontier.any()`` back to the host once a
      round;
    * ``"pipelined"`` (``repro/sparse/program.py:776-796``): round k's
      exchange is produced at the tail of iteration k-1 and consumed at
      the head of iteration k, the wire the carry between them. Message
      and drop counts stay per shard and are summed once after the loop;
      the global frontier count rides the exchange as a signal row
      (:func:`owner_route_start`). Every iteration is gated by
      ``is_real`` (round 0 always real, later ones while the frontier
      they consume was non-empty), so an iteration after convergence
      changes nothing. The host enqueues iteration k+1 before it reads
      the flag iteration k computed (whether iteration k+1 is real), so
      the card always has an iteration queued; a while-mode loop runs at
      most ``rounds`` iterations and stops after the first unreal one,
      as the reference's. On one flat shard with a min or store reduce
      the receive-reduce folds into admission (:func:`local_route_reduce`,
      ``fold_local``): no wire at all, the same gated loop.

    A fixed-mode program runs the lockstep loop in either mode: it reads
    nothing on the host, so on one stream "produce at the tail of k-1,
    consume at the head of k" enqueues lockstep's operations in
    lockstep's order, and its ``rounds`` rounds are the reference's
    ``rounds - 1`` iterations and drain.

    The round function takes the edges and a list of the input state
    tensors ``[S, n_local]``. With ``donate_states`` it owns them: the
    gated loop writes every iteration's states into them (``out=``), so
    its outputs are the input tensors, and the lockstep loop empties the
    list and lets go of them once round 0 has read them, so the
    allocator hands their memory to later rounds. Either way no state is
    copied, and the launch holds one state fewer at its peak."""
    CACHE_STATS["kernel_traces"] += 1
    ctx = Ctx(n=n, n_dev=n_dev, params=params, gsum=gsum)
    fold_local = (round_mode == "pipelined" and pods is None
                  and n_dev == 1 and prog.reduce_op in ("min", "store"))
    pipelined = round_mode == "pipelined" and not fold_local

    def run(src_slot, dst, w, state_in):
        owner = dst.clamp(min=0) % n_dev
        slot = dst.clamp(min=0) // n_dev
        evalid = dst >= 0
        dev = dst.device

        def active_of(frontier):
            return (torch.gather(frontier, 1, src_slot) & evalid
                    if prog.active == "frontier" else evalid)

        def payload(state):
            return prog.payload(ctx, state, src_slot, w).to(torch.float32)

        def do_round(state, frontier):
            """One whole round; per-shard counts ``[S]``."""
            active = active_of(frontier)
            vals = payload(state)
            m = active.sum(1, dtype=torch.int32)
            if fold_local:
                upd, nd = local_route_reduce(
                    vals, slot, owner, active, n_dev, caps[0], n_local,
                    prog.reduce_op, impl=impl)
            else:
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
            return state2, frontier2, m, nd

        def produce(state, frontier):
            """Round tail: payload, bucket and the exchange, the shard's
            frontier count riding it: ``(recv, meta, m [S], nd [S],
            gcnt [S])``."""
            active = active_of(frontier)
            vals = payload(state)
            m = active.sum(1, dtype=torch.int32)
            fcnt = frontier.sum(1, dtype=torch.int32)
            if pods is None:
                recv, meta, nd, gcnt = owner_route_start(
                    vals, slot, owner, active, n_dev, caps[0], fcnt,
                    impl=impl)
            else:
                recv, meta, nd, gcnt = owner_route_hier_start(
                    vals, slot, owner, active, pods[0], pods[1], caps[0],
                    caps[1], fcnt, impl=impl)
            return recv, meta, m, nd, gcnt

        def consume(recv, meta):
            """Round head: the receive-reduce of the carried wire."""
            recv_slot, recv_val = owner_route_finish(recv, meta)
            return reduce_received(recv_slot, recv_val, n_local,
                                   prog.reduce_op, impl=impl)

        msgs = torch.zeros(rounds, n_dev, dtype=torch.int32, device=dev)
        drops = torch.zeros(rounds, n_dev, dtype=torch.int32, device=dev)
        state = tuple(state_in)
        frontier = prog.frontier0(ctx, state)
        r = 0
        if round_mode == "lockstep" or prog.mode == "fixed":
            if donate_states:
                state_in.clear()       # round 0's update lets go of them
            while r < rounds:
                state, frontier, msgs[r], drops[r] = do_round(state, frontier)
                r += 1
                if prog.mode == "while":
                    HOST_READS["reads"] += 1
                    if not bool(frontier.any()):
                        break
        else:                                      # pipelined, while
            flags = _HostFlags(rounds, dev)
            r = torch.zeros((), dtype=torch.int32, device=dev)
            if pipelined:
                recv, meta, m, nd, gcnt = produce(state, frontier)
            for i in range(rounds):
                if pipelined:
                    upd = consume(recv, meta)
                    state2, frontier2 = prog.update(ctx, state, frontier,
                                                    upd)
                else:
                    state2, frontier2, m, nd = do_round(state, frontier)
                # round 0 always runs; a later iteration is real while
                # the frontier it consumed was non-empty
                real = (torch.ones((), dtype=torch.bool, device=dev)
                        if i == 0 else live)
                state = tuple(torch.where(real, a, b,
                                          out=b if donate_states else None)
                              for a, b in zip(state2, state))
                frontier = torch.where(real, frontier2, frontier)
                msgs[i] = torch.where(real, m, 0)
                drops[i] = torch.where(real, nd, 0)
                r = r + real.to(torch.int32)
                if i + 1 == rounds:
                    break
                if pipelined:
                    recv, meta, m, nd, gcnt = produce(state, frontier)
                    live = gcnt[0] > 0
                else:
                    live = frontier.any()
                flags.post(i, live)
                if i >= 1 and not flags.read(i - 1):
                    break                  # iteration i was the unreal one
        return (*state, r, msgs.sum(1, dtype=torch.int32),
                drops.sum(1, dtype=torch.int32))

    return run


# ---------------------------------------------------------------------------
# the analytic twin: the rules on CPU tensors, replayed through TaskEngine
# ---------------------------------------------------------------------------

def _channel_ranks(keys):
    """Stable rank of each key among the equal keys before it, in array
    order: the admission order of ``bucket``."""
    if not len(keys):
        return np.zeros(0, np.int64)
    # a stable sort's permutation is unique, so a 16-bit copy of the
    # (non-negative) keys gives the same order, radix-sorted
    order = np.argsort(keys.astype(np.uint16) if keys.max() < 1 << 16
                       else keys, kind="stable")
    ks = keys[order]
    starts = np.r_[0, np.flatnonzero(ks[1:] != ks[:-1]) + 1]
    sizes = np.diff(np.r_[starts, len(ks)])
    out = np.empty(len(ks), np.int64)
    out[order] = np.arange(len(ks)) - np.repeat(starts, sizes)
    return out


def _bucket_positions(chan, active):
    """Stable per-channel cumcount of the active tasks, in array order.
    -1 where inactive."""
    pos = np.full(len(chan), -1, np.int64)
    idx = np.flatnonzero(active)
    pos[idx] = _channel_ranks(chan[idx])
    return pos


def _flat_keep(chan, active, cap):
    """The flat keep rule: the first ``cap`` active tasks of each (sender
    shard, owner) channel ``chan = sender * S + owner``. ``(keep,
    n_drop)``."""
    idx = np.flatnonzero(active)
    keep = np.zeros(len(active), bool)
    keep[idx[_channel_ranks(chan[idx]) < cap]] = True
    return keep, int(len(idx) - keep.sum())


def _hier_keep(dev_of, owner, active, caps, pods):  # noqa: PLR0917
    """The two-stage pod/portal keep rule (as :func:`owner_route_hier`):
    stage 1 admits per (sender, dest intra coordinate) channel at cap1;
    stage 2 admits at the portal per dest pod at cap2, in the order the
    exchange delivers (sender intra rank, then stage-1 slot)."""
    n_intra, n_pods = pods
    cap1, cap2 = caps
    e_coord = owner % n_intra
    p_coord = owner // n_intra
    pos1 = _bucket_positions(dev_of * n_intra + e_coord, active)
    keep1 = active & (pos1 < cap1)
    drop1 = int(active.sum() - keep1.sum())
    portal = (dev_of // n_intra) * n_intra + e_coord
    idx = np.flatnonzero(keep1)
    arr = idx[np.lexsort((pos1[idx], dev_of[idx] % n_intra, portal[idx]))]
    chan2 = (portal * n_pods + p_coord)[arr]
    pos2 = _bucket_positions(chan2, np.ones(len(arr), bool))
    keep = np.zeros(len(active), bool)
    keep[arr[pos2 < cap2]] = True
    drop2 = int(len(arr) - keep.sum())
    return keep, drop1 + drop2


def _graph_caps(queues: QueueConfig, task: str,  # noqa: PLR0917
                e_local: int, n_dev: int,
                pods: Optional[Tuple[int, int]]) -> Tuple[int, ...]:
    """A graph program's per-round capacities, flat (allocation-clamped
    at ``e_local``, as :func:`_launch_graph`) or pod/portal."""
    if queues.iq_sizes.get(task) is not None and pods is not None:
        raise ValueError("explicit cap is only defined for the flat path")
    if pods is None:
        return (resolve_flat_cap(queues, task, e_local, n_dev, clamp=True),)
    return resolve_hier_caps(queues, task, e_local, *pods)


def program_rounds(prog: TaskProgram, g, n_dev, caps,  # noqa: PLR0917
                   params=None, seed=0,
                   pods=None, max_rounds=None, setup=None):
    """Host mirror of a graph program's round loop: yields, a round, the
    routed task stream ``(src_global, dst_global, n_drop)`` (every active
    task, and the drop count of the keep rule) while evolving the state
    with the kept tasks only, as the executable does. The state is the
    executable's: CPU tensors ``[S, n_local]`` that the program's own
    rules update, with the packed edges of :func:`_graph_setup` (``setup``
    if given, as numpy), so the admission order is the executable's.
    Received tasks fold through the plain receive-reduce."""
    params = dict(params or {})
    kparams = {k: v for k, v in params.items() if k not in prog.init_only}
    n = g.n
    n_local, src_slot, dst, w, E_max = (
        setup if setup is not None
        else _graph_setup(g, n_dev, undirected=prog.undirected, seed=seed))
    src_slot = np.asarray(src_slot).reshape(-1).astype(np.int64)
    dst = np.asarray(dst).reshape(-1)
    dev_of = np.repeat(np.arange(n_dev), E_max)
    evalid = dst >= 0
    dstl = dst.astype(np.int64)
    owner = np.where(evalid, dstl % n_dev, 0)
    src_global = src_slot * n_dev + dev_of
    chan = dev_of * n_dev + owner            # the flat (sender, owner) channel
    src_t = torch.from_numpy(src_slot).view(n_dev, E_max)
    w_t = torch.from_numpy(np.asarray(w, np.float32).reshape(n_dev, E_max))
    evalid_t = torch.from_numpy(evalid).view(n_dev, E_max)

    ctx = Ctx(n=n, n_dev=n_dev, params=kparams, gsum=gsum)
    states0, fills = prog.init(g, params)
    state = tuple(torch.from_numpy(np.asarray(
        owner_layout(s, n_dev, f)[0], np.float32)).view(n_dev, n_local)
        for s, f in zip(states0, fills))
    frontier = prog.frontier0(ctx, state)
    if prog.mode == "fixed":
        rounds = int(params["iters"])
    else:
        rounds = int(max_rounds if max_rounds is not None
                     else prog.max_rounds)

    changed, r = True, 0
    while r < rounds and (prog.mode == "fixed" or changed):
        active_t = (torch.gather(frontier, 1, src_t) & evalid_t
                    if prog.active == "frontier" else evalid_t)
        active = active_t.reshape(-1).numpy().copy()
        vals = prog.payload(ctx, state, src_t, w_t).to(torch.float32)
        if pods is None:
            keep, n_drop = _flat_keep(chan, active, caps[0])
        else:
            keep, n_drop = _hier_keep(dev_of, owner, active, caps, pods)
        kd = dstl[keep]
        kidx = (kd % n_dev) * n_local + kd // n_dev
        upd = reduce_received(
            torch.from_numpy(kidx.astype(np.int32))[None],
            vals.reshape(-1)[torch.from_numpy(keep)][None],
            n_dev * n_local, prog.reduce_op, impl="sort")
        yield src_global[active], dstl[active], n_drop
        state, frontier = prog.update(ctx, state, frontier,
                                      upd.view(n_dev, n_local))
        changed = bool(frontier.any())
        r += 1


def program_app_stats(prog: TaskProgram, data, n_dev, *,
                      queues: Optional[QueueConfig] = None,
                      cap: Optional[int] = None,
                      capacity_factor: Optional[float] = None,
                      params=None, seed=0,
                      pods: Optional[Tuple[int, int]] = None,
                      max_rounds=None, setup=None) -> AppStats:
    """The analytic twin of one launch on ``n_dev`` shards: the program's
    task stream (:func:`program_rounds`, or ``prog.stream``) replayed a
    round at a time through ``TaskEngine.route`` on a ``TileGrid(1,
    n_dev)`` at the capacity the executable resolves from the same
    :class:`QueueConfig`; one tile a shard gives the same (source shard,
    owner) channels, so the per-round message and drop counts equal the
    executable's :class:`AppStats`. The pod/portal path (``pods =
    (n_intra, n_pods)``) is counted by the two-stage keep rule. A graph
    program's ``setup`` is its :func:`_graph_setup` on ``n_dev`` shards
    (numpy), packed here when not given."""
    params = dict(params or {})
    queues = _resolve_queues(
        LaunchOptions(queues=queues, cap=cap,
                      capacity_factor=capacity_factor),
        prog.task, prog.default_capacity_factor)

    if prog.mode == "single":
        dest, _, n_items = prog.stream(data, params, n_dev, seed)
        e_local = len(dest) // n_dev
        dev_of = np.repeat(np.arange(n_dev), e_local)
        active = dest >= 0
        if pods is None:
            rcap = resolve_flat_cap(queues, prog.task, e_local, n_dev)
            engine = TaskEngine(EngineConfig(
                grid=TileGrid(1, n_dev),
                queues=QueueConfig(default_iq=rcap)), n_items)
            rs = engine.route(prog.task, src_idx=dev_of[active],
                              dst_idx=dest[active].astype(np.int64))
            return AppStats(rounds=1,
                            messages=np.array([rs.tasks_total], np.int64),
                            drops=np.array([rs.drops], np.int64))
        caps = resolve_hier_caps(queues, prog.task, e_local, *pods)
        owner = np.where(active, dest.astype(np.int64) % n_dev, 0)
        _, n_drop = _hier_keep(dev_of, owner, active, caps, pods)
        return AppStats(rounds=1,
                        messages=np.array([int(active.sum())], np.int64),
                        drops=np.array([n_drop], np.int64))

    if setup is None:
        setup = _graph_setup(data, n_dev, undirected=prog.undirected,
                             seed=seed)
    caps = _graph_caps(queues, prog.task, setup[-1], n_dev, pods)
    msgs, drops = [], []
    engine = None
    if pods is None:
        engine = TaskEngine(EngineConfig(
            grid=TileGrid(1, n_dev),
            queues=QueueConfig(default_iq=caps[0])), data.n)
    for src, dst, n_drop in program_rounds(prog, data, n_dev, caps,
                                           params=params, seed=seed,
                                           pods=pods, max_rounds=max_rounds,
                                           setup=setup):
        if engine is not None:
            rs = engine.route(prog.task, src_idx=src, dst_idx=dst)
            if rs.drops != n_drop:
                raise AssertionError(f"the engine's drops {rs.drops} differ "
                                     f"from the keep rule's {n_drop}")
            msgs.append(rs.tasks_total)
            drops.append(rs.drops)
        else:
            msgs.append(len(dst))
            drops.append(n_drop)
    return AppStats(rounds=len(msgs),
                    messages=np.asarray(msgs, np.int64),
                    drops=np.asarray(drops, np.int64))
