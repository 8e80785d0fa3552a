"""The resident ProgramServer: warm TaskPrograms serving a stream
(counterpart of ``repro/serve/engine.py``).

One server owns a fabric, a registry of resident graphs (each tenant
product graph packed once, on the fabric's device) and the TaskProgram
round-function cache. Life of a request:

1. **Admission** — the tenant's :class:`~repro_torch.core.queues.QueueConfig`
   resolves a per-round task *budget* (:meth:`QueueConfig.round_budget`,
   task class ``"serve"``). A request whose estimated per-round demand
   (its graph's edge count / its token block's task count) does not fit
   the tenant's remaining budget is rejected **before launch** —
   retriable when draining queued work could admit it, non-retriable
   when its demand alone exceeds the budget — admission replaces silent
   in-flight IQ drops.
2. **Batching** — admitted graph queries of one (program, graph) shape
   class are fused into a fixed-width tenant-column batch
   (:mod:`repro_torch.serve.batching`): one launch serves up to
   ``batch_width`` tenants; short batches are padded so every launch hits
   the SAME round-function cache entry.
3. **Execution** — :func:`repro_torch.sparse.program.launch_program` on
   the batched program, with the resident packing as ``setup=`` (no
   launch re-packs or re-copies a product graph): launches are *device
   futures* (CUDA events),
   held in an inflight window of up to ``ServeOptions.inflight_depth``
   batches so batch k+1 forms and launches while batch k computes;
   results are harvested lazily, oldest-first, and per-request results
   are the unpacked tenant columns, bit-identical to standalone launches
   for the min-reduce programs under ANY depth.
4. **Observability** — per-tenant and aggregate counters
   (:mod:`repro_torch.serve.stats`): queue depth, cache hit rate,
   NoC drops (always attributed, never swallowed), p50/p99 latency.
5. **Resilience** — the failure posture is a first-class contract
   (:mod:`repro_torch.serve.resilience`): a failed launch (at dispatch, from
   the device at harvest, in the MoE lane, or an injected host loss)
   never takes the server down. With ``ServeOptions.max_retries`` set,
   the poisoned batch's riders are requeued at the head of their
   tenant's queue with deterministic exponential backoff; past the
   retry budget or a ``deadline_s``, the request fails with a distinct
   reason. A per-shape-class :class:`~repro_torch.serve.resilience.
   CircuitBreaker` fails persistent offenders fast, and a ``host_loss``
   fault shrinks the :class:`~repro_torch.core.fabric.Fabric` to the
   survivors, re-prewarms only the classes with queued traffic, and
   relaunches — min-reduce survivors stay bit-identical to a fault-free
   run. Every fault is injectable deterministically by launch index via
   :class:`~repro_torch.serve.resilience.ServeFailurePlan`.

MoE dispatch rides the same loop through :class:`MoEService`: token
blocks are batched to a fixed [B, S, D] shape class and dispatched
through one ``moe_dcra`` callable on the service's fabric.

On a distributed :class:`~repro_torch.core.fabric.Fabric` every process
builds the same server and submits the same requests in the same order;
each holds its own shards' rows of the resident graphs, and the launches'
exchanges cross processes. Every decision that reads a clock or the card
(deadline expiry, the backoff park and its sleep, which inflight batches
are ready, the outcome of a launch) is made once and agreed
(:meth:`~repro_torch.core.scaleout.ProcessExchange.agree`), so every
process launches the same batches, pairs the same exchanges, and returns
the same responses and statistics.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Mapping, Optional, Tuple

import numpy as np

from ..core.fabric import Fabric
from ..core.queues import QueueConfig
from ..runtime.fault_tolerance import InjectedFailure, RetryLedger
from ..sparse import program as program_mod
from ..sparse.csr import CSR
from ..sparse.options import LaunchOptions
from ..sparse.program import (_graph_setup, prewarm_program,
                              resident_setup)
from .batching import (BATCHED_PROGRAMS, DrrFormer, FifoFormer, TenantBatch,
                       batched_program, split_tenant_states, tenant_graph)
from .options import ServeOptions
from .resilience import (BREAKER_CLOSED, FAULT_DEVICE, FAULT_HOST_LOSS,
                         CircuitBreaker, ServeFailurePlan)
from .stats import ServingStats

STATUS_OK = "ok"
STATUS_REJECTED = "rejected"          # admission control; retriable unless
                                      # the request can never fit the budget
STATUS_FAILED = "failed"

#: the QueueConfig task class admission budgets resolve through
ADMISSION_TASK = "serve"


@dataclass(frozen=True)
class Request:
    """One unit of tenant traffic.

    Graph queries name a resident ``graph`` and a ``root``; MoE dispatch
    requests carry a ``payload`` token block [S, D] instead.
    """
    req_id: int
    tenant: str
    program: str                       # "bfs" | "sssp" | "moe"
    graph: Optional[str] = None
    root: int = 0
    payload: Optional[np.ndarray] = None
    params: Mapping = field(default_factory=dict)


@dataclass(frozen=True)
class Response:
    """One request's outcome — immutable once issued (like
    :class:`Request`, part of the stable ``repro_torch.serve`` surface)."""
    req_id: int
    tenant: str
    status: str                        # STATUS_OK | _REJECTED | _FAILED
    retriable: bool = False
    reason: str = ""
    result: Optional[np.ndarray] = None
    batch_drops: int = 0               # NoC drops of the fused launch
    batch_messages: int = 0            # routed tasks of the fused launch
    rounds: int = 0
    batch_width: int = 0               # real tenants in the launch
    latency_s: float = 0.0             # end-to-end: submit -> harvest
    queue_wait_s: float = 0.0          # submit -> launch (formation wait)
    device_s: float = 0.0              # launch -> harvest (compute + xfer)
    retries: int = 0                   # failed launches this request rode
                                       # before this terminal outcome


@dataclass
class _Pending:
    """One admitted request waiting in a batch former (the former only
    reads ``tenant`` / ``klass`` / ``demand``). A retried entry keeps
    its original ``t_enq`` (latency and the deadline both span the whole
    life of the request, retries included); ``not_before`` parks it out
    of the former until its backoff elapses."""
    req: Request
    t_enq: float                       # submit() wall-clock
    demand: int                        # admission-time task estimate
    deadline: Optional[float] = None   # absolute perf_counter deadline
    not_before: float = 0.0            # backoff gate for retried entries

    @property
    def tenant(self) -> str:
        return self.req.tenant

    @property
    def klass(self) -> Tuple[str, Optional[str]]:
        return (self.req.program, self.req.graph)


@dataclass
class _InflightBatch:
    """One launched-but-unharvested fused batch in the window.

    ``launch`` is the :class:`~repro_torch.sparse.program.ProgramLaunch`
    device future; ``error`` is set instead when the launch itself threw
    (the batch then 'completes' instantly at harvest with every rider
    failed, keeping response order identical to the synchronous loop).
    Launch-time cache-delta and padding stats are stashed here and
    applied only on successful harvest, matching the synchronous loop's
    accounting on the failure path.
    """
    entries: List[_Pending]
    batch: TenantBatch
    g_n: int                           # base-graph vertex count
    t_launch: float
    launch: Optional[object] = None    # ProgramLaunch
    error: Optional[str] = None
    cache_hits: int = 0
    cache_misses: int = 0
    index: int = 0                     # server-wide launch index
    inject_device: bool = False        # ServeFailurePlan device fault:
                                       # surface an error at harvest

    @property
    def klass(self) -> Tuple[str, Optional[str]]:
        return (self.batch.program, self.batch.graph)

    def ready(self) -> bool:
        return self.error is not None or self.launch.is_ready()


class ProgramServer:
    """Resident serving engine over one fabric + graph registry.

    ``fabric`` is a :class:`repro_torch.core.fabric.Fabric`.

    ``tenant_queues`` maps tenant -> :class:`QueueConfig` admission
    budget (``default_queues`` covers the rest; ``None`` = unbounded
    admission). ``options`` is the :class:`LaunchOptions` default applied
    to EVERY launch the server issues (pre-warm included) — queue sizing
    (``options.queues``), ``route_impl``, ``round_mode="pipelined"``, all
    of it; the legacy ``axis=`` / ``launch_queues=`` kwargs fill it
    instead (both with ``options=`` raise ``ValueError``). The default
    factor-4 sizing is
    drop-free for the serving graphs, which is what keeps batched results
    bit-identical to standalone runs.

    ``serve_options`` is the :class:`~repro_torch.serve.options.ServeOptions`
    for the loop itself — inflight window depth, batch-formation
    fairness (FIFO vs deficit round-robin), state-buffer donation. The
    default reproduces the synchronous drain loop bit-for-bit.

    **The serving-loop contract** (one place, the three methods below are
    thin entries into it):

    * :meth:`step` advances the pipeline by one batch: it launches
      fused batches (the batch former pops up to ``batch_width``
      requests of one (program, graph) class, one per tenant; each
      becomes a single padded tenant-column
      :func:`~repro_torch.sparse.program.launch_program` device future) until
      the inflight window holds ``ServeOptions.inflight_depth`` of
      them, then harvests every *completed* batch oldest-first —
      blocking on the oldest only when nothing is ready — and returns
      the harvested responses, ``[]`` when idle. Responses always
      stream in launch order; with ``inflight_depth=1`` this is exactly
      the old launch-then-block step. An MoE batch is a synchronous
      barrier: the window settles first, then the one MoE dispatch
      runs. A failed launch — at dispatch or surfacing from the device
      at harvest — never takes the server down and poisons only its
      own batch; earlier and later inflight batches complete normally.
      With the default ``ServeOptions`` every rider of a poisoned
      batch gets a non-retriable :data:`STATUS_FAILED` response (the
      historical behavior, byte-identical reasons); with
      ``max_retries > 0`` riders with remaining retry budget AND
      deadline are requeued at the head of their tenant's queue (with
      deterministic backoff) instead, and only budget/deadline
      exhaustion is terminal. ``breaker_threshold`` consecutive
      failures of one (program, graph) class open that class's circuit
      breaker: submissions fail fast retriably, formed batches hold,
      one half-open probe decides. An injected ``host_loss`` fault
      shrinks the fabric (:meth:`~repro_torch.core.fabric.Fabric.shrink`),
      requeues the poisoned window's riders and re-prewarms ONLY the
      classes with queued traffic — unaffected classes are never
      re-built.
    * :meth:`drain` calls :meth:`step` until the queue, the inflight
      window AND the backoff park are empty, concatenating responses
      (launch order across batches).
    * :meth:`run` is submit-then-drain for a whole request list:
      admission rejections are collected (never dropped), the queue is
      drained, and ALL responses come back sorted by ``req_id``.

    Responses are one-to-one with submitted requests in every path, and
    (for the deterministic min-reduce programs) bit-identical across
    every ``inflight_depth`` and to standalone launches.
    """

    def __init__(self, fabric: Fabric, graphs: Dict[str, CSR], *,
                 axis: str = "data",
                 batch_width: int = 4,
                 tenant_queues: Optional[Dict[str, QueueConfig]] = None,
                 default_queues: Optional[QueueConfig] = None,
                 launch_queues: Optional[QueueConfig] = None,
                 max_rounds: Optional[int] = None,
                 moe: Optional["MoEService"] = None,
                 options: Optional[LaunchOptions] = None,
                 serve_options: Optional[ServeOptions] = None,
                 failure_plan: Optional[ServeFailurePlan] = None):
        if not isinstance(fabric, Fabric):
            raise TypeError(f"fabric must be a repro_torch Fabric, got "
                            f"{type(fabric).__name__}")
        if options is not None:
            if axis != "data" or launch_queues is not None:
                raise ValueError("options= conflicts with explicit axis=/"
                                 "launch_queues=: fold them into the "
                                 "LaunchOptions")
            self.options = options.resolve()
        else:
            self.options = LaunchOptions(axis=axis,
                                         queues=launch_queues).resolve()
        self.fabric = fabric
        self.axis = self.options.axis
        self.graphs = dict(graphs)
        self.batch_width = int(batch_width)
        self.tenant_queues = dict(tenant_queues or {})
        self.default_queues = default_queues
        self.launch_queues = self.options.queues
        self.max_rounds = max_rounds
        self.moe = moe
        self.serve_options = (serve_options or ServeOptions()).resolve()
        self.stats = ServingStats()
        self._former = (DrrFormer(self.serve_options.drr_quantum)
                        if self.serve_options.fairness == "drr"
                        else FifoFormer())
        self._window: Deque[_InflightBatch] = deque()
        self._inflight_demand: Dict[str, int] = {}
        self._n_dev = self.fabric.n_devices
        # resilience state (repro_torch.serve.resilience): deterministic fault
        # schedule, per-request retry ledger, per-shape-class breakers,
        # and the backoff park (retried entries waiting out not_before)
        self.failure_plan = failure_plan
        self._retry = RetryLedger(
            max_retries=self.serve_options.max_retries,
            backoff_base_s=self.serve_options.backoff_base_s)
        self._breakers: Dict[Tuple[str, Optional[str]], CircuitBreaker] = {}
        self._parked: List[_Pending] = []
        self._launch_index = 0
        # (graph, program's edge direction) -> the tenant product graph
        # packed once on the current fabric, on its device
        self._resident: Dict[Tuple[str, bool], tuple] = {}

    # ---- admission -------------------------------------------------------

    def _demand(self, req: Request) -> int:
        """Estimated per-round task injection of one request: worst case,
        every edge of the tenant's column emits (graph queries), or every
        token spawns top-k expert tasks (MoE)."""
        if req.program == "moe":
            if self.moe is None:
                raise ValueError("server has no MoEService configured")
            return self.moe.demand(req.payload)
        prog = batched_program(req.program)
        g = self.graphs[req.graph]
        return g.nnz * (2 if prog.undirected else 1)

    def _budget(self, tenant: str, demand: int) -> Optional[int]:
        q = self.tenant_queues.get(tenant, self.default_queues)
        if q is None:
            return None
        return q.round_budget(ADMISSION_TASK, demand, self._n_dev)

    def submit(self, req: Request) -> Optional[Response]:
        """Admit ``req`` into the serving queue, or reject it.

        Returns ``None`` on admission; a :data:`STATUS_REJECTED` response
        when the tenant's per-round budget is exhausted —
        ``retriable=True`` when the request would fit an idle budget (the
        tenant may resubmit once its queued work drains),
        ``retriable=False`` when its demand alone exceeds the budget, so
        no amount of draining could ever admit it. A non-closed circuit
        breaker for the request's (program, graph) class also rejects —
        always retriably, naming the breaker — before any budget is
        charged. Unknown programs/graphs and out-of-range roots fail
        loudly at submit time.
        """
        ts = self.stats.tenant(req.tenant)
        ts.submitted += 1
        if req.program == "moe":
            if self.moe is None:
                ts.failed += 1
                return Response(req.req_id, req.tenant, STATUS_FAILED,
                                reason="server has no MoEService configured")
        else:
            if req.program not in BATCHED_PROGRAMS:
                ts.failed += 1
                return Response(req.req_id, req.tenant, STATUS_FAILED,
                                reason=f"no batched program {req.program!r}")
            if req.graph not in self.graphs:
                ts.failed += 1
                return Response(req.req_id, req.tenant, STATUS_FAILED,
                                reason=f"unknown graph {req.graph!r}")
            n = self.graphs[req.graph].n
            if not 0 <= int(req.root) < n:
                # an unchecked root would seed distance 0 inside ANOTHER
                # tenant's column (_multi_root_init writes dist[t*n+root])
                ts.failed += 1
                return Response(
                    req.req_id, req.tenant, STATUS_FAILED,
                    reason=(f"root {req.root} out of range [0, {n}) "
                            f"for graph {req.graph!r}"))
        br = self._breakers.get((req.program, req.graph))
        if br is not None and br.state != BREAKER_CLOSED:
            # fail fast: the class keeps failing on device — reject
            # retriably at admission instead of burning a launch slot
            ts.rejected += 1
            return Response(req.req_id, req.tenant, STATUS_REJECTED,
                            retriable=True, reason=br.reject_reason())
        demand = self._demand(req)
        budget = self._budget(req.tenant, demand)
        pending = self._inflight_demand.get(req.tenant, 0)
        if budget is not None and pending + demand > budget:
            ts.rejected += 1
            if demand > budget:
                return Response(
                    req.req_id, req.tenant, STATUS_REJECTED,
                    retriable=False,
                    reason=(f"demand {demand} exceeds tenant budget "
                            f"{budget} tasks/round — can never be "
                            f"admitted; resubmission is futile"))
            return Response(
                req.req_id, req.tenant, STATUS_REJECTED, retriable=True,
                reason=(f"tenant budget {budget} tasks/round: "
                        f"{pending} pending + {demand} requested"))
        self._inflight_demand[req.tenant] = pending + demand
        now = time.perf_counter()
        deadline = (None if self.serve_options.deadline_s is None
                    else now + self.serve_options.deadline_s)
        self._former.push(_Pending(req, now, demand, deadline=deadline))
        self.stats.observe_queue_depth(len(self._former))
        return None

    # ---- pre-warm --------------------------------------------------------

    def prewarm(self, programs: Tuple[str, ...] = ("bfs", "sssp"),
                graphs: Optional[Tuple[str, ...]] = None) -> Dict:
        """Build the round function of every (program, graph,
        batch_width) shape class before traffic arrives; returns
        {(program, graph): keys}.

        Init-only roots are outside the cache key, so one
        pre-warm per shape class covers every later request batch.
        """
        out = {}
        for name in programs:
            if name == "moe":
                if self.moe is not None:
                    self.moe.prewarm()
                continue
            for gname in (graphs if graphs is not None else self.graphs):
                out[(name, gname)] = self._prewarm_class(name, gname)
        return out

    def _prewarm_class(self, name: str, gname: str):
        """Build ONE (program, graph, batch_width) shape class's round
        function on the server's *current* fabric — the unit
        :meth:`prewarm` iterates and the host-loss path re-runs for
        exactly the classes with queued traffic (never the whole
        registry: an unaffected class must not re-build)."""
        prog = batched_program(name)
        keys = prewarm_program(
            prog, tenant_graph(self.graphs[gname], self.batch_width),
            self.fabric, options=self.options, max_rounds=self.max_rounds,
            donate_states=self.serve_options.donate_buffers,
            params={"roots": (0,) * self.batch_width},
            setup=self._resident_setup(prog, gname))
        self.stats.prewarmed_keys += len(keys)
        return keys

    def _resident_setup(self, prog, gname: str) -> tuple:
        """The tenant product graph of ``gname`` packed for ``prog``'s
        edge direction on the current fabric, once: every launch of the
        class passes it as ``setup=`` (results and cache keys are those
        of a launch that packs for itself). On a distributed fabric only
        this process's rows reach its device."""
        key = (gname, prog.undirected)
        got = self._resident.get(key)
        if got is None:
            tg = tenant_graph(self.graphs[gname], self.batch_width)
            got = self._resident[key] = resident_setup(
                _graph_setup(tg, self._n_dev, undirected=prog.undirected,
                             seed=self.options.seed), self.fabric.device,
                fabric=self.fabric)
        return got

    def _agree(self, value, pick=None):
        """``value`` as every process of the fabric decides it (rank 0's,
        or ``pick`` of all of them): a decision that reads a clock or
        the card must come out the same in every process. ``value`` on a
        virtual fabric."""
        xchg = self.fabric.exchange
        return value if xchg is None else xchg.agree(value, pick)

    def _agree_error(self, err: Optional[str]) -> Optional[str]:
        """A launch failed if it failed in any process: the first
        process's error, in rank order."""
        return self._agree(err, pick=lambda errs: next(
            (e for e in errs if e is not None), None))

    # ---- the serving loop ------------------------------------------------

    def _width_for(self, entry: _Pending) -> int:
        return (self.moe.batch if entry.req.program == "moe"
                else self.batch_width)

    def _finish(self, entry: _Pending, resp: Response) -> Response:
        req = entry.req
        left = self._inflight_demand.get(req.tenant, 0) - entry.demand
        if left < 0:                   # would mask a double-_finish bug
            raise AssertionError(
                f"tenant {req.tenant!r} inflight demand went negative "
                f"({left}) finishing req {req.req_id} — double _finish?")
        if left:
            self._inflight_demand[req.tenant] = left
        else:
            # drop zeroed keys: a resident server must not leak one dict
            # slot per tenant ever seen
            del self._inflight_demand[req.tenant]
        self._retry.clear(req.req_id)  # terminal outcome: O(inflight) ledger
        ts = self.stats.tenant(req.tenant)
        if resp.status == STATUS_OK:
            ts.served += 1
        else:
            ts.failed += 1
        ts.noc_drops += resp.batch_drops
        ts.messages += resp.batch_messages
        ts.rounds += resp.rounds
        ts.latencies.append(resp.latency_s)
        ts.queue_waits.append(resp.queue_wait_s)
        ts.device_times.append(resp.device_s)
        return resp

    # ---- resilience helpers ----------------------------------------------

    def _next_launch_slot(self) -> Tuple[int, Optional[str]]:
        """Claim the next launch index and pop any fault the plan
        scheduled there — the ONE place the index advances, so graph and
        MoE launches share a single deterministic counter."""
        idx = self._launch_index
        self._launch_index += 1
        kind = (self.failure_plan.due(idx)
                if self.failure_plan is not None else None)
        return idx, kind

    def _breaker(self, klass: Tuple[str, Optional[str]]
                 ) -> Optional[CircuitBreaker]:
        if self.serve_options.breaker_threshold is None:
            return None
        br = self._breakers.get(klass)
        if br is None:
            br = self._breakers[klass] = CircuitBreaker(
                threshold=self.serve_options.breaker_threshold,
                klass=klass)
        return br

    def _breaker_observe(self, klass, *, ok: bool) -> None:
        """Feed one launch outcome to the class's breaker and count the
        open/close transitions."""
        br = self._breaker(klass)
        if br is None:
            return
        if ok:
            if br.record_success():
                self.stats.breaker_closes += 1
        elif br.record_failure():
            self.stats.breaker_opens += 1

    def _requeue(self, entries: List[_Pending]) -> None:
        """Head-of-queue requeue for a failed batch's riders: reverse
        push_front keeps their relative order; entries still backing off
        go to the park instead (step() readmits them once ``not_before``
        passes)."""
        now = time.perf_counter()
        park = self._agree([e.not_before > now for e in entries])
        for e, parked in zip(reversed(entries), reversed(park)):
            if parked:
                self._parked.append(e)
            else:
                self._former.push_front(e)
        if self._parked:
            order = self._agree(sorted(range(len(self._parked)),
                                       key=lambda i: self._parked[i].not_before))
            self._parked = [self._parked[i] for i in order]

    def _unpark(self) -> None:
        """Move parked entries whose backoff elapsed back to the head of
        their queues."""
        if not self._parked:
            return
        now = time.perf_counter()
        due = self._agree([e.not_before <= now for e in self._parked])
        ready = [e for e, d in zip(self._parked, due) if d]
        if ready:
            self._parked = [e for e, d in zip(self._parked, due) if not d]
            for e in reversed(ready):
                self._former.push_front(e)

    def _expire(self, entries: List[_Pending]
                ) -> Tuple[List[_Pending], List[Response]]:
        """Split formed entries into (still live, deadline-failed): a
        request past ``deadline_s`` fails non-retriably with a distinct
        reason BEFORE spending a launch on it."""
        if self.serve_options.deadline_s is None:
            return entries, []
        now = time.perf_counter()
        live, dead = [], []
        late = self._agree([e.deadline is not None and now >= e.deadline
                            for e in entries])
        for e, past in zip(entries, late):
            if past:
                dead.append(self._finish(e, Response(
                    e.req.req_id, e.req.tenant, STATUS_FAILED,
                    retriable=False,
                    reason=(f"deadline {self.serve_options.deadline_s:.6g}s "
                            f"exceeded before launch"),
                    latency_s=now - e.t_enq, queue_wait_s=now - e.t_enq,
                    retries=self._retry.attempt(e.req.req_id))))
            else:
                live.append(e)
        return live, dead

    def _settle_failed(self, entries: List[_Pending], err: str,
                       t_launch: float,
                       requeue_to: Optional[List[_Pending]] = None
                       ) -> List[Response]:
        """Disposition of a poisoned batch's riders: requeue those with
        retry budget and deadline remaining (head-of-queue, backoff via
        ``not_before``); fail the rest non-retriably — past-deadline
        riders and exhausted riders each with a distinct reason. With
        ``max_retries=0`` (default) this is byte-identical to the
        historical every-rider-fails path. ``requeue_to`` collects the
        retried riders instead of requeueing them now (the host-loss
        path settles several batches before one combined requeue that
        restores launch order)."""
        so = self.serve_options
        t1 = time.perf_counter()
        dt = t1 - t_launch
        out: List[Response] = []
        requeue: List[_Pending] = (requeue_to if requeue_to is not None
                                   else [])
        late = self._agree([e.deadline is not None and t1 >= e.deadline
                            for e in entries])
        for e, past in zip(entries, late):
            rid = e.req.req_id
            if past:
                out.append(self._finish(e, Response(
                    e.req.req_id, e.req.tenant, STATUS_FAILED,
                    retriable=False,
                    reason=(f"deadline {so.deadline_s:.6g}s exceeded "
                            f"({err})"),
                    latency_s=t1 - e.t_enq, device_s=dt,
                    queue_wait_s=t_launch - e.t_enq,
                    retries=self._retry.attempt(rid))))
            elif so.max_retries > 0 and self._retry.record_failure(rid):
                e.not_before = t1 + self._retry.backoff_s(rid)
                self.stats.tenant(e.req.tenant).retries += 1
                self.stats.retries += 1
                requeue.append(e)
            else:
                n = self._retry.attempt(rid)
                reason = (err if n == 0 else
                          f"{err} [failed after {n - 1} retries]")
                out.append(self._finish(e, Response(
                    e.req.req_id, e.req.tenant, STATUS_FAILED, reason=reason,
                    latency_s=t1 - e.t_enq, device_s=dt,
                    queue_wait_s=t_launch - e.t_enq, retries=max(0, n - 1))))
        if requeue_to is None:
            self._requeue(requeue)
        return out

    def _lose_hosts(self, entries: List[_Pending]) -> List[Response]:
        """The elastic-degrade path for an injected ``host_loss``:
        shrink the fabric to the survivors, poison every inflight batch
        (their launches ran on lost devices) AND the batch that was
        about to launch — all riders go through the normal retry
        disposition — then re-prewarm ONLY the shape classes that still
        have queued traffic. Min-reduce results on the shrunken fabric
        are bit-identical under drop-free sizing, so retried riders
        match a fault-free run."""
        plan = self.failure_plan
        old_n = self._n_dev
        keep = (plan.keep_devices if plan is not None
                and plan.keep_devices else max(1, old_n // 2))
        self.fabric = self.fabric.shrink(keep)
        self._n_dev = self.fabric.n_devices
        self._resident.clear()         # packed for the lost fabric
        self.stats.host_losses += 1
        err = (f"InjectedFailure: host loss at launch "
               f"{self._launch_index} (fabric {old_n} -> "
               f"{self._n_dev} devices)")
        out: List[Response] = []
        riders: List[_Pending] = []    # combined requeue: one reversed
        lost, self._window = list(self._window), deque()
        for ib in lost:                # poisoned window, oldest first
            out.extend(self._settle_failed(ib.entries, err, ib.t_launch,
                                           requeue_to=riders))
        out.extend(self._settle_failed(entries, err, time.perf_counter(),
                                       requeue_to=riders))
        self._requeue(riders)          # push_front puts riders[0] (the
        # oldest poisoned batch's first rider) back at the very head, so
        # relaunches replay in the original launch order
        classes = set(self._former.pending_classes())
        classes.update(e.klass for e in self._parked)
        for name, gname in sorted(c for c in classes if c[0] != "moe"):
            self._prewarm_class(name, gname)
        return out

    # ---- launch / harvest ------------------------------------------------

    def _launch_batch(self, entries: List[_Pending]) -> _InflightBatch:
        """Dispatch one fused batch WITHOUT waiting on the result: the
        returned record enters the inflight window. A launch-time
        exception (or an injected launch fault) is captured in ``error``
        (harvest settles the riders in window order) — it never takes
        the server down."""
        reqs = [e.req for e in entries]
        gname = reqs[0].graph
        g = self.graphs[gname]
        batch = TenantBatch(
            program=reqs[0].program, graph=gname, width=self.batch_width,
            roots=tuple(int(r.root) for r in reqs),
            tenants=[r.tenant for r in reqs],
            req_ids=[r.req_id for r in reqs]).padded()
        prog = batched_program(reqs[0].program)
        tg = tenant_graph(g, self.batch_width)
        c0 = program_mod.cache_stats()
        t0 = time.perf_counter()
        idx, kind = self._next_launch_slot()
        ib = _InflightBatch(entries=entries, batch=batch, g_n=g.n,
                            t_launch=t0, index=idx)
        if kind == FAULT_DEVICE:
            # dispatch normally; the error surfaces at harvest, like a
            # device fault mid-launch would
            ib.inject_device = True
            kind = None
        try:
            if kind is not None:
                raise InjectedFailure(f"{kind} fault at launch {idx}")
            ib.launch = program_mod.launch_program(
                prog, tg, self.fabric, options=self.options,
                max_rounds=self.max_rounds,
                donate_states=self.serve_options.donate_buffers,
                params={"roots": batch.roots},
                setup=self._resident_setup(prog, gname))
        except Exception as e:  # noqa: BLE001 — a failed launch must not
            # take the server down; its riders are settled at harvest
            # (retried when budget remains, failed otherwise)
            ib.error = f"{type(e).__name__}: {e}"
        ib.error = self._agree_error(ib.error)
        if ib.error is not None:
            ib.launch = None
            return ib
        c1 = program_mod.cache_stats()
        ib.cache_hits = c1["hits"] - c0["hits"]
        ib.cache_misses = c1["misses"] - c0["misses"]
        return ib

    def _harvest(self, ib: _InflightBatch) -> List[Response]:
        """Materialize one inflight batch: block, transfer, split tenant
        columns, settle the ledger. Failures (captured at launch OR
        surfacing from the device at harvest) poison only this batch's
        riders — settled through the retry disposition
        (:meth:`_settle_failed`) and fed to the class's breaker."""
        err = ib.error
        app_stats = state = None
        if err is None and ib.inject_device:
            # the launch ran; the injected device error stands in for
            # its result surfacing as a device failure
            err = f"InjectedFailure: device fault at launch {ib.index}"
        elif err is None:
            try:
                (state,), app_stats = ib.launch.result()
            except Exception as e:  # noqa: BLE001 — device-side failure
                err = f"{type(e).__name__}: {e}"
            err = self._agree_error(err)
        if err is not None:
            self._breaker_observe(ib.klass, ok=False)
            return self._settle_failed(ib.entries, err, ib.t_launch)
        t1 = time.perf_counter()
        dt = t1 - ib.t_launch
        self._breaker_observe(ib.klass, ok=True)
        self.stats.cache_hits += ib.cache_hits
        self.stats.cache_misses += ib.cache_misses
        self.stats.launches += 1
        self.stats.batched_requests += ib.batch.n_real
        self.stats.pad_columns += self.batch_width - ib.batch.n_real
        self.stats.noc_drops += app_stats.total_drops
        self.stats.round_latencies.append(dt / max(1, app_stats.rounds))
        per_tenant = split_tenant_states(state, ib.g_n, self.batch_width)
        return [self._finish(e, Response(
            e.req.req_id, e.req.tenant, STATUS_OK, result=per_tenant[i],
            batch_drops=app_stats.total_drops,
            batch_messages=app_stats.total_messages,
            rounds=app_stats.rounds, batch_width=ib.batch.n_real,
            latency_s=t1 - e.t_enq, device_s=dt,
            queue_wait_s=ib.t_launch - e.t_enq,
            retries=self._retry.attempt(e.req.req_id)))
            for i, e in enumerate(ib.entries)]

    def _harvest_window(self, *, block: bool) -> List[Response]:
        """Harvest completed batches oldest-first — NEVER out of order,
        so responses stream in launch order under any depth. Non-blocking
        unless ``block`` (then the whole window settles)."""
        out: List[Response] = []
        while self._window and (block or self._agree(
                self._window[0].ready())):
            out.extend(self._harvest(self._window.popleft()))
        return out

    def step(self) -> List[Response]:
        """Advance the pipeline by one batch (see the class docstring's
        serving-loop contract); ``[]`` when idle."""
        out: List[Response] = []
        self._unpark()
        depth = self.serve_options.inflight_depth
        while len(self._former) and len(self._window) < depth:
            entries = self._former.form(self._width_for)
            self.stats.observe_queue_depth(len(self._former))
            live, dead = self._expire(entries)
            out.extend(dead)
            if not live:
                continue
            if (self.failure_plan is not None
                    and live[0].req.program != "moe"
                    and self.failure_plan.peek(self._launch_index)
                    == FAULT_HOST_LOSS):
                # the loss consumes this launch's index WITHOUT
                # advancing it: the relaunch on the survivors claims the
                # same slot, keeping later scheduled faults aligned
                self.failure_plan.due(self._launch_index)
                out.extend(self._lose_hosts(live))
                continue
            br = self._breaker(live[0].klass)
            if br is not None and not br.allows_launch():
                # half-open probe in flight: hold the class (requeued in
                # order); harvesting below settles the probe
                self._requeue(live)
                break
            if live[0].req.program == "moe":
                # the MoE lane is synchronous — settle the window first
                # so responses keep streaming in launch order
                out.extend(self._harvest_window(block=True))
                out.extend(self._step_moe(live))
                return out
            self._window.append(self._launch_batch(live))
        out.extend(self._harvest_window(block=False))
        if not out and self._window:
            # window full (or queue empty) and nothing ready: the oldest
            # launch is the one the loop must wait on
            out.extend(self._harvest(self._window.popleft()))
        if not out and not self._window and not len(self._former) \
                and self._parked:
            # everything is backing off: sleep to the earliest retry
            # gate instead of busy-spinning drain()
            wait = self._agree(self._parked[0].not_before
                               - time.perf_counter())
            if wait > 0:
                time.sleep(wait)
        return out

    def _step_moe(self, entries: List[_Pending]) -> List[Response]:
        reqs = [e.req for e in entries]
        t0 = time.perf_counter()
        idx, kind = self._next_launch_slot()
        try:
            if kind is not None:
                # the MoE lane is synchronous with no separate harvest
                # seam and no elastic path: every scheduled kind
                # degrades to a dispatch exception here
                raise InjectedFailure(f"{kind} fault at launch {idx} (moe)")
            outs, hit = self.moe.dispatch([r.payload for r in reqs])
            err = None
        except Exception as e:  # noqa: BLE001
            err = f"{type(e).__name__}: {e}"
        err = self._agree_error(err)
        if err is not None:
            self._breaker_observe(entries[0].klass, ok=False)
            return self._settle_failed(entries, err, t0)
        self._breaker_observe(entries[0].klass, ok=True)
        t1 = time.perf_counter()
        dt = t1 - t0
        self.stats.cache_hits += int(hit)
        self.stats.cache_misses += int(not hit)
        self.stats.launches += 1
        self.stats.batched_requests += len(reqs)
        self.stats.pad_columns += self.moe.batch - len(reqs)
        self.stats.round_latencies.append(dt)
        return [self._finish(en, Response(
            en.req.req_id, en.req.tenant, STATUS_OK, result=outs[i],
            rounds=1, batch_width=len(reqs), latency_s=t1 - en.t_enq,
            device_s=dt, queue_wait_s=t0 - en.t_enq,
            retries=self._retry.attempt(en.req.req_id)))
            for i, en in enumerate(entries)]

    def drain(self) -> List[Response]:
        """:meth:`step` until idle, then settle the whole inflight
        window (see the class docstring); entries parked on retry
        backoff count as pending — drain outlives every backoff."""
        out: List[Response] = []
        while len(self._former) or self._window or self._parked:
            out.extend(self.step())
        return out

    def run(self, requests: List[Request]) -> List[Response]:
        """Submit a whole stream, drain, return responses in ``req_id``
        order (see the class docstring)."""
        responses: List[Response] = []
        for req in requests:
            rej = self.submit(req)
            if rej is not None:
                responses.append(rej)
        responses.extend(self.drain())
        return sorted(responses, key=lambda r: r.req_id)

    @property
    def queue_depth(self) -> int:
        """Admitted requests not yet launched (inflight batches have
        left the queue; retried entries parked on backoff count)."""
        return len(self._former) + len(self._parked)

    @property
    def inflight_depth(self) -> int:
        """Launched-but-unharvested fused batches in the window."""
        return len(self._window)


class MoEService:
    """MoE dispatch as a serving lane: one ``moe_dcra`` callable over a
    fixed [batch, seq, d_model] shape class on ``info``'s fabric; short
    batches zero-pad.

    ``traces`` counts builds of that callable (one, on the first
    dispatch: the port has no tracer, so a warm call leaves it
    unchanged) — the MoE analogue of the round-function cache's
    no-re-build assertion. ``params`` are the port's MoE weights on the
    fabric's device. On a distributed fabric every process dispatches the
    same payloads and gets every request's output (``moe_dcra`` returns
    the global ``out``)."""

    def __init__(self, cfg, params, info, *, batch: int = 4, seq: int = 16):
        if cfg.moe is None:
            raise ValueError("MoEService needs a config with cfg.moe set")
        self.cfg, self.params, self.info = cfg, params, info
        self.batch, self.seq = int(batch), int(seq)
        self.calls = 0
        self.traces = 0
        self._fn = None

    def demand(self, payload: Optional[np.ndarray]) -> int:
        seq = self.seq if payload is None else int(payload.shape[0])
        return seq * self.cfg.moe.top_k

    def _build(self):
        from ..core.dispatch import moe_dcra
        self.traces += 1

        def f(params, x):
            return moe_dcra(params, x, self.cfg, self.info)

        return f

    def prewarm(self) -> None:
        x = np.zeros((self.batch, self.seq, self.cfg.d_model), np.float32)
        self._dispatch_block(x)

    def _dispatch_block(self, x: np.ndarray):
        import torch
        before = self.traces
        if self._fn is None:
            self._fn = self._build()
        xt = torch.from_numpy(x).to(self.info.mesh.device)
        out, _aux = self._fn(self.params, xt)
        self.calls += 1
        return out.cpu().numpy(), self.traces == before

    def dispatch(self, payloads: List[np.ndarray]
                 ) -> Tuple[List[np.ndarray], bool]:
        """Fuse up to ``batch`` [seq, d_model] token blocks into one
        dispatch; returns (per-request outputs, warm-callable hit)."""
        for p in payloads:
            if p is None or p.shape != (self.seq, self.cfg.d_model):
                raise ValueError(
                    f"MoE payload must be [{self.seq}, {self.cfg.d_model}]")
        x = np.zeros((self.batch, self.seq, self.cfg.d_model), np.float32)
        for i, p in enumerate(payloads):
            x[i] = p
        out, hit = self._dispatch_block(x)
        return [out[i] for i in range(len(payloads))], hit
