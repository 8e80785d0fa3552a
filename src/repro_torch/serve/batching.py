"""Tenant-column batching: fuse N tenants' graph queries into ONE launch
(counterpart of ``repro/serve/batching.py``).

A graph query (BFS/SSSP from a root) is a frontier computation over a
fixed topology. To serve N tenants in one launch, the base graph
is expanded by a *tenant column*: base vertex ``v`` becomes the T virtual
vertices ``t * n + v`` (tenant-blocked), every base edge is replicated
once per tenant inside its own column, and the batched program's init rule
(:func:`repro_torch.sparse.torch_apps._multi_root_init`) seeds one root per
tenant. Columns never interact — edge ``(t*n+u, t*n+v)`` stays inside
tenant ``t`` — so each tenant's result is exactly its standalone run:

* min-reduce programs (BFS/SSSP/WCC) are **bit-identical** to the
  standalone ``run_program`` launch when no task drops: every final
  distance is the same left-fold of f32 adds along the winning path, and
  ``min`` is exact in f32 (asserted in tests/test_torch_serve.py);
* the cyclic owner layout stripes each column across all devices
  (virtual vertex ``t*n+v`` lives on shard ``(t*n+v) % n_dev``, uniform
  over ``v``), so one tenant's hot frontier can't capsize a single
  shard. The blocked id — NOT the interleaved ``v*T+t`` — matters: when
  ``n_dev`` divides T, interleaving would pin every vertex of tenant t
  to shard ``t % n_dev``, serialising the whole column's traffic.

The fused batch always has width ``T`` (short batches are padded with
dummy root-0 columns, results discarded): one (program, graph, T) shape
class -> ONE round-function cache entry, which is what the server
pre-warms.
"""
from __future__ import annotations

import weakref
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from ..sparse.csr import CSR, from_edges
from ..sparse.torch_apps import BATCHED_BFS, BATCHED_SSSP, TaskProgram

# base program name -> tenant-batched variant (same payload/update rules,
# multi-root init). Only min-reduce programs batch exactly — float adds
# commute per-column here because columns are disjoint, but an add-reduce
# program (pagerank) still sums in a different global order, so it is
# deliberately NOT in this registry.
BATCHED_PROGRAMS: Dict[str, TaskProgram] = {
    "bfs": BATCHED_BFS,
    "sssp": BATCHED_SSSP,
}


def batched_program(base_name: str) -> TaskProgram:
    """The tenant-batched variant of a base program (KeyError for
    programs that have none — add-reduce programs don't batch exactly)."""
    return BATCHED_PROGRAMS[base_name]


# (graph id, T) -> (weakref to the base CSR, expanded CSR); the expansion
# is pure topology, shared by every program and every request batch of the
# same width. The weakref guards against id() reuse: a lookup only counts
# as a hit when the recorded referent IS the argument, and a dead
# referent's entry is purged by the weakref callback, so the memo can't
# serve a stale expansion of a garbage-collected graph and can't grow
# past the set of live (graph, width) pairs.
_TENANT_GRAPHS: Dict[Tuple[int, int], Tuple["weakref.ref[CSR]", CSR]] = {}


def tenant_graph(g: CSR, n_tenants: int) -> CSR:
    """Tenant-expand ``g``: ``n * T`` virtual vertices, ``nnz * T`` edges,
    edge (u, v, w) -> (t*n+u, t*n+v, w) for every tenant column t.

    Memoized by CSR object identity + T — the server's graph registry is
    resident, so each (graph, batch width) expands exactly once.
    """
    T = int(n_tenants)
    if T < 1:
        raise ValueError(f"need at least one tenant column, got {T}")
    key = (id(g), T)
    got = _TENANT_GRAPHS.get(key)
    if got is not None and got[0]() is g:
        return got[1]
    rows = g.row_of()
    cols = g.col_idx.astype(np.int64)
    off = np.arange(T, dtype=np.int64) * g.n
    src = (rows[None, :] + off[:, None]).ravel()
    dst = (cols[None, :] + off[:, None]).ravel()
    w = np.tile(g.values, T)
    out = from_edges(g.n * T, src, dst, w)
    ref = weakref.ref(g, lambda _r, _k=key: _TENANT_GRAPHS.pop(_k, None))
    _TENANT_GRAPHS[key] = (ref, out)
    return out


def split_tenant_states(state: np.ndarray, n: int, n_tenants: int
                        ) -> List[np.ndarray]:
    """Undo the tenant column: one [n*T] state array -> T per-tenant [n]
    arrays (tenant t's value for base vertex v sits at slot t*n + v)."""
    return [np.ascontiguousarray(state.reshape(n_tenants, n)[t])
            for t in range(n_tenants)]


# ---------------------------------------------------------------------------
# batch formation: which queued requests ride the next fused launch
# ---------------------------------------------------------------------------
#
# A *former* owns the server's pending queue. Entries are any objects
# exposing three read-only attributes: ``tenant`` (str), ``klass`` (the
# (program, graph) shape-class key — one fused launch serves exactly one
# class) and ``demand`` (the admission-time per-round task estimate, the
# same number QueueConfig budgets are charged with). The engine pushes on
# admission and calls ``form(width_for)`` to pop the next batch; at most
# one entry per tenant rides a batch (each tenant owns whole columns) and
# only queue *heads* are ever popped, so intra-tenant FIFO order is
# preserved by construction in every discipline.

class FifoFormer:
    """Head-of-line batch formation — the original ``_next_batch``.

    One global FIFO: the next batch's class is whatever the oldest
    pending request wants, filled by scanning the whole queue for
    same-class requests from distinct tenants (arrival order of the
    rest preserved). A heavy tenant that keeps the head occupied can
    starve light tenants — that is the trade :class:`DrrFormer` fixes.
    """

    def __init__(self) -> None:
        self._q: Deque = deque()

    def push(self, entry) -> None:
        self._q.append(entry)

    def push_front(self, entry) -> None:
        """Requeue at the head of the line — a retried request must not
        re-pay the whole queue (it already waited once); push a failed
        batch's riders in reverse so their relative order is preserved."""
        self._q.appendleft(entry)

    def __len__(self) -> int:
        return len(self._q)

    def pending_tenants(self) -> List[str]:
        return list({e.tenant: None for e in self._q})

    def pending_classes(self) -> List:
        """Distinct (program, graph) classes still queued, head-first —
        what the engine re-prewarms after an elastic fabric shrink."""
        return list({e.klass: None for e in self._q})

    def form(self, width_for: Callable) -> List:
        """Pop the next batch (``[]`` when idle) — bit-identical to the
        pre-former serving loop's head-of-line scan."""
        if not self._q:
            return []
        head = self._q[0]
        key = head.klass
        width = int(width_for(head))
        taken: List = []
        seen_tenants = set()
        rest: Deque = deque()
        while self._q:
            e = self._q.popleft()
            if (len(taken) < width and e.klass == key
                    and e.tenant not in seen_tenants):
                taken.append(e)
                seen_tenants.add(e.tenant)
            else:
                rest.append(e)
        self._q = rest
        return taken


class DrrFormer:
    """Deficit-round-robin batch formation across tenants.

    Classic DRR adapted to fused tenant-column launches: one FIFO queue
    per tenant, a round-robin ring over tenants in first-seen order, and
    a per-tenant *deficit* counter. Each formation pass grants every
    pending tenant one ``quantum`` of deficit; the first tenant (in ring
    order from the RR pointer) whose head request's ``demand`` fits its
    deficit becomes the batch **setter** — its head fixes the batch's
    (program, graph) class — and is charged that demand. The remaining
    width is filled by one ring cycle of *riders*: other tenants whose
    heads match the class and fit their deficit (charged the same way).
    The pointer then advances past the setter.

    Properties (tests/test_torch_serve.py pins them):

    * **starvation-free** — with the default adaptive quantum (max
      demand seen) every pending head fits on its first visit, so the
      setter is always the first pending tenant at/after the pointer
      and every pending tenant sets a batch within ``n_tenants``
      formations; a request admitted behind ``d`` same-tenant requests
      launches within ``d * n_tenants`` formations.
    * **FIFO within a tenant** — only heads are popped.
    * **no banking while idle** — a tenant's deficit resets to zero
      when its queue empties, so bursts don't inherit credit.
    """

    def __init__(self, quantum: Optional[int] = None) -> None:
        self._by_tenant: Dict[str, Deque] = {}
        self._ring: List[str] = []          # tenants, first-seen order
        self._rr = 0                        # ring index of the next setter
        self._deficit: Dict[str, int] = {}
        self._quantum = None if quantum is None else int(quantum)
        self._max_demand = 1                # adaptive-quantum floor

    def push(self, entry) -> None:
        t = entry.tenant
        q = self._by_tenant.get(t)
        if q is None:
            q = self._by_tenant[t] = deque()
            self._ring.append(t)
            self._deficit[t] = 0
        q.append(entry)
        self._max_demand = max(self._max_demand, int(entry.demand))

    def push_front(self, entry) -> None:
        """Requeue at the head of the entry's tenant queue (see
        :meth:`FifoFormer.push_front`) — intra-tenant FIFO order is
        restored, the ring/deficit discipline is untouched."""
        t = entry.tenant
        q = self._by_tenant.get(t)
        if q is None:
            q = self._by_tenant[t] = deque()
            self._ring.append(t)
            self._deficit[t] = 0
        q.appendleft(entry)
        self._max_demand = max(self._max_demand, int(entry.demand))

    def __len__(self) -> int:
        return sum(len(q) for q in self._by_tenant.values())

    def pending_tenants(self) -> List[str]:
        return [t for t in self._ring if self._by_tenant[t]]

    def pending_classes(self) -> List:
        """Distinct (program, graph) classes still queued (ring order) —
        what the engine re-prewarms after an elastic fabric shrink."""
        return list({e.klass: None for t in self._ring
                     for e in self._by_tenant[t]})

    def _charge(self, tenant: str, demand: int) -> None:
        self._deficit[tenant] -= int(demand)
        if not self._by_tenant[tenant]:
            self._deficit[tenant] = 0       # no banking while idle

    def form(self, width_for: Callable) -> List:
        """Pop the next batch (``[]`` when idle)."""
        order = [self._ring[(self._rr + i) % len(self._ring)]
                 for i in range(len(self._ring))] if self._ring else []
        order = [t for t in order if self._by_tenant[t]]
        if not order:
            return []
        quantum = (self._max_demand if self._quantum is None
                   else self._quantum)
        setter = None
        while setter is None:               # each pass grants EVERY
            for t in order:                 # pending tenant one quantum
                self._deficit[t] += quantum
                if (setter is None and
                        self._by_tenant[t][0].demand <= self._deficit[t]):
                    setter = t              # keep granting to the rest
        e0 = self._by_tenant[setter].popleft()
        self._charge(setter, e0.demand)
        key = e0.klass
        width = int(width_for(e0))
        taken = [e0]
        si = order.index(setter)
        for t in order[si + 1:] + order[:si]:   # one rider cycle
            if len(taken) >= width:
                break
            q = self._by_tenant[t]
            if q and q[0].klass == key and q[0].demand <= self._deficit[t]:
                e = q.popleft()
                self._charge(t, e.demand)
                taken.append(e)
        self._rr = (self._ring.index(setter) + 1) % len(self._ring)
        return taken


@dataclass
class TenantBatch:
    """One fused launch: up to T tenants' requests for the same
    (program, graph) shape class, padded to exactly width T with dummy
    root-0 columns (``req_ids[t] is None`` marks padding)."""
    program: str                     # base program name ("bfs" | "sssp")
    graph: str                       # server graph-registry key
    width: int                       # T, the fixed tenant-column count
    roots: Tuple[int, ...] = ()
    tenants: List[str] = field(default_factory=list)
    req_ids: List[Optional[int]] = field(default_factory=list)

    @property
    def n_real(self) -> int:
        return sum(1 for r in self.req_ids if r is not None)

    def padded(self) -> "TenantBatch":
        pad = self.width - len(self.req_ids)
        if pad < 0:
            raise ValueError(f"batch overflows width {self.width}")
        if pad == 0:
            return self
        return TenantBatch(
            program=self.program, graph=self.graph, width=self.width,
            roots=tuple(self.roots) + (0,) * pad,
            tenants=list(self.tenants) + ["_pad"] * pad,
            req_ids=list(self.req_ids) + [None] * pad)
