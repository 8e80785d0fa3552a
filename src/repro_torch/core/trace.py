"""Spans and counters inside the port, and every counter the port keeps.

:func:`span` marks a phase of the work where it happens (``with
trace.span("wire"): ...``); :func:`count` adds to a named counter. Both
record only while a ``torch.profiler`` session is active or inside
``with recording():``. Off, :func:`span` returns one shared null context
after a single flag test and :func:`count` returns at once: no record,
no CUDA event, no host sync, no kernel.

A span records its name, its parent (the span open around it on this
thread), its root (the outermost one: one graph launch or one
``moe_dcra`` call; :meth:`~repro_torch.sparse.program.ProgramLaunch.
result` passes its launch's root on), its start and end on
``time.time_ns()``, the clock of the profiler's events, and, once CUDA
is in use, a pair of pooled ``torch.cuda.Event``\\ s on the current
stream: their ``elapsed_time``, read by :func:`records` after the work
is done, is the device time of what the span enqueued on that stream.
A span opened directly inside a span of the same name records nothing,
so nested ``wire`` spans count once.

Records stay in memory: :func:`records`, :func:`counters`,
:func:`summary`. A stretch of "on" (a profiler session, or an outermost
:func:`recording` entered while off) starts with no records and no
counts: the module wraps the profiler's start hook
(``torch.autograd.profiler._run_on_profiler_start``) to learn of a new
session. A stretch holds at most :data:`MAX_RECORDS` spans; the spans
past it count in ``counters()["dropped"]``.

The port's other counters live here too: :data:`HOST_READS` (the round
loops' blocking host reads) and :data:`CACHE_STATS` (the round-function
cache), reset by ``sparse/program.py``'s ``reset_host_reads`` and
``clear_cache``.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _profiler

MAX_RECORDS = 1_000_000

#: blocking host reads of device values inside the round loops since the
#: last ``reset_host_reads`` (the lockstep loop's convergence test, the
#: pipelined loop's wait on a flag); read by ``chip_smoke.py`` and by the
#: benchmark's ``host_reads_per_round.graph``
HOST_READS = {"reads": 0}
#: the round-function cache of ``sparse/program.py``: a repeated
#: same-shape launch is a ``hits`` increment with ``kernel_traces``
#: unchanged
CACHE_STATS = {"hits": 0, "misses": 0, "kernel_traces": 0}

_NULL = nullcontext()


class Record:
    """One span: ``id``, ``name``, ``parent`` (its id, ``None`` at a
    root), ``root`` (the id of its root), ``start_ns`` / ``end_ns``
    (``time.time_ns()``), ``device_ms`` (``None`` without CUDA)."""
    __slots__ = ("id", "name", "parent", "root", "start_ns", "end_ns",
                 "device_ms", "_events")

    def __init__(self, id_, name, parent, root, start_ns):  # noqa: PLR0917
        self.id, self.name, self.parent, self.root = id_, name, parent, root
        self.start_ns, self.end_ns = start_ns, None
        self.device_ms: Optional[float] = None
        self._events = None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6

    def __repr__(self):
        return (f"Record({self.id}, {self.name!r}, parent={self.parent}, "
                f"root={self.root}, host_ms={self.host_ms:.3f}, "
                f"device_ms={self.device_ms})")


class _State:
    def __init__(self):
        self.records: List[Record] = []
        self.counters: Dict[str, int] = defaultdict(int)
        self.recording = 0
        self.fresh = True             # the next record starts a stretch
        self.ids = itertools.count(1)
        self.local = threading.local()
        self.pool: list = []          # CUDA events whose time was read

    def stack(self) -> List[Record]:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s

    def event(self):
        return (self.pool.pop() if self.pool
                else torch.cuda.Event(enable_timing=True))

    def begin(self) -> None:
        for r in self.records:
            if r._events is not None:
                self.pool.extend(r._events)
        self.records = []
        self.counters = defaultdict(int)
        self.fresh = False


_STATE = _State()


_PROFILER_START = getattr(_profiler, "_run_on_profiler_start", None)


def _on_profiler_start():
    _STATE.fresh = True
    _PROFILER_START()


if _PROFILER_START is not None:
    _profiler._run_on_profiler_start = _on_profiler_start


def enabled() -> bool:
    """Whether spans and counts record now."""
    return bool(_profiler._is_profiler_enabled or _STATE.recording)


@contextmanager
def recording():
    """Record without the profiler. Entered while the tracer is off, it
    starts a new stretch."""
    st = _STATE
    if not enabled():
        st.fresh = True
    st.recording += 1
    try:
        yield
    finally:
        st.recording -= 1
        if not enabled():
            st.fresh = True


class _Span:
    __slots__ = ("rec",)

    def __init__(self, rec):
        self.rec = rec

    def __enter__(self):
        st, rec = _STATE, self.rec
        st.records.append(rec)
        st.stack().append(rec)
        if torch.cuda.is_initialized():
            rec._events = (st.event(), st.event())
            rec._events[0].record()
        rec.start_ns = time.time_ns()
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        if rec._events is not None:
            rec._events[1].record()
        rec.end_ns = time.time_ns()
        _STATE.stack().pop()
        return False


def span(name: str, root: Optional[int] = None):
    """A context manager that records the phase ``name`` while the tracer
    is on. ``root`` names the root of a span opened outside any other
    (a launch's ``result``); by default a span outside any other is its
    own root."""
    if not (_profiler._is_profiler_enabled or _STATE.recording):
        return _NULL
    st = _STATE
    if st.fresh:
        st.begin()
    stack = st.stack()
    parent = stack[-1] if stack else None
    if parent is not None and parent.name == name:
        return _NULL
    if len(st.records) >= MAX_RECORDS:
        st.counters["dropped"] += 1
        return _NULL
    i = next(st.ids)
    if parent is not None:
        rec = Record(i, name, parent.id, parent.root, 0)
    else:
        rec = Record(i, name, None, i if root is None else root, 0)
    return _Span(rec)


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` while the tracer is on."""
    if not (_profiler._is_profiler_enabled or _STATE.recording):
        return
    st = _STATE
    if st.fresh:
        st.begin()
    st.counters[name] += int(n)


def current_root() -> Optional[int]:
    """The root id of the innermost open span on this thread (``None``
    when off or outside every span)."""
    if not enabled():
        return None
    stack = _STATE.stack()
    return stack[-1].root if stack else None


def records() -> List[Record]:
    """The stretch's finished spans in the order they opened, their
    device times read (this waits for each span's end event once)."""
    st = _STATE
    done = [r for r in st.records if r.end_ns is not None]
    for r in done:
        if r._events is not None:
            start, end = r._events
            end.synchronize()
            r.device_ms = start.elapsed_time(end)
            st.pool.extend(r._events)
            r._events = None
    return done


def counters() -> Dict[str, int]:
    """A copy of the stretch's counters."""
    return dict(_STATE.counters)


def _child_sums(recs: List[Record]) -> Dict[int, tuple]:
    """``{id: (host ms, device ms)}`` summed over each span's children."""
    out: Dict[int, list] = defaultdict(lambda: [0.0, 0.0])
    for r in recs:
        if r.parent is not None:
            acc = out[r.parent]
            acc[0] += r.host_ms
            acc[1] += r.device_ms or 0.0
    return {k: tuple(v) for k, v in out.items()}


def summary() -> Dict[str, Dict[str, Optional[float]]]:
    """By span name: ``count``, ``host_ms``, ``self_host_ms`` (less the
    child spans), ``device_ms`` and ``self_device_ms`` (``None`` where no
    span of the name has a device time)."""
    recs = records()
    kids = _child_sums(recs)
    out: Dict[str, Dict[str, Optional[float]]] = {}
    for r in recs:
        e = out.setdefault(r.name, {"count": 0, "host_ms": 0.0,
                                    "self_host_ms": 0.0, "device_ms": None,
                                    "self_device_ms": None})
        ch, cd = kids.get(r.id, (0.0, 0.0))
        e["count"] += 1
        e["host_ms"] += r.host_ms
        e["self_host_ms"] += r.host_ms - ch
        if r.device_ms is not None:
            e["device_ms"] = (e["device_ms"] or 0.0) + r.device_ms
            e["self_device_ms"] = ((e["self_device_ms"] or 0.0)
                                   + r.device_ms - cd)
    return out
