"""The port's own spans and counters (``repro_torch.core.trace``) as the
per-layer readers take them.

The port records a span (name, parent, root, start and end on
``time.time_ns()``, device milliseconds from CUDA events on the card)
where the work happens, and counters beside them, only while the
profiler runs: in a ``--trace 1`` run, the measured window. Each reader
here returns ``None`` where there is nothing to read: an untraced run, a
port without the tracer, a run on the CPU (no device times)."""
from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Optional

from dcra_bench.trace import _union


def tracer():
    """The port's tracer module, ``None`` for a port that has none."""
    try:
        from repro_torch.core import trace
    except ImportError:
        return None
    return trace


def window_records(run) -> Optional[list]:
    """The traced window's span records, ``None`` without any."""
    if getattr(run, "trace", None) is None:
        return None
    t = tracer()
    recs = t.records() if t is not None else None
    return recs or None


def window_counters(run) -> Optional[Dict[str, int]]:
    """The traced window's counters, ``None`` without a traced window."""
    if getattr(run, "trace", None) is None:
        return None
    t = tracer()
    return t.counters() if t is not None else None


def named(recs, *names) -> list:
    return [r for r in recs if r.name in names]


def roots(recs, name) -> list:
    """The root spans ``name``: one a graph launch, or one MoE call."""
    return [r for r in recs if r.name == name and r.parent is None]


def outermost(recs, name) -> list:
    """The spans ``name`` with no span of the same name around them."""
    by_id = {r.id: r for r in recs}

    def nested(r):
        p = by_id.get(r.parent)
        while p is not None:
            if p.name == name:
                return True
            p = by_id.get(p.parent)
        return False
    return [r for r in named(recs, name) if not nested(r)]


def device_ms(recs, spans: Iterable, own: bool = False) -> Optional[float]:
    """Summed device milliseconds of ``spans`` (with ``own``, less their
    child spans' in ``recs``), ``None`` where one has no device time."""
    spans = list(spans)
    if not spans or any(r.device_ms is None for r in spans):
        return None
    total = sum(r.device_ms for r in spans)
    if own:
        ids = {r.id for r in spans}
        total -= sum(r.device_ms or 0.0 for r in recs if r.parent in ids)
    return total


def in_roots(spans, root_spans) -> list:
    ids = {r.id for r in root_spans}
    return [r for r in spans if r.root in ids]


def idle_ns(intervals: List[tuple], events) -> int:
    """Nanoseconds of ``intervals`` ``(start_ns, end_ns)`` in which no
    device operation of ``events`` ``(start_ns, end_ns, name)`` ran."""
    busy = _union((s, e) for s, e, _ in events)
    starts = [s for s, _ in busy]
    # prefix sums of the busy time, for the overlap of one interval
    before = [0]
    for s, e in busy:
        before.append(before[-1] + e - s)

    def busy_until(t):
        i = bisect.bisect_right(starts, t)
        if i == 0:
            return 0
        s, e = busy[i - 1]
        return before[i - 1] + min(e, t) - s

    return sum((e - s) - (busy_until(e) - busy_until(s))
               for s, e in intervals if e > s)


def per_root(total: Optional[float], root_spans) -> Optional[float]:
    return None if total is None or not root_spans else total / len(
        root_spans)

