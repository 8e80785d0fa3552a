"""Host spans and the device trace of the measured window.

:class:`Spans` times the benchmark's own calls into the port on the host
clock (``with spans("launch"): ...``) and, in a traced run, marks each as
a ``torch.profiler.record_function`` annotation, so the device trace can
say what the host was doing during each idle gap. :class:`Window` opens
the window (under ``torch.profiler`` when tracing) and, after it closes,
reduces the trace to a :class:`TraceSummary`: the union of the device
operations' intervals (busy time), their time by name, and the idle gaps
between them labelled by the host span they fell in.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

SPAN_PREFIX = "bench::"
WINDOW_SPAN = "window"
BREAKDOWN_ENTRIES = 10
NAME_CHARS = 120


class Spans:
    """Host-clock spans by name: ``samples[name]`` the seconds of each."""

    def __init__(self, tracing: bool = False):
        self.tracing = tracing
        self.samples: Dict[str, List[float]] = defaultdict(list)

    @contextmanager
    def __call__(self, name: str):
        mark = nullcontext()
        if self.tracing:
            from torch.profiler import record_function
            mark = record_function(SPAN_PREFIX + name)
        t = time.perf_counter()
        with mark:
            yield
        self.samples[name].append(time.perf_counter() - t)

    def total(self, name: str) -> float:
        return float(sum(self.samples.get(name, ())))


@dataclass
class TraceSummary:
    """The traced window reduced: ``window_s`` its length on the trace's
    clock, ``busy_s`` the union of the device operations' intervals in it,
    ``ops`` device seconds by operation name (summed, overlaps counted
    twice), ``events`` each device operation ``(start_ns, end_ns, name)``
    inside the window, ``gaps`` each idle interval ``(seconds, host
    span)``."""
    window_s: float
    busy_s: float
    ops: Dict[str, float]
    events: List[Tuple[int, int, str]]
    gaps: List[Tuple[float, str]]

    def device_seconds(self, pred: Callable[[str], bool]) -> float:
        """Summed device seconds of the operations whose name passes
        ``pred``."""
        return sum(s for name, s in self.ops.items() if pred(name))

    def breakdown(self) -> Dict[str, list]:
        ops = sorted(self.ops.items(), key=lambda kv: -kv[1])
        gaps = sorted(self.gaps, key=lambda g: -g[0])
        return {"device_ops": [[n[:NAME_CHARS], s]
                               for n, s in ops[:BREAKDOWN_ENTRIES]],
                "idle_gaps": [[span, s]
                              for s, span in gaps[:BREAKDOWN_ENTRIES]]}


def _union(intervals):
    """Sorted disjoint union of ``(start, end)`` intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def reduce_events(events, w0: int, w1: int, spans) -> TraceSummary:
    """``events`` the device operations ``(start_ns, end_ns, name)``,
    ``[w0, w1]`` the window, ``spans`` the host spans ``(start_ns,
    end_ns, name)`` (not nested among themselves)."""
    inside = []
    ops: Dict[str, float] = defaultdict(float)
    for s, e, name in events:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        inside.append((s, e, name))
        ops[name] += (e - s) * 1e-9
    busy = _union((s, e) for s, e, _ in inside)
    busy_ns = sum(e - s for s, e in busy)
    spans = sorted(spans)
    starts = [s for s, _, _ in spans]
    gaps = []
    prev = w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            mid = (prev + s) // 2
            i = bisect.bisect_right(starts, mid) - 1
            label = (spans[i][2] if i >= 0 and spans[i][1] >= mid
                     else "between spans")
            gaps.append(((s - prev) * 1e-9, label))
        prev = max(prev, e)
    return TraceSummary(window_s=(w1 - w0) * 1e-9, busy_s=busy_ns * 1e-9,
                        ops=dict(ops), events=inside, gaps=gaps)


def _kineto_events(prof):
    """``(device ops, host spans, window)`` of a finished profile, all in
    the trace's nanoseconds."""
    from torch._C._autograd import DeviceType
    device, spans, window = [], [], None
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start = ev.start_ns()
        end = start + ev.duration_ns()
        if ev.device_type() == DeviceType.CPU:
            if name.startswith(SPAN_PREFIX):
                span = name[len(SPAN_PREFIX):]
                if span == WINDOW_SPAN:
                    window = (start, end)
                else:
                    spans.append((start, end, span))
        elif not name.startswith(SPAN_PREFIX) and not ev.is_user_annotation():
            if end > start:
                device.append((start, end, name))
    return device, spans, window


class Window:
    """The measured window. ``with Window(ctx) as win:`` starts the
    profiler first when ``ctx.trace`` (a warm operation outside the
    window, so its start-up is not measured), then opens the window;
    ``win.close()`` marks its end on the host clock (the end of the last
    completed unit of work). After the block, ``win.seconds`` is the
    window's length on the host clock and ``win.summary`` the reduced
    trace (``None`` untraced)."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.t_start = self.t_end = None
        self.summary: Optional[TraceSummary] = None
        self._prof = None
        self._mark = None

    @property
    def seconds(self) -> float:
        return self.t_end - self.t_start

    def __enter__(self):
        import torch
        if self.ctx.trace:
            from torch.profiler import (ProfilerActivity, profile,
                                        record_function)
            acts = [ProfilerActivity.CPU]
            if self.ctx.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            torch.ones(1, device=self.ctx.device).add_(1)
            self._sync()
            self._mark = record_function(SPAN_PREFIX + WINDOW_SPAN)
            self._mark.__enter__()
        self.t_start = time.perf_counter()
        return self

    def _sync(self):
        import torch
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)

    def close(self) -> None:
        self.t_end = time.perf_counter()

    def __exit__(self, kind, *exc):
        if self.t_end is None:
            self.close()
        if self._prof is None:
            return False
        self._mark.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        if kind is None:
            device, spans, window = _kineto_events(self._prof)
            if window is not None:
                self.summary = reduce_events(device, window[0], window[1],
                                             spans)
        self._prof = None
        return False


def is_port_kernel(name: str, kernel: str) -> bool:
    """Whether the trace's device operation ``name`` is the port's kernel
    ``kernel``. The port's kernels sit in a top-level anonymous namespace,
    so a PyTorch kernel of the same name, or one that contains it, is not
    counted."""
    for prefix in ("(anonymous namespace)::", "void (anonymous namespace)::"):
        if name.startswith(prefix + kernel):
            return name[len(prefix) + len(kernel):][:1] in ("(", "<")
    return False
