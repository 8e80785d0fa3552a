"""The port's tracer, ``repro_torch.core.trace``, on the CPU, and its clock
and device times on the card.

Off, a span is one shared null context, records nothing and makes no
CUDA event. On (under ``torch.profiler`` or ``trace.recording()``),
spans nest with parent and root ids, self time is host time less the
children's, a stretch holds at most ``MAX_RECORDS`` spans and a new
stretch starts empty; the span's ``time.time_ns()`` interval holds the
profiler's events opened inside it. A graph launch records ``launch``
(``launch.init``, ``launch.stage``, a ``round`` a round each holding a
``wire``) and a ``result`` that shares its root; ``wire_slots`` counts
the exchange's slots; a ``moe_dcra`` call records ``moe`` with
``moe.route``, ``wire``, ``moe.ffn`` and ``moe.combine``. The results
and the port's other counters do not change with the tracer on.

The module imports nothing of the reference, so its ``cuda`` tests run
on the card: ``PYTHONPATH=src python -m pytest -q -s -m cuda
tests/test_torch_trace.py``.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.configs import get_config
from repro_torch.core import trace
from repro_torch.core.dispatch import MeshInfo, moe_dcra
from repro_torch.core.fabric import Fabric
from repro_torch.core.queues import QueueConfig
from repro_torch.core.routing import resolve_flat_cap
from repro_torch.models.moe import init_moe
from repro_torch.sparse import datasets
from repro_torch.sparse import program
from repro_torch.sparse.options import LaunchOptions
from repro_torch.sparse.torch_apps import PROGRAMS

PARAMS = {"bfs": {"root": 0}, "pagerank": {"damping": 0.85, "iters": 4}}


class _Profiled:
    """The tracer on through a CPU profiler session."""

    def __enter__(self):
        self._p = profile(activities=[ProfilerActivity.CPU])
        self._p.__enter__()
        return self

    def __exit__(self, *exc):
        return self._p.__exit__(*exc)


MODES = {"profiler": _Profiled, "recording": trace.recording}


def by_name(recs, name):
    return [r for r in recs if r.name == name]


def launch(app="bfs", fab=None, **opts):
    g = datasets.rmat(8, 8, seed=1)
    fab = fab or Fabric.fake(8, device="cpu")
    states, stats = program.launch_program(
        PROGRAMS[app], g, fab, params=PARAMS[app],
        options=LaunchOptions(**opts)).result()
    return g, states, stats


# ---------------------------------------------------------------------------
# off
# ---------------------------------------------------------------------------

def test_off_is_one_null_context_and_records_nothing(monkeypatch):
    assert not trace.enabled()
    before = [r.id for r in trace.records()], trace.counters()

    def no_event(*a, **k):
        raise AssertionError("a CUDA event was made with the tracer off")
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", no_event)
    a, b = trace.span("a"), trace.span("b", root=7)
    assert a is b
    with a:
        trace.count("wire_slots", 5)
    launch()
    assert trace.current_root() is None
    assert ([r.id for r in trace.records()], trace.counters()) == before


# ---------------------------------------------------------------------------
# on
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_nesting_roots_and_self_time(mode):
    with MODES[mode]():
        assert trace.enabled()
        with trace.span("a") as a:
            assert trace.current_root() == a.id
            with trace.span("b") as b:
                with trace.span("b") as again:   # same name: counted once
                    assert again is None
                with trace.span("c") as c:
                    torch.ones(64).add_(1)
        with trace.span("d", root=a.id) as d:
            pass
        with trace.span("e") as e:
            pass
    recs = trace.records()
    assert [r.name for r in recs] == ["a", "b", "c", "d", "e"]
    assert (a.parent, b.parent, c.parent, d.parent, e.parent) == (
        None, a.id, b.id, None, None)
    assert {r.root for r in (a, b, c, d)} == {a.id} and e.root == e.id
    assert all(r.device_ms is None for r in recs)        # no CUDA here
    for r in recs:
        assert r.start_ns <= r.end_ns
    assert a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns
    s = trace.summary()
    assert s["a"]["count"] == 1 and s["b"]["count"] == 1
    assert s["a"]["self_host_ms"] == pytest.approx(a.host_ms - b.host_ms)
    assert s["b"]["self_host_ms"] == pytest.approx(b.host_ms - c.host_ms)
    assert s["c"]["self_host_ms"] == pytest.approx(c.host_ms)
    assert s["a"]["device_ms"] is None


@pytest.mark.parametrize("mode", MODES)
def test_the_cap_counts_what_it_drops(mode, monkeypatch):
    monkeypatch.setattr(trace, "MAX_RECORDS", 3)
    with MODES[mode]():
        for _ in range(5):
            with trace.span("x"):
                pass
        trace.count("n", 2)
        trace.count("n", 3)
    assert len(trace.records()) == 3
    assert trace.counters() == {"dropped": 2, "n": 5}


@pytest.mark.parametrize("first", MODES)
@pytest.mark.parametrize("second", MODES)
def test_a_new_stretch_starts_empty(first, second):
    with MODES[first]():
        with trace.span("old"):
            trace.count("n", 1)
    assert [r.name for r in trace.records()] == ["old"]
    with MODES[second]():
        with trace.span("new"):
            pass
    assert [r.name for r in trace.records()] == ["new"]
    assert trace.counters() == {}


def test_recording_inside_the_profiler_keeps_its_stretch():
    with _Profiled():
        with trace.span("a"):
            pass
        with trace.recording():
            with trace.span("b"):
                pass
    assert [r.name for r in trace.records()] == ["a", "b"]


def test_a_profiler_event_lies_inside_its_span():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("outer") as outer:
            with record_function("inside_outer"):
                torch.ones(256).mul_(2)
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "inside_outer"]
    assert len(ev) == 1
    start = ev[0].start_ns()
    assert outer.start_ns <= start
    assert start + ev[0].duration_ns() <= outer.end_ns


def test_cuda_events_are_pooled_and_read_once(monkeypatch):
    """With CUDA in use a span takes two events from the pool, records
    them on the current stream and reads their time in ``records()``;
    read events go back to the pool."""
    made = []

    class FakeEvent:
        def __init__(self, enable_timing=False):
            assert enable_timing
            made.append(self)
            self.recorded = 0

        def record(self, stream=None):
            self.recorded += 1

        def synchronize(self):
            assert self.recorded

        def elapsed_time(self, end):
            return 2.5

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(trace._STATE, "pool", [])
    with trace.recording():
        for _ in range(3):
            with trace.span("x"):
                pass
    assert [r.device_ms for r in trace.records()] == [2.5] * 3
    assert len(made) == 6
    with trace.recording():
        for _ in range(3):
            with trace.span("y"):
                with trace.span("z"):
                    pass
    recs = trace.records()
    assert len(made) == 12                   # 6 reused, 6 new
    assert trace.summary()["y"]["self_device_ms"] == pytest.approx(0.0)
    assert trace.summary()["z"]["device_ms"] == pytest.approx(7.5)
    assert all(r.device_ms == 2.5 for r in recs)


# ---------------------------------------------------------------------------
# the port's spans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("app,mode", [("bfs", "lockstep"),
                                      ("pagerank", "lockstep"),
                                      ("bfs", "pipelined")])
def test_a_graph_launch_records_its_phases(app, mode):
    g = datasets.rmat(8, 8, seed=1)
    setup = program._graph_setup(g, 8, undirected=PROGRAMS[app].undirected)
    with trace.recording():
        _, _, stats = launch(app, round_mode=mode)
    recs = trace.records()
    (root,) = [r for r in recs if r.parent is None and r.name == "launch"]
    assert {r.root for r in recs} == {root.id}
    assert [r.name for r in recs if r.parent == root.id][:2] == [
        "launch.stage", "launch.init"]
    rounds = by_name(recs, "round")
    assert all(r.parent == root.id for r in rounds)
    wires = by_name(recs, "wire")
    (result,) = by_name(recs, "result")
    assert result.parent is None and result.root == root.id
    assert result.start_ns >= root.end_ns
    cap = resolve_flat_cap(QueueConfig.from_factor(4.0, "T3"), "T3",
                           setup[-1], 8, clamp=True)
    if mode == "lockstep":
        assert len(rounds) == stats.rounds
        assert [w.parent for w in wires] == [r.id for r in rounds]
        assert trace.counters() == {"wire_slots": 8 * 8 * cap
                                    * stats.rounds, "init_on_card": 1}
    else:    # the gated loop: an unreal last iteration, a wire produced
        assert len(rounds) >= stats.rounds          # ahead of its round
        assert {w.parent for w in wires} >= {r.id for r in rounds}
        assert trace.counters()["wire_slots"] % (8 * 8 * cap) == 0
        assert trace.counters()["init_on_card"] == 1


@pytest.mark.parametrize("resident", [False, True])
def test_every_launch_counts_its_init_on_card(resident):
    """Three launches, each with one ``launch`` root holding
    ``launch.stage`` and ``launch.init`` and one ``result`` of its root;
    each counts once in ``init_on_card`` and none in ``init_on_host``."""
    g = datasets.rmat(8, 8, seed=1)
    fab = Fabric.fake(8, device="cpu")
    setup = program._graph_setup(g, 8)
    if resident:
        setup = program.resident_setup(setup, "cpu")
    with trace.recording():
        for root in (0, 3, 5):
            program.launch_program(PROGRAMS["bfs"], g, fab,
                                   params={"root": root},
                                   setup=setup).result()
        counts = trace.counters()
    recs = trace.records()
    roots = [r for r in recs if r.parent is None and r.name == "launch"]
    assert len(roots) == 3
    for root in roots:
        kids = [r.name for r in recs if r.parent == root.id]
        assert kids.count("launch.stage") == kids.count("launch.init") == 1
        (result,) = [r for r in by_name(recs, "result")
                     if r.root == root.id]
        assert result.parent is None
    assert counts["init_on_card"] == 3 and "init_on_host" not in counts


def test_a_stream_program_traces_its_wire():
    rng = np.random.default_rng(0)
    elements = rng.integers(0, 100, 512)
    with trace.recording():
        program.run_program(PROGRAMS["histogram"], (elements, 100),
                            Fabric.fake(4, device="cpu"))
    assert [r.name for r in trace.records()] == ["wire"]
    assert trace.counters()["wire_slots"] > 0


@pytest.mark.parametrize("pods", [False, True])
def test_moe_dcra_records_its_phases(pods):
    cfg = get_config("olmoe-1b-7b").reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=8, capacity_factor=8.0))
    params = init_moe(torch.Generator().manual_seed(0), cfg)
    if pods:
        info = MeshInfo(Fabric.virtual((2, 1, 2, 2), ("pod", "data",
                                                       "expert", "tp"),
                                       device="cpu"), pod_axis="pod")
    else:
        info = MeshInfo(Fabric.virtual((2, 2, 2), ("data", "expert", "tp"),
                                       device="cpu"))
    x = torch.randn(4, 16, cfg.d_model, generator=torch.Generator(
    ).manual_seed(1))
    want = moe_dcra(params, x, cfg, info)
    with trace.recording():
        got = moe_dcra(params, x, cfg, info)
    assert all(torch.equal(a, b) for a, b in zip(want, got))
    recs = trace.records()
    (root,) = [r for r in recs if r.parent is None]
    assert root.name == "moe" and {r.root for r in recs} == {root.id}
    phases = [r for r in recs if r.parent == root.id]
    assert [r.name for r in phases] == ["moe.route", "moe.ffn",
                                        "moe.combine"]
    route, _, comb = phases
    wires = by_name(recs, "wire")
    assert [w.parent for w in wires] == [route.id] * (1 + pods) + [
        comb.id] * (1 + pods)
    assert trace.counters()["wire_slots"] > 0


def test_results_and_counters_unchanged_with_the_tracer_on():
    assert program.HOST_READS is trace.HOST_READS
    assert program.CACHE_STATS is trace.CACHE_STATS

    def run():
        program.reset_host_reads()
        c0 = program.cache_stats()
        _, states, stats = launch()
        c1 = program.cache_stats()
        return (states, stats, program.HOST_READS["reads"],
                {k: c1[k] - c0[k] for k in c1})
    launch()                              # the round function built
    off = run()
    with trace.recording():
        on = run()
    assert all(np.array_equal(a, b) for a, b in zip(off[0], on[0]))
    assert off[1].rounds == on[1].rounds
    assert np.array_equal(off[1].messages, on[1].messages)
    assert np.array_equal(off[1].drops, on[1].drops)
    assert off[2:] == on[2:] and off[2] == off[1].rounds
    assert off[3] == {"hits": 1, "misses": 0, "kernel_traces": 0}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: device times exist only there")
    return torch.device("cuda")


def _card_graph(card, shards=64, scale=20):
    g = datasets.rmat(scale, 16, seed=3)
    fab = Fabric.fake(shards, device=card)
    setup = {name: program.resident_setup(program._graph_setup(
        g, shards, undirected=PROGRAMS[name].undirected), card)
        for name in ("bfs", "pagerank")}
    return g, fab, setup


def _profiled_launch(card, g, fab, setup, app, sleep_cycles=0):
    """One warm launch, then one under the profiler (CPU and CUDA): its
    records and the profile's kineto events."""
    def go():
        program.launch_program(PROGRAMS[app], g, fab, params=PARAMS[app],
                               setup=setup[app]).result()
    go()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if sleep_cycles:            # the host runs ahead of the card
            torch.cuda._sleep(sleep_cycles)
        go()
        torch.cuda.synchronize()
    return trace.records(), list(prof.profiler.kineto_results.events())


def _launched(events):
    """``[(launch start_ns, kernel start_ns, kernel duration_ns)]``: each
    device operation with the host runtime call that enqueued it,
    matched by correlation id."""
    calls = {}
    for ev in events:
        if (ev.device_type() == DeviceType.CPU and ev.correlation_id()
                and ev.name().startswith("cu")):
            calls[ev.correlation_id()] = ev.start_ns()
    out = []
    for ev in events:
        if ev.device_type() == DeviceType.CUDA and ev.duration_ns() > 0:
            t = calls.get(ev.correlation_id())
            if t is not None:
                out.append((t, ev.start_ns(), ev.duration_ns()))
    return out


def _innermost(recs, t):
    inside = [r for r in recs if r.start_ns <= t <= r.end_ns]
    return max(inside, key=lambda r: r.start_ns) if inside else None


@pytest.mark.cuda
def test_cuda_spans_and_kernels_share_the_profilers_clock(card):
    """Each kernel enqueued inside a span starts after the span's start
    on ``time.time_ns()`` (to within 100 us): the port's spans and the
    profiler's device events are on one clock."""
    g, fab, setup = _card_graph(card)
    recs, events = _profiled_launch(card, g, fab, setup, "bfs")
    launched = _launched(events)
    assert launched, ("no device operation matched its launch: "
                      + repr(sorted({(e.device_type(), e.name()[:40])
                                     for e in events})[:40]))
    lead, lag = [], []
    for t_launch, start, _ in launched:
        r = _innermost(recs, t_launch)
        if r is not None:
            lead.append(start - r.start_ns)
            lag.append(start - t_launch)
    assert len(lead) > 10
    print(json.dumps({"clock": {"kernels": len(lead),
                                "min_start_after_span_us": min(lead) / 1e3,
                                "min_start_after_launch_us": min(lag) / 1e3,
                                "median_start_after_launch_us": float(
                                    np.median(lag)) / 1e3}}))
    assert min(lead) >= -100_000


@pytest.mark.cuda
def test_cuda_wire_event_times_match_the_trace(card):
    """The ``wire`` spans' CUDA-event milliseconds are within 10 % of the
    summed device time the profiler gives the operations enqueued inside
    them (PageRank, the card kept busy so the host runs ahead)."""
    g, fab, setup = _card_graph(card)
    recs, events = _profiled_launch(card, g, fab, setup, "pagerank",
                                    sleep_cycles=400_000_000)
    wires = by_name(recs, "wire")
    assert len(wires) == PARAMS["pagerank"]["iters"]
    assert all(w.device_ms is not None for w in wires)
    events_ms = sum(w.device_ms for w in wires)
    traced_ms = 1e-6 * sum(
        d for t, _, d in _launched(events)
        if any(w.start_ns <= t <= w.end_ns for w in wires))
    print(json.dumps({"wire": {"spans": len(wires), "events_ms": events_ms,
                               "traced_ms": traced_ms}}))
    assert traced_ms > 0
    assert abs(events_ms - traced_ms) <= 0.1 * traced_ms
