"""The per-layer readers of the port's own spans and counters
(``repro_torch.core.trace``), by hand on synthetic records and a
synthetic trace: each reads what it should, and reads nothing (``None``)
in an untraced run, on the CPU where it needs device times, and with a
port that has no tracer."""
import sys
import types

import pytest

from dcra_bench import harness, port_spans
from dcra_bench.trace import TraceSummary

GRAPH = ("launch_head_ms.graph", "result_host_ms.graph",
         "launch_idle_ms.graph", "wire_device_ms.graph", "wire_fill.graph")
MOE = ("route_device_ms.moe", "wire_device_ms.moe", "ffn_device_ms.moe",
       "combine_device_ms.moe")
DEVICE = ("wire_device_ms.graph",) + MOE
MS = 1_000_000                                     # ns


def rec(i, name, parent, root, start_ms, end_ms, device_ms=None):
    from repro_torch.core.trace import Record
    r = Record(i, name, parent, root, int(start_ms * MS))
    r.end_ns, r.device_ms = int(end_ms * MS), device_ms
    return r


def graph_records(device=True):
    """Two launches: each init 2 ms, stage 1 ms, two rounds with a wire
    (0.8 and 1.2 device ms), a result of 3 ms sharing the launch's
    root."""
    out = []
    for k, t in enumerate((0, 20)):
        b = 100 * k
        d = (lambda v: v) if device else (lambda v: None)
        out += [rec(b + 1, "launch", None, b + 1, t, t + 10, d(9.0)),
                rec(b + 2, "launch.init", b + 1, b + 1, t, t + 2, d(0.0)),
                rec(b + 3, "launch.stage", b + 1, b + 1, t + 2, t + 3,
                    d(0.1)),
                rec(b + 4, "round", b + 1, b + 1, t + 3, t + 6, d(2.0)),
                rec(b + 5, "wire", b + 4, b + 1, t + 4, t + 5, d(0.8)),
                rec(b + 6, "round", b + 1, b + 1, t + 6, t + 9, d(2.5)),
                rec(b + 7, "wire", b + 6, b + 1, t + 7, t + 8, d(1.2)),
                rec(b + 8, "result", None, b + 1, t + 11, t + 14, d(0.5))]
    return out


def moe_records(device=True):
    """Two calls: route 5 device ms holding a 2 ms wire, ffn 10, combine
    4 holding a 1 ms wire."""
    out = []
    for k in range(2):
        b, t = 100 * k, 50 * k
        d = (lambda v: v) if device else (lambda v: None)
        out += [rec(b + 1, "moe", None, b + 1, t, t + 30, d(21.0)),
                rec(b + 2, "moe.route", b + 1, b + 1, t, t + 10, d(5.0)),
                rec(b + 3, "wire", b + 2, b + 1, t + 5, t + 8, d(2.0)),
                rec(b + 4, "moe.ffn", b + 1, b + 1, t + 10, t + 20,
                    d(10.0)),
                rec(b + 5, "moe.combine", b + 1, b + 1, t + 20, t + 29,
                    d(4.0)),
                rec(b + 6, "wire", b + 5, b + 1, t + 22, t + 23, d(1.0))]
    return out


def summary(events_ms):
    events = [(int(s * MS), int(e * MS), "k") for s, e in events_ms]
    busy = sum(e - s for s, e in events_ms) / 1e3
    return TraceSummary(window_s=0.05, busy_s=busy, ops={"k": busy},
                        events=events, gaps=[])


def run_of(trace_summary, work=None):
    return types.SimpleNamespace(trace=trace_summary, work=work or {},
                                 counters={}, config={}, traffic={})


@pytest.fixture
def records(monkeypatch):
    """``records(recs, counters)``: the port's tracer hands these back."""
    from repro_torch.core import trace

    def use(recs, counters=None):
        monkeypatch.setattr(trace, "records", lambda: list(recs))
        monkeypatch.setattr(trace, "counters", lambda: dict(counters or {}))
    return use


def read(name, run):
    return harness.load_metric(name)(run)


def test_graph_readers_by_hand(records):
    records(graph_records(), {"wire_slots": 400})
    # busy: 1.5-2.5 ms and 3-9 ms of the first launch, 32-32.5 of the
    # second's result
    run = run_of(summary([(1.5, 2.5), (3, 9), (32, 32.5)]),
                 {"messages": [[100, 60], [30]], "drops": [[0, 20], [10]]})
    assert read("launch_head_ms.graph", run) == pytest.approx(3.0)
    assert read("result_host_ms.graph", run) == pytest.approx(3.0)
    # launch 1: init 1.5 idle, stage 0.5, result 3; launch 2: init 2,
    # stage 1, result 2.5
    assert read("launch_idle_ms.graph", run) == pytest.approx(
        (1.5 + 0.5 + 3 + 2 + 1 + 2.5) / 2)
    assert read("wire_device_ms.graph", run) == pytest.approx(
        2 * (0.8 + 1.2) / 4)
    assert read("wire_fill.graph", run) == pytest.approx(
        100.0 * (100 + 40 + 20) / 400)


def test_moe_readers_by_hand(records):
    records(moe_records(), {"wire_slots": 64})
    run = run_of(summary([(0, 30)]))
    assert read("route_device_ms.moe", run) == pytest.approx(3.0)
    assert read("wire_device_ms.moe", run) == pytest.approx(3.0)
    assert read("ffn_device_ms.moe", run) == pytest.approx(10.0)
    assert read("combine_device_ms.moe", run) == pytest.approx(3.0)


def test_nested_wires_count_once(records):
    recs = moe_records()
    recs.append(rec(7, "wire", 3, 1, 6, 7, 0.5))     # inside a wire
    records(recs)
    run = run_of(summary([(0, 30)]))
    assert read("wire_device_ms.moe", run) == pytest.approx(3.0)


@pytest.mark.parametrize("name", GRAPH + MOE)
def test_an_untraced_run_reads_nothing(records, name):
    records(graph_records() + moe_records(), {"wire_slots": 10})
    run = run_of(None, {"messages": [[1]], "drops": [[0]]})
    assert read(name, run) is None


@pytest.mark.parametrize("name", DEVICE)
def test_no_device_time_without_the_card(records, name):
    records(graph_records(device=False) + moe_records(device=False))
    assert read(name, run_of(summary([(0, 1)]))) is None


def test_no_device_idle_without_device_operations(records):
    records(graph_records())
    assert read("launch_idle_ms.graph", run_of(summary([]))) is None


@pytest.mark.parametrize("name", GRAPH + MOE)
def test_a_port_without_the_tracer_reads_nothing(monkeypatch, name):
    import repro_torch.core
    monkeypatch.delattr(repro_torch.core, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.core.trace", None)
    assert port_spans.tracer() is None
    run = run_of(summary([(0, 1)]), {"messages": [[1]], "drops": [[0]]})
    assert read(name, run) is None


def test_idle_is_the_interval_less_the_busy_union():
    events = [(2, 4, "a"), (3, 6, "b"), (8, 9, "c")]
    assert port_spans.idle_ns([(0, 10)], events) == 10 - 4 - 1
    assert port_spans.idle_ns([(4, 8), (9, 12)], events) == 2 + 3
    assert port_spans.idle_ns([(5, 5)], events) == 0
    assert port_spans.idle_ns([(0, 10)], []) == 10
