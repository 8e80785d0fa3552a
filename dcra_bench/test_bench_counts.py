"""The yardstick's arithmetic against hand-worked cases: the bytes the
routing kernels must move, the MoE layer's model FLOPs, the trace's
busy time and idle gaps, the per-layer readers."""
import importlib.util
import types

import pytest

from dcra_bench import harness
from dcra_bench.trace import Spans, TraceSummary, is_port_kernel, reduce_events


def metric(name):
    path = harness.ROOT / harness.BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("m_" + name.replace(
        ".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_route_bytes_by_hand():
    m = metric("route_roofline.graph")
    assert m.flat_cap(1000, 4, 4.0) == 1000          # clamped at e_max
    assert m.flat_cap(1001, 4, 1.0) == 256           # 250 up to 8s
    # 2 shards x 10 tasks (5 B each), 5 valid (12 B), 2 x 2 x 8 slots
    # (8 B), n_drop 2 x 4 B
    assert m.scatter_bytes(2, 10, 2, 8, 1, 1, 5) == 100 + 60 + 256 + 8
    assert m.reduce_bytes(32, 5, 6) == 128 + 20 + 24
    w = {"shards": 2, "e_max": 10, "capacity_factor": 1.6, "n": 12}
    assert m.round_bytes(w, 5, 1) == 424 + (128 + 16 + 48)


def test_route_roofline_reads_the_trace():
    m = metric("route_roofline.graph")
    k = "(anonymous namespace)::staged_place_kernel(int const*)"
    trace = TraceSummary(window_s=1.0, busy_s=0.5,
                         ops={k: 2e-6, "void at::native::fill": 1.0},
                         events=[], gaps=[])
    w = {"shards": 2, "e_max": 10, "capacity_factor": 1.6, "n": 12,
         "messages": [[5, 5]], "drops": [[1, 1]]}
    run = types.SimpleNamespace(trace=trace, work=w)
    want = 100 * 2 * 616 / 3.35e12 / 2e-6
    assert m.read(run) == pytest.approx(want)
    assert m.read(types.SimpleNamespace(trace=None, work=w)) is None


def test_moe_scatter_bytes_and_flops_by_hand():
    spec = harness.load_spec()
    cfg = harness.load_config(spec, "olmoe-1b-7b-moe")
    tr = harness.load_traffic("moe_fwd")
    # 16 shards of 1,024 tokens, groups of 8, caps 8,192 a bucket
    dispatch = 655_360 + 2_097_152 + 12_582_912 + 64
    expert = 5_242_880 + 1_572_864 + 8_388_608 + 64
    assert metric("scatter_roofline.moe").step_bytes(cfg, tr) == (
        dispatch + expert)
    m = metric("layer_mfu.moe")
    assert m.step_flops(16384, 2048, 64, 8, 1024) == (
        4_294_967_296 + 1_649_267_441_664)
    run = types.SimpleNamespace(
        work={"steps": 10, "tokens": 16384, "layers": 16, "window_s": 2.0},
        config=cfg)
    assert m.read(run) == pytest.approx(
        100 * 10 * 16 * 1_653_562_408_960 / (2.0 * 989e12))


def test_trace_busy_gaps_and_ops():
    t = reduce_events([(0, 10, "a"), (5, 20, "b"), (30, 40, "a"),
                       (45, 60, "c")], 0, 50,
                      [(0, 25, "launch"), (25, 45, "result")])
    assert t.busy_s == pytest.approx(35e-9)
    assert t.window_s == pytest.approx(50e-9)
    assert t.ops == pytest.approx({"a": 20e-9, "b": 15e-9, "c": 5e-9})
    assert sorted(t.gaps) == [(pytest.approx(5e-9), "result"),
                              (pytest.approx(10e-9), "result")]
    b = t.breakdown()
    assert b["device_ops"][0][0] == "a" and len(b["idle_gaps"]) == 2
    assert metric("device_idle.graph").read(
        types.SimpleNamespace(trace=t)) == pytest.approx(30.0)


def test_port_kernel_names():
    assert is_port_kernel("(anonymous namespace)::reduce_kernel<0>(int)",
                          "reduce_kernel")
    assert not is_port_kernel("(anonymous namespace)::reduce_kernel_x()",
                              "reduce_kernel")
    assert not is_port_kernel("at::native::reduce_kernel<512, 1>()",
                              "reduce_kernel")


def test_span_readers():
    spans = Spans()
    spans.samples["pack"] = [20.5]
    spans.samples["result"] = [0.02, 0.04]
    run = types.SimpleNamespace(spans=spans, trace=None,
                                counters={"host_reads": 12, "rounds": 8,
                                          "launches": 2})
    assert metric("pack_s.graph").read(run) == 20.5
    assert metric("result_ms.graph").read(run) == pytest.approx(30.0)
    assert metric("host_reads_per_round.graph").read(run) == 1.5
    assert metric("round_device_ms.graph").read(run) is None
