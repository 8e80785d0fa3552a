"""The port's analytic stack and design-space exploration against the JAX
package's numpy originals, on the CPU.

``repro_torch.core.{topology,cache,task_engine}``, ``repro_torch.costmodel``,
``repro_torch.sparse.apps`` and ``repro_torch.dse`` are numpy copies of
the reference's modules; both packages get the same seeded inputs in this
process (none of those reference modules runs JAX). Tolerances, stated
at each test:

* integer results (hops, die crossings, routed counts, drops, queue
  peaks, point ids, frontiers) are equal;
* floating results computed by the same numpy operations in the same
  order are held to a relative 1e-12 (``REL``), the bound the committed
  ``BENCH_dse.json`` is held to; in practice they are bit-identical.

The quick sweep, with its revalidation on virtual CPU shards, must
reproduce the committed ``BENCH_dse.json``: the same point ids, every
metric within ``REL``, the same frontier, per-app slices and dataset
signatures, and the 14 revalidation entries equal one by one.
"""
import dataclasses
import importlib
import json
import os

import numpy as np
import pytest
import torch

from repro.core import cache as jcache
from repro.core import queues as jq
from repro.core import task_engine as jte
from repro.core import topology as jtopo
from repro.costmodel import energy as jenergy
from repro.costmodel import perf as jperf
from repro.costmodel import silicon as jsilicon
from repro.dse import autoconfig as jauto
from repro.dse import compare as jcompare
from repro.dse import pareto as jpareto
from repro.dse import space as jspace
from repro.dse import sweep as jsweep
from repro.sparse import apps as japps
from repro.sparse import datasets as jdata
from repro_torch.core import cache as tcache
from repro_torch.core import queues as tq
from repro_torch.core import task_engine as tte
from repro_torch.core import topology as ttopo
from repro_torch.core.fabric import Fabric
from repro_torch.costmodel import energy as tenergy
from repro_torch.costmodel import perf as tperf
from repro_torch.costmodel import silicon as tsilicon
from repro_torch.dse import autoconfig as tauto
from repro_torch.dse import compare as tcompare
from repro_torch.dse import driver as tdriver
from repro_torch.dse import pareto as tpareto
from repro_torch.dse import shardcheck as tshardcheck
from repro_torch.dse import space as tspace
from repro_torch.dse import sweep as tsweep
from repro_torch.sparse import apps as tapps
from repro_torch.sparse import datasets as tdata

# the packages re-export the function ``evaluate``, which hides the module
jeval = importlib.import_module("repro.dse.evaluate")
teval = importlib.import_module("repro_torch.dse.evaluate")

REL = 1e-12
ROOT = os.path.join(os.path.dirname(__file__), "..")
BENCH = os.path.join(ROOT, "BENCH_dse.json")


def close(got, want, rel=REL):
    """``got`` within ``rel`` of ``want`` relative (exact at 0)."""
    return abs(got - want) <= rel * abs(want)


def same_numbers(got, want, rel=REL):
    """Two JSON-like trees equal, floats within ``rel`` relative."""
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            same_numbers(got[k], want[k], rel)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            same_numbers(a, b, rel)
    elif isinstance(want, float):
        assert close(got, want, rel), (got, want)
    else:
        assert got == want


# ---------------------------------------------------------------------------
# topology, cache, silicon: exact / REL
# ---------------------------------------------------------------------------

GRIDS = [(64, 64, 16), (32, 64, 32), (1, 8, 32), (48, 48, 16)]


@pytest.mark.parametrize("topology", jtopo.TOPOLOGIES)
@pytest.mark.parametrize("rows,cols,die", GRIDS)
def test_tile_grid_matches_reference(topology, rows, cols, die):
    """Hops, die crossings and bisection on random tile pairs: exact;
    ``avg_uniform_hops`` (closed form or a seeded sample): exact."""
    assert ttopo.TOPOLOGIES == jtopo.TOPOLOGIES
    kw = dict(topology=topology, die_rows=die, die_cols=die)
    j, t = jtopo.TileGrid(rows, cols, **kw), ttopo.TileGrid(rows, cols, **kw)
    rng = np.random.default_rng(rows * cols + die)
    src = rng.integers(0, j.n_tiles, 5000)
    dst = rng.integers(0, j.n_tiles, 5000)
    assert np.array_equal(t.hops(src, dst), j.hops(src, dst))
    assert np.array_equal(t.die_crossings(src, dst), j.die_crossings(src, dst))
    assert t.dies == j.dies and t.n_tiles == j.n_tiles
    assert t.bisection_links() == j.bisection_links()
    assert t.bisection_bytes_per_cycle() == j.bisection_bytes_per_cycle()
    assert t.avg_uniform_hops() == j.avg_uniform_hops()
    assert dataclasses.asdict(t.with_(noc_width_bits=32)) == \
        dataclasses.asdict(j.with_(noc_width_bits=32))


@pytest.mark.parametrize("kb,prefetch,present", [
    (512, True, True), (256, False, True), (1024, True, False),
    (64, False, False)])
def test_cache_model_matches_reference(kb, prefetch, present):
    """Hit rates and bandwidths: within REL (the same arithmetic)."""
    def model(m):
        return m.CacheModel(m.SRAMConfig(kb_per_tile=kb, prefetch=prefetch),
                            m.DRAMConfig(present=present))
    j, t = model(jcache), model(tcache)
    assert close(t.cache_bytes(), j.cache_bytes())
    assert close(t.sram_bw_bytes_per_ns(), j.sram_bw_bytes_per_ns())
    assert close(t.dram_bw_per_tile_bytes_per_ns(),
                 j.dram_bw_per_tile_bytes_per_ns())
    for eb in (4, 8, 64, 128):
        assert close(t.stream_hit_rate(eb), j.stream_hit_rate(eb))
    for foot in (0.0, 1e3, 3e5, 1e9):
        assert close(t.random_hit_rate(foot), j.random_hit_rate(foot))
        for sb, rb in ((0.0, 0.0), (1e4, 2e4), (5e6, 0.0)):
            assert close(t.hit_rate(sb, rb, foot), j.hit_rate(sb, rb, foot))
    for h in (0.0, 0.37, 1.0):
        assert close(t.effective_bw(h), j.effective_bw(h))


@pytest.mark.parametrize("seed", range(3))
def test_silicon_matches_reference(seed):
    """Murphy yield, die cost, die area and package cost: within REL."""
    rng = np.random.default_rng(seed)
    for area in rng.uniform(5.0, 800.0, 20):
        assert close(tsilicon.murphy_yield(area, 0.0007),
                     jsilicon.murphy_yield(area, 0.0007))
        assert close(tsilicon.die_cost_usd(area), jsilicon.die_cost_usd(area))
        assert tsilicon.gross_dies_per_wafer(area) == \
            jsilicon.gross_dies_per_wafer(area)
    for tiles, kb, pus, w, f in ((256, 512, 1, 64, 1.0), (1024, 256, 2, 32,
                                                          2.0)):
        a = jsilicon.dcra_die_area_mm2(tiles, kb, pus, w, f)
        assert close(tsilicon.dcra_die_area_mm2(tiles, kb, pus, w, f), a)
        for dies, hbm in ((1, 0.0), (4, 32.0), (16, 128.0)):
            got = dataclasses.asdict(tsilicon.package_cost(dies, a, hbm))
            want = dataclasses.asdict(jsilicon.package_cost(dies, a, hbm))
            same_numbers(got, want)
    assert tsilicon.murphy_yield(0.0, 1.0) == 1.0


# ---------------------------------------------------------------------------
# the task engine: exact
# ---------------------------------------------------------------------------

def _engines(cap, T=16, n=96):
    def one(te, topo, q):
        cfg = te.EngineConfig(grid=topo.TileGrid(4, T // 4, die_rows=2,
                                                 die_cols=2),
                              queues=q.QueueConfig(default_iq=cap))
        return te.TaskEngine(cfg, n)
    return one(jte, jtopo, jq), one(tte, ttopo, tq)


@pytest.mark.parametrize("self_heavy", [False, True])
@pytest.mark.parametrize("cap", [None, 1, 8])
@pytest.mark.parametrize("op", ["add", "min", "store"])
def test_task_engine_route_matches_reference(op, cap, self_heavy):
    """``TaskEngine.route``: every ``RoundStats`` field, the ``QueueStats``
    peaks and the reduced target equal, over two rounds, with and without
    caps, and with ~90 % of the tasks on their own tile (the bounded self
    channel)."""
    rng = np.random.default_rng(hash((op, cap, self_heavy)) % 2**32)
    n = 96
    j, t = _engines(cap)
    targets = {}
    for eng, name in ((j, "j"), (t, "t")):
        targets[name] = (np.zeros(n) if op == "add"
                         else np.full(n, np.inf) if op == "min"
                         else np.zeros(n))
    for task in ("T2", "T3"):
        src = rng.integers(0, n, 400)
        dst = (np.where(rng.random(400) < 0.9, src, rng.integers(0, n, 400))
               if self_heavy else rng.integers(0, n, 400))
        vals = rng.integers(0, 50, 400).astype(np.float64)
        rj = j.route(task, src, dst, values=vals, target=targets["j"], op=op,
                     stream_bytes_per_task=8.0, random_bytes_per_task=4.0)
        rt = t.route(task, src, dst, values=vals, target=targets["t"], op=op,
                     stream_bytes_per_task=8.0, random_bytes_per_task=4.0)
        assert dataclasses.asdict(rt) == dataclasses.asdict(rj)
        if cap == 1:
            assert rt.drops > 0
    t.mark_barrier()
    j.mark_barrier()
    assert np.array_equal(targets["t"], targets["j"])
    assert dataclasses.asdict(t.stats) == dataclasses.asdict(j.stats)
    for prop in ("total_messages", "total_hops", "total_tasks",
                 "total_die_crossings", "total_drops"):
        assert getattr(t.stats, prop) == getattr(j.stats, prop)


@pytest.mark.parametrize("topology", jtopo.TOPOLOGIES)
@pytest.mark.parametrize("side,n_tasks", [(32, 300_000), (32, 5_000),
                                          (64, 200_000), (24, 50_000)])
def test_task_engine_counts_by_channel_as_reference(topology, side, n_tasks):
    """The port counts a round by channel (``bincount`` on a round dense
    in the T x T channels, ``unique`` on a sparse one) and prices hops
    and die crossings from its tile-pair tables (grids up to
    ``PAIR_TABLE_MAX`` pairs; the 64 x 64 grid takes the per-message
    path), its owners by a mask where T is a power of two (the 24 x 24
    grid's 576 tiles take the modulo): every ``RoundStats`` field and the
    ``QueueStats`` equal to the reference's per-message arrays, and the
    min delivery equal."""
    rng = np.random.default_rng(side * n_tasks)
    n = 1 << 20
    src = rng.integers(0, n, n_tasks)
    dst = np.where(rng.random(n_tasks) < 0.3, src, rng.integers(0, n,
                                                                n_tasks))
    vals = rng.integers(0, 1000, n_tasks).astype(np.float64)
    out = []
    for te, topo, q in ((jte, jtopo, jq), (tte, ttopo, tq)):
        cfg = te.EngineConfig(grid=topo.TileGrid(side, side,
                                                 topology=topology,
                                                 die_rows=16, die_cols=16),
                              queues=q.QueueConfig(default_iq=2))
        eng = te.TaskEngine(cfg, n)
        target = np.full(n, np.inf)
        rs = eng.route("T3", src, dst, values=vals, target=target, op="min")
        out.append((dataclasses.asdict(rs), target,
                    dataclasses.asdict(eng.stats.queue)))
    assert out[1][0] == out[0][0] and out[1][2] == out[0][2]
    assert np.array_equal(out[1][1], out[0][1])
    assert (tte._pair_tables(ttopo.TileGrid(side, side)) is None) == \
        ((side * side) ** 2 > tte.PAIR_TABLE_MAX)


def test_queue_config_accessors_match_reference():
    """The output-queue knobs the perf model reads, and ``QueueStats``."""
    for kw in (dict(), dict(default_iq=None), dict(default_oq=48),
               dict(oq_sizes={"T3": 7}, iq_sizes={"T3": 5})):
        jc, tc = jq.QueueConfig(**kw), tq.QueueConfig(**kw)
        for task in ("T2", "T3"):
            assert tc.oq(task) == jc.oq(task)
    js, ts = jq.QueueStats(), tq.QueueStats()
    for stats in (js, ts):
        stats.record("T3", np.array([3, 0, 9]), np.array([1, 2]))
        stats.record("T3", np.array([4]), np.array([5, 0]))
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)


# ---------------------------------------------------------------------------
# the seven analytic apps, perf and energy
# ---------------------------------------------------------------------------

APP_GRAPH = dict(n_vertices=256, avg_degree=8, seed=7)


def _run_app(apps, te, topo, q, datasets, app, topology="hier_torus"):
    g = datasets.wiki_like(**APP_GRAPH)
    cfg = te.EngineConfig(grid=topo.TileGrid(8, 8, topology=topology,
                                             die_rows=4, die_cols=4),
                          queues=q.QueueConfig(default_iq=6))
    eng = te.TaskEngine(cfg, g.n)
    if app == "bfs":
        return apps.bfs(eng, g, 0), cfg, g
    if app == "sssp":
        return apps.sssp(eng, g, 0), cfg, g
    if app == "pagerank":
        return apps.pagerank(eng, g, iters=4), cfg, g
    if app == "wcc":
        return apps.wcc(eng, g), cfg, g
    if app == "spmv":
        return apps.spmv(eng, g, np.random.default_rng(0).random(g.n)), cfg, g
    if app == "kcore":
        return apps.kcore(eng, g, k=8), cfg, g
    els = datasets.histogram_data(1 << 11, 64, seed=4)
    return apps.histogram(eng, els, 64), cfg, els


ANALYTIC_APPS = ("bfs", "sssp", "pagerank", "wcc", "spmv", "kcore",
                 "histogram")


@pytest.mark.parametrize("app", ANALYTIC_APPS)
def test_analytic_app_matches_reference(app):
    """Results exact (PageRank and SpMV: within REL, their float64 sums);
    every round's ``RoundStats`` and the ``QueueStats`` equal."""
    (jr, js), _, _ = _run_app(japps, jte, jtopo, jq, jdata, app)
    (tr, ts), _, _ = _run_app(tapps, tte, ttopo, tq, tdata, app)
    if app in ("pagerank", "spmv"):
        assert np.allclose(tr, jr, rtol=REL, atol=0.0)
    else:
        assert np.array_equal(tr, jr)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    assert ts.total_messages > 0


@pytest.mark.parametrize("topology", jtopo.TOPOLOGIES)
def test_perf_and_energy_match_reference(topology):
    """``run_perf`` and ``run_energy`` of the same run: within REL."""
    for app in ("bfs", "pagerank"):
        (_, js), jc, g = _run_app(japps, jte, jtopo, jq, jdata, app, topology)
        (_, ts), tc, _ = _run_app(tapps, tte, ttopo, tq, tdata, app, topology)
        for kw in (dict(), dict(dataset_bytes=1e6, fanout=30.0)):
            jp = jperf.run_perf(js, jc, g.nnz, **kw)
            tp = tperf.run_perf(ts, tc, g.nnz, **kw)
            for f in ("seconds", "cycles", "teps"):
                assert close(getattr(tp, f), getattr(jp, f))
        for kw in (dict(), dict(dataset_bytes=1e6), dict(instr_per_task=9.0)):
            je = jenergy.run_energy(js, jc, **kw)
            te = tenergy.run_energy(ts, tc, **kw)
            for f in ("noc_j", "memory_j", "pu_j", "total_j"):
                assert close(getattr(te, f), getattr(je, f))


# ---------------------------------------------------------------------------
# the design space, the frontier, the evaluator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["quick", "full"])
def test_config_space_matches_reference(which):
    """Point ids, configs and ``len``: equal."""
    js, ts = getattr(jspace.ConfigSpace, which)(), \
        getattr(tspace.ConfigSpace, which)()
    assert len(ts) == len(js) == (24 if which == "quick" else 768)
    assert [p.point_id for p in ts.points()] == \
        [p.point_id for p in js.points()]
    assert [p.to_dict() for p in ts.points()] == \
        [p.to_dict() for p in js.points()]
    assert ts.to_dict() == js.to_dict()
    assert set(tspace.MEM_TECHS) == set(jspace.MEM_TECHS)


def test_design_point_conversions_match_reference():
    """Engine configs, stats keys, costs (REL) and the MoE queues."""
    for jp, tp in zip(jspace.ConfigSpace.quick().points(),
                      tspace.ConfigSpace.quick().points()):
        assert tp.stats_key == jp.stats_key
        assert tp.n_dies == jp.n_dies and tp.n_packages == jp.n_packages
        assert close(tp.die_area_mm2(), jp.die_area_mm2())
        assert close(tp.package_usd(), jp.package_usd())
        assert close(tp.system_usd(), jp.system_usd())
        jc, tc = jp.engine_config(), tp.engine_config()
        assert tc.queues.channel_cap("T3", 999, 64) == \
            jc.queues.channel_cap("T3", 999, 64)
        assert tc.queues.oq("T3") == jc.queues.oq("T3")
        assert dataclasses.asdict(tc.grid) == dataclasses.asdict(jc.grid)
        assert tp.moe_queues().channel_cap("dispatch", 512, 8) == \
            jp.moe_queues().channel_cap("dispatch", 512, 8)
    with pytest.raises(ValueError):
        tspace.DesignPoint(topology="ring")


@pytest.mark.parametrize("seed", range(5))
def test_pareto_frontier_matches_reference(seed):
    """Frontier indices of random records (ties and duplicates included)
    under the default and a two-objective spec: equal."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 6, (40, 3)).astype(float)
    recs = [{"teps": a, "watts": b, "package_usd": c} for a, b, c in vals]
    assert tpareto.pareto_frontier(recs) == jpareto.pareto_frontier(recs)
    spec = (("teps", "max"), ("watts", "min"))
    assert tpareto.pareto_frontier(recs, spec) == \
        jpareto.pareto_frontier(recs, spec)
    assert np.array_equal(tpareto.pareto_indices(vals),
                          jpareto.pareto_indices(vals))
    assert tpareto.pareto_frontier([]) == []


@pytest.mark.parametrize("idx", [0, 5, 17, 23])
def test_evaluate_point_matches_reference(idx):
    """``Evaluator.evaluate_point`` on the quick datasets at scale 7, five
    apps: every metric and per-cell number within REL."""
    jp = list(jspace.ConfigSpace.quick().points())[idx]
    tp = list(tspace.ConfigSpace.quick().points())[idx]
    apps_ = jsweep.QUICK_APPS
    jr = jeval.Evaluator(jeval.load_datasets(7), apps_).evaluate_point(jp)
    tr = teval.Evaluator(teval.load_datasets(7), apps_).evaluate_point(tp)
    same_numbers(tr.to_dict(), jr.to_dict())
    assert teval.APPS == jeval.APPS
    assert close(teval.geomean([1.0, 3.0, 7.5]), jeval.geomean([1.0, 3.0,
                                                                 7.5]))


# ---------------------------------------------------------------------------
# autoconfigure
# ---------------------------------------------------------------------------

AUTO_GRAPHS = {"rmat": ("rmat", dict(scale=8, edge_factor=16, seed=1)),
               "wiki": ("wiki_like", dict(n_vertices=128, avg_degree=25)),
               "er": ("erdos_renyi", dict(n=256, avg_degree=8, seed=5))}
OBJECTIVES = {"teps": "teps", "watts": "watts", "usd": "usd",
              "blend": {"teps": 0.7, "watts": 0.3}}


def _graph(datasets, name):
    fn, kw = AUTO_GRAPHS[name]
    return getattr(datasets, fn)(**kw)


def _same_launch(got, want):
    """Same point, source, objective and signature; score within REL."""
    assert got.point.point_id == want.point.point_id
    assert got.source == want.source
    assert got.objective == want.objective
    assert got.signature.to_dict() == pytest.approx(want.signature.to_dict(),
                                                    rel=REL)
    assert close(got.score, want.score)


@pytest.mark.parametrize("objective", OBJECTIVES)
@pytest.mark.parametrize("graph", AUTO_GRAPHS)
def test_autoconfigure_matches_reference(graph, objective):
    """Against the committed bench: the same ``LaunchConfig``."""
    jb, tb = jauto.load_bench(BENCH), tauto.load_bench(BENCH)
    assert tb == jb
    got = tauto.autoconfigure(_graph(tdata, graph), "bfs",
                              OBJECTIVES[objective], bench=tb)
    want = jauto.autoconfigure(_graph(jdata, graph), "bfs",
                               OBJECTIVES[objective], bench=jb)
    _same_launch(got, want)


def _far_bench():
    """The committed bench with its signatures 4096x larger: nothing it
    recorded resembles the test graphs."""
    with open(BENCH) as f:
        b = json.load(f)
    b["dataset_signatures"] = {
        k: dict(v, n=v["n"] << 12, nnz=v["nnz"] << 12)
        for k, v in b["dataset_signatures"].items()}
    return b


@pytest.mark.parametrize("variant", ["default", "missing", "far"])
@pytest.mark.parametrize("graph", AUTO_GRAPHS)
def test_autoconfigure_bench_variants_match_reference(graph, variant,
                                                      tmp_path):
    """``bench=None`` (the default path: the committed file), a bench path
    that does not exist (no frontier: the mini-sweep), and a bench whose
    signatures are far from every graph: the same ``LaunchConfig``."""
    kw = {"default": {}, "missing": {"bench_path": str(tmp_path / "none")},
          "far": {"bench": _far_bench()}}[variant]
    got = tauto.autoconfigure(_graph(tdata, graph), "bfs", **kw)
    want = jauto.autoconfigure(_graph(jdata, graph), "bfs", **kw)
    _same_launch(got, want)
    if variant != "default":
        assert got.source == "mini-sweep"


def test_default_bench_path_is_the_committed_file(monkeypatch):
    """The port resolves the repo-root ``BENCH_dse.json`` (its copy, not
    the reference's module); ``DCRA_BENCH_PATH`` overrides it."""
    monkeypatch.delenv("DCRA_BENCH_PATH", raising=False)
    assert os.path.samefile(tauto.default_bench_path(), BENCH)
    monkeypatch.setenv("DCRA_BENCH_PATH", "/elsewhere.json")
    assert tauto.default_bench_path() == "/elsewhere.json"


def test_signatures_match_reference():
    """Graph and element-stream signatures: equal."""
    for name in AUTO_GRAPHS:
        assert tauto.signature_of(_graph(tdata, name)).to_dict() == \
            pytest.approx(jauto.signature_of(_graph(jdata, name)).to_dict(),
                          rel=REL)
    els = jdata.histogram_data(1 << 12, 64, seed=4)
    assert tauto.signature_of(els).to_dict() == \
        jauto.signature_of(els).to_dict()


MOE_LOADS = {"uniform": lambda rng: (np.arange(4096) // 8) % 16,
             "random": lambda rng: rng.integers(0, 16, 4096),
             "skewed": lambda rng: np.where(rng.random(4096) < 0.8, 0,
                                            rng.integers(0, 16, 4096)),
             "correlated": lambda rng: np.r_[np.zeros(512, np.int64),
                                             (np.arange(3584) // 8) % 16]}


@pytest.mark.parametrize("load", MOE_LOADS)
def test_autoconfigure_moe_matches_reference(load):
    """The capacity factor, its dispatch queues and the load signature:
    equal, on uniform, random, skewed and locally correlated ids."""
    ids = MOE_LOADS[load](np.random.default_rng(1))
    fj, qj = jauto.autoconfigure_moe(ids, 16, 8)
    ft, qt = tauto.autoconfigure_moe(ids, 16, 8)
    assert ft == fj
    for task in ("dispatch", "portal", "expert"):
        assert qt.channel_cap(task, 512, 8) == qj.channel_cap(task, 512, 8)
    assert tauto.moe_dispatch_signature(ids, 16).to_dict() == \
        jauto.moe_dispatch_signature(ids, 16).to_dict()
    if load == "skewed":
        assert ft > tauto.MOE_FACTOR_LADDER[0]


def test_launch_config_folds_onto_the_port_fabric():
    """``device_queues`` as the reference's (flat: iq x fold^2 clamped at
    e_local; pod: factor n_dev), and ``pod_axis_for`` from the port's
    ``Fabric.pod_axis``: the pod axis only for a hier_torus point on a
    fabric with more than one pod."""
    for point in (tauto.BASELINE, tauto.BASELINE.with_(grid_side=64),
                  tauto.BASELINE.with_(topology="torus", iq_capacity=48)):
        jl = jauto.launch_for(jspace.DesignPoint.from_dict(point.to_dict()))
        tl = tauto.launch_for(point)
        for n_dev, e_local in ((8, 500), (64, 2235449), (1, 17)):
            for pod in (False, True):
                a = tl.device_queues(n_dev, e_local, pod=pod)
                b = jl.device_queues(n_dev, e_local, pod=pod)
                assert a.channel_cap("T3", e_local, n_dev) == \
                    b.channel_cap("T3", e_local, n_dev)
    hier = tauto.launch_for(tauto.BASELINE)
    torus = tauto.launch_for(tauto.BASELINE.with_(topology="torus"))
    pods = Fabric.virtual((2, 4), ("pod", "data"), device="cpu")
    assert hier.pod_axis_for(pods) == "pod"
    assert torus.pod_axis_for(pods) is None
    assert hier.pod_axis_for(Fabric.fake(8, device="cpu")) is None
    assert hier.pod_axis_for(Fabric.virtual((1, 8), ("pod", "data"),
                                            device="cpu")) is None


# ---------------------------------------------------------------------------
# the sweep: the committed file, the full space
# ---------------------------------------------------------------------------

def _same_bench(got, want):
    """(the contract) point ids, configs and frontier flags equal, every
    metric and per-cell number within REL, ``pareto``, ``app_frontiers``,
    ``dataset_signatures`` and the revalidation entries equal."""
    assert [r["point_id"] for r in got["points"]] == \
        [r["point_id"] for r in want["points"]]
    for a, b in zip(got["points"], want["points"]):
        assert a["config"] == b["config"] and a["pareto"] == b["pareto"]
        same_numbers(a["metrics"], b["metrics"])
        same_numbers(a["per_cell"], b["per_cell"])
    for key in ("pareto", "app_frontiers", "dataset_signatures",
                "revalidation", "schema", "space", "apps", "datasets",
                "dataset_scale"):
        assert got[key] == want[key], key


def test_quick_sweep_reproduces_the_committed_bench(tmp_path):
    """``python -m repro_torch.dse.sweep --quick --device cpu``: 24 points,
    the committed frontier, and the 14 revalidation entries from the
    port's executables on 8 CPU shards, equal to the committed file."""
    out = str(tmp_path / "bench.json")
    assert tsweep.main(["--quick", "--device", "cpu", "--out", out]) == 0
    with open(out) as f:
        got = json.load(f)
    with open(BENCH) as f:
        want = json.load(f)
    assert len(got["points"]) == 24 and len(got["revalidation"]) == 14
    _same_bench(got, want)
    assert all(r["ok"] for r in got["revalidation"])


def test_full_space_matches_the_reference_sweep():
    """The full space (768 points, seven apps) at scale 8, analytic only:
    equal to the reference's ``sweep.run`` in this process."""
    kw = dict(top_k=2, n_dev=8, out=None, quick=False,
              skip_revalidation=True)
    got = tsweep.run(tspace.ConfigSpace.full(), teval.APPS, 8, **kw)
    want = jsweep.run(jspace.ConfigSpace.full(), jeval.APPS, 8, **kw)
    assert len(got["points"]) == 768
    _same_bench(got, want)


def test_revalidation_raises_without_a_card(monkeypatch):
    """The sweep and ``shardcheck`` default to the card and do not fall
    back to the CPU when there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tshardcheck.check_point({"iq_capacity": 8, "apps": ["spmv"]}, 8, 6,
                                0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsweep.main(["--quick", "--out", ""])


# ---------------------------------------------------------------------------
# compare and the driver
# ---------------------------------------------------------------------------

def _bench_with(points, slices=None):
    b = {"schema": "dcra-dse-bench/v1",
         "points": [{"point_id": pid, "pareto": True,
                     "metrics": {"teps_geomean": t, "watts_geomean": w,
                                 "package_usd": c, "teps_per_usd": t / c}}
                    for pid, t, w, c in points]}
    if slices is not None:
        b["schema"] = "dcra-dse-bench/v2"
        for rec, bfs in zip(b["points"], slices):
            rec["per_cell"] = {"bfs:D": {"teps": bfs, "seconds": 1.0,
                                         "energy_j": 1.0}}
        b["app_frontiers"] = {"bfs": [r["point_id"] for r in b["points"]]}
    return b


# the reference tests' file pairs (tests/test_dse.py): old, new
COMPARE_PAIRS = {
    "improve-and-drift": (_bench_with([("p1", 100.0, 5.0, 40.0)]),
                          _bench_with([("p2", 120.0, 4.0, 35.0)])),
    "teps-regressed": (_bench_with([("p1", 100.0, 5.0, 40.0)]),
                       _bench_with([("p1", 80.0, 5.0, 40.0)])),
    "within-tolerance": (_bench_with([("p1", 100.0, 5.0, 40.0)]),
                         _bench_with([("p1", 97.0, 5.0, 40.0)])),
    "halved": (_bench_with([("p1", 100.0, 5.0, 40.0)]),
               _bench_with([("p1", 50.0, 5.0, 40.0)])),
    "slice-regressed": (_bench_with([("p1", 100.0, 5.0, 40.0)], [90.0]),
                        _bench_with([("p1", 100.0, 5.0, 40.0)], [60.0])),
    "v1-v2-mix": (_bench_with([("p1", 100.0, 5.0, 40.0)]),
                  _bench_with([("p1", 100.0, 5.0, 40.0)], [90.0])),
    "unknown-schema": (_bench_with([("p1", 100.0, 5.0, 40.0)]),
                       dict(_bench_with([("p1", 100.0, 5.0, 40.0)]),
                            schema="dcra-dse-bench/v99")),
    "committed-to-itself": (None, None),
}


@pytest.mark.parametrize("pair", COMPARE_PAIRS)
def test_compare_matches_reference(pair, tmp_path):
    """``compare`` gives the reference's failures and notes, and
    ``python -m repro_torch.dse.compare`` its exit codes (0 ok, 1 bad
    input, 2 regression), a missing file included."""
    old, new = COMPARE_PAIRS[pair]
    po, pn = str(tmp_path / "old.json"), str(tmp_path / "new.json")
    if old is None:
        po = pn = BENCH
    else:
        with open(po, "w") as f:
            json.dump(old, f)
        with open(pn, "w") as f:
            json.dump(new, f)
        if pair != "unknown-schema":
            assert tcompare.compare(old, new) == jcompare.compare(old, new)
    assert tcompare.main([po, pn]) == jcompare.main([po, pn])
    missing = str(tmp_path / "nope.json")
    assert tcompare.main([po, missing]) == jcompare.main([po, missing]) == 1


def _flaky_tasks(calls, fail_keys=()):
    def make(key):
        def run():
            calls.append(key)
            if key in fail_keys:
                raise RuntimeError(f"boom {key}")
            return {"value": key.upper()}
        return tdriver.SweepTask(key=key, run=run, meta={"m": 1})
    return [make(k) for k in ("a", "b", "c")]


def test_driver_error_records_carry_their_task_key(tmp_path):
    out = str(tmp_path / "sweep.json")
    results = tdriver.run_sweep(_flaky_tasks([], fail_keys=("b",)), out=out)
    by_key = {r["task_key"]: r for r in results}
    assert set(by_key) == {"a", "b", "c"}
    assert "error" in by_key["b"] and by_key["b"]["m"] == 1
    assert tdriver.summarize(results, "value") == "2 ok, 0 skipped, 1 errors"


def test_driver_resume_does_not_rerun_errored_points(tmp_path):
    out = str(tmp_path / "sweep.json")
    calls = []
    tdriver.run_sweep(_flaky_tasks(calls, fail_keys=("b",)), out=out)
    results = tdriver.run_sweep(_flaky_tasks(calls, fail_keys=("b",)),
                                out=out)
    assert calls == ["a", "b", "c"] and len(results) == 3


def test_driver_retry_errors_reruns_only_failures(tmp_path):
    out = str(tmp_path / "sweep.json")
    calls = []
    tdriver.run_sweep(_flaky_tasks(calls, fail_keys=("b",)), out=out)
    results = tdriver.run_sweep(_flaky_tasks(calls), out=out,
                                retry_errors=True)
    assert calls == ["a", "b", "c", "b"] and len(results) == 3
    by_key = {r["task_key"]: r for r in results}
    assert by_key["b"]["value"] == "B" and "error" not in by_key["b"]
