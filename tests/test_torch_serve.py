"""The port's device futures and serving tier against the JAX package, on
the CPU.

Part A — ``launch_program``: bit-identical to ``run_program`` and
idempotent, ``donate_states`` keyed only when set and reusing its input
states with no copy, ``prewarm_program``'s keys.

Part B — the host-only pieces of ``tests/test_serve.py`` and
``tests/test_resilience.py``, each run on both packages with the same
inputs: tenant-graph layout and memo, padding, the FIFO and DRR formers,
stats reservoirs, option validation, root range, oversized demand,
MoE-less failure accounting, the retry ledger, the circuit breaker and
seeded chaos plans.

Part C — one scenario, :func:`scenario`, run by the port here and by the
reference in one subprocess on 8 fake host devices, matched response by
response: a launch sequence's cache hit/miss/trace deltas, pre-warm keys,
the 16-request stream over 4 tenants (status, rounds, result, batch
attribution, the stats counters), the inflight-depth and DRR sweep,
donated buffers, the pipelined server, one poisoned launch failing only
its batch, admission control, attributed drops, a seeded chaos plan
(launch fault, device fault, host loss on a retrying server), a host
loss with batches in flight, exhausted retries, deadlines, and an MoE
lane fault mid-stream (``tests/test_resilience.py``'s stub lane).

The module imports nothing of the reference at top level, so the
``cuda`` tests run on a card whose host has no JAX:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_serve.py``.
"""
import dataclasses
import gc
import json
import os
import subprocess
import sys
import types
import weakref

import numpy as np
import pytest
import torch

from repro_torch.core.fabric import Fabric
from repro_torch.core.queues import QueueConfig
from repro_torch.sparse import datasets as tdata
from repro_torch.sparse import program as tprogram
from repro_torch.sparse.options import LaunchOptions
from repro_torch.sparse.torch_apps import BFS, SSSP

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
WIDTH = 4
TENANTS = ["acme", "globex", "initech", "umbrella"]


def wiki(datasets):
    return datasets.wiki_like(192, avg_degree=6, seed=3)


# ---------------------------------------------------------------------------
# Part A: launch_program
# ---------------------------------------------------------------------------

def test_launch_program_is_run_program_and_idempotent():
    g = wiki(tdata)
    fab = Fabric.fake(8, device="cpu")
    for prog, mode in ((BFS, "lockstep"), (SSSP, "pipelined")):
        opts = LaunchOptions(round_mode=mode)
        want = tprogram.run_program(prog, g, fab, params={"root": 7},
                                    options=opts)
        launch = tprogram.launch_program(prog, g, fab, params={"root": 7},
                                         options=opts)
        assert launch.is_ready() and launch.block() is launch
        got = launch.result()
        assert launch.result() is got                 # idempotent
        assert np.array_equal(got[0][0], want[0][0])
        assert got[1].rounds == want[1].rounds
        assert np.array_equal(got[1].messages, want[1].messages)
    from repro_torch.sparse.torch_apps import SPMV
    with pytest.raises(ValueError, match="graph programs"):
        tprogram.launch_program(SPMV, (g, np.ones(g.n)), fab)


def test_donate_states_keys_only_when_set_and_writes_its_inputs():
    """Donation joins the key only when set and copies no state: the
    gated (pipelined while) loop's outputs are its input tensors, the
    lockstep loop lets go of its inputs (nothing holds them when the
    round function returns); an undonated launch keeps its inputs and
    writes new tensors. Results are bit-identical either way."""
    g = wiki(tdata)
    fab = Fabric.fake(4, device="cpu")
    tprogram.clear_cache()
    plain = tprogram.run_program(BFS, g, fab, params={"root": 1})
    key = tprogram.cache_keys()[0]
    assert key[-1] != "donate"
    tprogram.clear_cache()
    seen = []
    real = tprogram._build_graph_fn

    def spy(*a, **kw):
        fn = real(*a, **kw)

        def run(*args):
            states = args[3]
            ptr = states[0].data_ptr()
            ref = weakref.ref(states[0])
            outs = fn(*args)
            seen.append((len(states), ref() is not None,
                         outs[0].data_ptr() == ptr))
            return outs
        return run
    try:
        tprogram._build_graph_fn = spy
        got = {(mode, donate): tprogram.run_program(
            BFS, g, fab, params={"root": 1}, donate_states=donate,
            options=LaunchOptions(round_mode=mode))
            for mode in ("lockstep", "pipelined") for donate in (False, True)}
    finally:
        tprogram._build_graph_fn = real
    assert list(tprogram.cache_keys())[:2] == [key, key + ("donate",)]
    for (states, stats) in got.values():
        assert np.array_equal(plain[0][0], states[0])
        assert stats.rounds == plain[1].rounds
    # (inputs still listed, alive, output is the input) per launch
    assert seen == [(1, True, False), (0, False, False),
                    (1, True, False), (1, True, True)]


def test_prewarm_program_returns_new_keys_then_nothing():
    g = wiki(tdata)
    fab = Fabric.fake(4, device="cpu")
    tprogram.clear_cache()
    keys = tprogram.prewarm_program(BFS, g, fab, params={"root": 0})
    assert len(keys) == 1 and keys == tprogram.cache_keys()
    assert tprogram.prewarm_program(BFS, g, fab, params={"root": 9}) == ()


def test_resident_setup_is_the_host_packing():
    g = wiki(tdata)
    fab = Fabric.fake(8, device="cpu")
    setup = tprogram._graph_setup(g, 8)
    res = tprogram.resident_setup(setup, "cpu")
    assert res[1].dtype == torch.int64 and res[1].shape == (8, setup[-1])
    a = tprogram.run_program(SSSP, g, fab, params={"root": 3}, setup=setup)
    b = tprogram.run_program(SSSP, g, fab, params={"root": 3}, setup=res)
    assert np.array_equal(a[0][0], b[0][0]) and a[1].rounds == b[1].rounds
    with pytest.raises(ValueError, match="another graph or fabric"):
        tprogram.run_program(SSSP, g, Fabric.fake(4, device="cpu"),
                             params={"root": 3}, setup=res)


# ---------------------------------------------------------------------------
# Part B: host-only pieces, both packages
# ---------------------------------------------------------------------------

def _packages():
    """(reference, port) namespaces of the serving tier's host pieces."""
    from repro.runtime import fault_tolerance as jft
    from repro.serve import batching as jb, options as jo, resilience as jr
    from repro.serve import stats as js
    from repro.sparse import datasets as jd, jax_apps as ja
    from repro_torch.runtime import fault_tolerance as tft
    from repro_torch.serve import batching as tb, options as to
    from repro_torch.serve import resilience as tr, stats as ts
    from repro_torch.sparse import torch_apps as ta
    ns = types.SimpleNamespace
    return (ns(b=jb, o=jo, r=jr, s=js, d=jd, a=ja, ft=jft),
            ns(b=tb, o=to, r=tr, s=ts, d=tdata, a=ta, ft=tft))


def test_tenant_graph_layout_matches_reference():
    out = []
    for pkg in _packages():
        g = pkg.d.erdos_renyi(48, avg_degree=4, seed=2)
        tg = pkg.b.tenant_graph(g, 3)
        assert pkg.b.tenant_graph(g, 3) is tg            # memo by identity
        rows, cols = tg.row_of(), tg.col_idx.astype(np.int64)
        assert np.array_equal(rows // g.n, cols // g.n)  # inside a column
        out.append((tg.n, tg.row_ptr, tg.col_idx, tg.values,
                    pkg.b.split_tenant_states(np.arange(g.n * 3.0), g.n, 3)))
    (jn, jr, jc, jv, js), (tn, tr, tc, tv, ts) = out
    assert jn == tn == 144
    for a, b in ((jr, tr), (jc, tc), (jv, tv)):
        assert np.array_equal(a, b)
    assert all(np.array_equal(a, b) for a, b in zip(js, ts))


def test_tenant_graph_memo_purges_dead_graphs_and_id_reuse():
    from repro_torch.serve import batching
    n0 = len(batching._TENANT_GRAPHS)
    g = tdata.erdos_renyi(32, avg_degree=3, seed=4)
    tg = batching.tenant_graph(g, 2)
    assert batching.tenant_graph(g, 2) is tg
    assert len(batching._TENANT_GRAPHS) == n0 + 1
    del g, tg
    gc.collect()
    assert len(batching._TENANT_GRAPHS) == n0
    # a stale entry under g's id whose referent is dead is recomputed
    g = tdata.erdos_renyi(32, avg_degree=3, seed=5)
    stale = batching.tenant_graph(tdata.erdos_renyi(8, avg_degree=2,
                                                    seed=6), 2)

    class _Dead:
        pass
    d = _Dead()
    batching._TENANT_GRAPHS[(id(g), 2)] = (weakref.ref(d), stale)
    del d
    tg = batching.tenant_graph(g, 2)
    assert tg is not stale and tg.n == g.n * 2 and tg.nnz == g.nnz * 2


def test_batch_padding_and_registry_match_reference():
    out = []
    for pkg in _packages():
        b = pkg.b.TenantBatch(program="bfs", graph="g", width=4,
                              roots=(5, 9), tenants=["a", "b"],
                              req_ids=[1, 2]).padded()
        with pytest.raises(ValueError):
            pkg.b.TenantBatch(program="bfs", graph="g", width=1,
                              roots=(1, 2), tenants=["a", "b"],
                              req_ids=[1, 2]).padded()
        with pytest.raises(KeyError):
            pkg.b.batched_program("pagerank")
        prog = pkg.b.batched_program("sssp")
        out.append((b.roots, b.tenants, b.req_ids, b.n_real,
                    sorted(pkg.b.BATCHED_PROGRAMS), prog.name,
                    prog.init_only, prog.reduce_op, prog.max_rounds))
    assert out[0] == out[1]


def test_multi_root_init_matches_reference_and_rejects_bad_roots():
    out = []
    for pkg in _packages():
        g = pkg.d.erdos_renyi(16, avg_degree=3, seed=8)
        tg = pkg.b.tenant_graph(g, 2)
        (dist,), fills = pkg.a.BATCHED_BFS.init(tg, {"roots": (0, g.n - 1)})
        out.append((dist, fills))
        for bad in (g.n, -1):
            with pytest.raises(ValueError, match="out of range"):
                pkg.a.BATCHED_SSSP.init(tg, {"roots": (0, bad)})
    assert np.array_equal(out[0][0], out[1][0]) and out[0][1] == out[1][1]


class _Entry:
    """Former-protocol stub: tenant / klass / demand (+ a test tag)."""

    def __init__(self, tenant, klass, demand=1, tag=0):
        self.tenant, self.klass = tenant, klass
        self.demand, self.tag = demand, tag


def _formations(former, entries, width):
    for e in entries:
        former.push(_Entry(*e))
    seq = []
    while len(former):
        seq.append([(e.tenant, e.klass, e.tag)
                    for e in former.form(lambda e: width)])
    return seq


def test_fifo_former_matches_reference():
    stream = [("a", "A"), ("b", "B"), ("c", "A"), ("a", "A"), ("d", "A")]
    seqs = [_formations(pkg.b.FifoFormer(), stream, 3)
            for pkg in _packages()]
    assert seqs[0] == seqs[1]
    assert seqs[1][0] == [("a", "A", 0), ("c", "A", 0), ("d", "A", 0)]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("quantum", [None, 3])
def test_drr_former_matches_reference(seed, quantum):
    rng = np.random.default_rng(seed)
    classes = [("bfs", "g"), ("sssp", "g"), ("bfs", "h")]
    stream = [(f"t{int(rng.integers(0, 5))}", classes[int(rng.integers(0, 3))],
               int(rng.integers(1, 9)), i) for i in range(40)]
    seqs = []
    for pkg in _packages():
        f = pkg.b.DrrFormer(quantum)
        seq = _formations(f, stream[:24], 4)
        f.push_front(_Entry(*stream[24]))
        seq += _formations(f, stream[25:], 4)
        seqs.append(seq)
    assert seqs[0] == seqs[1]
    assert sum(len(b) for b in seqs[1]) == 40


def test_stats_reservoirs_match_reference():
    snaps = []
    for pkg in _packages():
        assert pkg.s.STATS_WINDOW == 4096
        ts = pkg.s.TenantStats()
        ss = pkg.s.ServingStats()
        for i in range(pkg.s.STATS_WINDOW + 123):
            ts.latencies.append(float(i))
            ts.queue_waits.append(float(i) / 2)
            ts.device_times.append(float(i) / 3)
            ss.observe_queue_depth(i % 97)
            ss.round_latencies.append(float(i))
        assert len(ts.latencies) == pkg.s.STATS_WINDOW
        ss.tenants["x"] = ts
        ts.submitted, ts.served = 3, 2
        with pytest.raises(AssertionError, match="accounted"):
            ss.verify()
        snaps.append(ss.snapshot())
    assert snaps[0] == snaps[1]
    assert snaps[1]["max_queue_depth"] == 96


def test_serve_options_validation_matches_reference():
    bad = [dict(inflight_depth=0), dict(fairness="lifo"),
           dict(drr_quantum=0), dict(max_retries=-1),
           dict(backoff_base_s=-1.0), dict(deadline_s=0.0),
           dict(breaker_threshold=0)]
    out = []
    for pkg in _packages():
        assert pkg.o.ServeOptions().resolve().inflight_depth == 1
        assert pkg.o.ServeOptions(inflight_depth=4, fairness="drr",
                                  drr_quantum=100).resolve().fairness == "drr"
        msgs = []
        for kw in bad:
            with pytest.raises(ValueError) as e:
                pkg.o.ServeOptions(**kw).resolve()
            msgs.append(str(e.value))
        out.append(msgs)
    assert out[0] == out[1]


class _FakeMesh:
    """Just enough mesh for the reference's submit-time admission (no
    launches)."""
    devices = np.zeros(4)


def _servers(graphs, **kw):
    """(reference, port) servers over 4 shards for submit-time tests."""
    from repro.serve import ProgramServer as JServer
    from repro_torch.serve import ProgramServer as TServer
    return (JServer(_FakeMesh(), graphs[0], **kw),
            TServer(Fabric.fake(4, device="cpu"), graphs[1], **kw))


def _resp(r):
    return (r.req_id, r.tenant, r.status, r.retriable, r.reason)


def test_submit_time_failures_match_reference():
    """Out-of-range roots, an unknown graph or program, a moe request
    with no MoE lane, and a demand over the tenant's budget fail or
    reject at submit, identically, and the ledger balances."""
    from repro.serve import Request as JReq
    from repro.sparse import datasets as jd
    from repro_torch.serve import Request as TReq
    gs = [{"g": d.erdos_renyi(32, avg_degree=3, seed=7)} for d in (jd, tdata)]
    n = gs[1]["g"].n
    got = []
    for srv, Req in zip(_servers(gs, batch_width=2), (JReq, TReq)):
        out = [srv.submit(Req(i, "acme", "bfs", "g", root=bad))
               for i, bad in enumerate((n, n + 5, -1))]
        out.append(srv.submit(Req(3, "acme", "pagerank", "g")))
        out.append(srv.submit(Req(4, "acme", "bfs", "nope")))
        out.append(srv.submit(Req(5, "bee", "moe",
                                  payload=np.zeros((16, 8), np.float32))))
        assert srv.submit(Req(6, "acme", "bfs", "g", root=n - 1)) is None
        assert srv.submit(Req(7, "bee", "bfs", "g", root=0)) is None
        assert srv.queue_depth == 2
        got.append(([_resp(r) for r in out],
                    {t: (s.submitted, s.failed)
                     for t, s in srv.stats.tenants.items()}))
    assert got[0] == got[1]
    assert all(r[2] == "failed" and not r[3] for r in got[1][0])
    got = []
    from repro.core.queues import QueueConfig as JQueues
    for srv, Req, Queues in zip(_servers(gs, batch_width=2), (JReq, TReq),
                                (JQueues, QueueConfig)):
        srv.default_queues = Queues.from_cap(2, "serve")
        r = srv.submit(Req(0, "acme", "bfs", "g", root=0))   # budget 8
        srv.stats.verify()
        got.append((_resp(r), srv.stats.tenant("acme").rejected))
    assert got[0] == got[1]
    assert got[1][0][2] == "rejected" and got[1][0][3] is False


def test_retry_ledger_and_injection_schedule_match_reference():
    out = []
    for pkg in _packages():
        led = pkg.ft.RetryLedger(max_retries=2, backoff_base_s=0.25)
        trace = []
        for key in (3, 3, 3, 9, 3):
            trace.append((led.record_failure(key), led.attempt(key),
                          led.backoff_s(key)))
        led.clear(3)
        sched = pkg.ft.InjectionSchedule(at={3: "x", 5: "y"})
        fired = [sched.peek(3), sched.due(1), sched.due(3), sched.due(3)]
        with pytest.raises(pkg.ft.InjectedFailure, match="y at step 5"):
            sched.check(5)
        plan = pkg.ft.FailurePlan(at_steps={7: "z"})
        out.append((trace, led.total_retries, dict(led.attempts), fired,
                    sched.fired, sched.exhausted, plan.at_steps))
    assert out[0] == out[1]


def test_circuit_breaker_matches_reference():
    out = []
    for pkg in _packages():
        br = pkg.r.CircuitBreaker(threshold=2, klass=("sssp", "wiki"))
        steps = [br.allows_launch(), br.record_failure(),
                 br.record_success(), br.record_failure(),
                 br.record_failure(), br.state, br.reject_reason(),
                 br.allows_launch(), br.state, br.allows_launch(),
                 br.record_failure(), br.state, br.allows_launch(),
                 br.record_success(), br.state, br.opens, br.closes]
        with pytest.raises(ValueError, match="unknown fault kinds"):
            pkg.r.ServeFailurePlan(at={0: "meteor"})
        out.append(steps)
    assert out[0] == out[1]


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
def test_seeded_chaos_plans_match_reference(seed):
    plans = [pkg.r.seeded_chaos_plan(seed, 9, keep_devices=4)
             for pkg in _packages()]
    assert plans[0].at == plans[1].at and len(plans[1].at) == 3
    assert plans[0].keep_devices == plans[1].keep_devices == 4
    with pytest.raises(ValueError):
        _packages()[1].r.seeded_chaos_plan(seed, 2)


def test_fabric_shrink_follows_the_structure_rule():
    pod = Fabric.virtual((2, 4), ("pod", "data"), device="cpu")
    for keep, shape, names, portal in (
            (8, (2, 4), ("pod", "data"), "pod"),
            (4, (1, 4), ("pod", "data"), "pod"),
            (6, (6,), ("data",), None), (1, (1,), ("data",), None)):
        f = pod.shrink(keep)
        assert (f.shape, f.axis_names, f.portal_axis) == (shape, names,
                                                          portal)
        assert f.n_devices == keep and f.device == pod.device
    assert pod.shrink(4).fabric_key() != pod.fabric_key()
    assert pod.shrink(4).pod_axis is None           # one pod left
    for bad in (0, 9):
        with pytest.raises(ValueError, match="shrink keeps"):
            pod.shrink(bad)


# ---------------------------------------------------------------------------
# Part C: the request stream, both packages
# ---------------------------------------------------------------------------

def _sig(rs):
    return [[r.req_id, r.tenant, r.status, r.retriable, r.reason,
             None if r.result is None else np.asarray(r.result).tolist(),
             r.batch_drops, r.batch_messages, r.rounds, r.batch_width,
             r.retries] for r in sorted(rs, key=lambda r: r.req_id)]


def _ledger(srv):
    return {t: [v.submitted, v.served, v.rejected, v.failed, v.retries]
            for t, v in srv.stats.tenants.items()}


#: the snapshot's counters (latencies vary run to run)
COUNTERS = ("noc_drops", "launches", "batched_requests", "pad_columns",
            "cache_hits", "cache_misses", "cache_hit_rate",
            "prewarmed_keys", "retries", "breaker_opens", "breaker_closes",
            "host_losses")


def _counters(srv):
    snap = srv.stats.snapshot()
    out = {k: snap[k] for k in COUNTERS}
    out["tenants"] = {t: {k: v for k, v in s.items() if "latency" not in k
                          and "wait" not in k and "device" not in k}
                      for t, s in snap["tenants"].items()}
    return out


def _delta(program, c0):
    c1 = program.cache_stats()
    return [c1[k] - c0[k] for k in ("hits", "misses", "kernel_traces")]


def scenario(api, shape=(8,), names=("data",), pod=None):
    """The serving contract on one package. ``api`` names its modules and
    how to build a fabric of a shape; returns JSON-able results. The
    fabric is ``shape`` over ``names`` (8 flat shards by default); ``pod``
    names the axis every launch routes its portal stage over (none: the
    flat path), and host losses keep half the shards."""
    program, serve, Opts = api.program, api.serve, api.LaunchOptions
    g = wiki(api.datasets)
    fab = api.fabric(shape, names)
    n_dev = int(np.prod(shape))
    res = {}

    def O(**kw):
        """The launch options of a part on this fabric (``None``: the
        server's and the launches' defaults)."""
        return Opts(pod_axis=pod, **kw) if pod or kw else None

    # ---- one launch sequence: cache deltas, keys, donation ---------------
    program.clear_cache()
    seq = []
    for step in ("warm", "warm", "launch", "donate", "pipelined", "donate",
                 "short"):
        c0 = program.cache_stats()
        k0 = len(program.cache_keys())
        if step == "warm":
            new = program.prewarm_program(api.BFS, g, fab, options=O(),
                                          params={"root": len(seq)})
            assert len(new) == len(program.cache_keys()) - k0
        elif step == "short":
            program.launch_program(api.SSSP, g, fab, params={"root": 1},
                                   max_rounds=3, options=O()).result()
        else:
            launch = program.launch_program(
                api.BFS, g, fab, params={"root": 5},
                donate_states=step == "donate",
                options=O(round_mode="pipelined" if step == "pipelined"
                          else "lockstep"))
            assert launch.result() is launch.result()
        seq.append([step, len(program.cache_keys()) - k0,
                    program.cache_keys()[-1][-1] == "donate"]
                   + _delta(program, c0))
    res["sequence"] = seq

    # ---- pre-warm, then a 4-tenant stream --------------------------------
    reqs = [serve.Request(i, TENANTS[i % 4], "bfs" if i % 2 == 0 else "sssp",
                          "wiki", root=(i * 13) % g.n) for i in range(16)]
    program.clear_cache()
    srv = serve.ProgramServer(fab, {"wiki": g}, batch_width=WIDTH,
                              options=O())
    warm = srv.prewarm(("bfs", "sssp"))
    res["warm"] = [{f"{p}/{gn}": len(k) for (p, gn), k in warm.items()},
                   program.cache_stats(),
                   sum(len(k) for k in srv.prewarm(("bfs", "sssp")).values())]
    c0 = program.cache_stats()
    rs = srv.run(reqs)
    srv.stats.verify()
    res["stream"] = [_sig(rs), _delta(program, c0), _counters(srv),
                     _ledger(srv)]
    res["standalone"] = [
        bool(np.array_equal(program.run_program(
            api.BFS if r.program == "bfs" else api.SSSP, g, fab,
            params={"root": r.root}, options=O())[0][0], resp.result))
        for r, resp in zip(reqs, rs)]

    # ---- the depth / fairness sweep and the pipelined server -------------
    sweep = {}
    for name, so, opts in (
            ("fifo2", dict(inflight_depth=2), O()),
            ("fifo4", dict(inflight_depth=4), O()),
            ("drr3", dict(inflight_depth=3, fairness="drr"), O()),
            ("pipelined", {}, O(round_mode="pipelined"))):
        c0 = program.cache_stats()
        s2 = serve.ProgramServer(fab, {"wiki": g}, batch_width=WIDTH,
                                 options=opts,
                                 serve_options=serve.ServeOptions(**so))
        rs2 = s2.run(reqs)
        s2.stats.verify()
        sweep[name] = [_sig(rs2), _ledger(s2), _delta(program, c0),
                       s2.stats.launches]
    res["sweep"] = sweep

    # ---- donated buffers: their own keys, the same responses -------------
    s3 = serve.ProgramServer(fab, {"wiki": g}, batch_width=WIDTH,
                             options=O(), serve_options=serve.ServeOptions(
                                 inflight_depth=3, donate_buffers=True))
    k0 = len(program.cache_keys())
    s3.prewarm(("bfs", "sssp"))
    k1 = len(program.cache_keys())
    c0 = program.cache_stats()
    rs3 = s3.run(reqs)
    s3.stats.verify()
    res["donate"] = [_sig(rs3), k1 - k0, _delta(program, c0)]

    # ---- a poisoned launch at window position 2 of 3 ---------------------
    poison = g.n - 1
    real = program.launch_program
    window = []

    def poisoned(prog, data, fabric, **kw):
        window.append(s4.inflight_depth)
        if poison in tuple((kw.get("params") or {}).get("roots") or ()):
            raise RuntimeError("injected launch failure")
        return real(prog, data, fabric, **kw)
    program.launch_program = poisoned
    try:
        s4 = serve.ProgramServer(fab, {"wiki": g}, batch_width=WIDTH,
                                 options=O(), serve_options=serve.ServeOptions(
                                     inflight_depth=3))
        f_reqs = ([serve.Request(i, f"a{i}", "bfs", "wiki", root=1)
                   for i in range(4)]
                  + [serve.Request(4 + i, f"b{i}", "bfs", "wiki",
                                   root=poison if i == 0 else 2)
                     for i in range(4)]
                  + [serve.Request(8 + i, f"c{i}", "bfs", "wiki", root=3)
                     for i in range(4)])
        rs4 = s4.run(f_reqs)
        s4.stats.verify()
    finally:
        program.launch_program = real
    res["poison"] = [_sig(rs4), _ledger(s4), max(window)]

    # ---- admission control and attributed drops --------------------------
    s5 = serve.ProgramServer(
        fab, {"wiki": g}, batch_width=WIDTH, options=O(),
        tenant_queues={"acme": api.QueueConfig.from_cap(
            g.nnz // n_dev + 1, "serve"),
            "globex": api.QueueConfig.from_cap(2, "serve")})
    subs = [s5.submit(serve.Request(0, "acme", "bfs", "wiki", root=1)),
            s5.submit(serve.Request(1, "acme", "bfs", "wiki", root=2)),
            s5.submit(serve.Request(2, "globex", "bfs", "wiki", root=3))]
    drained = s5.drain()
    subs.append(s5.submit(serve.Request(3, "acme", "bfs", "wiki", root=2)))
    drained += s5.drain()
    s5.stats.verify()
    res["admission"] = [[None if r is None else _sig([r])[0] for r in subs],
                        _sig(drained), _ledger(s5)]
    # an explicit cap is the flat path's; the portal path drops at a
    # small factor
    tight = (api.QueueConfig.from_cap(2, "T3") if pod is None
             else api.QueueConfig.from_factor(0.25, "T3"))
    s6 = serve.ProgramServer(fab, {"wiki": g}, batch_width=WIDTH,
                             options=O(queues=tight))
    rs6 = s6.run([serve.Request(i, f"t{i}", "bfs", "wiki", root=i)
                  for i in range(2)])
    s6.stats.verify()
    res["drops"] = [_sig(rs6), s6.stats.noc_drops]

    # ---- a seeded chaos plan on a retrying server ------------------------
    c_reqs = ([serve.Request(i, TENANTS[i % 4], "sssp", "wiki",
                             root=(i * 13) % g.n) for i in range(8)]
              + [serve.Request(8 + i, TENANTS[i % 4], "bfs", "wiki",
                               root=(i * 7) % g.n) for i in range(8)])
    program.clear_cache()
    plan = serve.seeded_chaos_plan(5, 4, keep_devices=n_dev // 2)
    s7 = serve.ProgramServer(fab, {"wiki": g}, batch_width=WIDTH,
                             options=O(), serve_options=serve.ServeOptions(
                                 max_retries=3, breaker_threshold=1),
                             failure_plan=plan)
    s7.prewarm(("bfs", "sssp"))
    c0 = program.cache_stats()
    rs7 = s7.run(c_reqs)
    s7.stats.verify()
    res["chaos"] = [_sig(rs7), _ledger(s7), _counters(s7),
                    [list(f) for f in plan.fired], plan.exhausted,
                    s7.fabric.n_devices, _delta(program, c0)]

    # ---- host loss with batches in flight; retries run out; deadlines ----
    plan = serve.ServeFailurePlan(at={1: "host_loss"},
                                  keep_devices=n_dev // 2)
    s8 = serve.ProgramServer(fab, {"wiki": g}, batch_width=WIDTH,
                             options=O(), serve_options=serve.ServeOptions(
                                 inflight_depth=2, max_retries=1),
                             failure_plan=plan)
    rs8 = s8.run(c_reqs[8:])
    s8.stats.verify()
    s9 = serve.ProgramServer(fab, {"wiki": g}, batch_width=WIDTH,
                             options=O(), serve_options=serve.ServeOptions(max_retries=2),
                             failure_plan=serve.ServeFailurePlan(
                                 at={0: "launch", 1: "launch", 2: "launch"}))
    rs9 = s9.run([serve.Request(i, TENANTS[i], "bfs", "wiki", root=1 + i)
                  for i in range(4)])
    s9.stats.verify()
    s10 = serve.ProgramServer(fab, {"wiki": g}, batch_width=WIDTH,
                              options=O(), serve_options=serve.ServeOptions(
                                  deadline_s=1e-6))
    rs10 = s10.run([serve.Request(i, "t", "bfs", "wiki", root=i)
                    for i in range(2)])
    s10.stats.verify()
    res["faults"] = [[_sig(rs8), _ledger(s8), s8.stats.host_losses,
                      s8.fabric.n_devices],
                     [_sig(rs9), _ledger(s9), s9.stats.retries],
                     [_sig(rs10), _ledger(s10)]]

    # ---- an MoE lane fault mid-stream, terminal and retried --------------
    class StubMoE:
        """The engine's view of an MoE lane, without a model: dispatch
        doubles the payload (the mesh argument is the reference's)."""
        batch = 2

        def __init__(self):
            self.calls = 0

        def demand(self, payload):
            return int(payload.shape[0])

        def prewarm(self, mesh=None):
            pass

        def dispatch(self, payloads, mesh=None):
            self.calls += 1
            return [q * 2.0 for q in payloads], self.calls > 1
    payloads = [np.full((4, 8), 1.0 + i, np.float32) for i in range(2)]
    m_reqs = ([serve.Request(i, f"a{i}", "bfs", "wiki", root=1)
               for i in range(4)]
              + [serve.Request(4 + i, f"m{i}", "moe", payload=payloads[i])
                 for i in range(2)]
              + [serve.Request(6 + i, f"b{i}", "bfs", "wiki", root=2)
                 for i in range(4)])
    res["moe_fault"] = []
    for retries in (0, 1):
        stub = StubMoE()
        sm = serve.ProgramServer(fab, {"wiki": g}, batch_width=WIDTH,
                                 moe=stub, options=O(),
                                 serve_options=serve.ServeOptions(
                                     max_retries=retries),
                                 failure_plan=serve.ServeFailurePlan(
                                     at={1: "moe"}))
        for r in m_reqs:
            assert sm.submit(r) is None
        drained = sm.drain()          # launch order, not req_id order
        sm.stats.verify()
        res["moe_fault"].append([[r.req_id for r in drained],
                                 _sig(drained), stub.calls, _ledger(sm)])
    return json.loads(json.dumps(res))


def port_api():
    from repro_torch import serve
    from repro_torch.sparse import torch_apps
    return types.SimpleNamespace(
        program=tprogram, serve=serve, LaunchOptions=LaunchOptions,
        QueueConfig=QueueConfig, datasets=tdata, BFS=torch_apps.BFS,
        SSSP=torch_apps.SSSP,
        fabric=lambda shape, names: Fabric.virtual(shape, names,
                                                   device="cpu"))


SCRIPT = r"""
import os
os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=8'
import json, sys, types
from repro import serve
from repro.core.compat import make_mesh
from repro.core.queues import QueueConfig
from repro.sparse import datasets, program
from repro.sparse.jax_apps import BFS, SSSP
from repro.sparse.options import LaunchOptions
sys.path.insert(0, os.environ['TESTS_DIR'])
from test_torch_serve import scenario

api = types.SimpleNamespace(
    program=program, serve=serve, LaunchOptions=LaunchOptions,
    QueueConfig=QueueConfig, datasets=datasets, BFS=BFS, SSSP=SSSP,
    fabric=lambda shape, names: make_mesh(shape, names))
print('RESULT ' + json.dumps(scenario(api)))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=SRC,
               TESTS_DIR=os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-W", "ignore", "-c", SCRIPT],
                         env=env, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [l for l in out.stdout.splitlines() if l.startswith("RESULT ")][0]
    return json.loads(line[len("RESULT "):])


@pytest.fixture(scope="module")
def port():
    return scenario(port_api())


PARTS = ("sequence", "warm", "stream", "standalone", "sweep", "donate",
         "poison", "admission", "drops", "chaos", "faults", "moe_fault")


@pytest.mark.parametrize("part", PARTS)
def test_port_matches_reference(reference, port, part):
    assert port[part] == reference[part]


def test_stream_is_served_whole_from_the_warm_cache(port):
    sig, delta, counters, ledger = port["stream"]
    assert [r[2] for r in sig] == ["ok"] * 16
    assert delta[1:] == [0, 0] and delta[0] >= 4    # hits only, no build
    assert counters["noc_drops"] == 0 and counters["cache_hit_rate"] == 1.0
    assert all(row == [4, 4, 0, 0, 0] for row in ledger.values())
    assert all(port["standalone"])
    assert port["warm"][0] == {"bfs/wiki": 1, "sssp/wiki": 1}
    assert port["warm"][2] == 0                     # a second pre-warm


def test_sweep_and_donation_serve_the_same_responses(port):
    base = port["stream"][0]
    for name, (sig, ledger, delta, launches) in port["sweep"].items():
        assert sig == base, name
        assert delta[1] == (2 if name == "pipelined" else 0), name
        assert launches >= 4
    sig, new_keys, delta = port["donate"]
    assert sig == base and new_keys == 2 and delta[1:] == [0, 0]


def test_poisoned_launch_fails_only_its_batch(port):
    sig, ledger, window = port["poison"]
    assert [r[2] for r in sig] == ["ok"] * 4 + ["failed"] * 4 + ["ok"] * 4
    assert all("injected launch failure" in r[4] for r in sig[4:8])
    assert window == 2


def test_faults_run_their_course(port):
    (loss, loss_ledger, losses, n_after), (exh, _, retries), (dead, _) = \
        port["faults"]
    assert [r[2] for r in loss] == ["ok"] * 8 and losses == 1
    assert n_after == 4
    assert [r[2] for r in exh] == ["failed"] * 4 and retries == 8
    assert all("after 2 retries" in r[4] for r in exh)
    assert all(r[2] == "failed" and not r[3] and "deadline" in r[4]
               for r in dead)
    terminal, retried = port["moe_fault"]
    assert [r[2] for r in terminal[1]].count("failed") == 2
    assert [r[2] for r in retried[1]] == ["ok"] * 10
    assert all(r[5] == [[2.0 * (1.0 + r[0] - 4)] * 8] * 4
               for r in retried[1] if r[1].startswith("m"))


def test_chaos_plan_fires_and_every_request_is_served(port):
    sig, ledger, counters, fired, exhausted, n_after, _ = port["chaos"]
    assert exhausted and [k for _, k in fired] == ["launch", "device",
                                                   "host_loss"]
    assert [r[2] for r in sig] == ["ok"] * 16 and n_after == 4
    assert counters["host_losses"] == 1 and counters["retries"] > 0


# ---------------------------------------------------------------------------
# MoE lane (port only: the reference's own tests hold moe_dcra)
# ---------------------------------------------------------------------------

def test_moe_lane_is_one_warm_dispatch_equal_to_moe_dcra():
    from repro_torch.configs import get_config
    from repro_torch.core.dispatch import MeshInfo, moe_dcra
    from repro_torch.models.moe import init_moe
    from repro_torch.serve import MoEService, ProgramServer, Request
    cfg = get_config("olmoe-1b-7b").reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))
    params = init_moe(torch.Generator().manual_seed(0), cfg)
    fab = Fabric.virtual((2, 2, 2), ("data", "expert", "tp"), device="cpu")
    info = MeshInfo(fab)
    moe = MoEService(cfg, params, info, batch=4, seq=16)
    srv = ProgramServer(fab, {}, moe=moe)
    srv.prewarm(("moe",))
    assert moe.traces == 1
    rng = np.random.default_rng(0)
    blocks = [rng.normal(size=(16, cfg.d_model)).astype(np.float32)
              for _ in range(6)]
    rs = srv.run([Request(i, f"m{i % 3}", "moe", payload=b)
                  for i, b in enumerate(blocks)])
    srv.stats.verify()
    assert [r.status for r in rs] == ["ok"] * 6
    assert moe.traces == 1 and moe.calls == 3        # warm + 2 batches
    assert srv.stats.cache_hits == 2 and srv.stats.cache_misses == 0
    x = np.zeros((4, 16, cfg.d_model), np.float32)
    for i in range(3):
        x[i] = blocks[i]
    want, _ = moe_dcra(params, torch.from_numpy(x), cfg, info)
    for i, r in enumerate(rs[:3]):
        assert np.array_equal(r.result, want[i].numpy())


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the route kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_is_ready_polls_without_blocking(card):
    g = tdata.rmat(14, seed=1)
    fab = Fabric.fake(8, device=card)
    setup = tprogram.resident_setup(tprogram._graph_setup(g, 8), card)
    want = tprogram.run_program(BFS, g, fab, params={"root": 0},
                                setup=setup)
    torch.cuda.synchronize()
    # a long kernel queued first keeps the launch's event pending
    a = torch.randn(4096, 4096, device=card)
    for _ in range(40):
        a = a @ a
        a = a / a.norm()
    launch = tprogram.launch_program(
        PAGERANK_OF(), g, fab, params={"damping": 0.85, "iters": 20},
        setup=setup)
    assert launch.is_ready() is False               # polled, not waited
    launch.block()
    assert launch.is_ready()
    got = tprogram.launch_program(BFS, g, fab, params={"root": 0},
                                  setup=setup).result()
    assert np.array_equal(got[0][0], want[0][0])


def PAGERANK_OF():
    from repro_torch.sparse.torch_apps import PAGERANK
    return PAGERANK


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["lockstep", "pipelined"])
def test_cuda_donation_holds_one_state_fewer_at_the_peak(card, mode):
    """A donated BFS launch's peak of allocated card memory is at least
    one state ``[S, n_local]`` float32 below the undonated launch's, and
    the gated loop allocates no state an iteration."""
    g = tdata.rmat(14, seed=1)
    fab = Fabric.fake(8, device=card)
    setup = tprogram.resident_setup(tprogram._graph_setup(g, 8), card)
    state_bytes = 8 * setup[0] * 4
    opts = LaunchOptions(round_mode=mode)
    peak, allocs, rounds = {}, {}, {}
    for donate in (False, True, False, True):       # the first two build
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        n0 = torch.cuda.memory_stats()["allocation.all.allocated"]
        torch.cuda.reset_peak_memory_stats()
        _, st = tprogram.launch_program(
            BFS, g, fab, options=opts, params={"root": 0}, setup=setup,
            donate_states=donate).result()
        torch.cuda.synchronize()
        peak[donate] = torch.cuda.max_memory_allocated() - base
        allocs[donate] = (torch.cuda.memory_stats()
                          ["allocation.all.allocated"] - n0)
        rounds[donate] = st.rounds
    assert rounds[True] == rounds[False] > 1
    assert peak[False] - peak[True] >= state_bytes, peak
    if mode == "pipelined":
        assert allocs[False] - allocs[True] >= rounds[True], allocs


@pytest.mark.cuda
def test_cuda_server_matches_the_cpu_server(card):
    g = wiki(tdata)
    from repro_torch.serve import ProgramServer, Request, ServeOptions
    reqs = [Request(i, TENANTS[i % 4], "bfs" if i % 2 == 0 else "sssp",
                    "wiki", root=(i * 13) % g.n) for i in range(16)]
    outs = []
    for dev, so, opts in (("cpu", ServeOptions(), None),
                          (card, ServeOptions(inflight_depth=3), None),
                          (card, ServeOptions(donate_buffers=True),
                           LaunchOptions(round_mode="pipelined"))):
        srv = ProgramServer(Fabric.fake(8, device=dev), {"wiki": g},
                            batch_width=WIDTH, options=opts,
                            serve_options=so)
        srv.prewarm(("bfs", "sssp"))
        outs.append(_sig(srv.run(reqs)))
        srv.stats.verify()
    assert outs[0] == outs[1] == outs[2]
