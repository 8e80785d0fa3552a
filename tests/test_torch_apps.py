"""The port's BFS / SSSP / WCC against the JAX package, on the CPU.

The reference runs its apps under ``shard_map`` on 8 fake host devices
(one subprocess); the port runs the same graphs on the same number of
virtual shards with ``device="cpu"``. States, round counts and the
per-round message and drop counts must be equal, flat and pod/portal,
including under caps that drop; so must the round-function cache's
hit/miss/trace deltas on one launch sequence. The port's own results
are also held against its numpy oracles.
"""
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch.core.fabric import Fabric
from repro_torch.sparse import datasets as tdata
from repro_torch.sparse import program as tprogram
from repro_torch.sparse import ref as tref
from repro_torch.sparse.options import LaunchOptions
from repro_torch.sparse.torch_apps import dcra_bfs, dcra_sssp, dcra_wcc

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

GRAPHS = {"er": ("erdos_renyi", dict(n=256, avg_degree=8, seed=5)),
          "pl": ("wiki_like", dict(n_vertices=512, avg_degree=8, seed=7)),
          "disc": ("disconnected_pair", dict(n_each=128, avg_degree=6,
                                             seed=11)),
          "wl": ("wiki_like", dict(n_vertices=256, avg_degree=8, seed=7))}

# name -> (graph, app, fabric shape, launch kwargs)
CASES = {}
for _g, _shape in (("er", (8,)), ("pl", (8,)), ("er", (4,))):
    for _app in ("bfs", "sssp", "wcc"):
        CASES[f"{_g}{_shape[0]}/{_app}"] = (_g, _app, _shape, {})
CASES["disc8/bfs"] = ("disc", "bfs", (8,), {})
CASES["disc8/wcc"] = ("disc", "wcc", (8,), {})
for _n in (1, 2, 4, 8):
    CASES[f"wl{_n}-cap2/bfs"] = ("wl", "bfs", (_n,), {"cap": 2})
for _app in ("sssp", "wcc"):
    CASES[f"wl8-cap2/{_app}"] = ("wl", _app, (8,), {"cap": 2})
    CASES[f"wl1-cap2/{_app}"] = ("wl", _app, (1,), {"cap": 2})
for _app in ("bfs", "sssp", "wcc"):
    CASES[f"wl2x4-cf0.25/{_app}"] = ("wl", _app, (2, 4),
                                     {"capacity_factor": 0.25})
CASES["wl2x4-cf4/bfs"] = ("wl", "bfs", (2, 4), {"capacity_factor": 4.0})
CASES["wl2x2-cf0.5/bfs"] = ("wl", "bfs", (2, 2), {"capacity_factor": 0.5})
CASES["wl2x2-cf0.5/wcc"] = ("wl", "wcc", (2, 2), {"capacity_factor": 0.5})
CASES["er8-max2/bfs"] = ("er", "bfs", (8,), {"max_rounds": 2})

# a mode="fixed" program whose update reads ctx.gsum: hop distances from
# vertex 0 for FIXED_ITERS rounds, plus, at every vertex, the running sum
# over rounds of the global count of reached vertices
FIXED_CASES = {"er8/fixed": ("er", (8,)), "wl2x4/fixed": ("wl", (2, 4)),
               "wl2x2-cap2/fixed": ("wl", (2, 2))}
FIXED_ITERS = 5


def graph_of(name, datasets):
    fn, kw = GRAPHS[name]
    return getattr(datasets, fn)(**kw)


SCRIPT = r"""
import os
os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=8'
import json, sys
import numpy as np
from repro.core.compat import make_mesh
from repro.sparse import datasets, program
from repro.sparse.jax_apps import dcra_bfs, dcra_sssp, dcra_wcc
sys.path.insert(0, os.environ['TESTS_DIR'])
from test_torch_apps import CASES, FIXED_CASES, FIXED_ITERS, graph_of

def mesh_of(shape):
    return make_mesh(shape, ('data',) if len(shape) == 1 else ('pod', 'data'))

res = {}
for name, (gname, app, shape, kw) in CASES.items():
    g = graph_of(gname, datasets)
    kw = dict(kw, pod_axis='pod') if len(shape) == 2 else dict(kw)
    if app == 'wcc':
        out, st = dcra_wcc(g, mesh_of(shape), **kw)
    else:
        fn = dcra_bfs if app == 'bfs' else dcra_sssp
        out, st = fn(g, 0, mesh_of(shape), **kw)
    res[name] = {'state': np.asarray(out, np.float64).tolist(),
                 'rounds': st.rounds, 'messages': st.messages.tolist(),
                 'drops': st.drops.tolist()}

from repro.sparse.program import TaskProgram, run_program

def fx_init(g, params):
    dist = np.full(g.n, np.inf)
    dist[0] = 0.0
    return (dist, np.zeros(g.n)), (np.inf, 0.0)

def fx_update(ctx, state, frontier, upd):
    xp = ctx.xp
    new = xp.minimum(state[0], upd)
    reached = ctx.gsum(xp.sum(xp.isfinite(new).astype(xp.float32)))
    return (new, state[1] + reached), new < state[0]

FX = TaskProgram(name='fixed_reach', mode='fixed', init=fx_init,
                 frontier0=lambda ctx, s: ctx.xp.isfinite(s[0]),
                 payload=lambda ctx, s, src_slot, w: s[0][src_slot] + 1.0,
                 update=fx_update)
for name, (gname, shape) in FIXED_CASES.items():
    kw = {'pod_axis': 'pod'} if len(shape) == 2 else {}
    if 'cap2' in name:
        kw['capacity_factor'] = 0.5
    states, st = run_program(FX, graph_of(gname, datasets), mesh_of(shape),
                             params={'iters': FIXED_ITERS}, **kw)
    res[name] = {'state': [np.asarray(a, np.float64).tolist() for a in states],
                 'rounds': st.rounds, 'messages': st.messages.tolist(),
                 'drops': st.drops.tolist()}

g = graph_of('wl', datasets)
program.clear_cache()
seq = []
for root, shape in ((0, (8,)), (0, (8,)), (5, (8,)), (0, (4,)),
                    (0, (2, 4))):
    kw = {'pod_axis': 'pod'} if len(shape) == 2 else {}
    dcra_bfs(g, root, mesh_of(shape), **kw)
    seq.append(program.cache_stats())
res['cache'] = seq
print('RESULT ' + json.dumps(res))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=SRC,
               TESTS_DIR=os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", SCRIPT], env=env,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [l for l in out.stdout.splitlines() if l.startswith("RESULT ")][0]
    return json.loads(line[len("RESULT "):])


def fabric_of(shape):
    names = ("data",) if len(shape) == 1 else ("pod", "data")
    return Fabric.virtual(shape, names, device="cpu")


def run_port(gname, app, shape, kw, route_impl=None):
    g = graph_of(gname, tdata)
    kw = dict(kw)
    max_rounds = kw.pop("max_rounds", None)
    opts = LaunchOptions(pod_axis="pod" if len(shape) == 2 else None,
                         route_impl=route_impl, **kw)
    extra = {} if max_rounds is None else {"max_rounds": max_rounds}
    if app == "wcc":
        return dcra_wcc(g, fabric_of(shape), options=opts, **extra)
    fn = dcra_bfs if app == "bfs" else dcra_sssp
    return fn(g, 0, fabric_of(shape), options=opts, **extra)


@pytest.mark.parametrize("case", list(CASES))
def test_app_matches_reference(reference, case):
    gname, app, shape, kw = CASES[case]
    want = reference[case]
    out, st = run_port(gname, app, shape, kw)
    assert np.array_equal(np.asarray(out, np.float64),
                          np.asarray(want["state"], np.float64))
    assert st.rounds == want["rounds"]
    assert st.messages.tolist() == want["messages"]
    assert st.drops.tolist() == want["drops"]


def test_cases_cover_drops_and_drop_free_runs(reference):
    drops = [sum(reference[c]["drops"]) for c in CASES]
    assert any(d > 0 for d in drops) and any(d == 0 for d in drops)


def _fx_init(g, params):
    dist = np.full(g.n, np.inf)
    dist[0] = 0.0
    return (dist, np.zeros(g.n)), (np.inf, 0.0)


def _fx_update(ctx, state, frontier, upd):
    new = torch.minimum(state[0], upd)
    reached = ctx.gsum(torch.isfinite(new).sum(1, dtype=torch.float32))
    return (new, state[1] + reached[:, None]), new < state[0]


FIXED_REACH = tprogram.TaskProgram(
    name="fixed_reach", mode="fixed", init=_fx_init,
    frontier0=lambda ctx, s: torch.isfinite(s[0]),
    payload=lambda ctx, s, src_slot, w: torch.gather(s[0], 1, src_slot) + 1.0,
    update=_fx_update)


@pytest.mark.parametrize("case", list(FIXED_CASES))
def test_fixed_mode_and_gsum_match_reference(reference, case):
    """``mode="fixed"`` runs every round even after the frontier empties,
    and ``ctx.gsum`` hands each shard the sum over all shards."""
    gname, shape = FIXED_CASES[case]
    opts = LaunchOptions(pod_axis="pod" if len(shape) == 2 else None,
                         capacity_factor=0.5 if "cap2" in case else None)
    states, st = tprogram.run_program(
        FIXED_REACH, graph_of(gname, tdata), fabric_of(shape), options=opts,
        params={"iters": FIXED_ITERS})
    want = reference[case]
    assert len(states) == len(want["state"]) == 2
    for got, exp in zip(states, want["state"]):
        assert np.array_equal(got, np.asarray(exp, np.float64))
    assert st.rounds == want["rounds"] == FIXED_ITERS
    assert st.messages.tolist() == want["messages"]
    assert st.drops.tolist() == want["drops"]


@pytest.mark.parametrize("case", ["wl8-cap2/bfs", "wl2x4-cf0.25/sssp",
                                  "wl2x2-cf0.5/wcc", "pl8/bfs"])
def test_route_impls_are_bit_identical(case):
    gname, app, shape, kw = CASES[case]
    base, st = run_port(gname, app, shape, kw, route_impl="pallas")
    for impl in ("sort", "onehot"):
        out, st2 = run_port(gname, app, shape, kw, route_impl=impl)
        assert np.array_equal(out, base) and st2.rounds == st.rounds
        assert np.array_equal(st2.messages, st.messages)
        assert np.array_equal(st2.drops, st.drops)


@pytest.mark.parametrize("gname", ["er", "pl", "disc"])
@pytest.mark.parametrize("shape", [(8,), (2, 4)])
def test_apps_match_oracles(gname, shape):
    g = graph_of(gname, tdata)
    fab = fabric_of(shape)
    opts = LaunchOptions(pod_axis="pod" if len(shape) == 2 else None)
    root = int(np.argmax(g.degrees()))
    d, st = dcra_bfs(g, root, fab, options=opts)
    assert np.array_equal(d, tref.bfs_ref(g, root)) and st.total_drops == 0
    s, st = dcra_sssp(g, root, fab, options=opts)
    assert np.array_equal(s, tref.sssp_ref(g, root)) and st.total_drops == 0
    w, st = dcra_wcc(g, fab, options=opts)
    assert np.array_equal(w, tref.wcc_ref(g)) and st.total_drops == 0


def test_cache_stats_deltas_match_reference(reference):
    g = graph_of("wl", tdata)
    tprogram.clear_cache()
    seq = []
    for root, shape in ((0, (8,)), (0, (8,)), (5, (8,)), (0, (4,)),
                        (0, (2, 4))):
        opts = LaunchOptions(pod_axis="pod" if len(shape) == 2 else None)
        dcra_bfs(g, root, fabric_of(shape), options=opts)
        seq.append(tprogram.cache_stats())
    assert seq == reference["cache"]
    assert len(tprogram.cache_keys()) == 3


def test_config_auto_runs():
    """``config="auto"`` resolves a deployment and launches it, graph and
    stream programs alike (the launch raised before the analytic stack
    was ported): BFS drop-free at the folded capacity equals the oracle
    exactly, SpMV within 1e-4 of max|y| (float32 summation order)."""
    g = graph_of("er", tdata)
    fab = fabric_of((4,))
    d, stats = dcra_bfs(g, 0, fab, options=LaunchOptions(config="auto"))
    assert stats.total_drops == 0
    assert np.array_equal(d, tref.bfs_ref(g, 0))
    from repro_torch.sparse.torch_apps import SPMV
    x = np.ones(g.n)
    y, st = tprogram.run_program(SPMV, (g, x), fab, dataset=g,
                                 options=LaunchOptions(config="auto"))
    want = tref.spmv_ref(g, x)
    assert st.total_drops == 0
    assert np.abs(y - want).max() <= 1e-4 * np.abs(want).max()
    with pytest.raises(ValueError, match="unknown config"):
        dcra_bfs(g, 0, fab, options=LaunchOptions(config="fast"))


def test_precomputed_setup_is_reused_and_checked():
    g = graph_of("er", tdata)
    fab = fabric_of((8,))
    setup = tprogram._graph_setup(g, 8)
    d1, s1 = dcra_bfs(g, 3, fab, options=LaunchOptions())
    d2, s2 = dcra_bfs(g, 3, fab, options=LaunchOptions(), setup=setup)
    assert np.array_equal(d1, d2) and np.array_equal(s1.messages, s2.messages)
    with pytest.raises(ValueError):
        dcra_bfs(g, 3, fabric_of((4,)), setup=setup)


def test_unported_paths_raise():
    g = graph_of("er", tdata)
    fab = fabric_of((4,))
    with pytest.raises(ValueError, match="2\\^24"):
        dcra_wcc(types.SimpleNamespace(n=(1 << 24) + 1), fab)
    with pytest.raises(TypeError):
        dcra_bfs(g, 0, "not a fabric")
