"""The port's stream apps (SpMV, histogram, ``dcra_scatter``) and add-reduce
apps (PageRank, k-core) against the JAX package, on the CPU.

The reference runs under ``shard_map`` on 8 fake host devices (one
subprocess); the port runs the same inputs on the same number of virtual
shards with ``device="cpu"``, flat (1/2/4/8 shards) and pod/portal
(2 x 2, 2 x 4), including queues tight enough to drop. What must hold:

* per-round message and drop counts and round counts are equal;
* k-core, histogram and ``dcra_scatter`` min/store states are equal
  (k-core and histogram add whole numbers far below 2^24, so no f32 sum
  of them rounds in any order);
* SpMV and ``dcra_scatter`` add: one f32 add-reduce of the same values,
  possibly in another order, so each slot is within 2 ulp (2 * 2^-23) of
  its sum of |v|;
* PageRank: the same bound for each round's add-reduce, compounded over
  the rounds (see :func:`_check_state`);
* the round-function cache's hit/miss/trace deltas on one launch
  sequence are equal, including the single-shard histogram's local
  reduce (``misses == 0``) at <= 4096 elements.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.fabric import Fabric
from repro_torch.sparse import datasets as tdata
from repro_torch.sparse import program as tprogram
from repro_torch.sparse import ref as tref
from repro_torch.sparse import torch_apps as tapps
from repro_torch.sparse.options import LaunchOptions

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
EPS = float(np.finfo(np.float32).eps)            # 2^-23

GRAPHS = {"er": ("erdos_renyi", dict(n=256, avg_degree=8, seed=5)),
          "pl": ("wiki_like", dict(n_vertices=512, avg_degree=8, seed=7)),
          "wl": ("wiki_like", dict(n_vertices=256, avg_degree=8, seed=7))}
# name -> histogram_data(n, n_bins, seed), n_bins
HISTS = {"h12": (1 << 12, 64, 4), "h11": (1 << 11, 64, 4),
         "h5000": (5000, 61, 9)}

# name -> (app, data, fabric shape, launch kwargs + app params)
CASES = {}
for _tag, _g, _shape in (("er8", "er", (8,)), ("pl8", "pl", (8,)),
                         ("er4", "er", (4,))):
    CASES[f"{_tag}/spmv"] = ("spmv", _g, _shape, {"capacity_factor": 3.0})
    CASES[f"{_tag}/histogram"] = ("histogram", "h12", _shape,
                                  {"capacity_factor": 3.0})
    CASES[f"{_tag}/pagerank"] = ("pagerank", _g, _shape, {})
    CASES[f"{_tag}/kcore"] = ("kcore", _g, _shape, {"k": 12})
for _shape in ((1,), (2,), (2, 2)):
    _n = "x".join(map(str, _shape))
    CASES[f"wl{_n}/spmv"] = ("spmv", "wl", _shape, {})
    CASES[f"h11-{_n}/histogram"] = ("histogram", "h11", _shape, {})
    CASES[f"wl{_n}/pagerank"] = ("pagerank", "wl", _shape, {"iters": 4})
    CASES[f"wl{_n}/kcore"] = ("kcore", "wl", _shape, {"k": 8})
for _app, _data, _params in (("spmv", "wl", {}), ("histogram", "h11", {}),
                             ("pagerank", "wl", {"iters": 4}),
                             ("kcore", "wl", {"k": 8})):
    CASES[f"{_data}8-cap2/{_app}"] = (_app, _data, (8,),
                                      dict(_params, cap=2))
    CASES[f"{_data}2x4-cf0.25/{_app}"] = (_app, _data, (2, 4),
                                          dict(_params,
                                               capacity_factor=0.25))
CASES["wl8-seed3/spmv"] = ("spmv", "wl", (8,), {"seed": 3})
CASES["h11-1-cap2/histogram"] = ("histogram", "h11", (1,), {"cap": 2})
CASES["h12-1-onehot/histogram"] = ("histogram", "h12", (1,),
                                   {"route_impl": "onehot"})
CASES["h5000-1/histogram"] = ("histogram", "h5000", (1,), {})

# dcra_scatter: E = 384 tasks onto SCATTER_N items, -1 padding included
SCATTER_N = 97
SCATTER_E = 384
SCATTER = {}
for _op in ("add", "min", "store"):
    for _shape, _kw in (((1,), {}), ((2,), {}), ((8,), {}),
                        ((2, 4), {}), ((8,), {"cap": 2}),
                        ((2, 2), {"capacity_factor": 0.5})):
        _n = "x".join(map(str, _shape))
        _tag = "-".join(f"{k}{v}" for k, v in _kw.items())
        SCATTER[f"{_op}/{_n}{'-' + _tag if _tag else ''}"] = (_op, _shape,
                                                               _kw)


def graph_of(name, datasets):
    fn, kw = GRAPHS[name]
    return getattr(datasets, fn)(**kw)


def hist_of(name, datasets):
    n, bins, seed = HISTS[name]
    return datasets.histogram_data(n, bins, seed=seed), bins


def x_of(g):
    return np.random.default_rng(0).random(g.n)


def scatter_inputs(seed=0):
    rng = np.random.default_rng(seed)
    dest = rng.integers(-1, SCATTER_N, SCATTER_E).astype(np.int32)
    vals = (rng.random(SCATTER_E) * 20 - 10).astype(np.float32)
    return dest, vals


def split(kw):
    """``(launch kwargs, app params)`` of a case."""
    kw = dict(kw)
    params = {k: kw.pop(k) for k in ("iters", "k") if k in kw}
    return kw, params


SCRIPT = r"""
import os
os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=8'
import json, sys
import numpy as np
import jax.numpy as jnp
from repro.core.compat import make_mesh
from repro.sparse import datasets, program
from repro.sparse.jax_apps import (dcra_histogram, dcra_kcore, dcra_pagerank,
                                   dcra_scatter, dcra_spmv)
sys.path.insert(0, os.environ['TESTS_DIR'])
from test_torch_stream import (CASES, SCATTER, SCATTER_N, graph_of, hist_of,
                               scatter_inputs, split, x_of)

def mesh_of(shape):
    return make_mesh(shape, ('data',) if len(shape) == 1 else ('pod', 'data'))

def pod(shape, kw):
    return dict(kw, pod_axis='pod') if len(shape) == 2 else dict(kw)

def run(app, data, shape, kw):
    kw, params = split(kw)
    mesh = mesh_of(shape)
    kw = pod(shape, kw)
    if app == 'spmv':
        g = graph_of(data, datasets)
        y, d = dcra_spmv(g, x_of(g), mesh, **kw)
        return {'state': np.asarray(y, np.float64).tolist(), 'drops': [int(d)]}
    if app == 'histogram':
        els, bins = hist_of(data, datasets)
        y, d = dcra_histogram(els, bins, mesh, **kw)
        return {'state': np.asarray(y, np.float64).tolist(), 'drops': [int(d)]}
    g = graph_of(data, datasets)
    if app == 'pagerank':
        out, st = dcra_pagerank(g, mesh, **params, **kw)
    else:
        out, st = dcra_kcore(g, params['k'], mesh, **kw)
    return {'state': np.asarray(out, np.float64).tolist(),
            'rounds': st.rounds, 'messages': st.messages.tolist(),
            'drops': st.drops.tolist()}

res = {'cases': {}, 'scatter': {}}
for name, (app, data, shape, kw) in CASES.items():
    program.clear_cache()
    out = run(app, data, shape, kw)
    out['cache'] = program.cache_stats()
    res['cases'][name] = out

dest, vals = scatter_inputs()
for name, (op, shape, kw) in SCATTER.items():
    y, d = dcra_scatter(jnp.asarray(dest), jnp.asarray(vals), SCATTER_N,
                        mesh_of(shape), op=op, **pod(shape, kw))
    res['scatter'][name] = {'y': np.asarray(y, np.float64).tolist(),
                            'drops': int(d)}

from test_torch_stream import CACHE_SEQUENCE
program.clear_cache()
seq = []
for app, data, shape, kw in CACHE_SEQUENCE:
    if app == 'scatter':
        dcra_scatter(jnp.asarray(dest), jnp.asarray(vals), SCATTER_N,
                     mesh_of(shape), op=kw['op'])
    else:
        run(app, data, shape, kw)
    seq.append(program.cache_stats())
res['cache'] = seq
print('RESULT ' + json.dumps(res))
"""

# one launch sequence, its cache counters read after every launch
CACHE_SEQUENCE = [
    ("histogram", "h12", (1,), {}),                 # local reduce: no miss
    ("histogram", "h12", (1,), {"route_impl": "onehot",
                                "capacity_factor": 2.0}),    # routed: miss
    ("histogram", "h12", (1,), {"route_impl": "onehot",
                                "capacity_factor": 2.0}),    # hit
    ("histogram", "h11", (1,), {}),                 # local reduce again
    ("spmv", "wl", (8,), {}),
    ("spmv", "wl", (8,), {"seed": 3}),              # same shape: hit
    ("scatter", None, (8,), {"op": "add"}),
    ("scatter", None, (8,), {"op": "add"}),
    ("scatter", None, (8,), {"op": "min"}),
    ("pagerank", "wl", (2, 2), {"iters": 4}),
    ("pagerank", "wl", (2, 2), {"iters": 4}),
    ("pagerank", "wl", (2, 2), {"iters": 5}),       # rounds in the key
    ("kcore", "wl", (8,), {"k": 8}),
    ("kcore", "wl", (8,), {"k": 9}),                # k in the key
]


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


def options_of(shape, kw):
    return LaunchOptions(pod_axis="pod" if len(shape) == 2 else None, **kw)


def run_port(app, data, shape, kw):
    """``(state, AppStats or None, drops)`` of one case on the port."""
    kw, params = split(kw)
    fab, opts = fabric_of(shape), options_of(shape, kw)
    if app == "spmv":
        g = graph_of(data, tdata)
        y, d = tapps.dcra_spmv(g, x_of(g), fab, options=opts)
        return y, None, [d]
    if app == "histogram":
        els, bins = hist_of(data, tdata)
        y, d = tapps.dcra_histogram(els, bins, fab, options=opts)
        return y, None, [d]
    g = graph_of(data, tdata)
    if app == "pagerank":
        out, st = tapps.dcra_pagerank(g, fab, options=opts, **params)
    else:
        out, st = tapps.dcra_kcore(g, params["k"], fab, options=opts)
    return out, st, st.drops.tolist()


def _row_abs_sum(g, x):
    """Per row: sum of |A[r, c] * x[c]| over the row's stored entries."""
    return np.bincount(g.row_of(), weights=np.abs(
        g.values.astype(np.float64) * np.asarray(x, np.float32)[g.col_idx]),
        minlength=g.n)


def _check_state(app, data, got, want, params):
    if app in ("histogram", "kcore"):
        assert np.array_equal(got, want)
    elif app == "spmv":
        g = graph_of(data, tdata)
        assert np.all(np.abs(got - want) <= 2 * EPS * _row_abs_sum(g, x_of(g)))
    else:
        # each round's add-reduce is within 2 ulp of the slot's sum of
        # contributions, which is at most rank / damping; the damping
        # (< 1) shrinks the error carried from earlier rounds, and the
        # update adds at most 4 roundings of the rank: at most
        # (2 / 0.85 + 4) ulp of the largest rank per round, summed over
        # the rounds
        iters = params.get("iters", 20)
        tol = iters * (2 / 0.85 + 4) * EPS * np.max(np.abs(want))
        assert np.max(np.abs(got - want)) <= tol


@pytest.mark.parametrize("case", list(CASES))
def test_app_matches_reference(reference, case):
    app, data, shape, kw = CASES[case]
    want = reference["cases"][case]
    got, st, drops = run_port(app, data, shape, kw)
    if app in ("spmv", "histogram"):
        assert got.dtype == np.float32          # numpy on every path
    assert drops == want["drops"]
    if st is not None:
        assert st.rounds == want["rounds"]
        assert st.messages.tolist() == want["messages"]
    _check_state(app, data, np.asarray(got, np.float64),
                 np.asarray(want["state"], np.float64), split(kw)[1])


def test_cases_cover_drops_and_drop_free_runs(reference):
    drops = [sum(r["drops"]) for r in reference["cases"].values()]
    assert any(d > 0 for d in drops) and any(d == 0 for d in drops)
    sdrops = [r["drops"] for r in reference["scatter"].values()]
    assert any(d > 0 for d in sdrops) and any(d == 0 for d in sdrops)


@pytest.mark.parametrize("case", list(SCATTER))
def test_scatter_matches_reference(reference, case):
    op, shape, kw = SCATTER[case]
    dest, vals = scatter_inputs()
    y, dropped = tapps.dcra_scatter(dest, vals, SCATTER_N, fabric_of(shape),
                                    options=options_of(shape, kw), op=op)
    want = reference["scatter"][case]
    assert int(dropped) == want["drops"]
    got = y.numpy().astype(np.float64)
    exp = np.asarray(want["y"], np.float64)
    assert got.shape == exp.shape
    if op != "add":
        assert np.array_equal(got, exp)
        return
    n_dev = int(np.prod(shape))
    scale = np.zeros(len(exp))
    n_local = -(-SCATTER_N // n_dev)
    ok = dest >= 0
    np.add.at(scale, (dest[ok] % n_dev) * n_local + dest[ok] // n_dev,
              np.abs(vals[ok].astype(np.float64)))
    assert np.all(np.abs(got - exp) <= 2 * EPS * scale)


def test_pagerank_and_kcore_match_oracles():
    for gname in ("er", "pl"):
        g = graph_of(gname, tdata)
        for shape in ((8,), (2, 4)):
            rank, st = tapps.dcra_pagerank(g, fabric_of(shape),
                                           options=options_of(shape, {}))
            want = tref.pagerank_ref(g)
            assert st.total_drops == 0 and st.rounds == 20
            assert np.max(np.abs(rank - want)) / want.max() < 1e-4
            core, st = tapps.dcra_kcore(g, 12, fabric_of(shape),
                                        options=options_of(shape, {}))
            assert np.array_equal(core, tref.kcore_ref(g, 12))
            assert st.total_drops == 0


def test_stream_apps_match_oracles():
    g = graph_of("pl", tdata)
    x = x_of(g)
    els, bins = hist_of("h12", tdata)
    for shape in ((1,), (4,), (2, 4)):
        y, d = tapps.dcra_spmv(g, x, fabric_of(shape),
                               options=options_of(shape, {}))
        want = tref.spmv_ref(g, x)
        assert d == 0 and np.max(np.abs(y - want)) / np.abs(want).max() < 1e-4
        h, d = tapps.dcra_histogram(els, bins, fabric_of(shape),
                                    options=options_of(shape, {}))
        assert d == 0 and np.array_equal(h, tref.histogram_ref(els, bins))


def _port_cache_sequence():
    dest, vals = scatter_inputs()
    tprogram.clear_cache()
    seq = []
    for app, data, shape, kw in CACHE_SEQUENCE:
        if app == "scatter":
            tapps.dcra_scatter(dest, vals, SCATTER_N, fabric_of(shape),
                               op=kw["op"])
        else:
            run_port(app, data, shape, kw)
        seq.append(tprogram.cache_stats())
    return seq


def test_cache_stats_deltas_match_reference(reference):
    assert _port_cache_sequence() == reference["cache"]
    assert reference["cache"][0]["misses"] == 0     # the local reduce ran


def test_local_reduce_has_no_size_gate(reference):
    """A deliberate difference: the reference routes a single-shard
    histogram of more than 4096 elements off the TPU (its interpret-mode
    kernel would be slow); the port always takes the kernel's local
    reduce there. The counts are equal either way."""
    assert reference["cases"]["h5000-1/histogram"]["cache"]["misses"] == 1
    tprogram.clear_cache()
    run_port("histogram", "h5000", (1,), {})
    assert tprogram.cache_stats() == {"hits": 0, "misses": 0,
                                      "kernel_traces": 0}
    assert reference["cases"]["h12-1-onehot/histogram"]["cache"][
        "misses"] == 1
    assert reference["cases"]["h11-1/histogram"]["cache"]["misses"] == 0


def test_histogram_local_reduce_equals_routed_path():
    els, bins = hist_of("h5000", tdata)
    fab = fabric_of((1,))
    y_local, d_local = tapps.dcra_histogram(els, bins, fab)
    y_routed, d_routed = tapps.dcra_histogram(
        els, bins, fab, options=LaunchOptions(route_impl="sort"))
    assert d_local == d_routed == 0
    assert y_local.dtype == y_routed.dtype == np.float32
    assert np.array_equal(y_local, y_routed)
    assert int(y_local.sum()) == len(els)


def test_scatter_checks_its_inputs():
    dest, vals = scatter_inputs()
    with pytest.raises(ValueError, match="multiple"):
        tapps.dcra_scatter(dest[:-1], vals[:-1], SCATTER_N, fabric_of((8,)))
    with pytest.raises(TypeError):
        tapps.dcra_scatter(dest, vals, SCATTER_N, "not a fabric")
    y, d = tapps.dcra_scatter(torch.from_numpy(dest), torch.from_numpy(vals),
                              SCATTER_N, fabric_of((4,)),
                              options=LaunchOptions(round_mode="pipelined"))
    y2, d2 = tapps.dcra_scatter(dest, vals, SCATTER_N, fabric_of((4,)))
    assert torch.equal(y, y2) and int(d) == int(d2)


def test_programs_registry():
    assert set(tapps.PROGRAMS) == {"bfs", "sssp", "wcc", "pagerank", "spmv",
                                   "histogram", "kcore"}
    assert tapps.HISTOGRAM.local_reduce is not None
    assert tapps.SPMV.mode == tapps.HISTOGRAM.mode == "single"
