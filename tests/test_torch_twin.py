"""The port's analytic twin, ``config="auto"`` and the shardcheck
revalidation against the JAX package, on the CPU.

* The twin (``program_rounds`` / ``program_app_stats``) runs the port's
  own program rules on CPU tensors ``[S, n_local]``; its per-round
  message and drop counts must equal the reference's twin on
  ``tests/test_program.py``'s cases (flat 1/2/4/8 shards, caps 2 and 96;
  pod/portal 2 x 4 at factors 0.25 and 4), and the port's executable
  ``AppStats`` round by round for all seven programs: exact.
* ``run_program(..., options=LaunchOptions(config="auto"))`` resolves
  the same ``LaunchConfig`` (point id, source) as the reference's
  ``run_program(..., config="auto")`` under ``shard_map`` on 8 fake
  devices (one subprocess), flat and 2 x 4 pods, and gives the same
  ``AppStats`` (exact) and states: BFS and the histogram bit-identical,
  PageRank within its float32 bound (``_pagerank_tol``).
* ``shardcheck``'s entries on 8 CPU shards equal the reference's, heavy
  self-traffic included: exact.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.sparse import datasets as jdata
from repro.sparse import program as jprogram
from repro.sparse.jax_apps import PROGRAMS as JPROGRAMS
from repro_torch.core.fabric import Fabric
from repro_torch.dse.shardcheck import check_point
from repro_torch.sparse import datasets as tdata
from repro_torch.sparse import program as tprogram
from repro_torch.sparse.options import LaunchOptions
from repro_torch.sparse.torch_apps import PROGRAMS as TPROGRAMS

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
EPS = float(np.finfo(np.float32).eps)            # 2^-23

APPS = tuple(TPROGRAMS)
PARAMS = {"bfs": {"root": 0}, "sssp": {"root": 0}, "wcc": {},
          "pagerank": {"damping": 0.85, "iters": 4}, "kcore": {"k": 8.0},
          "spmv": {}, "histogram": {}}


def twin_data(datasets, app):
    """``tests/test_program.py``'s inputs: the wiki-like graph, SpMV's x,
    the histogram's stream."""
    g = datasets.wiki_like(256, avg_degree=8, seed=7)
    if app == "spmv":
        return g, np.random.default_rng(0).random(g.n)
    if app == "histogram":
        return datasets.histogram_data(1 << 11, 64, seed=4), 64
    return g


def _stats_equal(got, want):
    return (got.rounds == want.rounds
            and np.array_equal(got.messages, want.messages)
            and np.array_equal(got.drops, want.drops))


# ---------------------------------------------------------------------------
# the twin against the reference's twin (both numpy-side, this process)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
@pytest.mark.parametrize("app", APPS)
def test_twin_matches_reference_twin_flat(app, n_dev):
    """Flat caps 2 (drops) and, on 1 and 8 shards, 96: exact."""
    for cap in ((2, 96) if n_dev in (1, 8) else (2,)):
        got = tprogram.program_app_stats(
            TPROGRAMS[app], twin_data(tdata, app), n_dev, cap=cap,
            params=PARAMS[app])
        want = jprogram.program_app_stats(
            JPROGRAMS[app], twin_data(jdata, app), n_dev, cap=cap,
            params=PARAMS[app])
        assert _stats_equal(got, want), (cap, got, want)
        if cap == 2:
            assert got.total_drops > 0


@pytest.mark.parametrize("app", APPS)
def test_twin_matches_reference_twin_pods(app):
    """Pod/portal 2 x 4 (``pods=(4, 2)``) at factors 0.25 and 4: exact."""
    for cf in (0.25, 4.0):
        got = tprogram.program_app_stats(
            TPROGRAMS[app], twin_data(tdata, app), 8, capacity_factor=cf,
            params=PARAMS[app], pods=(4, 2))
        want = jprogram.program_app_stats(
            JPROGRAMS[app], twin_data(jdata, app), 8, capacity_factor=cf,
            params=PARAMS[app], pods=(4, 2))
        assert _stats_equal(got, want), (cf, got, want)


@pytest.mark.parametrize("pods", [None, (4, 2)])
@pytest.mark.parametrize("app", ["bfs", "wcc", "kcore"])
def test_program_rounds_stream_matches_reference(app, pods):
    """The routed stream a round (sources, destinations, the keep rule's
    drop count): equal, element by element."""
    g, h = twin_data(tdata, app), twin_data(jdata, app)
    caps = (2,) if pods is None else (5, 9)
    got = list(tprogram.program_rounds(TPROGRAMS[app], g, 8, caps,
                                       params=PARAMS[app], pods=pods))
    want = list(jprogram.program_rounds(JPROGRAMS[app], h, 8, caps,
                                        params=PARAMS[app], pods=pods))
    assert len(got) == len(want) > 1
    for (s1, d1, n1), (s2, d2, n2) in zip(got, want):
        assert np.array_equal(s1, s2) and np.array_equal(d1, d2) and n1 == n2


# ---------------------------------------------------------------------------
# the twin against the port's executable
# ---------------------------------------------------------------------------

LAYOUTS = {"flat8-cap2": ((8,), dict(cap=2)),
           "flat1-cap96": ((1,), dict(cap=96)),
           "flat4-cf0.5": ((4,), dict(capacity_factor=0.5)),
           "pod2x4-cf0.25": ((2, 4), dict(capacity_factor=0.25))}


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("app", APPS)
def test_twin_matches_port_executable(app, layout):
    """``program_app_stats`` equals the executable's ``AppStats`` round by
    round (virtual CPU shards): exact."""
    shape, kw = LAYOUTS[layout]
    pods = None
    if len(shape) == 2:
        fab = Fabric.virtual(shape, ("pod", "data"), device="cpu")
        opts, pods = LaunchOptions(pod_axis="pod", **kw), (shape[1], shape[0])
    else:
        fab, opts = Fabric.fake(shape[0], device="cpu"), LaunchOptions(**kw)
    data = twin_data(tdata, app)
    _, stats = tprogram.run_program(TPROGRAMS[app], data, fab, options=opts,
                                    params=PARAMS[app])
    twin = tprogram.program_app_stats(TPROGRAMS[app], data, fab.n_devices,
                                      params=PARAMS[app], pods=pods, **kw)
    assert _stats_equal(twin, stats), (twin, stats)


def test_fabric_analytic_hooks():
    """``tile_grid`` is one tile a shard; ``device_coords`` gives each
    virtual shard's index and coordinates where the reference gives a
    device id (a deliberate difference: the shards have no device)."""
    fab = Fabric.virtual((2, 4), ("pod", "data"), device="cpu")
    grid = fab.tile_grid()
    assert (grid.rows, grid.cols, grid.n_tiles) == (1, 8, 8)
    assert fab.device_coords() == tuple(
        (g, (g // 4, g % 4)) for g in range(8))
    assert Fabric.fake(3, device="cpu").device_coords() == \
        ((0, (0,)), (1, (1,)), (2, (2,)))


# ---------------------------------------------------------------------------
# config="auto" and shardcheck against the reference (8 fake devices)
# ---------------------------------------------------------------------------

# name -> (app, data, fabric shape)
AUTO_CASES = {}
for _shape in ((8,), (2, 4)):
    _tag = "x".join(map(str, _shape))
    for _app in ("bfs", "pagerank"):
        for _g in ("wl", "r8"):
            AUTO_CASES[f"{_g}{_tag}/{_app}"] = (_app, _g, _shape)
    for _h in ("h11", "h12"):
        AUTO_CASES[f"{_h}-{_tag}/histogram"] = ("histogram", _h, _shape)

SHARDCHECK = {"n_dev": 8, "scale": 8, "seed": 0,
              "checks": [{"point_id": f"iq{iq}", "iq_capacity": iq,
                          "apps": ["spmv", "histogram", "histogram_self",
                                   "bfs", "sssp", "wcc", "pagerank",
                                   "kcore"]}
                         for iq in (8, 64)]}


def auto_data(datasets, app, name):
    """``(data, dataset, params)`` of a ``config="auto"`` case: the
    wiki-like test graph or the quick bench's RMAT-8, the histogram's
    streams over 64 bins."""
    if app == "histogram":
        n = {"h11": 1 << 11, "h12": 1 << 12}[name]
        els = datasets.histogram_data(n, 64, seed=4)
        return (els, 64), els, {}
    g = (datasets.wiki_like(256, avg_degree=8, seed=7) if name == "wl"
         else datasets.rmat(8, edge_factor=16, seed=1))
    return g, g, ({"root": 0} if app == "bfs"
                  else {"damping": 0.85, "iters": 5})


SCRIPT = r"""
import os
os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=8'
import json, sys
import numpy as np
from repro.core.compat import make_mesh
from repro.dse.autoconfig import autoconfigure
from repro.dse.shardcheck import check_point
from repro.sparse import datasets
from repro.sparse.jax_apps import PROGRAMS
from repro.sparse.program import run_program
sys.path.insert(0, os.environ['TESTS_DIR'])
from test_torch_twin import AUTO_CASES, SHARDCHECK, auto_data

res = {'auto': {}, 'shardcheck': []}
for name, (app, gname, shape) in AUTO_CASES.items():
    mesh = make_mesh(shape, ('data',) if len(shape) == 1 else ('pod', 'data'))
    data, dataset, params = auto_data(datasets, app, gname)
    lc = autoconfigure(dataset, app)
    out, st = run_program(PROGRAMS[app], data, mesh, params=params,
                          config='auto', dataset=dataset)
    state = out[0] if isinstance(out, tuple) else out
    res['auto'][name] = {
        'point_id': lc.point.point_id, 'source': lc.source,
        'state': np.asarray(state, np.float64).tolist(),
        'rounds': st.rounds, 'messages': st.messages.tolist(),
        'drops': st.drops.tolist()}
for check in SHARDCHECK['checks']:
    res['shardcheck'] += check_point(check, SHARDCHECK['n_dev'],
                                     SHARDCHECK['scale'], SHARDCHECK['seed'])
print('RESULT ' + json.dumps(res))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=SRC,
               TESTS_DIR=os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", SCRIPT], env=env,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("RESULT ")][0]
    return json.loads(line[len("RESULT "):])


def _pagerank_tol(want, iters):
    """Each round's add-reduce within 2 ulp of a slot's sum of
    contributions (at most rank / damping), the update's 4 roundings,
    summed over the rounds (``tests/test_torch_stream.py``'s bound)."""
    return iters * (2 / 0.85 + 4) * EPS * np.max(np.abs(want))


@pytest.mark.parametrize("case", list(AUTO_CASES))
def test_config_auto_matches_reference(reference, case):
    """The same resolved point and source, ``AppStats`` equal, states
    bit-identical (PageRank within ``_pagerank_tol``)."""
    app, gname, shape = AUTO_CASES[case]
    want = reference["auto"][case]
    fab = (Fabric.fake(shape[0], device="cpu") if len(shape) == 1 else
           Fabric.virtual(shape, ("pod", "data"), device="cpu"))
    data, dataset, params = auto_data(tdata, app, gname)
    lc = tprogram.resolve_launch("auto", dataset, app)
    assert (lc.point.point_id, lc.source) == (want["point_id"],
                                              want["source"])
    out, st = tprogram.run_program(TPROGRAMS[app], data, fab, params=params,
                                   options=LaunchOptions(config="auto"),
                                   dataset=dataset)
    assert st.rounds == want["rounds"]
    assert st.messages.tolist() == want["messages"]
    assert st.drops.tolist() == want["drops"]
    got = np.asarray(out[0] if isinstance(out, tuple) else out, np.float64)
    ref = np.asarray(want["state"], np.float64)
    if app == "pagerank":
        assert np.max(np.abs(got - ref)) <= _pagerank_tol(ref,
                                                          params["iters"])
    else:
        assert np.array_equal(got, ref)


def test_config_auto_cases_cover_both_sources_and_routes(reference):
    """The cases reach a frontier pick and a mini-sweep pick, and on the
    pod fabric the hier_torus points route through the portal."""
    sources = {r["source"] for r in reference["auto"].values()}
    assert sources == {"frontier", "mini-sweep"}
    pod = Fabric.virtual((2, 4), ("pod", "data"), device="cpu")
    axes = {tprogram.resolve_launch("auto", auto_data(tdata, a, g)[1],
                                    a).pod_axis_for(pod)
            for a, g, s in AUTO_CASES.values() if len(s) == 2}
    assert "pod" in axes


@pytest.mark.parametrize("iq", [8, 64])
def test_shardcheck_matches_reference(reference, iq):
    """``check_point`` on 8 CPU shards: every entry (executable and
    analytic messages, drops, rounds, ok) equal to the reference's, the
    heavy self-traffic histogram included; all agree."""
    check = [c for c in SHARDCHECK["checks"] if c["iq_capacity"] == iq][0]
    got = check_point(check, SHARDCHECK["n_dev"], SHARDCHECK["scale"],
                      SHARDCHECK["seed"], device="cpu")
    want = [r for r in reference["shardcheck"] if r["cap"] == iq]
    assert got == want
    assert all(r["ok"] for r in got)
    if iq == 8:
        assert all(r["executable"]["drops"] > 0 for r in got
                   if r["app"].startswith("histogram"))


def test_shardcheck_cli_reads_a_spec_on_stdin(reference):
    """``python -m repro_torch.dse.shardcheck`` with ``"device": "cpu"``:
    exit code 0 and one ``RESULT`` line, the reference's entries."""
    spec = dict(SHARDCHECK, device="cpu",
                checks=[dict(SHARDCHECK["checks"][1],
                             apps=["spmv", "histogram_self", "bfs"])])
    out = subprocess.run([sys.executable, "-m", "repro_torch.dse.shardcheck"],
                         input=json.dumps(spec), capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=SRC))
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT ")]
    got = json.loads(lines[-1][len("RESULT "):])
    want = [r for r in reference["shardcheck"]
            if r["cap"] == 64 and r["app"] in ("spmv", "histogram_self",
                                               "bfs")]
    assert got == want


def test_twin_runs_on_cpu_tensors_without_a_card(monkeypatch):
    """The twin never touches a device: it runs with CUDA unavailable."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    st = tprogram.program_app_stats(TPROGRAMS["kcore"], twin_data(tdata,
                                                                  "kcore"),
                                    4, cap=2, params=PARAMS["kcore"])
    assert st.rounds > 0
