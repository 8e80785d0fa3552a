"""The port's legacy launch kwargs and its single-device edge-parallel
executables against the JAX package, on the CPU.

Part A — the counterparts of ``tests/test_pipeline.py``'s launch-surface
tests: ``resolve_options(options, **legacy)`` folds the reference's
legacy kwargs into a ``LaunchOptions`` (one ``DeprecationWarning`` a
process, ``options=`` beside an explicit legacy kwarg raises
``ValueError``, an unknown kwarg ``TypeError``), both spellings reach
the same round-function cache entry, and the seven ``dcra_*`` apps,
``run_program``, ``launch_program``, ``prewarm_program``,
``dcra_scatter`` and ``ProgramServer`` (``axis=`` / ``launch_queues=``)
accept them, each result equal to the ``options=`` spelling's and to the
reference's on one device.

Part B — the counterparts of ``tests/test_jax_apps.py``'s three
single-device tests: ``spmv_torch``, ``histogram_torch`` and
``bfs_torch`` against ``spmv_jnp``, ``histogram_jnp`` and ``bfs_jnp`` on
the same inputs (and the numpy oracles).
"""
import warnings

import numpy as np
import pytest
import torch

from repro_torch.core.fabric import Fabric
from repro_torch.core.queues import QueueConfig
from repro_torch.sparse import datasets as tdata
from repro_torch.sparse import options as topts
from repro_torch.sparse import program as tprogram
from repro_torch.sparse import torch_apps
from repro_torch.sparse.options import LaunchOptions, resolve_options


def _tiny(datasets):
    return datasets.wiki_like(96, avg_degree=4, seed=11)


def _fab():
    return Fabric.fake(1, device="cpu")


# ---------------------------------------------------------------------------
# Part A: the legacy launch kwargs
# ---------------------------------------------------------------------------

def test_legacy_kwargs_and_options_share_one_cache_entry():
    """The shim is an alias: the same key, the same callable, the same
    result; the warning fires once a process."""
    g, fab = _tiny(tdata), _fab()
    tprogram.clear_cache()
    topts._WARNED[0] = False
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        d1, s1 = torch_apps.dcra_bfs(g, 0, fab, capacity_factor=2.0)
        d1b, _ = torch_apps.dcra_bfs(g, 0, fab, capacity_factor=2.0)
    legacy = [x for x in w if issubclass(x.category, DeprecationWarning)]
    assert len(legacy) == 1
    assert "options=LaunchOptions" in str(legacy[0].message)
    after_legacy = tprogram.cache_stats()
    d2, s2 = torch_apps.dcra_bfs(g, 0, fab,
                                 options=LaunchOptions(capacity_factor=2.0))
    after_options = tprogram.cache_stats()
    assert after_options["misses"] == after_legacy["misses"] == 1
    assert after_options["hits"] == after_legacy["hits"] + 1
    assert np.array_equal(d1, d2) and np.array_equal(d1, d1b)
    assert s1.rounds == s2.rounds and s1.total_drops == s2.total_drops


def test_resolve_options_checks_as_the_reference():
    from repro.sparse import options as jopts
    for mod in (topts, jopts):
        mod._WARNED[0] = True            # the warning is the test above's
        opts = mod.resolve_options(None, capacity_factor=2.0, seed=3,
                                   route_impl="sort", round_mode="pipelined")
        assert (opts.capacity_factor, opts.seed, opts.route_impl,
                opts.round_mode) == (2.0, 3, "sort", "pipelined")
        # an explicit default is no legacy kwarg
        base = mod.LaunchOptions(cap=4)
        assert mod.resolve_options(base, axis="data", seed=0) is base
        with pytest.raises(ValueError, match="conflicts with explicit legacy"):
            mod.resolve_options(base, seed=1)
        with pytest.raises(ValueError, match="conflicts"):
            mod.resolve_options(None, cap=4, capacity_factor=2.0)
        with pytest.raises(TypeError, match="unknown launch kwargs"):
            mod.resolve_options(None, caps=4)
        with pytest.raises(TypeError, match="options= expects"):
            mod.resolve_options({"cap": 4})
    assert resolve_options(None, axis="data") == LaunchOptions()


def test_option_conflicts_raise_before_the_launch():
    g = _tiny(tdata)
    with pytest.raises(ValueError, match="conflicts"):
        torch_apps.dcra_bfs(g, 0, None, cap=4, capacity_factor=2.0)
    with pytest.raises(ValueError, match="conflicts"):
        torch_apps.dcra_spmv(g, np.ones(g.n), None, cap=4, config="auto")
    with pytest.raises(ValueError, match="conflicts"):
        torch_apps.dcra_bfs(g, 0, None, options=LaunchOptions(), cap=4)
    with pytest.raises(ValueError, match="round_mode"):
        torch_apps.dcra_bfs(g, 0, None, round_mode="warp")


def _calls(apps, datasets, g, x, els, fab):
    return {
        "bfs": lambda **kw: apps.dcra_bfs(g, 0, fab, **kw),
        "sssp": lambda **kw: apps.dcra_sssp(g, 0, fab, **kw),
        "wcc": lambda **kw: apps.dcra_wcc(g, fab, **kw),
        "pagerank": lambda **kw: apps.dcra_pagerank(g, fab, iters=3, **kw),
        "kcore": lambda **kw: apps.dcra_kcore(g, 3, fab, **kw),
        "spmv": lambda **kw: apps.dcra_spmv(g, x, fab, **kw),
        "histogram": lambda **kw: apps.dcra_histogram(els, 16, fab, **kw),
    }


def test_every_entrypoint_accepts_options():
    """All seven ``dcra_*`` apps, ``run_program``, ``launch_program``,
    ``prewarm_program`` and ``dcra_scatter`` take the legacy spelling,
    equal to ``options=`` bit for bit and to the reference's legacy
    spelling on one device (min and whole-number results exactly,
    PageRank and SpMV within float32 sums in another order)."""
    from repro.core.compat import make_mesh
    from repro.sparse import datasets as jdata
    from repro.sparse import jax_apps
    topts._WARNED[0] = True
    g, fab = _tiny(tdata), _fab()
    x = np.random.default_rng(0).random(g.n)
    els = tdata.histogram_data(512, 16, seed=4)
    opts = LaunchOptions(capacity_factor=2.0)
    port = _calls(torch_apps, tdata, g, x, els, fab)
    ref = _calls(jax_apps, jdata, _tiny(jdata), x,
                 jdata.histogram_data(512, 16, seed=4),
                 make_mesh((1,), ("data",)))
    assert set(port) == set(torch_apps.PROGRAMS)
    for app, call in port.items():
        got, _ = call(options=opts)
        legacy, _ = call(capacity_factor=2.0)
        assert np.array_equal(np.asarray(got), np.asarray(legacy)), app
        want = np.asarray(ref[app](capacity_factor=2.0)[0], np.float64)
        got = np.asarray(got, np.float64)
        if app in ("pagerank", "spmv"):
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), app
        else:
            assert np.array_equal(got, want), app
    bfs = torch_apps.PROGRAMS["bfs"]
    r1, _ = tprogram.run_program(bfs, g, fab, options=opts,
                                 params={"root": 0})
    r2, _ = tprogram.run_program(bfs, g, fab, capacity_factor=2.0,
                                 params={"root": 0})
    r3, _ = tprogram.launch_program(bfs, g, fab, capacity_factor=2.0,
                                    params={"root": 0}).result()
    assert np.array_equal(r1, r2) and np.array_equal(r1, r3)
    tprogram.clear_cache()
    keys = tprogram.prewarm_program(bfs, g, fab, capacity_factor=2.0,
                                    params={"root": 0})
    assert len(keys) == 1
    assert tprogram.prewarm_program(bfs, g, fab, options=opts,
                                    params={"root": 5}) == ()
    dest = np.arange(32) % 8
    vals = np.ones(32, np.float32)
    y1, _ = tprogram.dcra_scatter(dest, vals, 8, fab, options=opts)
    y2, _ = tprogram.dcra_scatter(dest, vals, 8, fab, capacity_factor=2.0)
    assert torch.equal(y1, y2)


def test_server_takes_axis_and_launch_queues():
    """``ProgramServer``'s legacy ``axis=`` / ``launch_queues=`` build the
    options ``options=`` would, and beside ``options=`` raise, as the
    reference's server does."""
    from repro.core.compat import make_mesh
    from repro.core.queues import QueueConfig as JQueues
    from repro.serve import ProgramServer as JServer
    from repro.sparse.options import LaunchOptions as JOptions
    from repro_torch.serve import ProgramServer
    g = _tiny(tdata)
    q = QueueConfig.from_factor(2.0, "T3")
    srv = ProgramServer(_fab(), {"g": g}, launch_queues=q)
    assert srv.options == LaunchOptions(queues=q)
    assert srv.launch_queues is q and srv.axis == "data"
    assert ProgramServer(_fab(), {"g": g}).options == LaunchOptions()
    msgs = []
    for Server, fab, Opts, Q in (
            (ProgramServer, _fab(), LaunchOptions, QueueConfig),
            (JServer, make_mesh((1,), ("data",)), JOptions, JQueues)):
        for kw in ({"axis": "tp"}, {"launch_queues":
                                    Q.from_factor(2.0, "T3")}):
            with pytest.raises(ValueError) as e:
                Server(fab, {}, options=Opts(), **kw)
            msgs.append(str(e.value))
    assert msgs[:2] == msgs[2:]


# ---------------------------------------------------------------------------
# Part B: the single-device edge-parallel executables
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def graphs():
    from repro.sparse import datasets as jdata
    return tdata.rmat(9, edge_factor=8, seed=3), jdata.rmat(9, edge_factor=8,
                                                             seed=3)


def test_spmv_torch(graphs):
    import jax.numpy as jnp
    from repro.sparse.jax_apps import spmv_jnp
    from repro.sparse import ref
    g, jg = graphs
    x = np.random.default_rng(0).random(g.n)
    y = torch_apps.spmv_torch(torch.from_numpy(g.row_of()),
                              torch.from_numpy(g.col_idx),
                              torch.from_numpy(g.values),
                              torch.from_numpy(x.astype(np.float32)), g.n)
    want = np.asarray(spmv_jnp(jnp.asarray(jg.row_of()),
                               jnp.asarray(jg.col_idx),
                               jnp.asarray(jg.values), jnp.asarray(x), jg.n))
    assert y.dtype == torch.float32 and y.shape == want.shape
    assert np.abs(y.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    assert np.allclose(y.numpy(), ref.spmv_ref(jg, x), rtol=1e-5, atol=1e-3)


def test_bfs_torch(graphs):
    import jax.numpy as jnp
    from repro.sparse.jax_apps import bfs_jnp
    from repro.sparse import ref
    g, jg = graphs
    d = torch_apps.bfs_torch(torch.from_numpy(g.row_of()),
                             torch.from_numpy(g.col_idx), g.n, 0,
                             max_levels=64)
    want = np.asarray(bfs_jnp(jnp.asarray(jg.row_of()),
                              jnp.asarray(jg.col_idx), jg.n, 0,
                              max_levels=64))
    assert d.dtype == torch.float32
    assert np.array_equal(d.numpy(), want)
    got = np.where(np.isinf(d.numpy()), -1, d.numpy())
    assert np.array_equal(got, ref.bfs_ref(jg, 0).astype(float))


def test_histogram_torch():
    import jax.numpy as jnp
    from repro.sparse import datasets as jdata
    from repro.sparse import ref
    from repro.sparse.jax_apps import histogram_jnp
    els = tdata.histogram_data(1 << 12, 128)
    h = torch_apps.histogram_torch(torch.from_numpy(els), 128)
    want = np.asarray(histogram_jnp(jnp.asarray(
        jdata.histogram_data(1 << 12, 128)), 128))
    # the counts keep the ids' integer type (int64 here; the reference's
    # int32 is jax's, which holds no 64-bit integers by default)
    assert h.dtype == torch.int64 and want.dtype == np.int32
    assert np.array_equal(h.numpy(), want)
    assert np.array_equal(h.numpy(), ref.histogram_ref(els, 128))
    # ids outside the bins are dropped, as segment_sum drops them
    odd = np.array([-1, 0, 3, 3, 4, 7], np.int32)
    assert np.array_equal(
        torch_apps.histogram_torch(torch.from_numpy(odd), 4).numpy(),
        np.asarray(histogram_jnp(jnp.asarray(odd), 4)))
