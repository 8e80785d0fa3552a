"""The PyTorch port's host side against the JAX package, on the CPU.

Queue sizing and capacities, the seeded graph generators, CSR, the edge
packer, the owner layout, the numpy oracles, the launch options and the
virtual-shard fabric: all compared exactly with the reference. Plus the
port's isolation (no jax, nothing of ``repro``) and its device rule (no
card and no device named -> an entry point raises).
"""
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro.core import queues as jq
from repro.core import routing as jrouting
from repro.sparse import csr as jcsr
from repro.sparse import datasets as jdata
from repro.sparse import options as joptions
from repro.sparse import program as jprogram
from repro.sparse import ref as jref
from repro_torch.core import queues as tq
from repro_torch.core import routing as trouting
from repro_torch.core.fabric import Fabric
from repro_torch.sparse import csr as tcsr
from repro_torch.sparse import datasets as tdata
from repro_torch.sparse import options as toptions
from repro_torch.sparse import program as tprogram
from repro_torch.sparse import ref as tref

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


# ---------------------------------------------------------------------------
# isolation and device
# ---------------------------------------------------------------------------

ISOLATION = r"""
import pkgutil, sys, importlib
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):
    importlib.import_module(m.name)
bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')
       or k == 'repro' or k.startswith('repro.')]
print('LOADED', len([k for k in sys.modules if k.startswith('repro_torch')]))
assert not bad, bad
assert 'triton' not in sys.modules
for name in ('serve', 'serve.batching', 'serve.engine', 'serve.options',
             'serve.resilience', 'serve.stats', 'runtime',
             'runtime.fault_tolerance', 'sparse.program', 'core.routing',
             'core.task_engine', 'core.topology', 'core.cache', 'costmodel',
             'costmodel.energy', 'costmodel.params', 'costmodel.perf',
             'costmodel.silicon', 'sparse.apps', 'dse', 'dse.autoconfig',
             'dse.compare', 'dse.driver', 'dse.evaluate', 'dse.pareto',
             'dse.shardcheck', 'dse.space', 'dse.sweep', 'dse.route_compare',
             'dse.serve_compare', 'launch.mesh',
             'launch.sharding', 'launch.analytic', 'launch.roofline',
             'launch.report', 'launch.dryrun', 'launch.hillclimb',
             'figures', 'figures.common', 'figures.fig4_topology',
             'figures.fig5_sram', 'figures.fig6_pus', 'figures.fig7_freq',
             'figures.fig8_hbm', 'figures.fig10_queues',
             'figures.fig11_scaling', 'figures.moe_dispatch',
             'figures.noc_routing', 'figures.roofline_table',
             'figures.route_bench', 'figures.run', 'figures.serve_bench'):
    assert 'repro_torch.' + name in sys.modules, name
"""


def test_port_imports_neither_jax_nor_the_reference():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", ISOLATION], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[-1]) >= 36      # every module imported


def test_chip_smoke_imports_neither_jax_nor_the_reference():
    """Every import in ``chip_smoke.py``, those inside functions too, is of
    the standard library, numpy, torch or the port."""
    import ast
    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    tree = ast.parse(open(path).read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    roots = {n.split(".")[0] for n in names}
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}, roots


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """No card (this CPU host), or the script alone without the
    repository: exit code 2 and no result line."""
    src = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(src).read())
    for script in (src, str(alone)):
        out = subprocess.run([sys.executable, script], capture_output=True,
                             text=True, timeout=120, cwd=tmp_path,
                             env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        assert out.returncode == 2, out.stderr[-2000:]
        assert '"ok"' not in out.stdout


def test_build_target_follows_the_source_and_every_header(tmp_path,
                                                         monkeypatch):
    """A library is named by the hash of its source and of every shared
    header in ``csrc/``: an edit to either names a new library, so a
    stale one is never loaded; an edit elsewhere does not."""
    from repro_torch.kernels import _build
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    (csrc / "gmm.cu").write_text('#include "sm90.cuh"\n')
    (csrc / "sm90.cuh").write_text("// helpers\n")
    (csrc / "notes.txt").write_text("a\n")
    first = _build._target("gmm")
    assert first.parent == tmp_path / "build"
    assert first.name.startswith("libgmm_") and first.suffix == ".so"
    assert _build._target("gmm") == first             # stable
    (csrc / "notes.txt").write_text("b\n")
    assert _build._target("gmm") == first
    (csrc / "sm90.cuh").write_text("// helpers, edited\n")
    second = _build._target("gmm")
    assert second != first
    (csrc / "extra.cuh").write_text("// a new header\n")
    third = _build._target("gmm")
    assert third not in (first, second)
    (csrc / "gmm.cu").write_text('#include "sm90.cuh"\n// edited\n')
    assert _build._target("gmm") not in (first, second, third)


def test_build_keeps_ptxas_verbose_output():
    from repro_torch.kernels import _build
    flags = " ".join(_build.NVCC_FLAGS)
    assert "-Xptxas -v" in flags and "arch=compute_90a,code=sm_90a" in flags


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z10blocked_kv' for 'sm_90a'
ptxas info    : Function properties for _Z10blocked_kv
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 40960 bytes smem
ptxas info    : Compiling entry function '_Z8wgmma_kv' for 'sm_90a'
ptxas info    : Function properties for _Z8wgmma_kv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
"""


def test_chip_smoke_reads_ptxas_output():
    """``chip_smoke.ptxas_report`` takes registers, spills and static
    shared memory of every kernel from nvcc's ``-Xptxas -v`` output."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    rows = chip_smoke.ptxas_report(PTXAS_LOG)
    assert [r[1:] for r in rows] == [(128, 4, 12, 40960), (168, 0, 0, 0)]
    assert len(rows) == 2 and all(r[0] for r in rows)


def test_entry_point_raises_without_cuda(monkeypatch):
    from repro_torch.sparse.torch_apps import dcra_bfs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dcra_bfs(tdata.erdos_renyi(16, 3), 0, Fabric.fake(2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Fabric.virtual((2, 2), ("pod", "data"))
    assert Fabric.fake(2, device="cpu").device == torch.device("cpu")


# ---------------------------------------------------------------------------
# queues and capacities
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("x", [0, 1, 7, 8, 9, 63, 64, 65, 1000])
def test_round8_matches_reference(x):
    assert tq.round8(x) == jq.round8(x)


QUEUES = [lambda m: m.QueueConfig(),
          lambda m: m.QueueConfig.unbounded(),
          lambda m: m.QueueConfig.from_factor(4.0),
          lambda m: m.QueueConfig.from_factor(0.25, "T1"),
          lambda m: m.QueueConfig.from_cap(5),
          lambda m: m.QueueConfig(iq_sizes={"T3": 0}, iq_factors={"T3": 2.0})]


@pytest.mark.parametrize("qi", range(len(QUEUES)))
def test_channel_caps_match_reference(qi):
    jqc, tqc = QUEUES[qi](jq), QUEUES[qi](tq)
    for task in ("T1", "T3"):
        for tasks, chans in ((0, 1), (100, 8), (517, 7), (4096, 64)):
            assert tqc.channel_cap(task, tasks, chans) == \
                jqc.channel_cap(task, tasks, chans)
            assert tqc.channel_cap(task, tasks, chans, lane_align=False) == \
                jqc.channel_cap(task, tasks, chans, lane_align=False)
            assert tqc.round_budget(task, tasks, chans) == \
                jqc.round_budget(task, tasks, chans)
            for clamp in (False, True):
                assert trouting.resolve_flat_cap(
                    tqc, task, tasks, chans, clamp=clamp) == \
                    jrouting.resolve_flat_cap(jqc, task, tasks, chans,
                                              clamp=clamp)
            assert trouting.resolve_hier_caps(tqc, task, tasks, 4, 2) == \
                jrouting.resolve_hier_caps(jqc, task, tasks, 4, 2)


@pytest.mark.parametrize("shape,names,pod", [
    ((8,), ("data",), None), ((2, 4), ("pod", "data"), "pod"),
    ((2, 2), ("pod", "data"), "pod"), ((1, 4), ("pod", "data"), "pod")])
def test_resolve_caps_matches_reference(shape, names, pod):
    fab = Fabric.virtual(shape, names, device="cpu")
    duck = types.SimpleNamespace(axis_sizes=dict(zip(names, shape)),
                                 n_devices=int(np.prod(shape)))
    for q in (jq.QueueConfig.from_factor(4.0), jq.QueueConfig.from_factor(
            0.25), jq.QueueConfig.from_cap(3)):
        tq_ = tq.QueueConfig(iq_sizes=dict(q.iq_sizes), default_iq=None,
                             iq_factors=dict(q.iq_factors))
        for e in (8, 77, 640):
            for clamp in (False, True):
                try:
                    want = jrouting.resolve_caps(duck, q, "T3", e, "data",
                                                 pod, clamp=clamp)
                except ValueError:
                    with pytest.raises(ValueError):
                        trouting.resolve_caps(fab, tq_, "T3", e, "data", pod,
                                              clamp=clamp)
                    continue
                assert trouting.resolve_caps(fab, tq_, "T3", e, "data", pod,
                                             clamp=clamp) == want


def test_fabric_introspection():
    flat = Fabric.fake(8, device="cpu")
    pod = Fabric.virtual((2, 4), ("pod", "data"), device="cpu")
    one_pod = Fabric.virtual((1, 4), ("pod", "data"), device="cpu")
    assert flat.n_devices == 8 and flat.pod_axis is None
    assert pod.axis_sizes == {"pod": 2, "data": 4} and pod.pod_axis == "pod"
    assert one_pod.portal_axis == "pod" and one_pod.pod_axis is None
    keys = {f.fabric_key() for f in (flat, pod, one_pod,
                                     Fabric.fake(4, device="cpu"))}
    assert len(keys) == 4
    assert flat.fabric_key() == Fabric.fake(8, device="cpu").fabric_key()
    with pytest.raises(ValueError):
        Fabric.virtual((2, 4), ("data",), device="cpu")


# ---------------------------------------------------------------------------
# datasets and CSR
# ---------------------------------------------------------------------------

def _same_csr(a, b):
    return (np.array_equal(a.row_ptr, b.row_ptr)
            and np.array_equal(a.col_idx, b.col_idx)
            and np.array_equal(a.values, b.values)
            and a.row_ptr.dtype == b.row_ptr.dtype
            and a.col_idx.dtype == b.col_idx.dtype
            and a.values.dtype == b.values.dtype)


GENERATORS = [
    ("rmat", dict(scale=8, seed=1)), ("rmat", dict(scale=10, seed=3)),
    ("rmat", dict(scale=9, edge_factor=4, seed=5, undirected=False)),
    ("erdos_renyi", dict(n=256, avg_degree=8, seed=5)),
    ("erdos_renyi", dict(n=300, avg_degree=5, seed=2, undirected=False)),
    ("wiki_like", dict(n_vertices=512, avg_degree=8, seed=7)),
    ("disconnected_pair", dict(n_each=128, avg_degree=6, seed=11))]


@pytest.mark.parametrize("name,kw", GENERATORS)
def test_generators_byte_identical(name, kw):
    assert _same_csr(getattr(tdata, name)(**kw), getattr(jdata, name)(**kw))


@pytest.mark.parametrize("chunk", [7, 1000, 1 << 20])
def test_rmat_pairs_chunked_byte_identical(chunk):
    """Chunked, threaded pairs equal the reference's block-by-block draws,
    and leave the generator where the reference leaves it."""
    scale, E = 9, 5003
    t_rng, j_rng = np.random.default_rng(4), np.random.default_rng(4)
    got = tdata._rmat_pairs(scale, E, t_rng, chunk=chunk)
    want = jdata._rmat_pairs(scale, E, j_rng)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(t_rng.random(4), j_rng.random(4))


def test_csr_from_arrays_and_methods():
    jg = jdata.wiki_like(300, avg_degree=6, seed=2)
    tg = tcsr.CSR.from_arrays(jg.row_ptr, jg.col_idx, jg.values)
    assert _same_csr(tg, jg) and tg.n == jg.n and tg.nnz == jg.nnz
    assert np.array_equal(tg.row_of(), jg.row_of())
    assert np.array_equal(tg.degrees(), jg.degrees())
    assert _same_csr(tg.transpose(), jg.transpose())
    rng = np.random.default_rng(4)
    src, dst = rng.integers(0, 50, 400), rng.integers(0, 50, 400)
    assert _same_csr(tcsr.from_edges(50, src, dst), jcsr.from_edges(50, src,
                                                                    dst))
    with pytest.raises(ValueError):
        tcsr.CSR.from_arrays([0, 2], [1], [1.0])


# ---------------------------------------------------------------------------
# packing and layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_dev", [1, 3, 8, 64])
@pytest.mark.parametrize("seed", [0, 7])
def test_pack_edges_byte_identical(n_dev, seed):
    rng = np.random.default_rng(seed + 100)
    E, n = 700, 96
    rows, cols = rng.integers(0, n, E), rng.integers(0, n, E)
    wts = rng.random(E).astype(np.float32)
    got = tprogram._pack_edges(rows, cols, wts, n_dev, seed)
    want = jprogram._pack_edges(rows, cols, wts, n_dev, seed)
    assert got[3] == want[3]
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("undirected", [False, True])
def test_graph_setup_matches_reference(undirected):
    jg = jdata.erdos_renyi(200, 6, seed=3, undirected=False)
    tg = tcsr.CSR.from_arrays(jg.row_ptr, jg.col_idx, jg.values)
    got = tprogram._graph_setup(tg, 8, undirected=undirected, seed=2)
    want = jprogram._graph_setup(jg, 8, undirected=undirected, seed=2)
    assert got[0] == want[0] and got[4] == want[4]
    for a, b in zip(got[1:4], want[1:4]):
        assert np.array_equal(a, b)


def test_pack_edges_empty():
    e = np.array([], np.int64)
    src_slot, dst, w, E_max = tprogram._pack_edges(e, e, e.astype(
        np.float32), 4)
    assert E_max == 8 and (dst == -1).all() and len(src_slot) == 32


@pytest.mark.parametrize("n,n_dev", [(17, 4), (32, 8), (5, 8), (64, 1)])
def test_owner_layout_matches_reference(n, n_dev):
    arr = np.random.default_rng(n).random(n).astype(np.float32)
    packed, valid = tprogram.owner_layout(arr, n_dev)
    jpacked, jvalid = jprogram.owner_layout(arr, n_dev)
    assert np.array_equal(packed, np.asarray(jpacked))
    assert np.array_equal(valid, np.asarray(jvalid))
    back = tprogram.from_owner_layout(packed, n, n_dev)
    assert np.array_equal(back, arr)
    assert np.array_equal(back, np.asarray(jprogram.from_owner_layout(
        jpacked, n, n_dev)))
    for fill in (0.0, np.inf):
        got = tprogram.owner_layout(arr, n_dev, fill)
        want = jprogram._owner_pack_np(arr, n_dev, fill)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1],
                                                                  want[1])


# ---------------------------------------------------------------------------
# oracles
# ---------------------------------------------------------------------------

ORACLE_GRAPHS = [("erdos_renyi", dict(n=256, avg_degree=8, seed=5)),
                 ("wiki_like", dict(n_vertices=512, avg_degree=8, seed=7)),
                 ("disconnected_pair", dict(n_each=128, avg_degree=6,
                                            seed=11)),
                 ("rmat", dict(scale=9, seed=1))]


@pytest.mark.parametrize("name,kw", ORACLE_GRAPHS)
def test_oracles_match_reference(name, kw):
    tg, jg = getattr(tdata, name)(**kw), getattr(jdata, name)(**kw)
    for root in (0, int(np.argmax(jg.degrees()))):
        assert np.array_equal(tref.bfs_ref(tg, root), jref.bfs_ref(jg, root))
        assert np.array_equal(tref.sssp_ref(tg, root),
                              jref.sssp_ref(jg, root))
    assert np.array_equal(tref.wcc_ref(tg), jref.wcc_ref(jg))


# ---------------------------------------------------------------------------
# launch options
# ---------------------------------------------------------------------------

OPTION_CASES = [dict(), dict(cap=4), dict(capacity_factor=2.0),
                dict(cap=4, capacity_factor=2.0),
                dict(queues="Q", cap=4), dict(config="auto"),
                dict(config="auto", cap=3), dict(round_mode="pipelined"),
                dict(round_mode="bogus"), dict(route_impl="sort"),
                dict(route_impl="quantum"), dict(pod_axis="pod", seed=3)]


@pytest.mark.parametrize("kw", OPTION_CASES)
def test_launch_options_conflicts_match_reference(kw):
    def build(mod, qmod):
        k = {key: (qmod.QueueConfig() if v == "Q" else v)
             for key, v in kw.items()}
        try:
            return mod.LaunchOptions(**k).resolve(), None
        except ValueError as e:
            return None, type(e)
    got, got_err = build(toptions, tq)
    want, want_err = build(joptions, jq)
    assert got_err == want_err
    if want is not None:
        for f in ("axis", "pod_axis", "cap", "capacity_factor", "config",
                  "objective", "seed", "route_impl", "round_mode"):
            assert getattr(got, f) == getattr(want, f)
    with pytest.raises(TypeError):
        toptions.resolve_options({"cap": 3})
