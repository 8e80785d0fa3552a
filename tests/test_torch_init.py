"""A graph launch's two ends on the device: the initial states made there
in owner layout, and the results unpacked there.

Each graph program's ``init_sharded`` must equal ``owner_layout`` of its
host ``init`` cast to float32, bit for bit, for any process's rows,
with padding (``n`` not a multiple of ``S``) and a root on the last
shard; a program with only ``init`` gets the same states through the
fallback, laid out by ``owner_rows``, and counts in ``init_on_host``.
``ProgramLaunch.result()`` equals ``from_owner_layout`` and a float64
cast, bit for bit, and its arrays never share memory with the reused
host buffers or with a later launch's results.

The module imports nothing of the reference, so its ``cuda`` test runs
on the card: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_init.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import trace
from repro_torch.core.fabric import Fabric
from repro_torch.serve.batching import tenant_graph
from repro_torch.sparse import datasets, program
from repro_torch.sparse.options import LaunchOptions
from repro_torch.sparse.program import from_owner_layout, owner_layout
from repro_torch.sparse.torch_apps import (BATCHED_BFS, BATCHED_SSSP, BFS,
                                           KCORE, PAGERANK, SSSP, WCC)

N = 203                       # a multiple of no S below
TENANTS = 2


def _graph():
    return datasets.erdos_renyi(N, 6, seed=5)


def _last_shard_vertex(lo, hi, n_dev):
    """The largest vertex in ``[lo, hi)`` owned by the last shard."""
    return max(v for v in range(lo, hi) if v % n_dev == n_dev - 1)


def _case(name, n_dev):
    """``(program, graph, params)``: single roots on the last shard, a
    tenant root there too."""
    g = _graph()
    root = _last_shard_vertex(0, N, n_dev)
    if name in ("bfs_batched", "sssp_batched"):
        tenant_root = _last_shard_vertex(N, 2 * N, n_dev) - N
        prog = BATCHED_BFS if name == "bfs_batched" else BATCHED_SSSP
        return prog, tenant_graph(g, TENANTS), {"roots": (0, tenant_root)}
    return {"bfs": (BFS, g, {"root": root}),
            "sssp": (SSSP, g, {"root": root}),
            "wcc": (WCC, g, {}),
            "pagerank": (PAGERANK, g, {"damping": 0.85, "iters": 3}),
            "kcore": (KCORE, g, {"k": 3.0})}[name]


APPS = ("bfs", "sssp", "wcc", "pagerank", "kcore", "bfs_batched",
        "sssp_batched")


def _init_ctx(prog, g, params, n_dev, rows):
    n_local, src_slot, dst, _, e_max = program._graph_setup(
        g, n_dev, undirected=prog.undirected)
    lo, hi = (0, n_dev) if rows == "all" else (n_dev // 4, 3 * n_dev // 4)
    return program.InitCtx(
        g.n, n_dev, n_local, lo, hi, params, torch.device("cpu"),
        torch.from_numpy(src_slot).view(n_dev, e_max).long()[lo:hi],
        torch.from_numpy(dst).view(n_dev, e_max)[lo:hi])


def _want(prog, g, params, ic):
    states0, fills = prog.init(g, params)
    return [np.asarray(owner_layout(s, ic.n_dev, f)[0], np.float32)
            .reshape(ic.n_dev, ic.n_local)[ic.lo:ic.hi]
            for s, f in zip(states0, fills)]


def _assert_bits(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        assert a.is_contiguous()
        assert np.array_equal(a.numpy().view(np.uint32), b.view(np.uint32))


# every process's rows, or a middle process's ``[S/4, 3S/4)``
LAYOUTS = [(1, "all"), (8, "all"), (64, "all"), (8, "part"), (64, "part")]


@pytest.mark.parametrize("n_dev,rows", LAYOUTS)
@pytest.mark.parametrize("app", APPS)
def test_device_init_equals_the_host_init_laid_out(app, n_dev, rows):
    prog, g, params = _case(app, n_dev)
    ic = _init_ctx(prog, g, params, n_dev, rows)
    want = _want(prog, g, params, ic)
    _assert_bits(list(prog.init_sharded(ic)), want)
    # the fallback a program with only ``init`` takes gives the same
    host_only = dataclasses.replace(prog, init_sharded=None)
    got, _ = program._initial_states(host_only, g, params, ic)
    _assert_bits(got, want)


@pytest.mark.parametrize("prog", [BFS, BATCHED_BFS])
def test_device_init_keeps_the_root_checks(prog):
    g = _graph()
    if prog is BFS:
        bad, err = {"root": N}, IndexError
    else:
        g, bad, err = tenant_graph(g, TENANTS), {"roots": (0, N)}, ValueError
    ic = _init_ctx(prog, g, bad, 8, "all")
    with pytest.raises(err):
        prog.init(g, bad)
    with pytest.raises(err):
        prog.init_sharded(ic)


def _fx_init(g, params):
    dist = np.full(g.n, np.inf)
    dist[0] = 0.0
    return (dist, np.zeros(g.n)), (np.inf, 0.0)


def _fx_update(ctx, state, frontier, upd):
    new = torch.minimum(state[0], upd)
    reached = ctx.gsum(torch.isfinite(new).sum(1, dtype=torch.float32))
    return (new, state[1] + reached[:, None]), new < state[0]


# a host-only program: hop distances from vertex 0 for a fixed number of
# rounds, plus the running count of reached vertices
FIXED_REACH = program.TaskProgram(
    name="fixed_reach", mode="fixed", init=_fx_init,
    frontier0=lambda ctx, s: torch.isfinite(s[0]),
    payload=lambda ctx, s, src_slot, w: torch.gather(s[0], 1, src_slot) + 1.0,
    update=_fx_update)


@pytest.mark.parametrize("n_dev", [1, 8, 64])
def test_a_host_only_init_is_laid_out_on_the_device(n_dev):
    g = _graph()
    params = {"iters": 3}
    ic = _init_ctx(FIXED_REACH, g, params, n_dev, "all")
    got, staging = program._initial_states(FIXED_REACH, g, params, ic)
    _assert_bits(got, _want(FIXED_REACH, g, params, ic))
    assert staging == ()                   # no pinned staging on the CPU
    with trace.recording():
        states, _ = program.launch_program(
            FIXED_REACH, g, Fabric.fake(n_dev, device="cpu"),
            params=params).result()
        counts = trace.counters()
    assert counts["init_on_host"] == 1 and "init_on_card" not in counts
    assert states[0][0] == 0.0


def _raw_states(fut, k):
    """A launch's output states before ``result()``: ``[S, n_local]``."""
    return [s.clone() for s in fut._outs[:k]]


def _assert_unpacked(states, raw, n, n_dev):
    assert len(states) == len(raw)
    for s, r in zip(states, raw):
        want = np.asarray(from_owner_layout(r.reshape(-1).numpy(), n,
                                            n_dev), np.float64)
        assert s.dtype == np.float64 and s.flags.c_contiguous
        assert np.array_equal(s.view(np.uint64), want.view(np.uint64))


@pytest.mark.parametrize("mode", ["lockstep", "pipelined"])
@pytest.mark.parametrize("app", ["bfs", "pagerank"])
def test_result_unpacks_on_the_device_bit_for_bit(app, mode):
    """One state (BFS) and three (PageRank); twice back to back: the
    first result's arrays are unchanged by the second ``result()``, and
    no array shares memory with another or with the reused buffers."""
    g = _graph()
    fab = Fabric.fake(8, device="cpu")
    prog, _, params = _case(app, 8)
    k = len(prog.init(g, params)[0])
    second = ({"root": 0} if app == "bfs" else params)
    opts = LaunchOptions(round_mode=mode)
    fut1 = program.launch_program(prog, g, fab, params=params, options=opts)
    raw1 = _raw_states(fut1, k)
    states1, stats1 = fut1.result()
    kept = [s.copy() for s in states1]
    _assert_unpacked(states1, raw1, g.n, 8)
    fut2 = program.launch_program(prog, g, fab, params=second, options=opts)
    assert fut2._readback is fut1._readback            # one shape class
    raw2 = _raw_states(fut2, k)
    states2, stats2 = fut2.result()
    _assert_unpacked(states2, raw2, g.n, 8)
    assert all(np.array_equal(a, b) for a, b in zip(states1, kept))
    if app == "bfs":
        assert not np.array_equal(states1[0], states2[0])
    arrays = list(states1) + list(states2)
    bufs = list(fut1._readback._bufs.values())
    for i, a in enumerate(arrays):
        assert not any(np.shares_memory(a, b) for b in arrays[i + 1:])
        assert not any(np.shares_memory(a, b.numpy()) for b in bufs)
    # the round counts ride the same readback
    want = program.run_program(prog, g, fab, params=params, options=opts)[1]
    assert stats1.rounds == want.rounds
    assert np.array_equal(stats1.messages, want.messages)
    assert np.array_equal(stats1.drops, want.drops)
    assert stats1.messages.dtype == np.int64 and stats1.rounds > 0
    assert fut1.result() is fut1.result()                # idempotent


@pytest.mark.cuda
@pytest.mark.parametrize("app", ["bfs", "pagerank"])
def test_cuda_device_init_and_unpack_match_the_host(app):
    """On the card: the device init equals the host init laid out, and
    ``result()`` (pinned buffers, one non-blocking copy) equals the host
    unpack of the same states, bit for bit, launch after launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    card = torch.device("cuda")
    g = datasets.rmat(14, 16, seed=3)
    n_dev = 64
    prog, _, params = _case(app, n_dev)
    params = dict(params, root=int(np.argmax(g.degrees()))) if (
        app == "bfs") else params
    setup = program._graph_setup(g, n_dev, undirected=prog.undirected)
    resident = program.resident_setup(setup, card)
    n_local, _, _, _, e_max = setup
    ic = program.InitCtx(g.n, n_dev, n_local, 0, n_dev, params, card,
                         resident[1], resident[2])
    want = [np.asarray(owner_layout(s, n_dev, f)[0], np.float32)
            .reshape(n_dev, n_local)
            for s, f in zip(*prog.init(g, params))]
    _assert_bits([s.cpu() for s in prog.init_sharded(ic)], want)
    fab = Fabric.fake(n_dev, device=card)
    earlier = []
    for _ in range(3):
        fut = program.launch_program(prog, g, fab, params=params,
                                     setup=resident)
        raw = [s.cpu() for s in fut._outs[:len(want)]]
        states, _ = fut.result()
        _assert_unpacked(states, raw, g.n, n_dev)
        for a, b in earlier:
            assert np.array_equal(a, b)
        earlier.append((states[0], states[0].copy()))
