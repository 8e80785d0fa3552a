"""The port's scale-out layer against the JAX package, on the CPU.

Units: ``Fabric`` process introspection and ``host_slice``, the
exchange plan, the chunk-seeded ingest, the paper dataset table and the
elastic reshard/rescale, each held to the reference's on the same
inputs. Then two real processes: two subprocesses join one gloo group on
127.0.0.1 through ``Fabric.distributed(..., device="cpu")`` and run the
graph apps (lockstep; BFS and SSSP also pipelined) and the routed
histogram, flat over 2 x 2 shards and on ``("portal", "data")`` (2, 2)
with the portal axis across the processes. Their states, rounds and
message and drop streams must equal a JAX reference run on 4 devices of
one process (PageRank's ranks within 1e-4 of the largest) and the port's
own virtual fabric of the same shape, in both round modes. Each
subprocess has a 300 s ``communicate`` timeout and a finite process-group
timeout, so a lost peer fails the test instead of hanging it.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch.core.fabric import Fabric
from repro_torch.core.scaleout import exchange_plan
from repro_torch.core.routing import noc_all_to_all
from repro_torch.runtime import elastic
from repro_torch.sparse import datasets as tdata

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
PG_TIMEOUT = 60                       # seconds, the workers' process group

# ---------------------------------------------------------------------------
# the cases both packages run: (graph, app, layout, round modes, options)
# ---------------------------------------------------------------------------

GRAPHS = {"er": ("erdos_renyi", dict(n=96, avg_degree=6, seed=5)),
          "rmat": ("rmat", dict(scale=8, seed=1))}
KCORE_K = 16
HIST = dict(n=4096, n_bins=64, seed=1)
CASES = {}
for _g in GRAPHS:
    for _lay in ("flat", "hier"):
        for _app in ("bfs", "sssp", "wcc", "kcore", "pagerank"):
            _modes = (("lockstep", "pipelined") if _app in ("bfs", "sssp")
                      else ("lockstep",))
            _kw = {} if _app in ("kcore", "pagerank") else {
                "capacity_factor": 1.0}
            CASES[f"{_g}/{_lay}/{_app}"] = (_g, _app, _lay, _modes, _kw)
# drops across the process boundary: a graph round and a stream round
CASES["er/flat/bfs-cap1"] = ("er", "bfs", "flat", ("lockstep", "pipelined"),
                             {"cap": 1})
for _lay in ("flat", "hier"):
    CASES[f"hist/{_lay}/histogram"] = (None, "histogram", _lay,
                                       ("lockstep",), {})
CASES["hist/flat/histogram-cf0.1"] = (None, "histogram", "flat",
                                      ("lockstep",), {"capacity_factor": 0.1})


def run_cases(apps, datasets, options_cls, fabrics, modes=None):
    """Every case of :data:`CASES` through one package's apps:
    ``{"case/mode": {"state", "rounds", "messages", "drops"}}``.
    ``fabrics`` maps ``"flat"``/``"hier"`` to a fabric; the hier layout
    routes through the portal axis. ``modes`` limits the round modes."""
    out = {}
    for name, (gname, app, lay, case_modes, kw) in CASES.items():
        kw = dict(kw)
        if lay == "hier":
            kw["pod_axis"] = "portal"
        fab = fabrics[lay]
        for mode in case_modes:
            if modes is not None and mode not in modes:
                continue
            opts = options_cls(round_mode=mode, **kw)
            if app == "histogram":
                els = datasets.histogram_data(HIST["n"], HIST["n_bins"],
                                              seed=HIST["seed"])
                y, dropped = apps.dcra_histogram(els, HIST["n_bins"], fab,
                                                 options=opts)
                out[f"{name}/{mode}"] = {
                    "state": np.asarray(y, np.float64).tolist(),
                    "drops": int(dropped)}
                continue
            fn, gkw = GRAPHS[gname]
            g = getattr(datasets, fn)(**gkw)
            if app in ("bfs", "sssp"):
                state, st = getattr(apps, f"dcra_{app}")(g, 0, fab,
                                                         options=opts)
            elif app == "wcc":
                state, st = apps.dcra_wcc(g, fab, options=opts)
            elif app == "kcore":
                state, st = apps.dcra_kcore(g, KCORE_K, fab, options=opts)
            else:
                state, st = apps.dcra_pagerank(g, fab, options=opts)
            out[f"{name}/{mode}"] = {
                "state": np.asarray(state, np.float64).tolist(),
                "rounds": int(st.rounds),
                "messages": np.asarray(st.messages).tolist(),
                "drops": np.asarray(st.drops).tolist()}
    return out


# ---------------------------------------------------------------------------
# the subprocesses
# ---------------------------------------------------------------------------

WORKER = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
sys.path.insert(0, os.environ['TESTS_DIR'])
from test_torch_scaleout import PG_TIMEOUT, run_cases
from repro_torch.core.fabric import Fabric
from repro_torch.runtime import elastic
from repro_torch.sparse import datasets, torch_apps
from repro_torch.sparse.options import LaunchOptions
from repro_torch.sparse.program import launch_program

coord, pid = sys.argv[1], int(sys.argv[2])
flat = Fabric.distributed((4,), ('data',), coordinator_address=coord,
                          num_processes=2, process_id=pid, device='cpu',
                          timeout=PG_TIMEOUT)
hier = Fabric.distributed((2, 2), ('portal', 'data'), portal_axis='portal',
                          device='cpu')
res = {'intro': {
    'flat': [flat.process_indices, flat.n_processes, flat.is_multiprocess,
             flat.process_index, flat.dcn_axes(), flat.local_shards,
             flat.n_local_shards, flat.host_slice(8)],
    'hier': [hier.dcn_axes(), hier.pod_axis, hier.local_shards],
    'device': [str(flat.device), flat.n_devices, flat.device_coords()]}}
res['cases'] = run_cases(torch_apps, datasets, LaunchOptions,
                         {'flat': flat, 'hier': hier})
src, dst, w = datasets.ingest_edges(6, edge_factor=4, seed=3, n_chunks=8,
                                    fabric=flat)
res['ingest'] = [src.tolist(), dst.tolist(), w.tolist()]
x = elastic.place(torch.arange(32.0).view(8, 4) + 0.5,
                  elastic.Sharding(flat, ('data', None)))
moved = elastic.rescale({'x': x}, hier, {'x': (('portal', 'data'), None)})
same = elastic.rescale(moved, hier, {'x': (('portal', 'data'), None)})
res['elastic'] = {'blocks': moved['x'].blocks.tolist(),
                  'global': moved['x'].global_array().tolist(),
                  'noop_identity': same['x'] is moved['x']}
res['exchange_calls'] = flat.exchange.stats['calls']
flat.exchange.reset_stats()
launch = launch_program(torch_apps.BFS, datasets.erdos_renyi(96, 6, seed=5),
                        flat, params={'root': 0},
                        options=LaunchOptions(capacity_factor=1.0))
at_launch = flat.exchange.stats['calls']
_, st = launch.result()
res['launch'] = [at_launch, flat.exchange.stats['calls'], st.rounds]
dist.destroy_process_group()
print('RESULT ' + json.dumps(res), flush=True)
"""

FAILING_WORKER = r"""
import sys
import torch.distributed as dist
from repro_torch.core.fabric import Fabric
from repro_torch.sparse import datasets
from repro_torch.sparse.torch_apps import dcra_bfs

coord, pid = sys.argv[1], int(sys.argv[2])
fab = Fabric.distributed((4,), ('data',), coordinator_address=coord,
                         num_processes=2, process_id=pid, device='cpu',
                         timeout=20)
if pid == 1:
    raise RuntimeError('worker 1 fails before its first exchange')
dcra_bfs(datasets.erdos_renyi(96, avg_degree=6, seed=5), 0, fab)
print('RESULT unexpected', flush=True)
"""

REF = r"""
import os, sys
os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=8'
import json
import numpy as np
import jax
from jax.sharding import NamedSharding, PartitionSpec as P
sys.path.insert(0, os.environ['TESTS_DIR'])
from test_torch_scaleout import run_cases
from repro.core.fabric import Fabric
from repro.runtime.elastic import rescale
from repro.sparse import datasets, jax_apps
from repro.sparse.options import LaunchOptions

flat = Fabric.fake(4)
hier = Fabric.single((2, 2), ('portal', 'data'), portal_axis='portal')
res = {'cases': run_cases(jax_apps, datasets, LaunchOptions,
                          {'flat': flat, 'hier': hier},
                          modes=('lockstep',))}
fab8 = Fabric.fake(8)
fab4 = fab8.resize(jax.devices()[:4])
x = jax.device_put(np.arange(16, dtype=np.float32),
                   NamedSharding(fab8.mesh, P('data')))
moved = rescale({'x': x}, fab4, {'x': P('data')})
same = rescale(moved, fab4, {'x': P('data')})
hier_small = Fabric.single((2, 4), ('pod', 'data')).resize(jax.devices()[:4])
res['elastic'] = {
    'shape4': list(fab4.shape), 'names': list(fab4.axis_names),
    'values': np.asarray(moved['x']).tolist(),
    'noop_identity': same['x'] is moved['x'],
    'hier_shape': list(hier_small.shape),
    'hier_names': list(hier_small.axis_names),
    'hier_pod_axis': hier_small.pod_axis,
    'key_stable': fab8.fabric_key() == Fabric.fake(8).fabric_key()}
print('RESULT ' + json.dumps(res), flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["TESTS_DIR"] = TESTS_DIR
    return env


def _start_pair(script):
    """Two processes of ``script`` joined at a free port. One intra-op
    thread each: two processes with a thread a core each, spinning
    against each other on one CPU, run the same cases six times
    slower."""
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(_env(), OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, "-c", script, coord, str(pid)],
                             env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
            for pid in (0, 1)]


def _finish(procs, timeout=300):
    """``[(returncode, stdout, stderr)]`` of every process, each waited
    for at most ``timeout`` seconds; none is left running."""
    outs = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=timeout)
            outs.append((p.returncode, so, se))
    finally:
        for p in procs:
            p.kill()
            p.communicate()
    return outs


def _result(stdout):
    lines = [ln for ln in stdout.splitlines() if ln.startswith("RESULT ")]
    assert lines, stdout[-2000:]
    return json.loads(lines[0][len("RESULT "):])


@pytest.fixture(scope="module")
def runs():
    """The two workers and the JAX reference, all started at once."""
    procs = _start_pair(WORKER)
    procs.append(subprocess.Popen([sys.executable, "-c", REF], env=_env(),
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True))
    outs = _finish(procs)
    for rc, so, se in outs:
        assert rc == 0, (so[-1500:], se[-3000:])
    return [_result(so) for _, so, _ in outs]


def _virtual_cases():
    from repro_torch.sparse import torch_apps
    from repro_torch.sparse.options import LaunchOptions
    return run_cases(torch_apps, tdata, LaunchOptions, {
        "flat": Fabric.fake(4, device="cpu"),
        "hier": Fabric.virtual((2, 2), ("portal", "data"), device="cpu")})


@pytest.fixture(scope="module")
def virtual():
    return _virtual_cases()


def _same(got, want, name):
    if name.split("/")[2] == "pagerank":
        g, w = np.asarray(got["state"]), np.asarray(want["state"])
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), name
        rest = ("rounds", "messages", "drops")
    else:
        rest = tuple(got)
    for k in rest:
        assert got[k] == want[k], (name, k, got[k], want[k])


# ---------------------------------------------------------------------------
# two processes
# ---------------------------------------------------------------------------

def test_both_workers_return_the_global_results(runs):
    w0, w1, _ = runs
    assert w0["cases"] == w1["cases"]
    assert w0["elastic"]["global"] == w1["elastic"]["global"]
    assert w0["exchange_calls"] == w1["exchange_calls"] > 0


def test_worker_introspection(runs):
    w0, w1, _ = runs
    for pid, w in enumerate((w0, w1)):
        flat, hier = w["intro"]["flat"], w["intro"]["hier"]
        assert flat[:5] == [[0, 1], 2, True, pid, ["data"]]
        assert flat[5:] == [[2 * pid, 2 * pid + 2], 2, [4 * pid, 4 * pid + 4]]
        assert hier == [["portal"], "portal", [2 * pid, 2 * pid + 2]]


def test_distributed_fabric_takes_a_shape_not_a_device_list(runs):
    """The port's distributed fabric has no JAX-style device list: a
    shape, one device a process, and shard indices where the reference
    gives device ids."""
    import inspect
    params = inspect.signature(Fabric.distributed).parameters
    assert "devices" not in params and "device" in params
    for w in runs[:2]:
        assert w["intro"]["device"] == [
            "cpu", 4, [[g, [g]] for g in range(4)]]


def test_launch_returns_after_its_last_exchange(runs):
    """gloo blocks the host, so a distributed launch_program returns with
    every round's exchange done; result() exchanges nothing more."""
    for w in runs[:2]:
        at_launch, after, rounds = w["launch"]
        assert at_launch == after == rounds > 1


@pytest.mark.parametrize("name", sorted(k for k, v in CASES.items()))
def test_two_processes_match_the_reference(runs, name):
    dist, _, ref = runs
    want = ref["cases"][f"{name}/lockstep"]
    for mode in CASES[name][3]:
        _same(dist["cases"][f"{name}/{mode}"], want, f"{name}/{mode}")


@pytest.mark.parametrize("name", sorted(k for k, v in CASES.items()
                                        if "pipelined" in v[3]))
def test_two_processes_match_the_virtual_fabric_in_both_modes(runs, virtual,
                                                              name):
    dist = runs[0]["cases"]
    for mode in ("lockstep", "pipelined"):
        assert dist[f"{name}/{mode}"] == virtual[f"{name}/{mode}"], mode
    assert virtual[f"{name}/pipelined"] == virtual[f"{name}/lockstep"]


def test_cases_drop_across_processes(runs):
    cases = runs[0]["cases"]
    assert sum(cases["er/flat/bfs-cap1/lockstep"]["drops"]) > 0
    assert cases["hist/flat/histogram-cf0.1/lockstep"]["drops"] > 0
    assert all(len(cases[f"{k}/lockstep"]["messages"]) > 1
               for k in CASES if CASES[k][1] in ("bfs", "kcore"))


def test_worker_ingest_shares_cover_the_stream(runs):
    from repro.sparse.datasets import ingest_edges as ref_ingest
    shares = [w["ingest"] for w in runs[:2]]
    for pid, share in enumerate(shares):
        want = ref_ingest(6, edge_factor=4, seed=3, n_chunks=8, rank=pid,
                          world=2)
        assert share == [a.tolist() for a in want]
    whole = tdata.ingest_edges(6, edge_factor=4, seed=3, n_chunks=8)
    assert _multiset(*(np.concatenate([np.asarray(s[i]) for s in shares])
                       for i in range(3))) == _multiset(*whole)


def test_worker_elastic_move_across_processes(runs):
    x = np.arange(32, dtype=np.float32).reshape(8, 4) + 0.5
    for pid, w in enumerate(runs[:2]):
        el = w["elastic"]
        assert el["global"] == x.tolist() and el["noop_identity"]
        # (portal, data) rows: shard g holds rows [2g, 2g+2), this
        # process shards [2 pid, 2 pid + 2)
        assert el["blocks"] == x.reshape(4, 2, 4)[2 * pid:2 * pid + 2
                                                  ].tolist()


def test_a_failing_worker_fails_its_peer_within_the_timeout():
    t0 = time.perf_counter()
    outs = _finish(_start_pair(FAILING_WORKER))
    elapsed = time.perf_counter() - t0
    assert outs[1][0] != 0 and "fails before" in outs[1][2]
    assert outs[0][0] != 0 and "RESULT" not in outs[0][1], outs[0][2][-2000:]
    assert "RuntimeError" in outs[0][2]
    assert elapsed < 120


# ---------------------------------------------------------------------------
# units
# ---------------------------------------------------------------------------

def _distributed(fab, n_processes, process_index=0):
    """``fab`` placed over processes without joining a group: what the
    introspection and the exchange plan read."""
    return dataclasses.replace(fab, process_index=process_index,
                               n_processes=n_processes)


class _Dev:
    def __init__(self, i, proc):
        self.id, self.process_index = i, proc


class _DuckMesh:
    """A reference mesh whose devices carry process indices."""

    def __init__(self, shape, names, n_processes):
        n = int(np.prod(shape))
        per = n // n_processes
        self.devices = np.array([_Dev(i, i // per) for i in range(n)],
                                dtype=object).reshape(shape)
        self.axis_names = names


def test_host_slice_matches_reference():
    from repro.core.fabric import Fabric as RFabric
    ref = RFabric.of(_DuckMesh((1,), ("data",), 1))
    fab = Fabric.fake(1, device="cpu")
    for total in range(41):
        for world in range(1, 9):
            for rank in range(world):
                assert (fab.host_slice(total, rank=rank, world=world)
                        == ref.host_slice(total, rank=rank, world=world))
            for bad in (-1, world):
                with pytest.raises(ValueError):
                    fab.host_slice(total, rank=bad, world=world)
                with pytest.raises(ValueError):
                    ref.host_slice(total, rank=bad, world=world)


LAYOUTS = [((4,), ("data",), 2), ((2, 2), ("portal", "data"), 2),
           ((4, 2), ("pod", "data"), 2), ((2, 4), ("pod", "data"), 4),
           ((8,), ("data",), 8), ((2, 4), ("pod", "data"), 1)]


@pytest.mark.parametrize("shape,names,n_proc", LAYOUTS)
def test_introspection_matches_reference(shape, names, n_proc):
    from repro.core.fabric import Fabric as RFabric
    ref = RFabric.of(_DuckMesh(shape, names, n_proc))
    fab = _distributed(Fabric.virtual(shape, names, device="cpu"), n_proc)
    assert fab.process_indices == ref.process_indices
    assert fab.n_processes == ref.n_processes
    assert fab.is_multiprocess == ref.is_multiprocess
    assert fab.process_index == ref.process_index == 0
    assert fab.dcn_axes() == ref.dcn_axes()
    assert fab.pod_axis == ref.pod_axis
    assert fab.host_slice(13) == ref.host_slice(13)
    per = int(np.prod(shape)) // n_proc
    assert fab.local_shards == (0, per) and fab.n_local_shards == per
    for p in range(n_proc):
        other = _distributed(fab, n_proc, p)
        assert other.local_shards == (p * per, (p + 1) * per)
        assert other.local_rows(np.arange(n_proc * per)).tolist() == list(
            range(p * per, (p + 1) * per))


def test_virtual_fabric_introspection():
    from repro.core.fabric import Fabric as RFabric
    ref = RFabric.fake(1)
    for fab in (Fabric.fake(8, device="cpu"),
                Fabric.virtual((2, 4), ("pod", "data"), device="cpu")):
        got = (fab.process_indices, fab.n_processes, fab.is_multiprocess,
               fab.process_index, fab.dcn_axes())
        assert got == ((0,), 1, False, 0, ()) == (
            ref.process_indices, ref.n_processes, ref.is_multiprocess,
            ref.process_index, ref.dcn_axes())
        assert fab.local_shards == (0, fab.n_devices)
        assert fab.exchange is None
        x = torch.arange(float(fab.n_devices))
        assert fab.local_rows(x) is x and fab.gather_shards(x) is x


def test_fabric_key_tells_virtual_from_distributed():
    for shape, names in (((4,), ("data",)), ((2, 2), ("portal", "data"))):
        virt = Fabric.virtual(shape, names, device="cpu")
        keys = {virt.fabric_key(), _distributed(virt, 2, 0).fabric_key(),
                _distributed(virt, 2, 1).fabric_key(),
                _distributed(virt, 4, 0).fabric_key()}
        assert len(keys) == 4
        assert virt.fabric_key() == Fabric.virtual(shape, names,
                                                   device="cpu").fabric_key()


@pytest.mark.parametrize("shape,dims,n_proc", [
    ((4,), (0,), 2), ((4,), (0,), 4), ((2, 2), (0,), 2), ((2, 2), (1,), 2),
    ((4, 2), (0,), 2), ((4, 2), (1,), 4), ((2, 4), (0, 1), 2),
    ((2, 3, 2), (0, 2), 2), ((2, 3, 2), (1,), 4), ((8,), (0,), 8)])
def test_exchange_plan_equals_the_transpose(shape, dims, n_proc):
    """Every process's plan, run here on its rows of one global wire,
    gives its rows of the local transpose: the blocks that stay move
    locally, the others arrive in the order their senders send them."""
    s = int(np.prod(shape))
    per = s // n_proc
    nb = int(np.prod([shape[d] for d in dims]))
    rows, c = 3, 2
    x = torch.arange(s * nb * rows * c, dtype=torch.float32).view(
        s, nb * rows, c)
    want = noc_all_to_all(x, shape, dims)
    plans = [exchange_plan(shape, dims, n_proc, p) for p in range(n_proc)]
    blocks = x.view(s * nb, rows * c)
    sent = {}                       # (sender, receiver) -> blocks in order
    for p, plan in enumerate(plans):
        out = blocks[p * per * nb:(p + 1) * per * nb]
        send = out[torch.from_numpy(plan["send"])]
        for q, part in enumerate(torch.split(send, plan["send_splits"])):
            sent[p, q] = part
        assert plan["send_splits"][p] == 0 == plan["recv_splits"][p]
    for p, plan in enumerate(plans):
        local = x.view(s * nb, rows * c)[p * per * nb:(p + 1) * per * nb]
        got = torch.empty_like(local)
        got[torch.from_numpy(plan["local_dst"])] = local[
            torch.from_numpy(plan["local_src"])]
        arrived = torch.cat([sent[q, p] for q in range(n_proc)])
        got[torch.from_numpy(plan["recv_dst"])] = arrived
        assert torch.equal(got.view(per, nb * rows, c),
                           want[p * per:(p + 1) * per])
        if n_proc == 1:
            assert len(plan["send"]) == 0


def test_exchange_stages_one_host_all_to_all_a_call(monkeypatch):
    """Process 0 of a flat (4,) fabric over 2 processes, its peer played
    by a stand-in for ``all_to_all_single``: the blocks that leave go in
    one call, on host tensors with one split a process, and the result
    is process 0's rows of the local transpose."""
    import torch.distributed as dist
    fab = _distributed(Fabric.fake(4, device="cpu"), 2, 0)
    shape, dims = (4,), (0,)
    x = torch.arange(4 * 4 * 3 * 2, dtype=torch.float32).view(4, 12, 2)
    peer_plan = exchange_plan(shape, dims, 2, 1)
    peer = x[2:].reshape(8, 6)[torch.from_numpy(peer_plan["send"])]
    seen = []

    def all_to_all_single(out, inp, output_split_sizes, input_split_sizes):
        seen.append((inp.device.type, out.device.type,
                     list(input_split_sizes), list(output_split_sizes)))
        out.copy_(peer)
    monkeypatch.setattr(dist, "all_to_all_single", all_to_all_single)
    got = noc_all_to_all(x[:2].contiguous(), shape, 0, fab.exchange)
    assert torch.equal(got, noc_all_to_all(x, shape, 0)[:2])
    assert seen == [("cpu", "cpu", [0, 4], [0, 4])]
    assert fab.exchange.stats["calls"] == 1
    assert fab.exchange.stats["bytes_out"] == 4 * 6 * 4


def test_portal_stage_alone_crosses_processes():
    """On (pods, data) with whole pods a process, stage 1 (data) keeps
    every block in the process; stage 2 (pods) sends all but its own."""
    plan1 = exchange_plan((8, 8), (1,), 2, 0)
    plan2 = exchange_plan((8, 8), (0,), 2, 0)
    assert len(plan1["send"]) == 0 and len(plan1["local_src"]) == 32 * 8
    assert plan2["send_splits"] == [0, 32 * 4]


def _multiset(src, dst, w):
    from collections import Counter
    return Counter(zip(np.asarray(src).tolist(), np.asarray(dst).tolist(),
                       np.asarray(w).tolist()))


@pytest.mark.parametrize("scale,ef,n_chunks", [(6, 4, 1), (6, 4, 3),
                                               (7, 8, 8), (7, 8, 16),
                                               (5, 2, 7)])
def test_rmat_edge_chunk_matches_reference(scale, ef, n_chunks):
    from repro.sparse.datasets import rmat_edge_chunk as ref_chunk
    for c in range(n_chunks):
        got = tdata.rmat_edge_chunk(scale, c, n_chunks, ef, seed=3)
        want = ref_chunk(scale, c, n_chunks, ef, seed=3)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_rmat_edge_chunk_past_one_draw_block_matches_reference():
    """A chunk of 2^21 pairs: the port draws it in blocks of 2^20."""
    from repro.sparse.datasets import rmat_edge_chunk as ref_chunk
    got = tdata.rmat_edge_chunk(17, 0, 1, 16, seed=1)
    want = ref_chunk(17, 0, 1, 16, seed=1)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("world", [2, 3, 8])
def test_ingest_edges_split_matches_reference(world):
    from repro.sparse.datasets import ingest_edges as ref_ingest
    whole = tdata.ingest_edges(6, edge_factor=4, seed=3, n_chunks=8)
    shares = []
    for rank in range(world):
        got = tdata.ingest_edges(6, edge_factor=4, seed=3, n_chunks=8,
                                 rank=rank, world=world)
        want = ref_ingest(6, edge_factor=4, seed=3, n_chunks=8, rank=rank,
                          world=world)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert len(got[0]) < len(whole[0])          # no share is the whole
        shares.append(got)
    union = [np.concatenate([s[i] for s in shares]) for i in range(3)]
    assert _multiset(*union) == _multiset(*whole)
    fab = _distributed(Fabric.fake(world, device="cpu"), world, world - 1)
    via_fabric = tdata.ingest_edges(6, edge_factor=4, seed=3, n_chunks=8,
                                    fabric=fab)
    for a, b in zip(via_fabric, shares[-1]):
        assert np.array_equal(a, b)


def test_ingest_graph_matches_reference():
    from repro.sparse.datasets import ingest_graph as ref_graph
    got = tdata.ingest_graph(6, edge_factor=4, seed=3, n_chunks=4)
    want = ref_graph(6, edge_factor=4, seed=3, n_chunks=4)
    for k in ("row_ptr", "col_idx", "values"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_paper_datasets_match_reference():
    from repro.sparse import datasets as rdata
    assert list(tdata.PAPER_DATASETS) == list(rdata.PAPER_DATASETS)
    for k, want in rdata.PAPER_DATASETS.items():
        got = tdata.PAPER_DATASETS[k]
        assert (got.name, got.vertices, got.edges, got.footprint_bytes) == (
            want.name, want.vertices, want.edges, want.footprint_bytes)


def test_elastic_matches_reference(runs):
    """The reference's part B, on the port: resize 8 -> 4 shards, rescale
    a leaf onto it, a second pass is the same object; a hier fabric
    resized below one pod keeps its names with the pod axis off."""
    fab8 = Fabric.fake(8, device="cpu")
    fab4 = fab8.resize(4)
    x = elastic.place(torch.arange(16, dtype=torch.float32),
                      elastic.Sharding(fab8, ("data",)))
    moved = elastic.rescale({"x": x}, fab4, {"x": ("data",)})
    same = elastic.rescale(moved, fab4, {"x": ("data",)})
    hier_small = Fabric.virtual((2, 4), ("pod", "data"),
                                device="cpu").resize(4)
    got = {"shape4": list(fab4.shape), "names": list(fab4.axis_names),
           "values": moved["x"].global_array().tolist(),
           "noop_identity": same["x"] is moved["x"],
           "hier_shape": list(hier_small.shape),
           "hier_names": list(hier_small.axis_names),
           "hier_pod_axis": hier_small.pod_axis,
           "key_stable": fab8.fabric_key() == Fabric.fake(
               8, device="cpu").fabric_key()}
    assert got == runs[2]["elastic"]
    assert moved["x"].sharding == elastic.Sharding(fab4, ("data",))
    assert moved["x"].blocks.tolist() == torch.arange(16.).view(4, 4).tolist()


def test_reshard_skips_noop_leaves(monkeypatch):
    fab = Fabric.fake(4, device="cpu")
    sh = elastic.Sharding(fab, ("data",))
    x = elastic.place(torch.arange(8.0), sh)
    calls = []
    real = Fabric.unshard
    monkeypatch.setattr(Fabric, "unshard",
                        lambda self, *a: (calls.append(1), real(self, *a))[1])
    out = elastic.reshard({"a": x, "b": [x]}, {"a": sh, "b": [sh]})
    assert calls == [] and out["a"] is x and out["b"][0] is x
    rep = elastic.reshard({"a": x}, {"a": elastic.Sharding(fab, (None,))})
    assert len(calls) == 1
    assert rep["a"].blocks.tolist() == [list(range(8))] * 4
    assert rep["a"].global_array().tolist() == list(range(8))


# ---------------------------------------------------------------------------
# what a distributed fabric refuses
# ---------------------------------------------------------------------------

def test_shard_count_that_does_not_divide_raises():
    import torch.distributed as dist
    with pytest.raises(ValueError, match="do not split"):
        Fabric.distributed((3,), ("data",), coordinator_address="127.0.0.1:1",
                           num_processes=2, process_id=0, device="cpu")
    with pytest.raises(ValueError, match="do not split"):
        _distributed(Fabric.fake(6, device="cpu"), 4)
    with pytest.raises(ValueError, match="do not split"):
        _distributed(Fabric.fake(4, device="cpu"), 2).resize(3)
    assert not dist.is_initialized()


def test_distributed_without_a_card_raises(monkeypatch):
    import torch.distributed as dist
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Fabric.distributed((2,), ("data",), coordinator_address="127.0.0.1:1",
                           num_processes=1, process_id=0)
    assert not dist.is_initialized()


def test_server_and_moe_refuse_a_distributed_fabric():
    """Nothing is refused any more: ``ProgramServer`` and ``MoEService``
    (over ``moe_dcra``) construct on a distributed fabric, joining no
    group until they launch (``tests/test_torch_serve_distributed.py``
    and ``tests/test_torch_moe_distributed.py`` run them across
    processes). What a distributed fabric still refuses is a host loss
    whose kept shards do not split over its processes."""
    from repro_torch.configs import get_config
    from repro_torch.core.dispatch import MeshInfo
    from repro_torch.serve import MoEService, ProgramServer
    import torch.distributed as dist
    fab = _distributed(Fabric.fake(4, device="cpu"), 2)
    g = tdata.erdos_renyi(32, avg_degree=4, seed=5)
    info = MeshInfo(_distributed(Fabric.virtual(
        (2, 2, 1), ("data", "expert", "tp"), device="cpu"), 2))
    cfg = get_config("olmoe-1b-7b")
    moe = MoEService(cfg, None, info, batch=2, seq=4)
    srv = ProgramServer(fab, {"g": g}, moe=moe)
    assert srv.fabric is fab and srv.moe is moe
    assert moe.info.mesh.n_processes == 2
    assert (srv.queue_depth, srv.inflight_depth) == (0, 0)
    assert srv.fabric.shrink(2).local_shards == (0, 1)
    with pytest.raises(ValueError, match="do not split over 2 processes"):
        srv.fabric.shrink(3)
    assert not dist.is_initialized()
