"""The port's serving tier across processes against the JAX package, on
the CPU.

Two subprocesses join one gloo group on 127.0.0.1 through
``Fabric.distributed(..., device="cpu")`` and each runs
``tests/test_torch_serve.py::scenario`` (every part: the launch sequence,
pre-warm, the 16-request stream, the depth and fairness sweep, donation,
a poisoned launch, admission, drops, a seeded chaos plan, host losses,
retries, deadlines and the MoE lane's faults) flat over (4,) shards, two
a process, and on ``("portal", "data")`` (2, 2) with every launch routed
through the portal stage, which crosses the processes. Every part must
equal the reference's on a mesh of the same shape (one JAX subprocess on
8 fake host devices), and the two workers' results must equal each
other.

Then what only processes can show: a clock that runs ahead on one
process, so a deadline expires there alone, changes no decision (both
processes expire what rank 0 expires); a host loss whose kept shards
split over the processes keeps both, one shard each, and serves every
request as the one-process server does; a kept count that does not
split raises ``ValueError`` on both.

Every subprocess has a ``communicate`` timeout and the workers a finite
process-group timeout, so a lost peer fails the test instead of hanging
it. The ``cuda`` tests run the server and the MoE lane across two
processes sharing ``cuda:0``; they skip without a card.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from test_torch_scaleout import SRC, TESTS_DIR, _finish, _free_port, _result
from test_torch_serve import PARTS, TENANTS, WIDTH, _ledger, _sig, wiki

PG_TIMEOUT = 60                       # seconds, the workers' process group

#: layout -> (fabric shape, axis names, the axis launches route pods over)
LAYOUTS = {"flat": ((4,), ("data",), None),
           "pods": ((2, 2), ("portal", "data"), "portal")}


def skewed_clock(api, pid, fast_rank):
    """Eight requests with a 60 s deadline; once they are queued, the
    serving loop's clock on process ``fast_rank`` jumps 1000 s ahead.
    Returns the responses and the ledger."""
    from repro_torch.serve import ProgramServer, Request, ServeOptions
    from repro_torch.serve import engine

    class Clock:
        offset = 0.0

        def perf_counter(self):
            return time.perf_counter() + self.offset

        def sleep(self, s):
            time.sleep(s)
    clock = Clock()
    engine.time = clock
    try:
        srv = ProgramServer(api.fabric((4,), ("data",)),
                            {"wiki": wiki(api.datasets)}, batch_width=WIDTH,
                            serve_options=ServeOptions(deadline_s=60.0))
        for i in range(8):
            assert srv.submit(Request(i, TENANTS[i % 4], "bfs", "wiki",
                                      root=i)) is None
        if pid == fast_rank:
            clock.offset = 1000.0
        rs = srv.drain()
        srv.stats.verify()
    finally:
        engine.time = time
    return [_sig(rs), _ledger(srv)]


def host_loss(api, keep):
    """A host loss at launch 1 that keeps ``keep`` of 4 flat shards, on a
    retrying server: the responses, the ledger and the fabric after, or
    the ``ValueError`` the loss raised."""
    from repro_torch.serve import (ProgramServer, Request, ServeFailurePlan,
                                   ServeOptions)
    srv = ProgramServer(api.fabric((4,), ("data",)),
                        {"wiki": wiki(api.datasets)}, batch_width=WIDTH,
                        serve_options=ServeOptions(max_retries=1),
                        failure_plan=ServeFailurePlan(at={1: "host_loss"},
                                                      keep_devices=keep))
    reqs = [Request(i, TENANTS[i % 4], "bfs" if i < 8 else "sssp", "wiki",
                    root=(i * 7) % 192) for i in range(12)]
    try:
        rs = srv.run(reqs)
    except ValueError as e:
        return ["raised", str(e)]
    srv.stats.verify()
    return [_sig(rs), _ledger(srv), srv.stats.host_losses,
            srv.fabric.n_devices, list(srv.fabric.shape)]


WORKER = r"""
import json, os, sys
import torch.distributed as dist
sys.path.insert(0, os.environ['TESTS_DIR'])
from test_torch_serve import port_api, scenario
from test_torch_serve_distributed import (LAYOUTS, PG_TIMEOUT, host_loss,
                                          skewed_clock)
from repro_torch.core.fabric import Fabric

coord, pid = sys.argv[1], int(sys.argv[2])


def fabric(shape, names):
    return Fabric.distributed(shape, names, coordinator_address=coord,
                              num_processes=2, process_id=pid,
                              device='cpu', timeout=PG_TIMEOUT)


api = port_api()
api.fabric = fabric
res = {lay: scenario(api, shape, names, pod)
       for lay, (shape, names, pod) in LAYOUTS.items()}
res['clock'] = [skewed_clock(api, pid, fast) for fast in (1, 0)]
res['host_loss'] = [host_loss(api, keep) for keep in (2, 3)]
fab = fabric((4,), ('data',))
res['local_rows'] = [fab.local_shards, fab.shrink(2).local_shards]
xchg = fab.exchange
xchg.reset_stats()
res['agree'] = [xchg.agree(pid), xchg.agree(pid, pick=max),
                xchg.stats['agree_calls'], xchg.stats['agree_s'] > 0]
dist.destroy_process_group()
with open(os.path.join(sys.argv[3], f'worker{pid}.json'), 'w') as f:
    json.dump(res, f)
"""

REF = r"""
import os, sys
os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=8'
import json, types
from repro import serve
from repro.core.compat import make_mesh
from repro.core.queues import QueueConfig
from repro.sparse import datasets, program
from repro.sparse.jax_apps import BFS, SSSP
from repro.sparse.options import LaunchOptions
sys.path.insert(0, os.environ['TESTS_DIR'])
from test_torch_serve import scenario
from test_torch_serve_distributed import LAYOUTS

api = types.SimpleNamespace(
    program=program, serve=serve, LaunchOptions=LaunchOptions,
    QueueConfig=QueueConfig, datasets=datasets, BFS=BFS, SSSP=SSSP,
    fabric=lambda shape, names: make_mesh(shape, names))
lay, out = sys.argv[1:3]
shape, names, pod = LAYOUTS[lay]
with open(os.path.join(out, f'ref_{lay}.json'), 'w') as f:
    json.dump(scenario(api, shape, names, pod), f)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["TESTS_DIR"] = TESTS_DIR
    return env


def _workers(script, n, *args):
    """``n`` processes of ``script`` joined at a free port, one intra-op
    thread each (they share the CPU)."""
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(_env(), OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, "-c", script, coord, str(pid),
                              *args], env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
            for pid in range(n)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(workers, references)``: the two workers and one reference
    subprocess a layout, all started at once; each writes its results
    into a file of its own."""
    tmp = tmp_path_factory.mktemp("serve_dist")
    procs = _workers(WORKER, 2, str(tmp))
    procs += [subprocess.Popen([sys.executable, "-W", "ignore", "-c", REF,
                                lay, str(tmp)], env=_env(),
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                               text=True)
              for lay in LAYOUTS]
    outs = _finish(procs, timeout=600)
    for rc, so, se in outs:
        assert rc == 0, (so[-1500:], se[-3000:])

    def load(name):
        with open(tmp / name) as f:
            return json.load(f)
    return ([load(f"worker{pid}.json") for pid in (0, 1)],
            {lay: load(f"ref_{lay}.json") for lay in LAYOUTS})


def test_both_processes_return_the_same(runs):
    workers, _ = runs
    same = [{k: v for k, v in w.items() if k != "local_rows"}
            for w in workers]
    assert same[0] == same[1]
    assert workers[0]["local_rows"] == [[0, 2], [0, 1]]
    assert workers[1]["local_rows"] == [[2, 4], [1, 2]]


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("part", PARTS)
def test_parts_match_reference(runs, layout, part):
    """Each part of the scenario on two processes equals the reference's
    on one mesh of the same shape: statuses, reasons, results, rounds,
    batch attribution, cache deltas, the ledger and the counters."""
    workers, refs = runs
    for w in workers:
        assert w[layout][part] == refs[layout][part], (layout, part)


def test_skewed_clock_changes_no_decision(runs):
    """Rank 1's clock past every deadline: rank 0 decides, nothing
    expires on either process. Rank 0's past them: both expire all."""
    workers, _ = runs
    ahead1, ahead0 = workers[0]["clock"]
    assert workers[1]["clock"] == [ahead1, ahead0]
    assert [r[2] for r in ahead1[0]] == ["ok"] * 8
    assert [r[2] for r in ahead0[0]] == ["failed"] * 8
    assert all("deadline" in r[4] for r in ahead0[0])


def test_agreements_are_rank_0s_and_counted(runs):
    """``agree`` gives rank 0's value on both processes, or ``pick`` of
    every process's; ``stats`` counts each call and its seconds."""
    workers, _ = runs
    for w in workers:
        assert w["agree"] == [0, 1, 2, True]


def test_host_loss_keeps_every_process(runs):
    """Keeping 2 of 4 shards leaves one a process; every request is
    served, equal to the one-process server's responses, ledger and
    counters on a virtual fabric of the same shape."""
    from test_torch_serve import port_api
    workers, _ = runs
    want = json.loads(json.dumps(host_loss(port_api(), 2)))
    for w in workers:
        assert w["host_loss"][0] == want
    assert want[2:] == [1, 2, [2]]
    assert [r[2] for r in want[0]] == ["ok"] * 12


def test_host_loss_that_does_not_split_raises(runs):
    workers, _ = runs
    for w in workers:
        kind, msg = w["host_loss"][1]
        assert kind == "raised" and "do not split over 2 processes" in msg


# ---------------------------------------------------------------------------
# on the card: two processes sharing cuda:0
# ---------------------------------------------------------------------------

CUDA_WORKER = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
sys.path.insert(0, os.environ['TESTS_DIR'])
from test_torch_serve import TENANTS, WIDTH, _sig, wiki
from repro_torch.configs import get_config
from repro_torch.core.dispatch import MeshInfo
from repro_torch.core.fabric import Fabric
from repro_torch.models.moe import moe_params_from_numpy
from repro_torch.serve import MoEService, ProgramServer, Request
from repro_torch.sparse import datasets

coord, pid = sys.argv[1], int(sys.argv[2])
fab = Fabric.distributed((2, 2), ('portal', 'data'), coordinator_address=coord,
                         num_processes=2, process_id=pid, device='cuda:0',
                         timeout=120)
g = wiki(datasets)
reqs = [Request(i, TENANTS[i % 4], 'bfs' if i % 2 == 0 else 'sssp', 'wiki',
                root=(i * 13) % g.n) for i in range(16)]
srv = ProgramServer(fab, {'wiki': g}, batch_width=WIDTH)
srv.prewarm(('bfs', 'sssp'))
res = {'serve': _sig(srv.run(reqs))}
cfg = get_config('olmoe-1b-7b').reduced()
w = np.load(os.environ['MOE_WEIGHTS'])
params = moe_params_from_numpy({k: w[k] for k in ('router', 'wg', 'wu', 'wd')},
                               device='cuda:0')
info = MeshInfo(Fabric.distributed((2, 1, 2, 2), ('pod', 'data', 'expert',
                                                  'tp'), device='cuda:0'),
                pod_axis='pod')
svc = MoEService(cfg, params, info, batch=2, seq=16)
msrv = ProgramServer(info.mesh, {}, moe=svc)
resps = msrv.run([Request(i, f'm{i}', 'moe', payload=w['x'][i])
                  for i in range(2)])
res['moe'] = [r.result.tolist() for r in resps]
res['traces'] = svc.traces
dist.destroy_process_group()
print('RESULT ' + json.dumps(res), flush=True)
"""


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the route kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_server_and_moe_lane_across_two_processes(card, tmp_path):
    """Two processes sharing the card serve the 16-request stream on
    (2, 2) pods equal to the one-process server on the card, and one MoE
    lane dispatch on the two-stage packaging (the portal stage across
    them) within 1e-5 of max|out| of ``moe_dcra`` on the virtual
    packaging."""
    from repro_torch.configs import get_config
    from repro_torch.core.dispatch import MeshInfo, moe_dcra
    from repro_torch.core.fabric import Fabric
    from repro_torch.models.moe import moe_params_from_numpy
    from repro_torch.serve import ProgramServer, Request
    from repro_torch.sparse import datasets
    cfg = get_config("olmoe-1b-7b").reduced()
    rng = np.random.default_rng(5)
    E, D, F = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_expert
    w = {"router": rng.standard_normal((D, E)) * 0.1,
         "wg": rng.standard_normal((E, D, F)) * 0.1,
         "wu": rng.standard_normal((E, D, F)) * 0.1,
         "wd": rng.standard_normal((E, F, D)) * 0.1,
         "x": rng.standard_normal((2, 16, D))}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    path = tmp_path / "moe.npz"
    np.savez(path, **w)
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(_env(), MOE_WEIGHTS=str(path))
    procs = [subprocess.Popen([sys.executable, "-c", CUDA_WORKER, coord,
                               str(pid)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for pid in range(2)]
    outs = _finish(procs, timeout=600)
    for rc, so, se in outs:
        assert rc == 0, (so[-1500:], se[-3000:])
    got = [_result(so) for _, so, _ in outs]
    assert got[0] == got[1]
    g = wiki(datasets)
    reqs = [Request(i, TENANTS[i % 4], "bfs" if i % 2 == 0 else "sssp",
                    "wiki", root=(i * 13) % g.n) for i in range(16)]
    srv = ProgramServer(Fabric.virtual((2, 2), ("portal", "data"),
                                       device=card), {"wiki": g},
                        batch_width=WIDTH)
    assert got[0]["serve"] == json.loads(json.dumps(_sig(srv.run(reqs))))
    params = moe_params_from_numpy({k: w[k] for k in ("router", "wg", "wu",
                                                      "wd")}, device=card)
    info = MeshInfo(Fabric.virtual((2, 1, 2, 2), ("pod", "data", "expert",
                                                  "tp"), device=card),
                    pod_axis="pod")
    want, _ = moe_dcra(params, torch.from_numpy(w["x"]).to(card), cfg, info)
    want = want.cpu().numpy()
    err = np.abs(np.asarray(got[0]["moe"], np.float32) - want).max()
    assert err <= 1e-5 * np.abs(want).max()
    assert got[0]["traces"] == 1
