"""int8 error-feedback gradient compression across two processes: the
gloo counterpart of ``tests/test_compression_distributed.py``.

Two subprocesses join one gloo group on 127.0.0.1 through
``Fabric.distributed(..., device="cpu")``; beside them one JAX
subprocess runs the reference's script (read out of
``tests/test_compression_distributed.py``) on 8 fake devices; all three
start at once. In the workers:

* ``compress_psum`` over one axis of a 2 x 2 ``("data", "model")``
  fabric (``data`` crosses the processes, ``model`` does not) and over
  both, and ``Fabric.psum`` over each, equal bit for bit to the
  one-process virtual fabric's results on the same shards, summed in
  the processes' order (:class:`ProcessOrder`);
* ``Fabric.psum`` over the axes of a 2 x 2 x 2 fabric that cross, stay
  within, or do both, likewise;
* the least-squares data-parallel run of the reference's script on 8
  shards (4 a process), gradients averaged exactly (``psum / 8``) or
  through ``compress_psum``: both reach the reference's max|w - w*|
  within 1e-5, and the one-process run's (in the processes' order)
  exactly.
"""
import ast
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.fabric import Fabric
from repro_torch.optim import compression as comp
from repro_torch.optim.adamw import AdamW

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
REFERENCE = os.path.join(os.path.dirname(__file__),
                         "test_compression_distributed.py")
AXES = {"data": "data", "model": "model", "both": ("data", "model")}
#: the 2 x 2 x 2 fabric's sums: across the processes, within, both
AXES3 = {"data": ("data",), "model,tp": ("model", "tp"),
         "data,model": ("data", "model"), "all": ("data", "model", "tp")}

WORKER = r"""
import json, sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[3])
from test_torch_compression_distributed import (AXES3, cube_inputs,
                                                dp_run, shard_inputs)
from repro_torch.core.fabric import Fabric
from repro_torch.optim import compression as comp

coord, pid = sys.argv[1], int(sys.argv[2])
fab = Fabric.distributed((2, 2), ("data", "model"),
                         coordinator_address=coord, num_processes=2,
                         process_id=pid, device="cpu", timeout=60)
g, r = (fab.local_rows(t) for t in shard_inputs())
res = {"dcn_axes": list(fab.dcn_axes())}
for name, axes in (("data", "data"), ("model", "model"),
                   ("both", ("data", "model"))):
    out, ef = comp.compress_psum({"g": g}, comp.EFState({"g": r}), fab, axes)
    res[name] = {"mean": fab.gather_shards(out["g"]).tolist(),
                 "residual": fab.gather_shards(ef.residual["g"]).tolist(),
                 "psum": fab.gather_shards(fab.psum(g, axes)).tolist()}
fab3 = Fabric.distributed((2, 2, 2), ("data", "model", "tp"),
                          device="cpu")
x3 = fab3.local_rows(cube_inputs())
res["3d"] = {name: fab3.gather_shards(fab3.psum(x3, axes)).tolist()
             for name, axes in AXES3.items()}
fab8 = Fabric.distributed((8,), ("data",), device="cpu")
res["dp"] = {str(c): dp_run(fab8, c) for c in (False, True)}
print("RESULT " + json.dumps(res), flush=True)
"""


class ProcessOrder(Fabric):
    """A virtual fabric whose sums run in the order of the same fabric
    over two processes: over every axis, each half's rows summed, then
    the two halves (``Fabric.gsum`` and gloo's ``all_reduce``); over axes
    some of which each process holds whole, those first."""

    def psum(self, x, axes):
        dims = self.axis_dims(axes)
        if len(dims) == len(self.shape):
            half = x.shape[0] // 2
            return (x[:half].sum(0, keepdim=True)
                    + x[half:].sum(0, keepdim=True)).expand_as(x)
        inner = [self.axis_names[d] for d in dims if d > 0]
        if dims and dims[0] == 0 and inner:
            return super().psum(super().psum(x, inner), self.axis_names[0])
        return super().psum(x, axes)


def cube_inputs():
    """Per-shard values ``[8, 5, 3]`` of the 2 x 2 x 2 cases."""
    rng = np.random.default_rng(4)
    return torch.from_numpy(rng.standard_normal((8, 5, 3)).astype(np.float32))


def shard_inputs():
    """Per-shard gradients and residuals ``[4, 5, 3]`` of the 2 x 2 cases,
    from a seeded numpy generator."""
    rng = np.random.default_rng(3)
    g = rng.standard_normal((4, 5, 3)).astype(np.float32)
    r = (rng.standard_normal((4, 5, 3)) * 0.01).astype(np.float32)
    return torch.from_numpy(g), torch.from_numpy(r)


def dp_run(fab, compress):
    """The reference script's run on ``fab`` (8 shards over ``data``, all
    of them or this process's): least squares on X [64, 16] from seed 0,
    AdamW at 0.05, 150 steps; max|w - w*|."""
    rng = np.random.default_rng(0)
    w_star = torch.from_numpy(rng.normal(0, 1, (16,)).astype(np.float32))
    X = torch.from_numpy(rng.normal(0, 1, (64, 16)).astype(np.float32))
    y = X @ w_star
    # a distributed fabric's shard gives this process's rows
    Xs = fab.shard(X, ("data",))
    ys = fab.shard(y, ("data",))
    n_loc = fab.n_local_shards
    opt = AdamW(lr=lambda s: 0.05, weight_decay=0.0, clip_norm=0.0)
    params = {"w": torch.zeros(16)}
    state = opt.init(params)
    ef = comp.init_ef({"w": torch.zeros(n_loc, 16)})
    for _ in range(150):
        w = params["w"].detach().expand(n_loc, 16).clone().requires_grad_(True)
        loss = ((Xs @ w[..., None])[..., 0] - ys).square().mean(1).sum()
        (g,) = torch.autograd.grad(loss, [w])
        if compress:
            gs, ef = comp.compress_psum({"w": g}, ef, fab, ("data",))
            mean = gs["w"]
        else:
            mean = fab.psum(g, "data") / 8
        params, state = opt.update({"w": mean[0]}, state, params)
    return float((params["w"] - w_star).abs().max())


def _reference_script():
    tree = ast.parse(open(REFERENCE).read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and node.targets[0].id == "SCRIPT":
            return ast.literal_eval(node.value)
    raise AssertionError("no SCRIPT in the reference's test")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _result(stdout):
    lines = [ln for ln in stdout.splitlines() if ln.startswith("RESULT ")]
    assert lines, stdout[-2000:]
    return json.loads(lines[0][len("RESULT "):])


@pytest.fixture(scope="module")
def runs():
    """``(worker 0's, worker 1's, the reference's)`` results; every
    process waited for at most 300 s and none left running. The
    reference starts once both workers have exited, so that its 8 XLA
    host devices do not compete with the workers for the CPU (under load
    they pushed its collectives past XLA's rendezvous timeout)."""
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    here = os.path.dirname(os.path.abspath(__file__))
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, coord, str(pid),
                               here], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for pid in (0, 1)]
    outs = []
    try:
        for p in list(procs):
            so, se = p.communicate(timeout=300)
            outs.append((p.returncode, so, se))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _reference_script()], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        so, se = procs[-1].communicate(timeout=300)
        outs.append((procs[-1].returncode, so, se))
    finally:
        for p in procs:
            p.kill()
            p.communicate()
    for rc, so, se in outs:
        assert rc == 0, (so[-1500:], se[-3000:])
    return [_result(so) for _, so, _ in outs]


def test_both_workers_return_the_same_global_results(runs):
    a, b, _ = runs
    assert a == b
    assert a["dcn_axes"] == ["data"]


@pytest.mark.parametrize("name", list(AXES))
def test_compress_psum_across_processes_equals_the_virtual_fabric(runs, name):
    fab = ProcessOrder.virtual((2, 2), ("data", "model"), device="cpu")
    g, r = shard_inputs()
    out, ef = comp.compress_psum({"g": g}, comp.EFState({"g": r}), fab,
                                 AXES[name])
    got = runs[0][name]
    assert np.array_equal(np.array(got["mean"], np.float32), out["g"].numpy())
    assert np.array_equal(np.array(got["residual"], np.float32),
                          ef.residual["g"].numpy())
    assert np.array_equal(np.array(got["psum"], np.float32),
                          fab.psum(g, AXES[name]).numpy())


@pytest.mark.parametrize("name", list(AXES3))
def test_psum_across_processes_sums_local_axes_first(runs, name):
    """Over the axes each process holds whole no rows cross; over those
    and ``data`` the local sums come first; over every axis, ``gsum``."""
    fab = ProcessOrder.virtual((2, 2, 2), ("data", "model", "tp"),
                               device="cpu")
    want = fab.psum(cube_inputs(), AXES3[name])
    assert np.array_equal(np.array(runs[0]["3d"][name], np.float32),
                          want.numpy())


def test_data_parallel_across_processes_reaches_the_reference(runs):
    """Exact < 0.05 and compressed < 0.15 as the reference's test asserts;
    both within 1e-5 of the reference's max|w - w*| and equal to the
    one-process run on ``ProcessOrder.fake(8)``."""
    dp, want = runs[0]["dp"], runs[2]
    fab = ProcessOrder.fake(8, device="cpu")
    for compress, key in ((False, "exact"), (True, "compressed")):
        got = dp[str(compress)]
        assert abs(got - want[key]) <= 1e-5, (key, got, want[key])
        assert got == dp_run(fab, compress)
    assert dp["False"] < 0.05 and dp["True"] < 0.15
