"""``moe_dcra`` across processes against the port's virtual fabric and the
JAX package, on the CPU.

``tests/test_torch_moe.py``'s ``CASES`` (fused, tp-sharded FFN and
two-stage packagings, two experts a shard, a sequence that does not
split over the group, and each with a capacity factor that drops) run in
gloo processes that each hold their rows of the shards:

* the flat (data 2, expert 2, tp 2) cases over 2 processes, so the data
  axis crosses them, and over 4, so the expert exchange crosses too;
* the (pod 2, data 1, expert 2, tp 2) cases over 2 processes, one pod
  each, so the portal stage crosses.

Every process is handed the same global tokens and weights (the
reference's ``init_moe`` values). Its ``out``, ``aux``, top-k ids, every
bucket's admitted and dropped counts, and the gradients of ``sum(out *
cot)`` (the four weights and x) and of ``aux`` (the router and x) must
equal the port's virtual fabric bit for bit, on every process, and the
reference's (one JAX subprocess on 8 fake host devices, started beside
the workers) within ``tests/test_torch_moe.py``'s bounds. The workers and
the virtual run take one intra-op thread each.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_moe_cases import WEIGHTS, run_case
from test_torch_moe import CASES, FLAT, PODS, SCRIPT
from test_torch_scaleout import SRC, TESTS_DIR, _finish, _free_port

PG_TIMEOUT = 60                       # seconds, the workers' process group

#: process count -> the cases that group runs
GROUPS = {2: [n for n in CASES], 4: [n for n in CASES if CASES[n][0] == FLAT]}
RUNS = [(n, p) for p, names in GROUPS.items() for n in names]
assert {CASES[n][0] for n in GROUPS[2]} == {FLAT, PODS}

WORKER = r"""
import json, os, sys
import numpy as np
import torch.distributed as dist
sys.path.insert(0, os.environ['TESTS_DIR'])
from _torch_moe_cases import run_case
from repro_torch.core.fabric import Fabric

coord, pid, world, data_path, out_path = sys.argv[1:6]
pid, world = int(pid), int(world)
cases = json.loads(sys.argv[6])
data = dict(np.load(data_path))
res = {}
for name, spec in cases.items():
    shape, names = spec[0]
    fab = Fabric.distributed(shape, names, coordinator_address=coord,
                             num_processes=world, process_id=pid,
                             device='cpu', timeout=int(os.environ['PG']))
    res.update(run_case(name, spec, fab, data))
np.savez(out_path, **res)
dist.destroy_process_group()
print('RESULT ok', flush=True)
"""


def _inputs():
    """Each case's weights (the reference's ``init_moe`` at
    ``key(experts)``), tokens and cotangent, as the reference's script
    draws them."""
    import jax
    from repro.configs import get_config as j_get_config
    from repro.models.moe import init_moe
    base = j_get_config("olmoe-1b-7b").reduced()
    data = {}
    for name, (_, _, experts, factor, shape, skew) in CASES.items():
        cfg = dataclasses.replace(base, moe=dataclasses.replace(
            base.moe, num_experts=experts, capacity_factor=factor))
        for k, v in init_moe(jax.random.key(experts), cfg).items():
            data[f"{name}/param/{k}"] = np.asarray(v)
        rng = np.random.default_rng(sum(shape) + experts)
        x = rng.standard_normal(shape) + skew * rng.standard_normal(shape[-1])
        data[f"{name}/x"] = x.astype(np.float32)
        data[f"{name}/cot"] = np.random.default_rng(
            99 + experts).standard_normal(shape).astype(np.float32)
    return data


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(virtual, workers, reference)``: the virtual fabric's results in
    this process; each group's processes' results by ``(process count,
    pid)``; the reference's arrays. The workers and the reference start
    at once."""
    from repro_torch.core.fabric import Fabric
    tmp = tmp_path_factory.mktemp("moe_dist")
    data = _inputs()
    np.savez(tmp / "inputs.npz", **data)
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), TESTS_DIR=TESTS_DIR,
               PG=str(PG_TIMEOUT))
    procs, outs = [], []
    for world, names in GROUPS.items():
        coord = f"127.0.0.1:{_free_port()}"
        cases = json.dumps({n: CASES[n] for n in names})
        for pid in range(world):
            outs.append((world, pid, tmp / f"w{world}_{pid}.npz"))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", WORKER, coord, str(pid), str(world),
                 str(tmp / "inputs.npz"), str(outs[-1][2]), cases],
                env=dict(env, OMP_NUM_THREADS="1"), stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
    ref_path = tmp / "ref.npz"
    procs.append(subprocess.Popen(
        [sys.executable, "-c", SCRIPT, str(ref_path), json.dumps(CASES),
         json.dumps(list(CASES))], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True))
    # one intra-op thread, as the workers: a threaded batched matmul may
    # add its terms in another order
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        virtual = {}
        for name, spec in CASES.items():
            shape, names = spec[0]
            virtual.update(run_case(name, spec, Fabric.virtual(
                shape, names, device="cpu"), data))
    finally:
        torch.set_num_threads(threads)
        done = _finish(procs, timeout=600)
    for rc, so, se in done:
        assert rc == 0, (so[-1500:], se[-3000:])
    workers = {(w, p): dict(np.load(path)) for w, p, path in outs}
    with np.load(ref_path) as z:
        ref = {k: z[k] for k in z.files}
    return virtual, workers, ref


def _keys(name, got):
    return sorted(k for k in got if k.startswith(f"{name}/"))


@pytest.mark.parametrize("name,world", RUNS)
def test_every_process_equals_the_virtual_fabric(runs, name, world):
    """Output, aux, top-k ids, bucket counts and every gradient, bit for
    bit, on every process; the weights' gradients are the global ones
    on each."""
    virtual, workers, _ = runs
    keys = _keys(name, virtual)
    assert {k.split("/", 1)[1] for k in keys} >= (
        {"out", "aux", "topk", "dispatch/admitted", "dispatch/dropped"}
        | {f"grad_out/{k}" for k in WEIGHTS + ("x",)})
    for pid in range(world):
        got = workers[world, pid]
        assert _keys(name, got) == keys
        for k in keys:
            assert np.array_equal(got[k], virtual[k]), (pid, k)


@pytest.mark.parametrize("name,world", RUNS)
def test_processes_match_reference(runs, name, world):
    """Against the reference: out within 1e-5 of max|out|, aux within
    1e-6 relative, every gradient within 1e-5 of its max|g| (the
    reference's ``jax.grad`` through ``shard_map``); drops where the
    factor is under 2, none where it is 8."""
    _, workers, ref = runs
    for pid in range(world):
        got = workers[world, pid]
        want = ref[f"{name}/out"]
        scale = np.abs(want).max()
        assert np.abs(got[f"{name}/out"] - want).max() <= 1e-5 * scale
        a, b = float(got[f"{name}/aux"]), float(ref[f"{name}/aux"])
        assert abs(a - b) <= 1e-6 * abs(b)
        for part, keys in (("grad_out", WEIGHTS + ("x",)),
                           ("grad_aux", ("router", "x"))):
            for k in keys:
                w = ref[f"{name}/{part}/{k}"]
                g = got[f"{name}/{part}/{k}"]
                assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max(), (
                    pid, part, k)
        dropped = sum(int(got[k].sum()) for k in _keys(name, got)
                      if k.endswith("/dropped"))
        assert (dropped > 0) == (CASES[name][3] < 2.0)
