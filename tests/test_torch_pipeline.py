"""The port's pipelined rounds against its lockstep rounds and the JAX
package, on the CPU.

Part A — the split-phase routing of ``repro_torch.core.routing``:
``owner_route_start`` / ``owner_route_finish`` give ``owner_route``'s and
``owner_route_hier``'s receive buffers with the signal summed over all
shards; ``local_route_reduce`` is bit-identical to bucket + reduce and to
the reference's function on the same numpy inputs, drops included.

Part B — the cases of ``tests/test_pipeline.py`` Part B
(``wiki_like(256, 8, seed 7)`` on 1/2/4/8 flat shards at cap 2 and
factor 4, and 2 x 4 pod/portal): the port's pipelined results equal its
lockstep results bit for bit, and rounds and per-round message and drop
counts equal the reference's pipelined run's exactly; states equal the
reference's exactly for min and whole-number add, and within float32
summation error for PageRank. The reference runs in one subprocess on 8
fake host devices.

The module imports nothing of the reference at top level, so the
``cuda`` tests run on a card whose host has no JAX:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_pipeline.py``.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import routing as trouting
from repro_torch.core.fabric import Fabric
from repro_torch.kernels import route as kroute
from repro_torch.sparse import datasets as tdata
from repro_torch.sparse import program as tprogram
from repro_torch.sparse.options import LaunchOptions
from repro_torch.sparse.torch_apps import PROGRAMS

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
EPS = float(np.finfo(np.float32).eps)            # 2^-23

PARAMS = {"bfs": {"root": 0}, "sssp": {"root": 0}, "wcc": {},
          "pagerank": {"damping": 0.85, "iters": 4}, "kcore": {"k": 8.0}}
ITER_APPS = tuple(PARAMS)

# name -> (app, fabric shape, launch kwargs): tests/test_pipeline.py Part B
CASES = {}
for _n in (1, 2, 4, 8):
    for _app in (ITER_APPS if _n in (1, 8) else ("bfs",)):
        CASES[f"{_app}/flat{_n}/cap2"] = (_app, (_n,), {"cap": 2})
        if _n == 8:
            CASES[f"{_app}/flat8/cf4"] = (_app, (8,), {"capacity_factor": 4.0})
for _app, _cf in (("bfs", 0.25), ("bfs", 4.0), ("pagerank", 0.5)):
    CASES[f"{_app}/pod2x4/cf{_cf}"] = (_app, (2, 4), {"capacity_factor": _cf})


def graph():
    return tdata.wiki_like(256, avg_degree=8, seed=7)


def fabric_of(shape, device="cpu"):
    names = ("data",) if len(shape) == 1 else ("pod", "data")
    return Fabric.virtual(shape, names, device=device)


def options_of(shape, kw, round_mode):
    return LaunchOptions(pod_axis="pod" if len(shape) == 2 else None,
                         round_mode=round_mode, **kw)


# ---------------------------------------------------------------------------
# Part A: split-phase routing
# ---------------------------------------------------------------------------

def _tasks(seed, s, n, n_items):
    gen = torch.Generator().manual_seed(seed)
    dest = torch.randint(0, n_items, (s, n), generator=gen,
                         dtype=torch.int32)
    vals = torch.rand(s, n, generator=gen)
    valid = torch.rand(s, n, generator=gen) < 0.8
    sig = torch.randint(0, 1000, (s,), generator=gen, dtype=torch.int32)
    return dest, vals, valid, sig


@pytest.mark.parametrize("cap", [2, 16, 64])
def test_owner_route_start_finish_equals_owner_route(cap):
    s, n, n_local = 8, 64, 24
    dest, vals, valid, sig = _tasks(cap, s, n, s * n_local)
    owner, slot = dest % s, dest // s
    want = trouting.owner_route(vals, slot, owner, valid, s, cap)
    recv, meta, nd, gsig = trouting.owner_route_start(
        vals, slot, owner, valid, s, cap, sig)
    got = trouting.owner_route_finish(recv, meta)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(nd, want[2])
    assert torch.equal(gsig, sig.sum().to(torch.int32).expand(s))
    assert (cap > 2) or int(nd.sum()) > 0          # cap 2 drops


@pytest.mark.parametrize("pods", [(2, 4), (4, 2)])
@pytest.mark.parametrize("caps", [(2, 4), (16, 64)])
def test_owner_route_hier_start_finish_equals_owner_route_hier(pods, caps):
    n_pods, n_intra = pods
    s, n, n_local = n_pods * n_intra, 64, 24
    dest, vals, valid, sig = _tasks(caps[0] + n_pods, s, n, s * n_local)
    owner, slot = dest % s, dest // s
    want = trouting.owner_route_hier(vals, slot, owner, valid, n_intra,
                                     n_pods, *caps)
    recv, meta, nd, gsig = trouting.owner_route_hier_start(
        vals, slot, owner, valid, n_intra, n_pods, *caps, sig)
    got = trouting.owner_route_finish(recv, meta)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(nd, want[2])
    # the signal crossed both stages: the global sum on every shard
    assert torch.equal(gsig, sig.sum().to(torch.int32).expand(s))


def _fold_inputs(s):
    rng = np.random.default_rng(5)
    n, nb, cap, n_local = 512, 8, 16, 64          # 512 >> nb*cap: drops
    dest = rng.integers(0, nb, (s, n)).astype(np.int32)
    valid = rng.random((s, n)) < 0.8
    vals = rng.random((s, n)).astype(np.float32)
    slots = rng.integers(0, n_local, (s, n)).astype(np.int32)
    return dest, valid, vals, slots, nb, cap, n_local


@pytest.mark.parametrize("op", ["min", "store"])
@pytest.mark.parametrize("impl", ["pallas", "sort", "onehot"])
def test_local_route_reduce_is_bucket_plus_reduce(op, impl):
    dest, valid, vals, slots, nb, cap, n_local = map(
        lambda a: torch.from_numpy(a) if isinstance(a, np.ndarray) else a,
        _fold_inputs(2))
    xb, (slot_b,), _, nd_ref = trouting.bucket(vals[..., None], dest, valid,
                                               [slots], nb, cap, impl=impl)
    want = trouting.reduce_received(slot_b, xb[..., 0], n_local, op,
                                    impl=impl)
    got, nd = trouting.local_route_reduce(vals, slots, dest, valid, nb, cap,
                                          n_local, op, impl=impl)
    assert torch.equal(nd, nd_ref) and int(nd.sum()) > 0
    assert torch.equal(got, want)


@pytest.mark.parametrize("op", ["min", "store"])
def test_local_route_reduce_matches_reference(op):
    import jax.numpy as jnp
    from repro.core.routing import local_route_reduce as jlocal
    dest, valid, vals, slots, nb, cap, n_local = _fold_inputs(1)
    got, nd = trouting.local_route_reduce(
        torch.from_numpy(vals), torch.from_numpy(slots),
        torch.from_numpy(dest), torch.from_numpy(valid), nb, cap, n_local,
        op)
    want, nd_ref = jlocal(jnp.asarray(vals[0]), jnp.asarray(slots[0]),
                          jnp.asarray(dest[0]), jnp.asarray(valid[0]), nb,
                          cap, n_local, op)
    assert int(nd[0]) == int(nd_ref) > 0
    assert np.array_equal(got[0].numpy(), np.asarray(want))


def test_local_route_reduce_refuses_add():
    dest, valid, vals, slots, nb, cap, n_local = map(
        lambda a: torch.from_numpy(a) if isinstance(a, np.ndarray) else a,
        _fold_inputs(1))
    with pytest.raises(ValueError, match="order-insensitive"):
        trouting.local_route_reduce(vals, slots, dest, valid, nb, cap,
                                    n_local, "add")


def test_one_shard_pipelined_ranks_and_never_scatters(monkeypatch):
    """On one flat shard a min-reduce pipelined round folds the receive
    into admission: the rank wrapper runs, the bucket scatter does not."""
    calls = {"bucket_rank": 0, "bucket_scatter": 0}
    for name in calls:
        real = getattr(kroute, name)

        def spy(*a, _real=real, _name=name):
            calls[_name] += 1
            return _real(*a)
        monkeypatch.setattr(kroute, name, spy)
    g = graph()
    fab = fabric_of((1,))
    (d_l,), s_l = tprogram.run_program(PROGRAMS["bfs"], g, fab,
                                       params={"root": 0})
    assert calls == {"bucket_rank": 0, "bucket_scatter": s_l.rounds}
    calls.update(bucket_rank=0, bucket_scatter=0)
    (d_p,), s_p = tprogram.run_program(
        PROGRAMS["bfs"], g, fab, params={"root": 0},
        options=LaunchOptions(round_mode="pipelined"))
    assert calls["bucket_scatter"] == 0
    assert calls["bucket_rank"] == s_p.rounds + 1     # and one unreal
    assert np.array_equal(d_l, d_p) and s_l.rounds == s_p.rounds


def test_round_mode_is_a_cache_key_dimension():
    g = graph()
    fab = fabric_of((4,))
    tprogram.clear_cache()
    for mode, misses in (("lockstep", 1), ("pipelined", 2),
                         ("pipelined", 2)):
        tprogram.run_program(PROGRAMS["bfs"], g, fab, params={"root": 0},
                             options=LaunchOptions(round_mode=mode))
        assert tprogram.cache_stats()["misses"] == misses
    # no rounds, nothing to overlap: a pipelined launch of 0 rounds runs
    # (and is keyed) as lockstep
    tprogram.clear_cache()
    for mode in ("lockstep", "pipelined"):
        (d,), st = tprogram.run_program(
            PROGRAMS["bfs"], g, fab, params={"root": 0}, max_rounds=0,
            options=LaunchOptions(round_mode=mode))
        assert st.rounds == 0 and d[0] == 0.0
    assert tprogram.cache_stats()["misses"] == 1
    assert tprogram.cache_keys()[0][11] == "lockstep"


def test_pipelined_while_loop_reads_the_host_once_an_iteration():
    """The lockstep loop reads convergence after each of its rounds; the
    pipelined loop runs one unreal iteration more and reads one flag
    after each iteration but the first: as many reads. A fixed-mode loop
    reads none."""
    g = graph()
    fab = fabric_of((8,))
    for mode in ("lockstep", "pipelined"):
        tprogram.reset_host_reads()
        _, st = tprogram.run_program(PROGRAMS["bfs"], g, fab,
                                     params={"root": 0},
                                     options=LaunchOptions(round_mode=mode))
        assert tprogram.HOST_READS["reads"] == st.rounds > 1
    tprogram.reset_host_reads()
    tprogram.run_program(PROGRAMS["pagerank"], g, fab,
                         params=PARAMS["pagerank"],
                         options=LaunchOptions(round_mode="pipelined"))
    assert tprogram.HOST_READS["reads"] == 0


def test_max_rounds_caps_pipelined_iterations():
    g = graph()
    fab = fabric_of((8,))
    for max_rounds in (1, 2, 3):
        got = [tprogram.run_program(
            PROGRAMS["bfs"], g, fab, params={"root": 0},
            max_rounds=max_rounds, options=LaunchOptions(round_mode=mode))
            for mode in ("lockstep", "pipelined")]
        assert np.array_equal(got[0][0][0], got[1][0][0])
        assert got[0][1].rounds == got[1][1].rounds == max_rounds
        assert np.array_equal(got[0][1].messages, got[1][1].messages)


# ---------------------------------------------------------------------------
# Part B: the reference's Part B cases
# ---------------------------------------------------------------------------

SCRIPT = r"""
import os
os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=8'
import json, sys
import jax
import numpy as np
from repro.core.compat import make_mesh
from repro.sparse import datasets
from repro.sparse.jax_apps import PROGRAMS
from repro.sparse.program import run_program
sys.path.insert(0, os.environ['TESTS_DIR'])
from test_torch_pipeline import CASES, PARAMS

g = datasets.wiki_like(256, avg_degree=8, seed=7)
res = {}
for name, (app, shape, kw) in CASES.items():
    mesh = make_mesh(shape, ('data',) if len(shape) == 1 else ('pod', 'data'))
    kw = dict(kw, pod_axis='pod') if len(shape) == 2 else dict(kw)
    out, st = run_program(PROGRAMS[app], g, mesh, params=PARAMS[app],
                          round_mode='pipelined', **kw)
    res[name] = {'state': [np.asarray(a, np.float64).tolist()
                           for a in jax.tree_util.tree_leaves(out)],
                 'rounds': int(st.rounds), 'messages': st.messages.tolist(),
                 'drops': st.drops.tolist()}
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


def run_both(app, shape, kw, device="cpu"):
    g = graph()
    fab = fabric_of(shape, device)
    return [tprogram.run_program(PROGRAMS[app], g, fab, params=PARAMS[app],
                                 options=options_of(shape, kw, mode))
            for mode in ("lockstep", "pipelined")]


def assert_same_run(a, b):
    (sa, ta), (sb, tb) = a, b
    assert len(sa) == len(sb)
    for x, y in zip(sa, sb):
        assert np.array_equal(x, y)
    assert ta.rounds == tb.rounds
    assert np.array_equal(ta.messages, tb.messages)
    assert np.array_equal(ta.drops, tb.drops)


@pytest.mark.parametrize("case", list(CASES))
def test_pipelined_is_bit_identical_to_lockstep(case):
    lock, pipe = run_both(*CASES[case])
    assert_same_run(lock, pipe)


@pytest.mark.parametrize("case", list(CASES))
def test_pipelined_matches_reference(reference, case):
    app = CASES[case][0]
    states, st = run_both(*CASES[case])[1]
    want = reference[case]
    assert st.rounds == want["rounds"]
    assert st.messages.tolist() == want["messages"]
    assert st.drops.tolist() == want["drops"]
    assert len(states) == len(want["state"])
    for got, exp in zip(states, want["state"]):
        exp = np.asarray(exp, np.float64)
        if app == "pagerank":
            # as tests/test_torch_stream.py: at most (2 / 0.85 + 4) ulp of
            # the largest rank a round
            tol = (PARAMS[app]["iters"] * (2 / 0.85 + 4) * EPS
                   * np.max(np.abs(exp)))
            assert np.max(np.abs(got - exp)) <= tol
        else:
            assert np.array_equal(got, exp)


def test_tight_caps_drop_under_pipelining(reference):
    """cap 2 must overflow for every app, or the drop-stream agreement
    is vacuous."""
    for app in ITER_APPS:
        tight = [reference[c]["drops"] for c in CASES
                 if c.startswith(app + "/") and c.endswith("cap2")]
        assert any(sum(d) > 0 for d in tight), app


def test_pod_portal_cases_cover_both_programs():
    pods = [c for c in CASES if "/pod" in c]
    assert {c.split("/")[0] for c in pods} == {"bfs", "pagerank"}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the route kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bfs/flat1/cap2", "bfs/flat8/cf4",
                                  "sssp/flat8/cap2", "wcc/flat1/cap2",
                                  "bfs/pod2x4/cf0.25", "kcore/flat8/cap2"])
def test_cuda_pipelined_is_bit_identical_to_lockstep(card, case):
    app, shape, kw = CASES[case]
    lock, pipe = run_both(app, shape, kw, device=card)
    assert_same_run(lock, pipe)
    cpu = run_both(app, shape, kw)[1]
    assert_same_run(pipe, cpu)


@pytest.mark.cuda
def test_cuda_pipelined_pagerank_streams_equal_lockstep(card):
    """PageRank's add reduce is a float32 atomicAdd on the card: its
    order varies, so ranks are held to float32 summation error and the
    message and drop streams exactly."""
    (sl, tl), (sp, tp) = run_both("pagerank", (8,), {"cap": 2}, card)
    assert tl.rounds == tp.rounds == PARAMS["pagerank"]["iters"]
    assert np.array_equal(tl.messages, tp.messages)
    assert np.array_equal(tl.drops, tp.drops)
    tol = 2 * PARAMS["pagerank"]["iters"] * (2 / 0.85 + 4) * EPS * np.max(
        np.abs(sl[0]))
    assert np.max(np.abs(sl[0] - sp[0])) <= tol
