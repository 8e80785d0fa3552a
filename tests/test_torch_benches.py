"""The port's two timing benches, ``repro_torch.figures.route_bench`` and
``repro_torch.figures.serve_bench``, against the reference's
``benchmarks/route_bench.py`` and ``benchmarks/serve_bench.py`` on the
CPU.

``route_bench``: the constants are the reference's; an op cell's inputs
are the reference's arrays and every impl's bucketing equals the
reference's ``bucket(..., impl="onehot")`` on JAX's CPU backend; a round
cell's final state and drop stream, under every impl and round shape,
equal the reference's jitted ``fori_loop``; ``main`` writes an artifact
with the reference's keys that the port's gate accepts.

``serve_bench``: the reference runs in three subprocesses on 4 XLA host
devices (smoke at depth 3, chaos seed 0, the bench artifact at depth 3),
the port in this process on 4 virtual shards of the CPU: the per-tenant
ledger and the launch counters, the chaos line text for text, and the
artifact's non-timing fields are equal.
"""
import contextlib
import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
if ROOT not in sys.path:          # the reference's ``benchmarks`` package
    sys.path.insert(0, ROOT)

from benchmarks import route_bench as jbench                    # noqa: E402
from repro_torch.dse import route_compare, serve_compare        # noqa: E402
from repro_torch.figures import route_bench as tbench           # noqa: E402
from repro_torch.figures import serve_bench as tserve           # noqa: E402

ROUTE_CONSTANTS = ("QUICK_GRID", "FULL_GRID", "ROUND_QUICK_GRID",
                   "ROUND_FULL_GRID", "ROUNDS", "IMPLS", "MODES", "SCHEMA")
OP_CELLS = [(4096, 8), (4096, 64), (16384, 16)]
ROUND_CELLS = [(16384, 16), (65536, 64)]


def _np(t):
    return np.asarray(t)


@pytest.mark.parametrize("name", ROUTE_CONSTANTS)
def test_route_bench_constants_equal_the_reference(name):
    assert getattr(tbench, name) == getattr(jbench, name)


@pytest.mark.parametrize("name", ("PROGRAMS", "BENCH_SCHEMA"))
def test_serve_bench_constants_equal_the_reference(name):
    from benchmarks import serve_bench as jserve
    assert getattr(tserve, name) == getattr(jserve, name)
    assert sorted(tserve.STANDALONE) == sorted(jserve.STANDALONE)


# ---------------------------------------------------------------------------
# route_bench: op cells
# ---------------------------------------------------------------------------

def _reference_op_inputs(n, s):
    """The reference's draws (``benchmarks/route_bench.py:60-64``)."""
    import jax.numpy as jnp
    rng = np.random.default_rng(n + s)
    dest = jnp.asarray(rng.integers(0, s, n), jnp.int32)
    valid = jnp.asarray(rng.random(n) < 0.9)
    vals = jnp.asarray(rng.random((n, 1)), jnp.float32)
    slot_ids = jnp.asarray(rng.integers(0, n, n), jnp.int32)
    return dest, valid, vals, slot_ids


_OP_CACHE = {}


def _reference_op(n, s):
    if (n, s) not in _OP_CACHE:
        from repro.core.queues import round8
        from repro.core.routing import bucket
        cap = round8(2 * n // max(s, 1))
        dest, valid, vals, slot_ids = _reference_op_inputs(n, s)
        xb, (aux,), task_slot, n_drop = bucket(vals, dest, valid, [slot_ids],
                                               s, cap, impl="onehot")
        _OP_CACHE[n, s] = (cap, _np(xb), _np(aux), _np(task_slot),
                           int(n_drop))
    return _OP_CACHE[n, s]


@pytest.mark.parametrize("n,s", OP_CELLS)
def test_op_cell_inputs_are_the_reference_arrays(n, s):
    want = _reference_op_inputs(n, s)
    got = tbench.cell_inputs(n, s, "cpu")
    for key, w in zip(("dest", "valid", "vals", "slot_ids"), want):
        g = got[key][0].numpy()
        assert g.dtype == _np(w).dtype, key
        assert np.array_equal(g, _np(w)), key


@pytest.mark.parametrize("impl", tbench.IMPLS)
@pytest.mark.parametrize("n,s", OP_CELLS)
def test_op_cell_bucketing_equals_the_reference(n, s, impl):
    cap, xb, aux, task_slot, n_drop = _reference_op(n, s)
    assert cap == tbench.round8(2 * n // max(s, 1))
    got_xb, (got_aux,), got_slot, got_drop = tbench.bucket_op(
        tbench.cell_inputs(n, s, "cpu"), s, cap, impl)
    assert np.array_equal(got_xb[0].numpy(), xb)
    assert np.array_equal(got_aux[0].numpy(), aux)
    assert np.array_equal(got_slot[0].numpy(), task_slot)
    assert got_drop.tolist() == [n_drop]


# ---------------------------------------------------------------------------
# route_bench: round cells
# ---------------------------------------------------------------------------

_ROUND_CACHE = {}


def _reference_rounds(n, s, cap=None):
    """The reference's jitted min-relay loop
    (``benchmarks/route_bench.py:110-144``), its ``("onehot",
    "lockstep")`` pair: ``(cap, state, drops)``. The reference asserts
    all six of its pairs equal to this one. ``cap`` defaults to the
    bench's."""
    if (n, s, cap) in _ROUND_CACHE:
        return _ROUND_CACHE[n, s, cap]
    import jax
    import jax.numpy as jnp
    from repro.core.queues import round8
    from repro.core.routing import bucket, reduce_received

    key = (n, s, cap)
    cap = cap or round8(2 * n // max(s, 1))
    n_local = max(n // 4, s)
    rng = np.random.default_rng(n + s + 1)
    src = jnp.asarray(rng.integers(0, n_local, n), jnp.int32)
    dest = jnp.asarray(rng.integers(0, s, n), jnp.int32)
    slot_ids = jnp.asarray(rng.integers(0, n_local, n), jnp.int32)
    w = jnp.asarray(rng.random(n) + 0.05, jnp.float32)
    state0 = jnp.full((n_local,), jnp.inf, jnp.float32).at[0].set(0.0)
    frontier0 = jnp.isfinite(state0)

    def body(_, carry):
        state, frontier, drops, r = carry
        active = frontier[src]
        vals = state[src] + w
        xb, (slot_b,), _, nd = bucket(vals[:, None], dest, active,
                                      [slot_ids], s, cap, impl="onehot")
        upd = reduce_received(slot_b, xb[:, 0], n_local, "min",
                              impl="onehot")
        return (jnp.minimum(state, upd), upd < state, drops.at[r].set(nd),
                r + 1)

    init = (state0, frontier0, jnp.zeros((tbench.ROUNDS,), jnp.int32),
            jnp.int32(0))
    state, _, drops, _ = jax.jit(
        lambda: jax.lax.fori_loop(0, tbench.ROUNDS, body, init))()
    _ROUND_CACHE[key] = (cap, _np(state), _np(drops))
    return _ROUND_CACHE[key]


@pytest.mark.parametrize("mode", tbench.MODES)
@pytest.mark.parametrize("impl", tbench.IMPLS)
@pytest.mark.parametrize("n,s", ROUND_CELLS)
def test_round_cell_state_and_drops_equal_the_reference(n, s, impl, mode):
    cap, want_state, want_drops = _reference_rounds(n, s)
    inp = tbench.round_inputs(n, s, "cpu")
    assert inp["state0"].shape == (1, want_state.shape[0])
    state, drops = tbench.run_rounds(inp, s, cap, impl, mode)
    assert state.dtype == torch.float32 and drops.dtype == torch.int32
    assert np.array_equal(state.numpy(), want_state)
    assert np.array_equal(drops.numpy(), want_drops)
    # the cells the quick grid runs must route something and reach more
    # than the root
    assert np.isfinite(want_state).sum() > 1


@pytest.mark.parametrize("mode", tbench.MODES)
@pytest.mark.parametrize("impl", tbench.IMPLS)
def test_round_drop_stream_equals_the_reference_where_buckets_overflow(
        impl, mode):
    """The bench's caps (twice a bucket's mean) drop nothing; at cap 8
    (16384 tasks into 16 buckets) the last three rounds drop, and the
    drop stream is the reference's."""
    n, s, cap = 16384, 16, 8
    _, want_state, want_drops = _reference_rounds(n, s, cap)
    assert (want_drops > 0).sum() == 3
    state, drops = tbench.run_rounds(tbench.round_inputs(n, s, "cpu"), s,
                                     cap, impl, mode)
    assert np.array_equal(state.numpy(), want_state)
    assert np.array_equal(drops.numpy(), want_drops)


# ---------------------------------------------------------------------------
# route_bench: the artifact
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def route_artifacts(tmp_path_factory):
    """``main --quick --reps 1`` of both packages, each grid cut to one
    small cell alike: ``(reference, port)`` artifacts and the port's
    path."""
    tmp = tmp_path_factory.mktemp("route")
    mp = pytest.MonkeyPatch()
    try:
        for mod in (jbench, tbench):
            mp.setattr(mod, "QUICK_GRID", [(4096, 8)])
            mp.setattr(mod, "ROUND_QUICK_GRID", [(16384, 16)])
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            jbench.main(["--quick", "--reps", "1", "--out",
                         str(tmp / "ref.json")])
            tbench.main(["--quick", "--reps", "1", "--device", "cpu",
                         "--out", str(tmp / "port.json")])
    finally:
        mp.undo()
    ref = json.loads((tmp / "ref.json").read_text())
    port = json.loads((tmp / "port.json").read_text())
    return ref, port, str(tmp / "port.json"), out.getvalue()


def _key_tree(obj):
    if isinstance(obj, dict):
        return {k: _key_tree(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_key_tree(v) for v in obj]
    return type(obj).__name__ if isinstance(obj, (int, float)) else None


def test_route_artifact_has_the_reference_keys(route_artifacts):
    ref, port, _, _ = route_artifacts
    assert sorted(port) == sorted(ref)
    for kind in ("cells", "round_cells"):
        assert len(port[kind]) == len(ref[kind]) == 1
        assert _key_tree(port[kind][0]) == _key_tree(ref[kind][0])
        assert [(c["n"], c["s"], c["cap"]) for c in port[kind]] == \
            [(c["n"], c["s"], c["cap"]) for c in ref[kind]]
    for field in ("schema", "quick", "impls", "backend"):
        assert port[field] == ref[field], field
    assert port["pallas_lowering"] == "plain"
    assert port["round_cells"][0]["rounds"] == ref["round_cells"][0]["rounds"]


def test_route_artifact_prints_the_reference_rows(route_artifacts):
    _, _, _, text = route_artifacts
    rows = [ln.split(",") for ln in text.splitlines() if "_bench," in ln]
    heads = [r[:4] for r in rows]
    assert heads == [["route_bench", "N=4096", "S=8", "cap=1024"],
                     ["round_bench", "N=16384", "S=16", "cap=2048"]] * 2


def test_route_compare_accepts_the_port_artifact(route_artifacts, capsys):
    _, port, path, _ = route_artifacts
    assert all(v > 0 for c in port["cells"]
               for v in c["speedup_vs_onehot"].values())
    assert route_compare.main([path, path]) == 0
    assert "REGRESSED" not in capsys.readouterr().err


# ---------------------------------------------------------------------------
# serve_bench
# ---------------------------------------------------------------------------

SERVE_LEGS = {"smoke": ["--smoke", "--devices", "4", "--depth", "3"],
              "chaos": ["--chaos", "0", "--devices", "4"],
              "bench": ["--devices", "4", "--depth", "3"]}
TIMED_COUNTERS = ("p50_round", "p99_round")


@pytest.fixture(scope="module")
def serve_runs(tmp_path_factory):
    """Each leg of :data:`SERVE_LEGS`: the reference's stdout (a
    subprocess on 4 XLA host devices) and the port's (in process, 4
    virtual shards of the CPU); the bench leg writes ``ref.json`` and
    ``port.json``."""
    tmp = tmp_path_factory.mktemp("serve")
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    runs = {}
    for leg, args in SERVE_LEGS.items():
        extra = ["--bench-out", str(tmp / "ref.json")] if leg == "bench" \
            else []
        ref = subprocess.run([sys.executable, "-m", "benchmarks.serve_bench"]
                             + args + extra, cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=300)
        assert ref.returncode == 0, ref.stderr[-3000:]
        extra = ["--bench-out", str(tmp / "port.json")] if leg == "bench" \
            else []
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            tserve.main(args + extra + ["--device", "cpu"])
        runs[leg] = (ref.stdout, out.getvalue())
    runs["artifacts"] = (json.loads((tmp / "ref.json").read_text()),
                         json.loads((tmp / "port.json").read_text()),
                         str(tmp / "port.json"))
    return runs


def _ledger(text):
    lines = text.splitlines()
    head = lines.index("tenant,submitted,served,rejected,failed,p50_ms,"
                       "p99_ms,p50_wait_ms,p50_device_ms")
    rows = []
    for ln in lines[head + 1:]:
        if ln.startswith("#"):
            break
        rows.append(ln.split(",")[:5])
    return rows


def _counters(text):
    (line,) = [ln for ln in text.splitlines() if ln.startswith("# launches=")]
    pairs = dict(kv.split("=", 1) for kv in line[2:].split())
    return {k: v for k, v in pairs.items() if k not in TIMED_COUNTERS}


def test_serve_smoke_ledger_equals_the_reference(serve_runs):
    ref, port = serve_runs["smoke"]
    assert _ledger(port) == _ledger(ref)
    assert len(_ledger(port)) == 4
    assert all(r[2] == r[1] and r[3:] == ["0", "0"] for r in _ledger(port))


def test_serve_smoke_counters_equal_the_reference(serve_runs):
    ref, port = serve_runs["smoke"]
    assert _counters(port) == _counters(ref)
    assert _counters(port)["re_traces"] == "0"
    assert _counters(port)["noc_drops"] == "0"
    summary = [ln for ln in port.splitlines() if ln.startswith("# devices=")]
    assert len(summary) == 1 and "surface=fabric" in summary[0]
    assert "devices=4 width=4 depth=3" in summary[0]


def test_serve_smoke_result_ok(serve_runs):
    ref, port = serve_runs["smoke"]
    assert ref.splitlines()[-1] == port.splitlines()[-1] == "RESULT ok"


def test_serve_chaos_line_equals_the_reference(serve_runs):
    ref, port = serve_runs["chaos"]
    want = [ln for ln in ref.splitlines() if ln.startswith("# chaos")]
    got = [ln for ln in port.splitlines() if ln.startswith("# chaos")]
    assert got == want and len(got) == 1
    assert re.search(r"retries=\d+ breaker_opens=\d+ devices 4 -> 2$",
                     got[0])
    assert port.splitlines()[-1] == "RESULT chaos ok"


ROW_FIELDS = ("mode", "depth", "fairness", "donate", "launches",
              "cache_hit_rate", "re_traces")


def test_serve_artifact_fields_equal_the_reference(serve_runs):
    ref, port, _ = serve_runs["artifacts"]
    assert port["schema"] == ref["schema"] == tserve.BENCH_SCHEMA
    assert port["backend"] == ref["backend"] == "cpu"
    assert port["config"] == ref["config"]
    assert sorted(port) == sorted(ref)
    assert [{k: r[k] for k in ROW_FIELDS} for r in port["rows"]] == \
        [{k: r[k] for k in ROW_FIELDS} for r in ref["rows"]]
    assert [sorted(r) for r in port["rows"]] == \
        [sorted(r) for r in ref["rows"]]
    assert port["overlap_speedup"] > 0


def test_serve_compare_accepts_the_port_artifact(serve_runs, capsys):
    _, _, path = serve_runs["artifacts"]
    assert serve_compare.main([path, path]) == 0
    assert "FAIL" not in capsys.readouterr().err


def test_serve_fabric_flag_changes_nothing(serve_runs):
    _, want = serve_runs["smoke"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tserve.main(SERVE_LEGS["smoke"] + ["--fabric", "--device", "cpu"])
    assert _ledger(out.getvalue()) == _ledger(want)
    assert _counters(out.getvalue()) == _counters(want)
    assert out.getvalue().splitlines()[-1] == "RESULT ok"


def test_serve_reps_alternate_the_drains(tmp_path, capsys):
    """``--bench-out --reps 3``: the rows keep their fields and counts,
    the config records the reps, the gate reads the artifact; an even
    count is refused."""
    path = tmp_path / "reps.json"
    tserve.main(["--devices", "4", "--depth", "3", "--reps", "3",
                 "--bench-out", str(path), "--device", "cpu"])
    bench = json.loads(path.read_text())
    assert bench["config"]["reps"] == 3
    pairs = bench["pairs_s"]
    assert len(pairs) == 3 and all(a > 0 and b > 0 for a, b in pairs)
    assert bench["overlap_speedup"] == float(np.median([a / b
                                                        for a, b in pairs]))
    assert [r["mode"] for r in bench["rows"]] == ["sync", "overlapped"]
    assert all(r["launches"] == 12 and r["re_traces"] == 0
               for r in bench["rows"])
    assert bench["overlap_speedup"] > 0
    assert "median of 3 pairs" in capsys.readouterr().out
    assert serve_compare.main([str(path), str(path)]) == 0
    with pytest.raises(SystemExit):
        tserve.main(["--reps", "2", "--device", "cpu"])
