"""The port's two trajectory gates, ``repro_torch.dse.route_compare`` and
``repro_torch.dse.serve_compare``, against the reference's.

Every case builds its two artifacts here, in the shape of the committed
``BENCH_route.json`` / ``BENCH_serve.json`` (no test reads those files):
``compare()`` must return the reference's ``(failures, notes)`` and
``main()`` its exit code and printed lines, on the same files. Each case
also states the exit code it expects, so the two cannot agree on a wrong
verdict unseen.
"""
import copy
import json
import os
import subprocess
import sys

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.dse import route_compare as j_route
from repro.dse import serve_compare as j_serve
from repro_torch.dse import route_compare as t_route
from repro_torch.dse import serve_compare as t_serve

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
IMPLS = ("onehot", "pallas", "sort")
V1, V2 = "dcra-route-bench/v1", "dcra-route-bench/v2"


def route_bench(cells=((4096, 8), (16384, 8), (16384, 64)),
                rounds=((16384, 16), (65536, 16)), ratio=1.0, schema=V2,
                backend="cpu", lowering="xla"):
    """A route artifact: op cells with each impl's speedup over onehot and
    round cells with each impl's pipelined-over-lockstep speedup, both
    scaled by ``ratio``; ``rounds=None`` leaves ``round_cells`` out."""
    bench = {"schema": schema, "backend": backend,
             "pallas_lowering": lowering, "quick": True,
             "impls": list(IMPLS), "cells": []}
    for j, (n, s) in enumerate(cells):
        ms = {i: 0.5 + 0.1 * k + 0.01 * j for k, i in enumerate(IMPLS)}
        bench["cells"].append({
            "n": n, "s": s, "cap": max(1, n // (4 * s)), "ms": ms,
            "speedup_vs_onehot": {i: ratio * ms["onehot"] / ms[i]
                                  for i in IMPLS}})
    if rounds is not None:
        bench["round_cells"] = [{
            "n": n, "s": s, "cap": n // 8, "rounds": 6,
            "round_ms": {"lockstep": {i: 26.0 for i in IMPLS},
                         "pipelined": {i: 12.0 + k for k, i in
                                       enumerate(IMPLS)}},
            "round_speedup": {i: ratio * 26.0 / (12.0 + k)
                              for k, i in enumerate(IMPLS)}}
            for n, s in rounds]
    return bench


def serve_bench(speedup=1.06, modes=("sync", "overlapped"), re_traces=0,
                backend="cpu", schema="dcra-serve-bench/v1"):
    rows = [{"mode": m, "depth": 1 if m == "sync" else 3, "launches": 12,
             "re_traces": re_traces if m == "overlapped" else 0,
             "throughput_rps": 129.6 * (speedup if m == "overlapped" else 1),
             "p50_latency_s": 0.21, "p99_latency_s": 0.37, "serve_s": 0.37}
            for m in modes]
    return {"schema": schema, "backend": backend, "rows": rows,
            "overlap_speedup": speedup,
            "config": {"depth": 3, "devices": 8, "requests": 48,
                       "tenants": 6, "width": 4}}


def scaled(bench, kind, factor, impl="sort", index=0):
    """``bench`` with one impl's ratio in cell ``index`` of ``kind``
    (``cells`` or ``round_cells``) times ``factor``."""
    out = copy.deepcopy(bench)
    field = "speedup_vs_onehot" if kind == "cells" else "round_speedup"
    out[kind][index][field][impl] *= factor
    return out


def without(bench, kind, index=None, impl=None):
    out = copy.deepcopy(bench)
    if index is None:
        del out[kind]
    elif impl is None:
        del out[kind][index]
    else:
        field = "speedup_vs_onehot" if kind == "cells" else "round_speedup"
        del out[kind][index][field][impl]
    return out


def with_fields(bench, **kw):
    out = copy.deepcopy(bench)
    out.update(kw)
    return out


BASE = route_bench()
ROUTE_CASES = {
    # name: (old, new, argv extras, exit code)
    "identical": (BASE, route_bench(), [], 0),
    "op_drop_25": (BASE, scaled(BASE, "cells", 0.75), [], 2),
    "op_drop_19": (BASE, scaled(BASE, "cells", 0.81), [], 0),
    "round_drop_25": (BASE, scaled(BASE, "round_cells", 0.75, "pallas"),
                      [], 2),
    "round_drop_19": (BASE, scaled(BASE, "round_cells", 0.81, "pallas"),
                      [], 0),
    "speedup_up": (BASE, route_bench(ratio=1.5), [], 0),
    "missing_cell": (BASE, without(BASE, "cells", 1), [], 2),
    "missing_impl": (BASE, without(BASE, "cells", 2, "pallas"), [], 2),
    "missing_round_impl": (BASE, without(BASE, "round_cells", 0, "sort"),
                           [], 2),
    "new_cells": (BASE, route_bench(cells=((4096, 8), (16384, 8),
                                           (16384, 64), (65536, 8)),
                                    rounds=((16384, 16), (65536, 16),
                                            (4096, 4))), [], 0),
    "v1_baseline": (route_bench(rounds=None, schema=V1), BASE, [], 0),
    "v1_baseline_drop": (route_bench(rounds=None, schema=V1),
                         scaled(BASE, "cells", 0.5, "pallas", 2), [], 2),
    "v1_new": (BASE, route_bench(rounds=None, schema=V1), [], 1),
    "backend_mismatch": (BASE, route_bench(backend="cuda"), [], 2),
    "lowering_mismatch": (BASE, route_bench(lowering="triton"), [], 2),
    "rounds_missing_new": (BASE, without(BASE, "round_cells"), [], 2),
    "rounds_missing_old": (without(BASE, "round_cells"), BASE, [], 0),
    "no_old_cells": (with_fields(BASE, cells=[]), BASE, [], 2),
    "no_new_cells": (BASE, with_fields(BASE, cells=[]), [], 2),
    "wrong_schema_old": (with_fields(BASE, schema="dcra-route-bench/v3"),
                         BASE, [], 1),
    "wrong_schema_new": (BASE, with_fields(BASE, schema="other"), [], 1),
    "tol_loose": (BASE, scaled(BASE, "cells", 0.75), ["--tol", "0.3"], 0),
    "tol_tight": (BASE, scaled(BASE, "cells", 0.95), ["--tol", "0.01"], 2),
}

SBASE = serve_bench()
SERVE_CASES = {
    "identical": (SBASE, serve_bench(), [], 0),
    "drop_25": (SBASE, serve_bench(1.06 * 0.75), [], 2),
    "drop_19": (SBASE, serve_bench(1.06 * 0.81), [], 2),
    "drop_10": (SBASE, serve_bench(1.06 * 0.90), [], 0),
    "speedup_up": (SBASE, serve_bench(1.8), [], 0),
    "old_missing_sync": (serve_bench(modes=("overlapped",)), SBASE, [], 2),
    "new_missing_overlapped": (SBASE, serve_bench(modes=("sync",)), [], 2),
    "both_missing": (serve_bench(modes=()), serve_bench(modes=("sync",)),
                     [], 2),
    "re_traces": (SBASE, serve_bench(re_traces=3), [], 2),
    "backend_mismatch": (SBASE, serve_bench(backend="cuda"), [], 2),
    "wrong_schema_old": (serve_bench(schema="dcra-serve-bench/v2"), SBASE,
                         [], 1),
    "wrong_schema_new": (SBASE, with_fields(SBASE, schema=None), [], 1),
    "tol_loose": (SBASE, serve_bench(1.06 * 0.75), ["--tol", "0.3"], 0),
    "tol_tight": (SBASE, serve_bench(1.06 * 0.99), ["--tol", "0.001"], 2),
}
GATES = {"route": (t_route, j_route, ROUTE_CASES, 0.2),
         "serve": (t_serve, j_serve, SERVE_CASES, 0.15)}


def write(tmp_path, old, new):
    paths = []
    for name, bench in (("old", old), ("new", new)):
        path = tmp_path / f"{name}.json"
        path.write_text(bench if isinstance(bench, str) else json.dumps(bench))
        paths.append(str(path))
    return paths


def tol_of(extra, default):
    return float(extra[1]) if extra else default


@pytest.mark.parametrize("gate,case", [(g, c) for g in GATES
                                       for c in GATES[g][2]])
def test_gate_matches_reference(tmp_path, capsys, gate, case):
    """The same failures and notes, line for line; the same exit code and
    output from ``main`` on the files; the exit code the case names."""
    port, ref, cases, default_tol = GATES[gate]
    old, new, extra, want_rc = cases[case]
    tol = tol_of(extra, default_tol)
    got = port.compare(copy.deepcopy(old), copy.deepcopy(new), tol=tol)
    assert got == ref.compare(copy.deepcopy(old), copy.deepcopy(new),
                              tol=tol)
    paths = write(tmp_path, old, new)
    rc = port.main(paths + extra)
    printed = capsys.readouterr()
    assert ref.main(paths + extra) == rc == want_rc
    assert capsys.readouterr() == printed
    if want_rc == 2:
        assert got[0] and all(f"FAIL: {f}" in printed.err for f in got[0])
    if want_rc == 0:
        assert not got[0] and all(n in printed.out for n in got[1])


@pytest.mark.parametrize("gate", list(GATES))
@pytest.mark.parametrize("which", ["old", "new"])
def test_gate_refuses_bad_json(tmp_path, capsys, gate, which):
    port, ref, cases, _ = GATES[gate]
    old, new, _, _ = cases["identical"]
    paths = write(tmp_path, "{not json" if which == "old" else old,
                  "[1, 2" if which == "new" else new)
    assert port.main(paths) == 1
    got = capsys.readouterr()
    assert ref.main(paths) == 1
    assert capsys.readouterr() == got
    assert "bad input" in got.err and not got.out
    # a file that is not there is bad input too
    assert port.main([paths[0], str(tmp_path / "missing.json")]) == 1


def test_gates_keep_the_reference_constants():
    assert t_route.SCHEMA == j_route.SCHEMA == V2
    assert t_route.COMPAT_SCHEMAS == j_route.COMPAT_SCHEMAS == (V1, V2)
    assert t_serve.SCHEMA == j_serve.SCHEMA
    assert t_serve.REQUIRED_MODES == j_serve.REQUIRED_MODES
    for port, ref in ((t_route, j_route), (t_serve, j_serve)):
        want = ref.compare.__defaults__
        assert port.compare.__defaults__ == want


GRID = st.lists(st.tuples(st.sampled_from([1024, 4096, 16384, 65536]),
                          st.sampled_from([4, 8, 16, 64])),
                min_size=0, max_size=5, unique=True)


@settings(max_examples=60, deadline=None)
@given(old_cells=GRID, new_cells=GRID, old_rounds=GRID, new_rounds=GRID,
       factors=st.lists(st.floats(0.3, 1.7), min_size=6, max_size=6),
       tol=st.sampled_from([0.0, 0.05, 0.2, 0.5]),
       v1=st.booleans(), backend=st.sampled_from(["cpu", "cpu", "cuda"]))
def test_route_gate_matches_reference_on_random_grids(
        old_cells, new_cells, old_rounds, new_rounds, factors, tol, v1,
        backend):
    """Random (n, s) grids on either side, each cell's ratios scaled by
    its own factor, v1 baselines and backend mismatches mixed in."""
    old = route_bench(old_cells, None if v1 else old_rounds,
                      schema=V1 if v1 else V2)
    new = route_bench(new_cells, new_rounds, backend=backend)
    for kind in ("cells", "round_cells"):
        for j, cell in enumerate(new.get(kind, [])):
            field = ("speedup_vs_onehot" if kind == "cells"
                     else "round_speedup")
            for k, impl in enumerate(IMPLS):
                cell[field][impl] *= factors[(j + k) % len(factors)]
    assert t_route.compare(old, new, tol=tol) == j_route.compare(
        old, new, tol=tol)


@settings(max_examples=60, deadline=None)
@given(old_speedup=st.floats(0.2, 4.0), ratio=st.floats(0.3, 1.7),
       tol=st.floats(0.0, 0.6), old_modes=st.sets(
           st.sampled_from(["sync", "overlapped", "other"])),
       re_traces=st.integers(0, 2))
def test_serve_gate_matches_reference_on_random_speedups(
        old_speedup, ratio, tol, old_modes, re_traces):
    old = serve_bench(old_speedup, modes=tuple(sorted(old_modes)))
    new = serve_bench(old_speedup * ratio, re_traces=re_traces)
    assert t_serve.compare(old, new, tol=tol) == j_serve.compare(
        old, new, tol=tol)


@pytest.mark.parametrize("gate,cases", [
    ("route_compare", ("identical", "op_drop_25", "v1_new")),
    ("serve_compare", ("identical", "re_traces", "wrong_schema_old"))])
def test_gate_runs_as_a_module(tmp_path, gate, cases):
    """``python -m repro_torch.dse.<gate> OLD NEW``: exit codes 0, 2, 1,
    with the reference's output."""
    _, ref, table, _ = GATES[gate.split("_")[0]]
    for case in cases:
        old, new, extra, want_rc = table[case]
        paths = write(tmp_path, old, new)
        out = subprocess.run(
            [sys.executable, "-m", f"repro_torch.dse.{gate}", *paths,
             *extra], env=dict(os.environ, PYTHONPATH=SRC),
            capture_output=True, text=True, timeout=120)
        assert out.returncode == want_rc, (case, out.stderr[-2000:])
        assert (out.returncode == 0) == (not out.stderr), case
        assert f"[dse.{gate}]" in out.stdout + out.stderr, case
