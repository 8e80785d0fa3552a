"""The paper's figure harness on the port (``repro_torch.figures``) against
the reference's ``benchmarks/`` on the CPU.

The figures are analytic: at scale 10 every CSV line equals the
reference's, text for text (both in process, the reference on the JAX
CPU backend). ``moe_dispatch``'s analytic rows are equal and its timing
row is there; ``roofline_table`` reads the same records as the
reference and prints "—" where the port has no term. ``noc_routing``
runs the reference in a subprocess on 8 XLA host devices (as its harness
runs it) and the port on 8 virtual shards of the CPU: drops and die
crossings equal, BFS and histogram exact, SpMV within its float32 bound.
"""
import ast
import glob
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
if ROOT not in sys.path:          # the reference's ``benchmarks`` package
    sys.path.insert(0, ROOT)

FIGURES = ("fig4_topology", "fig5_sram", "fig6_pus", "fig7_freq",
           "fig8_hbm", "fig10_queues", "fig11_scaling")
SCALE = 10
MODULES = FIGURES + ("common", "moe_dispatch", "noc_routing",
                     "roofline_table", "route_bench", "run", "serve_bench")


def _lines(capsys, fn, *args):
    capsys.readouterr()
    fn(*args)
    return capsys.readouterr().out.splitlines()


def _port(name):
    import importlib
    return importlib.import_module(f"repro_torch.figures.{name}")


def _reference(name):
    import importlib
    return importlib.import_module(f"benchmarks.{name}")


@pytest.mark.parametrize("name", FIGURES)
def test_figure_csv_equals_the_reference(capsys, name):
    want = _lines(capsys, _reference(name).main, SCALE)
    got = _lines(capsys, _port(name).main, SCALE)
    assert len(want) > 2
    assert got == want


def test_moe_dispatch_rows_equal_the_reference(capsys):
    want = _lines(capsys, _reference("moe_dispatch").main)
    got = _lines(capsys, _port("moe_dispatch").main, "cpu")
    assert got[0] == want[0] == "figure,arch,metric,value"
    timed = "einsum_us_per_call"
    assert ([ln for ln in got if timed not in ln]
            == [ln for ln in want if timed not in ln])
    rows = [ln.split(",") for ln in got[1:] if timed in ln]
    assert [r[1] for r in rows] == ["mixtral-8x22b", "olmoe-1b-7b"]
    assert all(float(r[3]) > 0 for r in rows)


RECORD = {"arch": "granite-8b", "shape": "train_4k", "mesh": "single",
          "tag": None, "compute_s": 1.234e-3, "memory_s": 5.678e-4,
          "collective_s": 9.1e-5, "bottleneck": "compute",
          "model_flops_ratio": 0.8125}


def _records(collective):
    recs = [dict(RECORD, collective_s=collective),
            dict(RECORD, arch="olmoe-1b-7b", shape="decode_32k",
                 mesh="multi", compute_s=2.5e-6, memory_s=3.85e-3,
                 collective_s=collective, bottleneck="memory",
                 bytes_per_device=1.5e9),
            {"arch": "rwkv6-7b", "shape": "long_500k", "mesh": "single",
             "skipped": "shape not applicable (DESIGN.md §5)"},
            {"arch": "qwen2-1.5b", "shape": "train_4k", "mesh": "multi",
             "error": "RuntimeError: " + "x" * 80},
            dict(RECORD, tag="remat_dots")]
    return recs


def _table(capsys, tmp_path, monkeypatch, module, recs, reference):
    path = tmp_path / ("ref.json" if reference else "port.json")
    path.write_text(json.dumps(recs))
    if reference:
        monkeypatch.setattr(module, "RESULTS", str(path))
        return _lines(capsys, module.main)
    return _lines(capsys, module.main, str(path))


def test_roofline_table_reads_the_same_records(capsys, tmp_path,
                                               monkeypatch):
    ref, port = _reference("roofline_table"), _port("roofline_table")
    recs = _records(9.1e-5)
    want = _table(capsys, tmp_path, monkeypatch, ref, recs, True)
    got = _table(capsys, tmp_path, monkeypatch, port, recs, False)
    assert len(want) == 5 and got == want


def test_roofline_table_prints_a_dash_for_a_term_the_port_lacks(
        capsys, tmp_path, monkeypatch):
    ref, port = _reference("roofline_table"), _port("roofline_table")
    want = _table(capsys, tmp_path, monkeypatch, ref, _records(9.1e-5), True)
    got = _table(capsys, tmp_path, monkeypatch, port, _records(None), False)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        gf, wf = g.split(","), w.split(",")
        if gf[3] in ("SKIP", "ERROR") or gf[0] == "arch":
            assert g == w
            continue
        assert gf[5] == "—" and wf[5] == f"{9.1e-5:.3e}"
        assert gf[:5] + gf[6:] == wf[:5] + wf[6:]


def test_roofline_table_points_at_the_dry_run_without_results(capsys,
                                                               tmp_path):
    got = _lines(capsys, _port("roofline_table").main,
                 str(tmp_path / "none.json"))
    assert got[0].startswith("roofline_table,SKIPPED,run `PYTHONPATH=src "
                             "python -m repro_torch.launch.dryrun` first")


NOC_ARGS = ["--scale", "9", "--devices", "8", "--pods", "2"]


@pytest.fixture(scope="module")
def noc():
    """The reference's rows (subprocess, 8 XLA host devices) and the
    port's cases on 8 virtual shards of the CPU."""
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-m", "benchmarks.noc_routing"]
                         + NOC_ARGS, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    rows = [ln.split(",") for ln in out.stdout.splitlines()
            if ln.startswith("noc_routing,")]
    from repro_torch.figures import noc_routing
    return rows, noc_routing.measure(9, 8, 2, "cpu", reps=1)


def test_noc_routing_drops_and_die_crossings_equal_the_reference(noc):
    rows, (_, _, _, cases, crossings) = noc
    want = {(r[1], r[2]): r[4] for r in rows if r[1] != "analytic"}
    got = {(c.app, c.mode): f"drops={c.drops}" for c in cases}
    assert got == want and len(got) == 6
    assert all(c.drops == 0 for c in cases)
    analytic = {r[2]: int(r[3]) for r in rows if r[1] == "analytic"}
    assert analytic == {"die_crossings_flat": crossings["flat"],
                        "die_crossings_hier": crossings["hier"]}
    assert crossings["hier"] < crossings["flat"]


def test_noc_routing_states_hold_to_the_oracle(noc):
    from repro_torch.kernels.route import gamma
    _, (g, x, _, cases, _) = noc
    k = np.diff(g.row_ptr).astype(np.float64)
    mag = np.bincount(g.row_of(), weights=np.abs(
        g.values.astype(np.float64) * x[g.col_idx]), minlength=g.n)
    bound = gamma(k + 1) * mag * (1 + 2.0 ** -20)
    for c in cases:
        if c.app == "spmv":
            assert np.all(np.abs(c.y.astype(np.float64) - c.oracle)
                          <= bound), c.mode
        else:
            assert c.err == 0.0, (c.app, c.mode)
            assert np.array_equal(c.y.astype(np.float64), c.oracle)


def test_noc_routing_prints_the_reference_rows(noc, capsys):
    rows, _ = noc
    from repro_torch.figures import noc_routing
    got = [ln.split(",") for ln in _lines(capsys, noc_routing.main, 9, 8, 2,
                                          "cpu")[1:]]
    assert [r[:3] for r in got] == [r[:3] for r in rows]
    assert [r[4:] for r in got if r[1] in ("bfs", "histogram")] == \
        [r[4:] for r in rows if r[1] in ("bfs", "histogram")]
    assert [r[3] for r in got[-2:]] == [r[3] for r in rows[-2:]]
    assert all(r[3].endswith("ms") and float(r[3][:-2]) > 0
               for r in got[:-2])


def test_run_names_a_failing_figure_and_exits_1(monkeypatch, capsys):
    from repro_torch.figures import run

    def broken(scale, device=None, quick=False):
        def boom():
            raise RuntimeError("boom")
        return [("fig5_sram", lambda: None), ("fig4_topology", boom),
                ("fig7_freq", lambda: None)]
    monkeypatch.setattr(run, "figures", broken)
    with pytest.raises(SystemExit) as e:
        run.main(["--quick", "--device", "cpu"])
    assert e.value.code == 1
    out = capsys.readouterr()
    assert "FAILED figures: fig4_topology" in out.err
    assert "fig4_topology,ERROR,RuntimeError: boom" in out.err
    assert out.out.count("== ") == 3          # the rest ran on


def test_run_runs_every_module_in_the_reference_order(monkeypatch):
    from repro_torch.figures import run
    calls = []
    names = [n for n, _ in run.figures(9, "cpu")]
    text = open(os.path.join(ROOT, "benchmarks", "run.py")).read()
    want = re.findall(r'\("(\w+)",', text)
    assert len(want) == 12
    assert names == want
    assert set(names) == set(MODULES) - {"common", "run"}
    monkeypatch.setattr(run, "figures", lambda scale, device=None, quick=False: [
        (n, lambda n=n: calls.append((n, scale, device, quick)))
        for n in names])
    run.main(["--scale", "9", "--device", "cpu"])
    run.main(["--quick", "--device", "cpu"])
    assert calls == ([(n, 9, "cpu", False) for n in names]
                     + [(n, 12, "cpu", True) for n in names])


def test_run_quick_on_the_cpu(monkeypatch, tmp_path, capsys):
    """Every module in this process, the route bench's grids cut to one
    cell each (its artifact written under ``build/`` of ``tmp_path``,
    never over the committed baseline's name in the working
    directory)."""
    from repro_torch.figures import route_bench, run
    for grid in ("FULL_GRID", "QUICK_GRID"):
        monkeypatch.setattr(route_bench, grid, [(4096, 8)])
    for grid in ("ROUND_FULL_GRID", "ROUND_QUICK_GRID"):
        monkeypatch.setattr(route_bench, grid, [(16384, 16)])
    monkeypatch.chdir(tmp_path)
    run.main(["--scale", "9", "--device", "cpu"])
    out = capsys.readouterr()
    heads = [ln for ln in out.out.splitlines() if ln.startswith("== ")]
    assert len(heads) == 12, out.err[-3000:]
    assert "FAILED" not in out.err
    assert not (tmp_path / "BENCH_route_torch.json").exists()
    bench = json.loads((tmp_path / run.ROUTE_OUT).read_text())
    assert bench["quick"] is False and len(bench["cells"]) == 1


def test_figures_import_neither_jax_nor_the_reference():
    files = glob.glob(os.path.join(SRC, "repro_torch", "figures", "*.py"))
    found = {os.path.basename(p)[:-3] for p in files} - {"__init__"}
    assert found == set(MODULES)
    for path in files:
        tree = ast.parse(open(path).read())
        mods = []
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods += [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                mods.append(node.module or "")
        tops = {m.split(".")[0] for m in mods}
        assert not tops & {"jax", "jaxlib", "repro", "benchmarks"}, (path,
                                                                     tops)
        torch_ok = os.path.basename(path) in ("noc_routing.py",
                                              "moe_dispatch.py",
                                              "route_bench.py")
        assert ("torch" in tops) == torch_ok, path
