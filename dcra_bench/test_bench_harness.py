"""The harness finds a cell's configuration, traffic mix and per-layer
metrics by name from files alone, and runs every cell end to end at a
tiny size on the CPU."""
import json
import shutil

import pytest
import torch

from dcra_bench import harness

CELLS = ("kron23-bfs", "kron23-pagerank", "olmoe-moe-fwd")


def test_benchmark_json_names_files_that_exist():
    spec = harness.load_spec()
    for c in spec["configs"]:
        assert (harness.ROOT / c["file"]).exists()
        assert c["file"].startswith(spec["paths"][0] + "/")
        cfg = harness.load_config(spec, c["name"])
        assert cfg["name"] == c["name"]
        assert set(c["reduced"]) == set(cfg["reduced"])
        harness.load_driver(cfg["driver"])
    for w in spec["workloads"]:
        harness.load_traffic(w["traffic"])
    for m in spec["per_layer"]:
        assert callable(harness.load_metric(m["name"]))
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_end_to_end(tiny_cell, name, trace):
    spec, cell, cfg, tr = tiny_cell(name)
    run = harness.run_cell(spec, cell, 2 ** 31 + 3, 0.3, trace, "cpu",
                           0.0, cfg, tr)
    res = harness.result_of(spec, cell, run, trace,
                            {"platform": "cpu", "count": 1})
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"
    json.loads(json.dumps(res, allow_nan=False))
    if trace:
        assert res["device"]["window_s"] > 0
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        e2e = [m["name"] for m in spec["end_to_end"]
               if harness.applies(m, name)]
        assert sorted(res["metrics"]) == sorted(e2e)
        assert all(v["value"] > 0 for v in res["metrics"].values())


def test_a_new_cell_is_files_and_entries_alone(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as new
    files and new entries of BENCHMARK.json, no file edited: the harness
    finds and runs them by name."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.ROOT / harness.BENCH_DIR,
                    root / harness.BENCH_DIR,
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = harness.load_spec()
    bench = root / harness.BENCH_DIR
    cfg = json.loads((bench / "configs" / "gap-kron23.json").read_text())
    cfg.update(name="gap-kron10", scale=10, shards=4)
    (bench / "configs" / "gap-kron10.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "bfs_four_roots.json").write_text(json.dumps(
        {"app": "bfs", "roots": 4, "warm_launches": 1,
         "checked_answers": 2}))
    (bench / "metrics" / "rounds_per_launch.graph.py").write_text(
        "def read(run):\n"
        "    return run.counters['rounds'] / run.counters['launches']\n")
    spec["configs"].append({"name": "gap-kron10", "source": "test",
                            "file": "dcra_bench/configs/gap-kron10.json",
                            "reduced": ["scale"], "why": "test"})
    cell = {"name": "kron10-bfs4", "config": "gap-kron10",
            "traffic": "bfs_four_roots", "chips": 1, "why": "test"}
    spec["workloads"].append(cell)
    spec["per_layer"].append({"name": "rounds_per_launch.graph",
                              "unit": "rounds", "better": "lower",
                              "source": "program_counter",
                              "layer": "round loop", "moves": "teps",
                              "workloads": ["kron10-bfs4"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    spec = harness.load_spec(root)
    run = harness.run_cell(spec, harness.find_cell(spec, "kron10-bfs4"),
                           5, 0.2, True, "cpu", 0.0, root=root)
    res = harness.result_of(spec, cell, run, True, {}, root=root)
    assert res["correct"]
    assert res["metrics"]["rounds_per_launch.graph"]["value"] > 1
    assert "pack_s.graph" not in res["metrics"]    # not listed for it


def keep_env(monkeypatch):
    """``main`` sets the cache directories in the environment: restore
    them after the test."""
    for var in harness.CACHE_DIRS:
        monkeypatch.setenv(var, "unset")


def test_main_refuses_without_a_card(monkeypatch, capsys):
    keep_env(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "kron23-bfs", "--seed", "1",
                       "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""


def test_main_refuses_with_a_forbidden_module_loaded(monkeypatch, capsys):
    spec = harness.load_spec()

    def fake_run(*a, **k):
        return harness.Run(e2e={}, checks=[harness.Check("x", 0, 0)],
                           attempted=1, failed=0, memory_peak_bytes=0,
                           spans=None)
    keep_env(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run_cell", fake_run)
    monkeypatch.setitem(__import__("sys").modules, "jax.numpy", object())
    rc = harness.main(["--workload", spec["workloads"][0]["name"],
                       "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "jax" in out.err


def test_non_finite_readings_fail_and_stay_json():
    c = harness.Check("gap", float("nan"), 1.0)
    assert not c.ok
    assert harness.worse(0.5, float("nan")) != harness.worse(0.5,
                                                             float("nan"))
    assert harness._number(float("inf")) > 1e300


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(cuda_device, name):
    """One short run of each cell on the card through the command of
    BENCHMARK.json: a result line, correct, on the card."""
    import subprocess
    import sys
    spec = harness.load_spec()
    out = subprocess.run(
        [sys.executable, *spec["command"][1:], "--workload", name,
         "--seed", str(2 ** 31 + 5), "--seconds", "2", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
