"""The isolation rule: nothing the benchmark runs imports JAX or the JAX
package (top-level module names compared whole: the port's own name
begins with the JAX package's), the plain references import nothing of
the port, and nothing reads the JAX package's benchmark folder."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from dcra_bench import harness

BENCH = harness.ROOT / harness.BENCH_DIR
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
#: the JAX package's benchmark folder, spelled so this file does not name it
OLD_BENCH = "bench" + "marks"


def sources():
    return sorted(p for p in BENCH.rglob("*.py")
                  if "__pycache__" not in p.parts)


def imported_tops(path: Path):
    """Top-level names of every module ``path`` imports, by statement or
    by ``importlib.import_module`` / ``__import__`` of a constant."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and node.args:
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(
                fn, "id", "")
            arg = node.args[0]
            if name in ("import_module", "__import__") and isinstance(
                    arg, ast.Constant) and isinstance(arg.value, str):
                out.add(arg.value.split(".")[0])
    return out


def test_sources_found():
    names = {p.name for p in sources()}
    assert {"harness.py", "run.py", "graph.py", "moe.py"} <= names


@pytest.mark.parametrize("path", sources(), ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax_or_jax_package(path):
    bad = imported_tops(path) & FORBIDDEN
    assert not bad, f"{path.name} imports {bad}"


def test_references_import_nothing_of_the_port():
    for path in (BENCH / "reference").glob("*.py"):
        tops = imported_tops(path)
        assert "repro_torch" not in tops, path.name
        assert "dcra_bench" not in tops, path.name      # no way round it


def test_nothing_reads_the_jax_benchmark_folder():
    for path in [*sources(), *BENCH.rglob("*.json")]:
        text = path.read_text()
        for mark in (f"{OLD_BENCH}/", f"{OLD_BENCH}.", f'"{OLD_BENCH}"',
                     f"'{OLD_BENCH}'"):
            assert mark not in text, f"{path.name} names {mark}"


def test_a_run_loads_no_jax(tmp_path):
    """A whole tiny run of each cell in a fresh process: afterwards no
    forbidden top-level module is loaded."""
    code = (
        "import sys\n"
        "from dcra_bench import harness\n"
        "from dcra_bench.conftest import TINY\n"
        "spec = harness.load_spec()\n"
        "for w in spec['workloads']:\n"
        "    cfg = harness.load_config(spec, w['config'])\n"
        "    tr = harness.load_traffic(w['traffic'])\n"
        "    c, t = TINY[cfg['driver']]\n"
        "    cfg.update(c); tr.update(t)\n"
        "    run = harness.run_cell(spec, w, 1, 0.2, False, 'cpu', 0.0,\n"
        "                           cfg, tr)\n"
        "    assert run.correct, w['name']\n"
        "print(harness.forbidden_loaded())\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(harness.ROOT), str(harness.ROOT / "src")]))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         cwd=harness.ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_fails_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's
    folder, a run exits with an error and prints no result."""
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / harness.BENCH_DIR,
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, *spec["command"][1:], "--workload",
         spec["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
