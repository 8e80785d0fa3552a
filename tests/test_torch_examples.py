"""The port's example scripts (``examples/*_torch.py``) end to end on
the CPU, each in a subprocess at a tiny size with ``--device cpu``: each
must exit 0, and ``train_lm_torch`` must show a falling loss. None of
them imports ``jax``, ``repro`` or ``benchmarks`` (read with ``ast``,
imports inside functions too).
"""
import ast
import glob
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
EXAMPLES = {
    "train_lm_torch": ["--steps", "5", "--batch", "2", "--seq", "16",
                       "--warmup", "2", "--lr", "3e-3"],
    "serve_lm_torch": ["--batch", "2", "--prompt-len", "6", "--gen", "4"],
    "quickstart_torch": [],
    "serve_graph_torch": ["--requests", "8"],
}


def _run(name):
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="2")
    path = os.path.join(ROOT, "examples", f"{name}.py")
    return subprocess.run([sys.executable, path, "--device", "cpu"]
                          + EXAMPLES[name], env=env, capture_output=True,
                          text=True, timeout=300)


def test_every_port_example_is_listed():
    found = {os.path.basename(p)[:-3] for p in
             glob.glob(os.path.join(ROOT, "examples", "*_torch.py"))}
    assert found == set(EXAMPLES)


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(name):
    out = _run(name)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-3000:])
    if name == "train_lm_torch":
        m = re.search(r"CE ([0-9.]+) -> ([0-9.]+) over 5 steps", out.stdout)
        assert m and float(m.group(2)) < float(m.group(1)), out.stdout
    if name == "quickstart_torch":
        assert "histogram kernel ok: True (0 kernel launch on cpu)" \
            in out.stdout


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_imports_neither_jax_nor_the_reference(name):
    tree = ast.parse(open(os.path.join(ROOT, "examples", f"{name}.py")).read())
    mods = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods.append(node.module or "")
    tops = {m.split(".")[0] for m in mods}
    assert not tops & {"jax", "jaxlib", "repro", "benchmarks"}, tops
    assert "repro_torch" in tops
