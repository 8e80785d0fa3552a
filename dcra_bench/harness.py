"""The benchmark's driver-independent half: find a cell's files by name,
check the card, run the cell's driver, read its per-layer metrics, hold
the process to the isolation rule and print the result.

A driver (``drivers/<name>.py``) exposes ``run(ctx) -> Run``. It makes
the inputs from ``ctx.seed``, sets up and warms the port, measures for
``ctx.seconds`` (under the profiler when ``ctx.trace``), reads the peak
memory, frees the port's state and checks the window's answers against
the plain reference. The harness prints, as the last line of standard
output::

    {"correct": ..., "attempted": ..., "failed": ..., "metrics": {...},
     "device": {...}, "breakdown": {...}, "checks": {...}}

``metrics`` holds the cell's end-to-end metrics with ``--trace 0`` and
its per-layer metrics with ``--trace 1``; ``checks`` (last) each number
compared with its limit, which also close standard error.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
BENCH_DIR = Path(__file__).resolve().parent.name
#: top-level modules the process may not hold once the window has closed
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")
#: compile caches a library may use, at fixed paths inside the checkout
#: (the port builds its own kernels into ``build/kernels`` there)
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton",
              "TORCH_EXTENSIONS_DIR": "torch_extensions"}


def worse(a: float, b: float) -> float:
    """The larger of two readings, NaN if either is (``max`` would drop a
    NaN that comes second)."""
    if math.isnan(a) or math.isnan(b):
        return float("nan")
    return max(a, b)


def _number(v):
    """A reading as JSON can hold it: a reading that is not finite (the
    comparison fails on it) is written as the largest double."""
    v = float(v) if not isinstance(v, int) else v
    if isinstance(v, float) and not math.isfinite(v):
        return -1.7976931348623157e308 if v < 0 else 1.7976931348623157e308
    return v


@dataclass
class Check:
    """One number compared with its limit: ``ok`` when ``value <=
    limit``."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class Context:
    """What a driver gets: the cell's entries and files, the run's
    arguments, the device, the process's start on the host clock, and
    the span recorder."""
    cell: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    seed: int
    seconds: float
    trace: bool
    device: Any
    t0: float
    spans: Any = None


@dataclass
class Run:
    """What a driver hands back. ``e2e`` holds every end-to-end metric it
    measured by name; ``work`` and ``counters`` what the per-layer
    readers take (with ``trace``, the reduced profiler trace, and
    ``spans``)."""
    e2e: Dict[str, float]
    checks: List[Check]
    attempted: int
    failed: int
    memory_peak_bytes: int
    spans: Any
    trace: Any = None
    counters: Dict[str, float] = field(default_factory=dict)
    work: Dict[str, Any] = field(default_factory=dict)
    config: Dict[str, Any] = field(default_factory=dict)
    traffic: Dict[str, Any] = field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks)


# ---------------------------------------------------------------------------
# finding a cell's files by name
# ---------------------------------------------------------------------------

def load_spec(root: Path = ROOT) -> Dict[str, Any]:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _named(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def find_cell(spec, name) -> Dict[str, Any]:
    return _named(spec["workloads"], name, "workload")


def load_config(spec, name, root: Path = ROOT) -> Dict[str, Any]:
    entry = _named(spec["configs"], name, "configuration")
    with open(root / entry["file"]) as f:
        return json.load(f)


def load_traffic(name: str, root: Path = ROOT) -> Dict[str, Any]:
    """``traffic/<name>.json``: a mix's parameters, read by its driver."""
    with open(root / BENCH_DIR / "traffic" / f"{name}.json") as f:
        return json.load(f)


def load_driver(name: str):
    return importlib.import_module(f"dcra_bench.drivers.{name}")


def load_metric(name: str, root: Path = ROOT) -> Callable:
    """The ``read`` function of ``metrics/<name>.py``."""
    path = root / BENCH_DIR / "metrics" / f"{name}.py"
    mod_name = "dcra_bench_metric_" + "".join(
        ch if ch.isalnum() else "_" for ch in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def applies(metric: Dict[str, Any], cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def set_cache_dirs(root: Path = ROOT) -> None:
    """Every compile cache the port or a library may use, at a fixed
    path inside the checkout (the port's own kernels build into
    ``build/kernels``)."""
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(root / "build" / sub)


def forbidden_loaded() -> List[str]:
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def run_cell(spec, cell, seed: int, seconds: float, trace: bool, device,
             t0: float, config=None, traffic=None, root: Path = ROOT) -> Run:
    """Run ``cell`` once on ``device``; ``config`` and ``traffic`` default
    to the cell's files under ``root``."""
    import torch
    from dcra_bench.trace import Spans
    device = torch.device(device)
    config = (config if config is not None
              else load_config(spec, cell["config"], root))
    traffic = (traffic if traffic is not None
               else load_traffic(cell["traffic"], root))
    ctx = Context(cell=cell, config=config, traffic=traffic, seed=int(seed),
                  seconds=float(seconds), trace=bool(trace), device=device,
                  t0=t0, spans=Spans(bool(trace)))
    run = load_driver(config["driver"]).run(ctx)
    run.config, run.traffic = config, traffic
    return run


def metrics_of(spec, cell, run: Run, trace: bool, root: Path = ROOT
               ) -> Dict[str, Any]:
    """The cell's end-to-end metrics (``trace`` false) or per-layer ones,
    in ``BENCHMARK.json``'s order; a reader that finds nothing is left
    out."""
    out = {}
    if not trace:
        for m in spec["end_to_end"]:
            if applies(m, cell["name"]) and m["name"] in run.e2e:
                out[m["name"]] = {"value": _number(run.e2e[m["name"]]),
                                  "unit": m["unit"]}
        return out
    for m in spec["per_layer"]:
        if not applies(m, cell["name"]):
            continue
        value = load_metric(m["name"], root)(run)
        if value is not None:
            out[m["name"]] = {"value": _number(value), "unit": m["unit"]}
    return out


def result_of(spec, cell, run: Run, trace: bool, device_info,
              root: Path = ROOT) -> Dict:
    res = {"correct": run.correct, "attempted": int(run.attempted),
           "failed": int(run.failed),
           "metrics": metrics_of(spec, cell, run, trace, root),
           "device": dict(device_info)}
    if trace and run.trace is not None:
        res["device"]["busy_s"] = run.trace.busy_s
        res["device"]["window_s"] = run.trace.window_s
        res["breakdown"] = run.trace.breakdown()
    res["checks"] = {c.name: {"value": _number(c.value),
                              "limit": _number(c.limit)}
                     for c in run.checks}
    return res


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t0: Optional[float] = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    args = parse_args(argv)
    spec = load_spec()
    cell = find_cell(spec, args.workload)
    set_cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"{cell['name']} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    run = run_cell(spec, cell, args.seed, args.seconds, bool(args.trace),
                   device, t0)
    found = forbidden_loaded()
    if found:
        print(f"the process holds {found} after the window: the benchmark "
              f"measures the port alone", file=sys.stderr)
        return 4
    device_info = {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(device),
                   "count": int(cell["chips"]),
                   "memory_peak_bytes": int(run.memory_peak_bytes)}
    res = result_of(spec, cell, run, bool(args.trace), device_info)
    for c in run.checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}) "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0
