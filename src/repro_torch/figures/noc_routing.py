"""Single-stage vs hierarchical (pod/portal) owner-routed NoC collectives.

Runs the shared routing layer (:mod:`repro_torch.core.routing`) both ways
on the same task streams, one flat all_to_all over all shards against the
paper's §III-A two-stage tile-NoC / die-NoC path, and reports the time a
call, IQ-overflow drops, the largest error against the numpy oracle, and
the analytic die-crossing count from the topology model (the quantity
the portal aggregation exists to cut). The shards are virtual shards of
one device (:class:`~repro_torch.core.fabric.Fabric`).

  PYTHONPATH=src python -m repro_torch.figures.noc_routing [--devices 8]
      [--pods 2] [--scale 11] [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..core.fabric import Fabric, resolve_device
from ..core.task_engine import EngineConfig, TaskEngine
from ..core.topology import TileGrid
from ..sparse import datasets, ref
from ..sparse.options import LaunchOptions
from ..sparse.torch_apps import dcra_bfs, dcra_histogram, dcra_spmv
from .common import emit

HIST_N, HIST_BINS = 1 << 16, 1 << 10


@dataclass
class Case:
    """One app routed one way: ms a call, drops, the last call's output
    and the oracle's."""
    app: str
    mode: str
    ms: float
    drops: int
    y: np.ndarray
    oracle: np.ndarray

    @property
    def err(self) -> float:
        return float(np.max(np.abs(np.asarray(self.y, np.float64)
                                   - self.oracle)))


MODES = ("single_stage", "hierarchical")


def _timed(fn, device, reps=5):
    """One call for its output (the first one also builds), then the mean
    ms of ``reps`` calls, each synchronised and its output on the host."""
    y, d = fn()
    np.asarray(y)
    t = time.perf_counter()
    for _ in range(reps):
        y, d = fn()
        np.asarray(y)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    return (time.perf_counter() - t) / reps * 1e3, int(d), y


def die_crossings(dest, n_dev, n_pods):
    """Analytic die-NoC crossings for the same stream (topology model)."""
    grid = TileGrid(1, n_dev, "hier_torus", die_rows=1,
                    die_cols=n_dev // n_pods)
    eng = TaskEngine(EngineConfig(grid=grid), int(dest.max()) + 1)
    valid = dest >= 0
    src = (np.arange(len(dest)) % n_dev)[valid]   # edge-parallel src shards
    rs = eng.route("T3", src_idx=src, dst_idx=dest[valid])
    return rs.die_crossings


def _bfs_stats(g, fabric, pod_axis=None):
    d, st = dcra_bfs(g, 0, fabric, options=LaunchOptions(
        capacity_factor=4.0, pod_axis=pod_axis))
    return d.astype(np.float64), st.total_drops


def workload(scale: int):
    """``(graph, x, elements)``: RMAT-``scale`` (edge factor 8, seed 3),
    SpMV's dense vector and the histogram's elements."""
    g = datasets.rmat(scale, edge_factor=8, seed=3)
    x = np.random.default_rng(0).random(g.n)
    return g, x, datasets.histogram_data(HIST_N, HIST_BINS)


def oracles(g, x, els):
    """Each app's numpy oracle, float64."""
    return {"spmv": ref.spmv_ref(g, x),
            "histogram": ref.histogram_ref(els, HIST_BINS).astype(np.float64),
            "bfs": ref.bfs_ref(g, 0).astype(np.float64)}


def fabrics(n_dev: int, n_pods: int, device=None):
    """``{mode: fabric}``: ``n_dev`` flat shards, and ``n_pods`` pods of
    ``n_dev // n_pods`` routed in two stages."""
    device = resolve_device(device)
    return {"single_stage": Fabric.fake(n_dev, device=device),
            "hierarchical": Fabric.virtual((n_pods, n_dev // n_pods),
                                           ("pod", "data"), device=device)}


def run_mode(g, x, els, fabric, mode, want, reps: int = 5):
    """The three apps routed ``mode``'s way on ``fabric``: a
    :class:`Case` each. The hierarchical mode routes through the pod
    axis; iterative TaskPrograms route hierarchically too: every round
    re-enters the two-stage pod/portal collective."""
    pod = "pod" if mode == "hierarchical" else None
    opts = LaunchOptions(capacity_factor=3.0, pod_axis=pod)
    calls = {
        "spmv": lambda: dcra_spmv(g, x, fabric, options=opts),
        "histogram": lambda: dcra_histogram(els, HIST_BINS, fabric,
                                            options=opts),
        "bfs": lambda: _bfs_stats(g, fabric, pod),
    }
    out = []
    for app, fn in calls.items():
        ms, drops, y = _timed(fn, fabric.device, reps)
        out.append(Case(app, mode, ms, drops, np.asarray(y), want[app]))
    return out


def crossings(g, n_dev: int, n_pods: int):
    """The die crossings of the graph's edge stream, flat and in pods."""
    dest = g.row_of()
    return {"flat": die_crossings(dest, n_dev, n_dev),
            "hier": die_crossings(dest, n_dev, n_pods)}


def measure(scale: int = 11, n_dev: int = 8, n_pods: int = 2, device=None,
            reps: int = 5):
    """``(graph, x, elements, cases, crossings)``: SpMV, histogram and BFS,
    each single-stage and hierarchical, and the die crossings
    ``{"flat": ..., "hier": ...}`` of the graph's edge stream."""
    g, x, els = workload(scale)
    want = oracles(g, x, els)
    by_mode = [run_mode(g, x, els, fab, mode, want, reps)
               for mode, fab in fabrics(n_dev, n_pods, device).items()]
    cases = [c for app in want for cs in by_mode for c in cs if c.app == app]
    return g, x, els, cases, crossings(g, n_dev, n_pods)


def main(scale: int = 11, n_dev: int = 8, n_pods: int = 2, device=None):
    _, _, _, cases, crossings = measure(scale, n_dev, n_pods, device)
    rows = [("noc_routing", c.app, c.mode, f"{c.ms:.2f}ms",
             f"drops={c.drops}", f"err={c.err:.2e}") for c in cases]
    rows.append(("noc_routing", "analytic", "die_crossings_flat",
                 crossings["flat"], "", ""))
    rows.append(("noc_routing", "analytic", "die_crossings_hier",
                 crossings["hier"], "", ""))
    emit(rows, "figure,app,mode,ms_per_round,drops,err")
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--pods", type=int, default=2)
    ap.add_argument("--scale", type=int, default=11)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    a = ap.parse_args()
    main(scale=a.scale, n_dev=a.devices, n_pods=a.pods, device=a.device)
