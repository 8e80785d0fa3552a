"""Re-validate analytic winners on the port's executables, for every app,
iterative ones included (counterpart of ``repro/dse/shardcheck.py``).

The DSE sweep's analytic stack models the bounded input queue of the
routing layer (:mod:`repro_torch.core.routing`); this check proves the
model on a top-K point by routing the *same* task stream through both
paths at the same parallelism and comparing message / drop counts:

* executable: the ``dcra_*`` apps of :mod:`repro_torch.sparse.torch_apps`
  on ``n_dev`` virtual shards of one device (the card unless the spec
  names another), with the point's IQ capacity pinned via
  ``LaunchOptions(cap=...)``;
* analytic: each app's twin (:func:`repro_torch.sparse.program.
  program_app_stats`), the program's task stream replayed round by round
  through ``TaskEngine.route`` with ``QueueConfig(default_iq=cap)`` on
  ``fab.tile_grid()``, one tile per shard, so the (source shard -> owner)
  channels are the executable's. For the iterative apps the twin evolves
  the state under the executable's own kept/dropped admission order, so
  the per-round streams (and drop counts) agree exactly even when tight
  queues lose updates mid-run.

The ``histogram_self`` app is the heavy self-traffic case: every shard's
element stream targets mostly bins the shard itself owns, so overflow
lands on the (d -> d) channels.

The shards are virtual, so the check runs in the caller's process
(:func:`check_point`). As a command, ``python -m repro_torch.dse.shardcheck``
reads the spec as JSON on stdin and prints one ``RESULT <json>`` line;
exit code 0 when every entry agrees, 3 otherwise. Spec::

    {"n_dev": 8, "scale": 8, "seed": 0, "device": "cuda",
     "checks": [{"point_id": "...", "iq_capacity": 12,
                 "apps": ["spmv", "histogram", "bfs", "sssp", "wcc",
                          "pagerank", "kcore"]}]}

``device`` defaults to the card; without one the check raises, it does
not fall back to the CPU.
"""
from __future__ import annotations

import json
import sys
import time
from typing import Dict, Optional

import numpy as np

RESULT_PREFIX = "RESULT "

# the iterative (graph-program) apps and their revalidation parameters
PROGRAM_PARAMS = {
    "bfs": {"root": 0},
    "sssp": {"root": 0},
    "wcc": {},
    "pagerank": {"damping": 0.85, "iters": 5},
    "kcore": {"k": 8.0},
}


def _analytic_counts(dest: np.ndarray, n: int, fab, cap: int):
    """The same stream through the analytic twin at shard parallelism
    (``fab.tile_grid()``: one tile per shard)."""
    from ..core.queues import QueueConfig
    from ..core.task_engine import EngineConfig, TaskEngine
    n_dev = fab.n_devices
    engine = TaskEngine(EngineConfig(grid=fab.tile_grid(),
                                     queues=QueueConfig(default_iq=cap)), n)
    e_local = len(dest) // n_dev
    shard_of = np.repeat(np.arange(n_dev), e_local)
    valid = dest >= 0
    rs = engine.route("T3", src_idx=shard_of[valid],
                      dst_idx=dest[valid].astype(np.int64))
    return rs.tasks_total, rs.drops


def _timed(fn, timings, key, sync):
    t0 = time.perf_counter()
    out = fn()
    sync()
    if timings is not None:
        timings[key] = timings.get(key, 0.0) + time.perf_counter() - t0
    return out


def check_point(check: dict, n_dev: int, scale: int, seed: int,  # noqa: PLR0917
                device=None, timings: Optional[Dict[str, float]] = None
                ) -> list:
    """One point's revalidation entries (the reference's, key for key).
    ``timings``, when given, gathers seconds by ``"<app> executable"``
    (device synchronised), ``"<app> analytic"`` (host) and ``"packing"``
    (the graph programs' edges, packed once a direction and shared by
    both sides)."""
    import torch
    from ..core.fabric import Fabric
    from ..sparse import datasets
    from ..sparse.options import LaunchOptions
    from ..sparse.program import _graph_setup, program_app_stats, run_program
    from ..sparse.torch_apps import (PROGRAMS, dcra_histogram, dcra_scatter,
                                     dcra_spmv, histogram_task_stream,
                                     spmv_task_stream)

    fab = Fabric.fake(n_dev, device=device)
    cap = max(1, int(check["iq_capacity"]))  # honored exactly, no rounding
    opts = LaunchOptions(cap=cap, seed=seed)

    def sync():
        if fab.device.type == "cuda":
            torch.cuda.synchronize(fab.device)

    g = datasets.rmat(scale, edge_factor=8, seed=1)
    setups = {}
    out = []
    for app in check.get("apps", ("spmv", "histogram")):
        exe, ana = f"{app} executable", f"{app} analytic"
        if app == "spmv":
            x = np.random.default_rng(seed).random(g.n)
            dest, _ = spmv_task_stream(g, x, n_dev, seed)
            n_items = g.n
            # the delivered-task count measured END TO END: unit payloads
            # through the same scatter, kept + dropped observed at the
            # owners, not recomputed from the host-side stream
            ones = np.ones(len(dest), np.float32)

            def run():
                _, dropped = dcra_spmv(g, x, fab, options=opts)
                y1, drop1 = dcra_scatter(dest, ones, n_items, fab,
                                         options=LaunchOptions(cap=cap),
                                         op="add")
                return dropped, y1, drop1
            dropped, y1, drop1 = _timed(run, timings, exe, sync)
            kept = int(round(float(y1.double().sum())))
            if int(drop1) != int(dropped):     # same stream, same cap
                raise AssertionError(f"spmv drops {int(dropped)} differ "
                                     f"from its unit scatter's {int(drop1)}")
        elif app in ("histogram", "histogram_self"):
            n_items = max(g.n // 16, 64)
            if app == "histogram":
                els = datasets.histogram_data(g.nnz, n_items, seed=seed + 3)
            else:
                # heavy self-traffic: ~90% of each shard's elements hash
                # to bins the shard itself owns (bin % n_dev == shard)
                e_local = max(g.nnz // n_dev, 32)
                rng = np.random.default_rng(seed + 7)
                shard_of = np.repeat(np.arange(n_dev), e_local)
                bins = rng.integers(0, max(n_items // n_dev, 1),
                                    n_dev * e_local) * n_dev
                self_mask = rng.random(n_dev * e_local) < 0.9
                owner = np.where(self_mask, shard_of,
                                 rng.integers(0, n_dev, n_dev * e_local))
                els = np.minimum(bins + owner, n_items - 1)
            dest, _ = histogram_task_stream(els, n_dev)
            # the histogram IS a unit-payload scatter: its own output
            # counts the delivered tasks
            y, dropped = _timed(lambda: dcra_histogram(els, n_items, fab,
                                                       options=opts),
                                timings, exe, sync)
            kept = int(round(float(np.asarray(y).sum(dtype=np.float64))))
        elif app in PROGRAM_PARAMS:
            # iterative app: the whole program, its per-round message and
            # drop trajectories against the twin's
            params = PROGRAM_PARAMS[app]
            prog = PROGRAMS[app]
            if prog.undirected not in setups:
                setups[prog.undirected] = _timed(
                    lambda: _graph_setup(g, n_dev, undirected=prog.undirected,
                                         seed=seed),
                    timings, "packing", lambda: None)
            setup = setups[prog.undirected]
            _, stats = _timed(lambda: run_program(prog, g, fab, options=opts,
                                                  params=params, setup=setup),
                              timings, exe, sync)
            twin = _timed(lambda: program_app_stats(
                prog, g, n_dev, cap=cap, params=params, seed=seed,
                setup=setup), timings, ana, lambda: None)
            ok = (stats.rounds == twin.rounds
                  and np.array_equal(stats.messages, twin.messages)
                  and np.array_equal(stats.drops, twin.drops))
            out.append({
                "point_id": check.get("point_id", ""),
                "app": app, "n_dev": n_dev, "cap": cap,
                "executable": {"messages": stats.total_messages,
                               "drops": stats.total_drops,
                               "rounds": stats.rounds},
                "analytic": {"messages": twin.total_messages,
                             "drops": twin.total_drops,
                             "rounds": twin.rounds},
                "ok": bool(ok),
            })
            continue
        else:
            raise ValueError(f"unsupported revalidation app {app!r}")
        exe_drops = int(dropped)
        exe_msgs = kept + exe_drops
        ana_msgs, ana_drops = _timed(
            lambda: _analytic_counts(dest, n_items, fab, cap), timings, ana,
            lambda: None)
        ok = (exe_msgs == ana_msgs) and (exe_drops == ana_drops)
        out.append({
            "point_id": check.get("point_id", ""),
            "app": app, "n_dev": n_dev, "cap": cap,
            "executable": {"messages": exe_msgs, "drops": exe_drops},
            "analytic": {"messages": ana_msgs, "drops": ana_drops},
            "ok": bool(ok),
        })
    return out


def main() -> int:
    spec = json.load(sys.stdin)
    n_dev = int(spec.get("n_dev", 8))
    scale = int(spec.get("scale", 8))
    seed = int(spec.get("seed", 0))
    device = spec.get("device")
    results = []
    for check in spec["checks"]:
        results.extend(check_point(check, n_dev, scale, seed, device=device))
    print(RESULT_PREFIX + json.dumps(results), flush=True)
    return 0 if all(r["ok"] for r in results) else 3


if __name__ == "__main__":
    sys.exit(main())
