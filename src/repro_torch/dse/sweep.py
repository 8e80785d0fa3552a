"""``python -m repro_torch.dse.sweep`` — the design-space exploration CLI
(counterpart of ``repro/dse/sweep.py``).

Enumerates a :class:`~repro_torch.dse.space.ConfigSpace`, evaluates every
point analytically on the host (:class:`~repro_torch.dse.evaluate.
Evaluator`), extracts the 3-D Pareto frontier over (TEPS↑, watts↓,
$/package↓), re-validates the top-K analytic winners on the port's
executables on ``--device`` (the card by default; message/drop counts
must match the analytic model exactly — see
:mod:`repro_torch.dse.shardcheck`), and writes the ``BENCH_dse.json``
record of the sweep.

Exit codes: 0 ok; 1 sweep produced no valid points; 3 revalidation
mismatch (the analytic model diverged from the executables — a gating
failure, not a soft warning).

Usage::

    PYTHONPATH=src python -m repro_torch.dse.sweep --quick --device cpu \\
        --out /tmp/BENCH_dse.json
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional, Sequence

from .autoconfig import signature_of
from .driver import SweepTask, run_sweep
from .evaluate import APPS, Evaluator, geomean, load_datasets
from .pareto import DEFAULT_OBJECTIVES, pareto_frontier
from .shardcheck import check_point
from .space import ConfigSpace

SCHEMA = "dcra-dse-bench/v2"
QUICK_APPS = ("bfs", "pagerank", "spmv", "histogram", "kcore")
# every app is revalidated on the executables — the one-round scatters AND
# the iterative TaskPrograms (per-round trajectory agreement, see shardcheck)
REVALIDATION_APPS = ("spmv", "histogram", "bfs", "sssp", "wcc",
                     "pagerank", "kcore")


def revalidate(results: Sequence[Dict], top_k: int, n_dev: int,  # noqa: PLR0917
               scale: int, device=None,
               timings: Optional[Dict[str, float]] = None) -> List[Dict]:
    """Re-run the top-K points' queue model on the port's executables on
    ``n_dev`` virtual shards of ``device`` (default the card), in this
    process (:func:`~repro_torch.dse.shardcheck.check_point`)."""
    ranked = sorted((r for r in results if r.get("pareto")),
                    key=lambda r: -r["metrics"]["teps_geomean"])
    out: List[Dict] = []
    for r in ranked[:top_k]:
        check = {"point_id": r["point_id"],
                 "iq_capacity": r["config"]["iq_capacity"],
                 "apps": list(REVALIDATION_APPS)}
        out.extend(check_point(check, n_dev, scale, 0, device=device,
                               timings=timings))
    return out


def per_app_frontiers(valid: Sequence[Dict], apps_list: Sequence[str]
                      ) -> Dict[str, List[str]]:
    """App-specific Pareto slices: the (TEPS↑, watts↓, $/pkg↓) frontier
    recomputed from each record's per-``app`` cells alone. A point that is
    globally dominated can still be optimal *for one app* (and vice
    versa) — ``autoconfig.select_from_frontier`` ranks on these."""
    out: Dict[str, List[str]] = {}
    for app in apps_list:
        recs, pids = [], []
        for r in valid:
            cells = [c for name, c in r.get("per_cell", {}).items()
                     if name.split(":")[0] == app]
            if not cells:
                continue
            recs.append({
                "teps": geomean([c["teps"] for c in cells]),
                "watts": geomean([c["energy_j"] / max(c["seconds"], 1e-12)
                                  for c in cells]),
                "package_usd": r["metrics"]["package_usd"],
            })
            pids.append(r["point_id"])
        idx = pareto_frontier(recs, DEFAULT_OBJECTIVES)
        out[app] = sorted(pids[i] for i in idx)
    return out


def run(space: ConfigSpace, apps_list: Sequence[str], scale: int,  # noqa: PLR0917
        top_k: int, n_dev: int, out: Optional[str],
        quick: bool, skip_revalidation: bool = False, device=None,
        timings: Optional[Dict[str, float]] = None) -> Dict:
    """The sweep: analytic evaluation on the host, the frontier, and the
    revalidation of the top-K frontier points on ``device`` (default the
    card); ``timings`` gathers the revalidation's seconds by app."""
    t0 = time.time()
    data = load_datasets(scale)
    ev = Evaluator(data, apps_list)
    points = list(space.points())
    print(f"[dse] sweeping {len(points)} points x {len(apps_list)} apps x "
          f"{len(data)} datasets (scale={scale})", flush=True)

    tasks = [SweepTask(key=p.point_id,
                       run=(lambda p=p: ev.evaluate_point(p).to_dict()),
                       meta={"point_id": p.point_id})
             for p in points]
    records = run_sweep(tasks, out=None, resume=False)
    valid = [r for r in records if "metrics" in r]

    frontier = pareto_frontier([r["metrics"] | {"teps": r["metrics"]
                                                ["teps_geomean"],
                                                "watts": r["metrics"]
                                                ["watts_geomean"]}
                                for r in valid], DEFAULT_OBJECTIVES)
    frontier_ids = {valid[i]["point_id"] for i in frontier}
    for r in valid:
        r["pareto"] = r["point_id"] in frontier_ids
    app_frontiers = per_app_frontiers(valid, apps_list)

    reval: List[Dict] = []
    if not skip_revalidation:
        reval = revalidate(valid, top_k=top_k, n_dev=n_dev,
                           scale=min(scale, 8), device=device,
                           timings=timings)

    bench = {
        "schema": SCHEMA,
        "quick": quick,
        "space": space.to_dict(),
        "apps": list(apps_list),
        "datasets": sorted(data),
        "dataset_scale": scale,
        # what launch-time auto-configuration matches against (additive to
        # schema v1; autoconfig recomputes from dataset_scale when absent)
        "dataset_signatures": {name: signature_of(g).to_dict()
                               for name, g in data.items()},
        "points": records,
        "pareto": sorted(frontier_ids),
        # schema v2: app-specific Pareto slices so launch auto-config can
        # rank on the frontier of the app actually being launched
        "app_frontiers": app_frontiers,
        "revalidation": reval,
        "elapsed_s": time.time() - t0,
    }
    if out:
        with open(out, "w") as f:
            json.dump(bench, f, indent=1)
        print(f"[dse] wrote {out}: {len(valid)} points, "
              f"{len(frontier_ids)} on the frontier, "
              f"{sum(1 for r in reval if r['ok'])}/{len(reval)} "
              f"revalidations ok, {bench['elapsed_s']:.1f}s", flush=True)
    return bench


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="quick space + small datasets")
    ap.add_argument("--scale", type=int, default=None,
                    help="dataset scale (default: 8 quick / 12 full)")
    ap.add_argument("--out", default="BENCH_dse.json")
    ap.add_argument("--top-k", type=int, default=2,
                    help="analytic winners to revalidate on the executables")
    ap.add_argument("--n-dev", type=int, default=8)
    ap.add_argument("--apps", default=None,
                    help="comma-separated subset of " + ",".join(APPS))
    ap.add_argument("--skip-revalidation", action="store_true")
    ap.add_argument("--device", default=None,
                    help="device of the revalidation's shards (default: the "
                         "card; 'cpu' to run it on the host)")
    args = ap.parse_args(argv)

    space = ConfigSpace.quick() if args.quick else ConfigSpace.full()
    scale = args.scale if args.scale is not None else (8 if args.quick
                                                      else 12)
    apps_list = (tuple(args.apps.split(",")) if args.apps
                 else (QUICK_APPS if args.quick else APPS))
    bench = run(space, apps_list, scale, args.top_k, args.n_dev,
                args.out, quick=args.quick,
                skip_revalidation=args.skip_revalidation,
                device=args.device)

    valid = [r for r in bench["points"] if "metrics" in r]
    if not valid or not bench["pareto"]:
        print("[dse] FAIL: no valid points / empty frontier",
              file=sys.stderr)
        return 1
    if not args.skip_revalidation and (
            not bench["revalidation"]
            or not all(r["ok"] for r in bench["revalidation"])):
        print("[dse] FAIL: revalidation mismatch "
              f"{bench['revalidation']}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
