"""``python -m repro_torch.dse.compare OLD.json NEW.json`` — frontier trajectory
regression gate between successive ``BENCH_dse.json`` artifacts.

Two ``dcra-dse-bench`` files are compared on what the frontier *delivers*,
not on point identity (point-id formats may evolve across PRs):

* **per-objective bests** over the Pareto set — max TEPS, min watts, min
  $/package, max TEPS/$ — each must not regress beyond ``--tol``
  (relative);
* **common frontier points** (matched by point_id) are reported
  individually; a common point whose TEPS geomean regressed beyond the
  tolerance is a failure too (the same hardware point got slower — a
  model change, not a frontier shift);
* **per-app frontier bests** (schema v2 ``app_frontiers``): when BOTH
  files record app-specific Pareto slices, each common app's best slice
  TEPS must not regress beyond the tolerance either; a file pair mixing
  v1 and v2 skips this leg with a note (an older artifact may predate
  the slices);
* structural drift (points only in one file, frontier size change) is
  reported but informational.

Accepts both tracked schemas (``dcra-dse-bench/v1`` and ``/v2``) on
either side.

Exit codes: 0 ok; 1 bad input; 2 frontier regression.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Dict, List, Optional, Sequence, Tuple

SCHEMAS = ("dcra-dse-bench/v1", "dcra-dse-bench/v2")

# (name, metrics key, direction): the sweep's objective axes
OBJECTIVE_BESTS: Tuple[Tuple[str, str, str], ...] = (
    ("teps", "teps_geomean", "max"),
    ("watts", "watts_geomean", "min"),
    ("package_usd", "package_usd", "min"),
    ("teps_per_usd", "teps_per_usd", "max"),
)


def frontier_metrics(bench: Dict) -> Dict[str, Dict]:
    """point_id -> metrics for the Pareto records of a bench file."""
    return {r["point_id"]: r["metrics"] for r in bench.get("points", [])
            if r.get("pareto") and "metrics" in r}


def objective_bests(frontier: Dict[str, Dict]) -> Dict[str, float]:
    out = {}
    for name, key, direction in OBJECTIVE_BESTS:
        vals = [m[key] for m in frontier.values() if key in m]
        if vals:
            out[name] = max(vals) if direction == "max" else min(vals)
    return out


def _regressed(name: str, old: float, new: float, tol: float) -> bool:
    direction = {n: d for n, _, d in OBJECTIVE_BESTS}[name]
    if direction == "max":
        return new < old * (1.0 - tol)
    return new > old * (1.0 + tol)


def app_bests(bench: Dict) -> Dict[str, float]:
    """app -> best per-app TEPS geomean over that app's frontier slice
    (empty when the bench predates schema v2's ``app_frontiers``)."""
    fronts = bench.get("app_frontiers") or {}
    by_id = {r["point_id"]: r for r in bench.get("points", [])
             if "metrics" in r}
    out: Dict[str, float] = {}
    for app, pids in fronts.items():
        vals = []
        for pid in pids:
            rec = by_id.get(pid)
            if rec is None:
                continue
            cells = [c["teps"] for name, c in rec.get("per_cell",
                                                      {}).items()
                     if name.split(":")[0] == app]
            if cells:
                vals.append(math.exp(sum(math.log(max(c, 1e-12))
                                         for c in cells) / len(cells)))
        if vals:
            out[app] = max(vals)
    return out


def compare(old: Dict, new: Dict, tol: float = 0.05
            ) -> Tuple[List[str], List[str]]:
    """Returns (failures, notes); empty failures == trajectory ok."""
    failures: List[str] = []
    notes: List[str] = []
    fo, fn = frontier_metrics(old), frontier_metrics(new)
    if not fo:
        return ["old bench has no frontier points"], notes
    if not fn:
        return ["new bench has no frontier points"], notes

    bo, bn = objective_bests(fo), objective_bests(fn)
    for name in bo:
        if name not in bn:
            failures.append(f"objective {name}: missing from new frontier")
            continue
        line = f"best {name}: {bo[name]:.6g} -> {bn[name]:.6g}"
        if _regressed(name, bo[name], bn[name], tol):
            failures.append(f"{line}  REGRESSED beyond tol={tol:.0%}")
        else:
            notes.append(line)

    ao, an = app_bests(old), app_bests(new)
    if ao and an:
        for app in sorted(set(ao) & set(an)):
            line = f"best {app} teps: {ao[app]:.6g} -> {an[app]:.6g}"
            if an[app] < ao[app] * (1.0 - tol):
                failures.append(f"{line}  REGRESSED beyond tol={tol:.0%}")
            else:
                notes.append(line)
    elif ao or an:
        notes.append("per-app frontier slices present on one side only "
                     "(v1/v2 mix) — per-app leg skipped")

    common = sorted(set(fo) & set(fn))
    for pid in common:
        t_old, t_new = fo[pid]["teps_geomean"], fn[pid]["teps_geomean"]
        if t_new < t_old * (1.0 - tol):
            failures.append(f"point {pid}: teps {t_old:.6g} -> {t_new:.6g} "
                            f"REGRESSED beyond tol={tol:.0%}")
    gone, born = sorted(set(fo) - set(fn)), sorted(set(fn) - set(fo))
    if gone or born:
        notes.append(f"frontier drift: {len(gone)} point(s) left, "
                     f"{len(born)} joined (structural, informational)")
    notes.append(f"frontier size {len(fo)} -> {len(fn)}, "
                 f"{len(common)} common point(s)")
    return failures, notes


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old", help="previous BENCH_dse.json")
    ap.add_argument("new", help="freshly-swept BENCH_dse.json")
    ap.add_argument("--tol", type=float, default=0.05,
                    help="relative regression tolerance (default 5%%)")
    args = ap.parse_args(argv)
    try:
        with open(args.old) as f:
            old = json.load(f)
        with open(args.new) as f:
            new = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"[dse.compare] bad input: {e}", file=sys.stderr)
        return 1
    for name, bench in (("old", old), ("new", new)):
        schema = bench.get("schema")
        if schema is not None and schema not in SCHEMAS:
            print(f"[dse.compare] bad input: {name} schema {schema!r} "
                  f"not in {SCHEMAS}", file=sys.stderr)
            return 1
    failures, notes = compare(old, new, tol=args.tol)
    for line in notes:
        print(f"[dse.compare] {line}")
    for line in failures:
        print(f"[dse.compare] FAIL: {line}", file=sys.stderr)
    return 2 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
