"""``python -m repro_torch.dse.route_compare OLD.json NEW.json`` —
routing hot-path trajectory gate (the port's copy of
``repro/dse/route_compare.py``; sibling of :mod:`repro_torch.dse.compare`,
for the wall-clock ``dcra-route-bench/v2`` artifact ``BENCH_route.json``).

Absolute milliseconds do not transfer across machines (the committed
baseline is produced on a dev box, CI runs on shared runners), so the
gate compares what IS machine-portable — the within-run ratios:

* op-level ``cells``: each impl's **speedup vs the onehot baseline
  measured in the same run**;
* round-level ``round_cells``: each impl's **pipelined-vs-lockstep round
  speedup** — the headline win of ``round_mode="pipelined"``. If the
  fused round shape stops beating the two-pass shape, that is a code
  regression, not runner noise.

A cell+impl whose ratio falls more than ``--tol`` (default 20%) below
the committed baseline fails the build. Cells are matched by (n, s); a
cell or impl present in the baseline but missing from the new bench is a
failure (silent coverage loss); new cells are informational.

Exit codes: 0 ok; 1 bad input; 2 regression.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Sequence, Tuple

SCHEMA = "dcra-route-bench/v2"
# schemas this gate still understands as a *baseline* — a v1 baseline
# (no round_cells) gates only the op-level ratios until regenerated
COMPAT_SCHEMAS = ("dcra-route-bench/v1", SCHEMA)


def _cells(bench: Dict, kind: str) -> Dict[Tuple[int, int], Dict]:
    return {(c["n"], c["s"]): c for c in bench.get(kind, [])}


def _gate_ratios(co: Dict, cn: Dict, field: str, label: str, tol: float,
                 failures: List[str], notes: List[str]) -> None:
    """Gate one ratio dict (impl -> ratio) across matched (n, s) cells."""
    for key in sorted(co):
        if key not in cn:
            failures.append(f"{label} cell N={key[0]} S={key[1]}: missing "
                            f"from new bench")
            continue
        so = co[key].get(field, {})
        sn = cn[key].get(field, {})
        for impl in sorted(so):
            if impl not in sn:
                failures.append(f"{label} cell N={key[0]} S={key[1]} "
                                f"{impl}: missing from new bench")
                continue
            line = (f"{label} N={key[0]} S={key[1]} {impl}: "
                    f"{so[impl]:.2f}x -> {sn[impl]:.2f}x")
            if sn[impl] < so[impl] * (1.0 - tol):
                failures.append(f"{line}  REGRESSED beyond tol={tol:.0%}")
            else:
                notes.append(line)
    born = sorted(set(cn) - set(co))
    if born:
        notes.append(f"{len(born)} new {label} cell(s): {born} "
                     f"(informational)")


def compare(old: Dict, new: Dict, tol: float = 0.2
            ) -> Tuple[List[str], List[str]]:
    """Returns (failures, notes); empty failures == trajectory ok."""
    failures: List[str] = []
    notes: List[str] = []
    co, cn = _cells(old, "cells"), _cells(new, "cells")
    if not co:
        return ["old bench has no cells"], notes
    if not cn:
        return ["new bench has no cells"], notes
    # speedups only compare within one lowering: a baseline measured
    # under one backend or lowering says nothing of a re-measure under
    # another
    for field in ("backend", "pallas_lowering"):
        if old.get(field) != new.get(field):
            return [f"{field} mismatch: baseline {old.get(field)!r} vs "
                    f"new {new.get(field)!r} — regenerate the committed "
                    f"baseline on the comparison backend"], notes
    _gate_ratios(co, cn, "speedup_vs_onehot", "op", tol, failures, notes)
    ro = _cells(old, "round_cells")
    rn = _cells(new, "round_cells")
    if ro and not rn:
        failures.append("baseline has round_cells but new bench has none")
    elif not ro and rn:
        notes.append("baseline has no round_cells (v1?) — round-level "
                     "ratios reported but not gated; regenerate the "
                     "baseline to gate them")
    _gate_ratios(ro, rn, "round_speedup", "round", tol, failures, notes)
    return failures, notes


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old", help="committed baseline BENCH_route.json")
    ap.add_argument("new", help="freshly-benched BENCH_route.json")
    ap.add_argument("--tol", type=float, default=0.2,
                    help="relative speedup regression tolerance "
                         "(default 20%%)")
    args = ap.parse_args(argv)
    try:
        with open(args.old) as f:
            old = json.load(f)
        with open(args.new) as f:
            new = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"[dse.route_compare] bad input: {e}", file=sys.stderr)
        return 1
    for name, bench in (("old", old), ("new", new)):
        allowed = COMPAT_SCHEMAS if name == "old" else (SCHEMA,)
        if bench.get("schema") not in allowed:
            print(f"[dse.route_compare] bad input: {name} schema "
                  f"{bench.get('schema')!r} not in {allowed!r}",
                  file=sys.stderr)
            return 1
    failures, notes = compare(old, new, tol=args.tol)
    for line in notes:
        print(f"[dse.route_compare] {line}")
    for line in failures:
        print(f"[dse.route_compare] FAIL: {line}", file=sys.stderr)
    return 2 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
