"""``python -m repro_torch.dse.serve_compare OLD.json NEW.json`` —
serving trajectory gate (the port's copy of ``repro/dse/serve_compare.py``;
sibling of :mod:`repro_torch.dse.route_compare`, for the wall-clock
``dcra-serve-bench/v1`` artifact ``BENCH_serve.json``).

Absolute req/s do not transfer across machines (the committed baseline
is produced on a dev box, CI runs on shared runners), so the gate
compares what IS machine-portable — the within-run ratio:

* ``overlap_speedup``: the overlapped drain's throughput over the
  synchronous drain's, measured back-to-back in the same run on the
  same stream. This is the headline win of the inflight launch window
  (``ServeOptions.inflight_depth``); if pipelined serving stops beating
  the synchronous loop, that is a code regression, not runner noise.

The new bench fails the build when its ``overlap_speedup`` falls more
than ``--tol`` (default 15%) below the committed baseline's, and both
benches must carry a sync AND an overlapped row (silent coverage loss
is a failure). Speedups only compare within one backend.

Exit codes: 0 ok; 1 bad input; 2 regression.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Sequence, Tuple

SCHEMA = "dcra-serve-bench/v1"
REQUIRED_MODES = ("sync", "overlapped")


def compare(old: Dict, new: Dict, tol: float = 0.15
            ) -> Tuple[List[str], List[str]]:
    """Returns (failures, notes); empty failures == trajectory ok."""
    failures: List[str] = []
    notes: List[str] = []
    for name, bench in (("old", old), ("new", new)):
        modes = {r.get("mode") for r in bench.get("rows", [])}
        missing = [m for m in REQUIRED_MODES if m not in modes]
        if missing:
            failures.append(f"{name} bench is missing {missing} row(s)")
    if failures:
        return failures, notes
    if old.get("backend") != new.get("backend"):
        return [f"backend mismatch: baseline {old.get('backend')!r} vs "
                f"new {new.get('backend')!r} — regenerate the committed "
                f"baseline on the comparison backend"], notes
    so = float(old["overlap_speedup"])
    sn = float(new["overlap_speedup"])
    line = (f"overlap_speedup: {so:.2f}x -> {sn:.2f}x "
            f"(depth={new.get('config', {}).get('depth')})")
    if sn < so * (1.0 - tol):
        failures.append(f"{line}  REGRESSED beyond tol={tol:.0%}")
    else:
        notes.append(line)
    for row in new["rows"]:
        if row.get("re_traces", 0) != 0:
            failures.append(f"{row['mode']} row re-traced "
                            f"{row['re_traces']} kernels under load")
    return failures, notes


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old", help="committed baseline BENCH_serve.json")
    ap.add_argument("new", help="freshly-benched BENCH_serve.json")
    ap.add_argument("--tol", type=float, default=0.15,
                    help="relative speedup regression tolerance "
                         "(default 15%%)")
    args = ap.parse_args(argv)
    try:
        with open(args.old) as f:
            old = json.load(f)
        with open(args.new) as f:
            new = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"[dse.serve_compare] bad input: {e}", file=sys.stderr)
        return 1
    for name, bench in (("old", old), ("new", new)):
        if bench.get("schema") != SCHEMA:
            print(f"[dse.serve_compare] bad input: {name} schema "
                  f"{bench.get('schema')!r} != {SCHEMA!r}",
                  file=sys.stderr)
            return 1
    failures, notes = compare(old, new, tol=args.tol)
    for line in notes:
        print(f"[dse.serve_compare] {line}")
    for line in failures:
        print(f"[dse.serve_compare] FAIL: {line}", file=sys.stderr)
    return 2 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
