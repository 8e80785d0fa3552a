"""Generic resumable sweep driver.

One loop for every sweep client (here the DSE sweep CLI): each one
iterates "evaluate a config point, record a dict, skip what's done,
never let one failure kill the sweep". This module owns that loop:

* each unit of work is a :class:`SweepTask` — a dedup ``key``, a ``run``
  thunk returning the result record, and static ``meta`` merged into the
  record (also the error record, so failures stay attributable);
* :func:`run_sweep` resumes from an existing JSON list (``key_of`` maps
  previously-written records back to task keys), appends one record per
  task, and rewrites the file after every task so a crash loses at most
  the in-flight point.

Every record — error records included — is stamped with its ``task_key``,
so resume never depends on ``key_of`` being able to reconstruct a key from
a failure payload (a record without a key would be re-run on every
resume while its stale error records piled up in the file). Re-running failures is now an
explicit choice: ``retry_errors=True`` drops the matching error records
and runs those tasks again; the default treats them as done.
"""
from __future__ import annotations

import json
import os
import traceback
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence


@dataclass
class SweepTask:
    key: str
    run: Callable[[], Dict]
    meta: Dict = field(default_factory=dict)


def load_results(out: Optional[str]) -> List[Dict]:
    if out and os.path.exists(out):
        with open(out) as f:
            return json.load(f)
    return []


def _write(out: Optional[str], results: List[Dict]) -> None:
    if out:
        with open(out, "w") as f:
            json.dump(results, f, indent=1)


def record_key(rec: Dict,
               key_of: Optional[Callable[[Dict], Optional[str]]] = None
               ) -> Optional[str]:
    """A record's task key: the stamped ``task_key`` wins, ``key_of`` is
    the fallback for files written before stamping existed."""
    key = rec.get("task_key")
    if key is None and key_of is not None:
        key = key_of(rec)
    return key


def run_sweep(tasks: Iterable[SweepTask], out: Optional[str] = None,
              resume: bool = True,
              key_of: Optional[Callable[[Dict], Optional[str]]] = None,
              verbose: bool = True,
              raise_errors: bool = False,
              retry_errors: bool = False) -> List[Dict]:
    """Run every task not already recorded; returns the full record list.

    ``out=None`` keeps everything in memory (single-shot sweeps that
    post-process before writing, e.g. the BENCH emitter). Every record is
    stamped with its ``task_key`` so errored points resume as *done*;
    ``retry_errors=True`` re-runs them instead (their stale error records
    are dropped, not duplicated).
    """
    tasks = list(tasks)
    results = load_results(out) if resume else []
    if retry_errors:
        keys = {t.key for t in tasks}
        results = [r for r in results
                   if not ("error" in r and record_key(r, key_of) in keys)]
    done = {record_key(r, key_of) for r in results}
    for task in tasks:
        if task.key in done:
            continue
        try:
            rec = dict(task.run())
        except Exception as e:  # record and continue — sweeps must finish
            if raise_errors:
                raise
            traceback.print_exc()
            rec = {"error": f"{type(e).__name__}: {e}"}
        rec.setdefault("task_key", task.key)
        for k, v in task.meta.items():
            rec.setdefault(k, v)
        results.append(rec)
        done.add(task.key)
        _write(out, results)
        if verbose and "error" in rec:
            print(f"[sweep] {task.key}: ERROR {rec['error']}", flush=True)
    return results


def summarize(results: Sequence[Dict], ok_field: str) -> str:
    ok = sum(1 for r in results if ok_field in r)
    skip = sum(1 for r in results if "skipped" in r)
    err = sum(1 for r in results if "error" in r)
    return f"{ok} ok, {skip} skipped, {err} errors"
