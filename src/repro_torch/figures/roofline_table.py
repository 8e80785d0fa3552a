"""Roofline terms per (arch x shape) from the dry run's records.

Reads the port's dry-run results (``python -m repro_torch.launch.dryrun``
writes ``dryrun_results_torch.json`` at the repo root); if absent, emits
a pointer instead of recomputing (the dry run is its own entry point).
A term the port does not have (``None``: the collective term, which only
XLA's compiled HLO gives) prints as "—", as :mod:`repro_torch.launch.report`
prints it.

  PYTHONPATH=src python -m repro_torch.figures.roofline_table [PATH]
"""
from __future__ import annotations

import json
import os
import sys

from ..launch.dryrun import DEFAULT_OUT
from ..launch.report import DASH


def _num(v, spec: str) -> str:
    return DASH if v is None else format(v, spec)


def main(path=None):
    path = os.path.abspath(path or DEFAULT_OUT)
    if not os.path.exists(path):
        print(f"roofline_table,SKIPPED,run `PYTHONPATH=src python -m "
              f"repro_torch.launch.dryrun` first (writes {path})")
        return []
    with open(path) as f:
        rows = json.load(f)
    print("arch,shape,mesh,compute_s,memory_s,collective_s,bottleneck,"
          "model_flops_ratio,bytes_per_device")
    out = []
    for r in rows:
        if "error" in r:
            print(f"{r['arch']},{r['shape']},{r['mesh']},ERROR,,,{r['error'][:60]},,")
            continue
        if "skipped" in r:
            print(f"{r['arch']},{r['shape']},{r['mesh']},SKIP,,,"
                  f"{r['skipped'][:60]},,")
            continue
        if r.get("tag"):
            continue   # hillclimb variants belong to §Perf
        line = (f"{r['arch']},{r['shape']},{r['mesh']},"
                f"{_num(r['compute_s'], '.3e')},{_num(r['memory_s'], '.3e')},"
                f"{_num(r['collective_s'], '.3e')},{r['bottleneck']},"
                f"{_num(r.get('model_flops_ratio', 0), '.3f')},"
                f"{_num(r.get('bytes_per_device', 0), '.3e')}")
        print(line)
        out.append(r)
    return out


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
