"""Shared figure machinery: run the seven apps on a DCRA config, report
TEPS / TEPS-per-watt / TEPS-per-dollar (paper §V metrics).

The evaluation primitives (``evaluate`` / ``config_cost`` / ``run_app`` /
``load_datasets``) live in :mod:`repro_torch.dse.evaluate`: the DSE
engine and the figures share one analytic code path; this module keeps
the presentation helpers (sweeps over named configs, geomean
improvement tables, CSV emission).

Datasets are scale-reduced stand-ins with the paper's *names* retained;
trends, not absolute TEPS, are the reproduction target (the absolute
numbers need the cycle-accurate Dalorex simulator).
"""
from __future__ import annotations

import subprocess
from typing import Dict, List, Optional, Tuple

from ..core.task_engine import EngineConfig
from ..dse.evaluate import (APPS, ConfigResult, config_cost,  # noqa: F401
                            evaluate, geomean, load_datasets, run_app)


def sweep(configs: Dict[str, EngineConfig], data: Dict[str, object],
          apps_list=APPS, baseline: Optional[str] = None
          ) -> List[Tuple[str, str, str, ConfigResult]]:
    """Every (config, dataset, app) cell through :func:`evaluate`."""
    rows = []
    for cname, cfg in configs.items():
        for dname, g in data.items():
            for app in apps_list:
                rows.append((cname, dname, app, evaluate(cfg, g, app)))
    return rows


def improvements(rows, baseline: str, metric: str) -> Dict[str, float]:
    """Geomean improvement of each config over the baseline config."""
    base = {(d, a): getattr(r, metric)
            for c, d, a, r in rows if c == baseline}
    out: Dict[str, List[float]] = {}
    for c, d, a, r in rows:
        if c == baseline:
            continue
        out.setdefault(c, []).append(getattr(r, metric) / max(base[(d, a)],
                                                              1e-12))
    return {c: geomean(v) for c, v in out.items()}


def emit(rows_csv: List[Tuple], header: str):
    """Print ``header`` and one comma-joined line a row."""
    print(header)
    for row in rows_csv:
        print(",".join(str(x) for x in row))


def card_record(device) -> Dict[str, str]:
    """``{"name", "power_limit"}`` of the card ``device`` names, as
    ``nvidia-smi --query-gpu=name,power.limit`` gives them: what a
    benchmark artifact measured on the card carries beside its times."""
    out = subprocess.run(
        ["nvidia-smi", "-i", str(device.index or 0),
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    name, limit = out.strip().rsplit(", ", 1)
    return {"name": name, "power_limit": limit}
