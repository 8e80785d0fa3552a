"""Paper Fig. 10: output-queue sizing (OQ2 vs OQ1), 64x64 tiles.

OQ2 holds per-edge vertex-update pushes; OQ1 holds per-vertex edge lookups.
Expected: sizing OQ2 up to ~the average degree helps (R-MAT avg 32 gains
more than WK avg 25, which mostly helps SPMV).
"""
from __future__ import annotations

from ..core.queues import QueueConfig
from ..core.task_engine import EngineConfig
from ..core.topology import TileGrid
from .common import emit, load_datasets, sweep

OQ1 = 12


def configs():
    grid = TileGrid(64, 64, "hier_torus", die_rows=16, die_cols=16)
    out = {}
    for mult in (1, 2, 4, 8, 16):
        out[f"OQ2_{mult}x"] = EngineConfig(
            grid=grid,
            queues=QueueConfig(oq_sizes={"T3": OQ1 * mult}, default_oq=OQ1))
    return out


def main(scale: int = 16):
    data = load_datasets(scale)
    apps_list = ("sssp", "pagerank", "bfs", "wcc", "spmv")  # histogram: 2 tasks
    rows = sweep(configs(), data, apps_list=apps_list)
    out = []
    base = {(d, a): r.teps for c, d, a, r in rows if c == "OQ2_1x"}
    for c, d, a, r in rows:
        if c != "OQ2_1x":
            out.append(("fig10", c, a, d, f"{r.teps / base[(d, a)]:.3f}"))
    emit(out, "figure,config,app,dataset,teps_improvement_over_OQ2=OQ1")
    return rows, out


if __name__ == "__main__":
    main()
