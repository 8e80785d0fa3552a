"""Paper Fig. 11: strong scaling of one dataset across grid sizes.

Expected: throughput rises sub-linearly (message hops/work grow with the
grid); TEPS/W roughly stable; TEPS/$ peaks at a modest grid (~64x64 in the
paper) because cost grows linearly while speedup saturates.
"""
from __future__ import annotations

from ..core.cache import DRAMConfig, SRAMConfig
from ..core.task_engine import EngineConfig
from ..core.topology import TileGrid
from ..sparse import datasets
from .common import emit, evaluate

GRIDS = (16, 32, 64, 128)


def main(scale: int = 16, app: str = "pagerank"):
    g = datasets.rmat(scale, edge_factor=16, seed=1)
    out = []
    for side in GRIDS:
        cfg = EngineConfig(
            grid=TileGrid(side, side, "hier_torus", die_rows=16, die_cols=16),
            sram=SRAMConfig(kb_per_tile=512),
            dram=DRAMConfig(present=True))
        r = evaluate(cfg, g, app)
        out.append(("fig11", f"{side}x{side}", app, f"{r.teps:.3e}",
                    f"{r.teps_per_watt:.3e}", f"{r.teps_per_dollar:.3e}",
                    r.hops))
    emit(out, "figure,grid,app,teps,teps_per_watt,teps_per_dollar,total_hops")
    return out


if __name__ == "__main__":
    main()
