"""Paper Fig. 7: PU frequency {0.25, 0.5, 1, 2} GHz, 64x64 tiles, 512KB.

Expected: ~linear to 1GHz, then saturation (2GHz ~ +38% geomean over 1GHz).
"""
from __future__ import annotations

from ..core.cache import SRAMConfig
from ..core.task_engine import EngineConfig
from ..core.topology import TileGrid
from .common import emit, improvements, load_datasets, sweep


def configs():
    grid = TileGrid(64, 64, "hier_torus", die_rows=16, die_cols=16)
    return {f"{f}GHz": EngineConfig(grid=grid,
                                    sram=SRAMConfig(kb_per_tile=512),
                                    pu_freq_ghz=f)
            for f in (0.25, 0.5, 1.0, 2.0)}


def main(scale: int = 16):
    data = load_datasets(scale)
    rows = sweep(configs(), data)
    out = []
    for metric in ("teps", "teps_per_watt"):
        for c, v in improvements(rows, "0.25GHz", metric).items():
            out.append(("fig7", c, metric, f"{v:.3f}"))
    emit(out, "figure,config,metric,geomean_improvement_over_250MHz")
    return rows, out


if __name__ == "__main__":
    main()
