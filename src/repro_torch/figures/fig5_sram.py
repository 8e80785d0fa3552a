"""Paper Fig. 5: SRAM/tile {64..512KB} x tiles-per-HBM-channel, 32x32 tiles.

Expected trends: perf rises strongly with SRAM (hit-rate -> effective BW;
~2.6x geomean 64KB->512KB); 16x16 tiles/die (4x DRAM BW per tile) adds
~1.4x perf but ~halves perf-per-dollar (4x more HBM devices).
"""
from __future__ import annotations

from ..core.cache import DRAMConfig, SRAMConfig
from ..core.task_engine import EngineConfig
from ..core.topology import TileGrid
from .common import emit, improvements, load_datasets, sweep


def configs():
    out = {}
    for kb in (64, 128, 256, 512):
        # 32x32 tiles per die -> 1024 tiles per 8-channel HBM: T/C = 128
        out[f"{kb}KB_TC128"] = EngineConfig(
            grid=TileGrid(32, 32, "hier_torus", die_rows=32, die_cols=32),
            sram=SRAMConfig(kb_per_tile=kb),
            dram=DRAMConfig(tiles_per_die=1024))
    # 16x16 tiles per die -> 256 tiles/HBM: T/C = 32 (4x BW per tile)
    out["512KB_TC32"] = EngineConfig(
        grid=TileGrid(32, 32, "hier_torus", die_rows=16, die_cols=16),
        sram=SRAMConfig(kb_per_tile=512),
        dram=DRAMConfig(tiles_per_die=256))
    return out


def main(scale: int = 16):
    data = load_datasets(scale)
    rows = sweep(configs(), data)
    out = []
    for metric in ("teps", "teps_per_watt", "teps_per_dollar"):
        for c, v in improvements(rows, "64KB_TC128", metric).items():
            out.append(("fig5", c, metric, f"{v:.3f}"))
    emit(out, "figure,config,metric,geomean_improvement_over_64KB_TC128")
    return rows, out


if __name__ == "__main__":
    main()
