"""Paper Fig. 6: PUs per tile {1,4,16} at constant 64x64 total PUs.

Multiple PUs share one IQ -> hotspots from skew are softened. Expected:
PageRank benefits most (~2.5x at 16 PUs/tile); barrier-less apps less.
"""
from __future__ import annotations

from ..core.cache import SRAMConfig
from ..core.task_engine import EngineConfig
from ..core.topology import TileGrid
from .common import emit, improvements, load_datasets, sweep


def configs():
    # same total PUs / SRAM / bisection: scale tile resources with PU count
    return {
        "1pu": EngineConfig(
            grid=TileGrid(64, 64, "hier_torus", die_rows=16, die_cols=16),
            sram=SRAMConfig(kb_per_tile=512), pus_per_tile=1),
        "4pu": EngineConfig(
            grid=TileGrid(32, 32, "hier_torus", die_rows=8, die_cols=8,
                          noc_width_bits=128),
            sram=SRAMConfig(kb_per_tile=2048), pus_per_tile=4),
        "16pu": EngineConfig(
            grid=TileGrid(16, 16, "hier_torus", die_rows=4, die_cols=4,
                          noc_width_bits=256),
            sram=SRAMConfig(kb_per_tile=8192), pus_per_tile=16),
    }


def main(scale: int = 16):
    data = load_datasets(scale)
    rows = sweep(configs(), data)
    out = []
    for metric in ("teps", "teps_per_watt"):
        for c, v in improvements(rows, "1pu", metric).items():
            out.append(("fig6", c, metric, f"{v:.3f}"))
    # per-app detail (PageRank is the interesting case)
    base = {(d, a): r.teps for c, d, a, r in rows if c == "1pu"}
    for c, d, a, r in rows:
        if c != "1pu":
            out.append(("fig6_app", f"{c}/{a}/{d}", "teps",
                        f"{r.teps / base[(d, a)]:.3f}"))
    emit(out, "figure,config,metric,improvement_over_1pu")
    return rows, out


if __name__ == "__main__":
    main()
