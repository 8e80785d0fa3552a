"""Paper Fig. 8/9: DCRA-SRAM vs Dalorex vs DCRA-HBM (packaging-time knob).

The three systems are :class:`repro_torch.dse.space.DesignPoint`\\ s
differing in the package-time memory-tech axis (and Dalorex's pre-silicon
die/SRAM choices): the same points the DSE sweep enumerates, sized per
dataset to the smallest deployment grid where it fits.

Each system runs at the smallest parallelization where the dataset fits:
DCRA-HBM (8MB/PU incl. HBM) smallest grid, Dalorex (2MB SRAM/tile) 4x tiles,
DCRA-SRAM (512KB/tile) 16x tiles. Expected: DCRA-SRAM fastest (most
scaled-out); DCRA-HBM best TEPS/$ nearly across the board; energy mixed.
Also emits the Fig. 9 energy breakdown (PU / memory / NoC shares).
"""
from __future__ import annotations

import math

from ..costmodel.silicon import monolithic_wafer_cost
from ..dse.space import DesignPoint
from .common import APPS, config_cost, emit, evaluate, load_datasets


def _side_for(n_tiles: int, die: int = 16) -> int:
    return max(int(math.sqrt(n_tiles)), die)


def design_points(dataset_bytes: float):
    """Size each system to the smallest grid where the dataset fits."""
    def tiles_needed(bytes_per_tile):
        # scale-reduced datasets can fit one tile: clamp the shift at 0
        need = max(dataset_bytes / bytes_per_tile, 1.0)
        return max(256, 1 << max(0, math.ceil(math.log2(need))))
    hbm_tiles = tiles_needed(8 * 2**20)          # 8MB/PU with HBM
    dal_tiles = hbm_tiles * 4                     # 2MB SRAM/tile
    sram_tiles = dal_tiles * 4                    # 512KB SRAM/tile
    return {
        "DCRA-HBM": DesignPoint(
            grid_side=_side_for(hbm_tiles), die_side=16,
            sram_kb_per_tile=512, mem_tech="hbm"),
        "Dalorex": DesignPoint(
            grid_side=_side_for(dal_tiles, die=64), die_side=64,
            topology="torus", sram_kb_per_tile=2048, mem_tech="sram"),
        "DCRA-SRAM": DesignPoint(
            grid_side=_side_for(sram_tiles), die_side=16,
            sram_kb_per_tile=512, mem_tech="sram"),
    }


def systems(dataset_bytes: float):
    return {name: p.engine_config()
            for name, p in design_points(dataset_bytes).items()}


def main(scale: int = 16):
    data = load_datasets(scale)
    out = []
    for dname, g in data.items():
        cfgs = systems(g.memory_bytes())
        for cname, cfg in cfgs.items():
            cost = (monolithic_wafer_cost() if cname == "Dalorex"
                    else config_cost(cfg))
            for app in APPS:
                r = evaluate(cfg, g, app, cost_usd=cost)
                out.append(("fig8", cname, dname, app, f"{r.teps:.3e}",
                            f"{r.teps_per_dollar:.3e}",
                            f"{r.teps_per_watt:.3e}"))
                b = r.breakdown
                out.append(("fig9", cname, dname, app,
                            f"pu={b.pu_j / b.total_j:.2f}",
                            f"mem={b.memory_j / b.total_j:.2f}",
                            f"noc={b.noc_j / b.total_j:.2f}"))
    emit(out, "figure,system,dataset,app,teps|pu,teps_per_usd|mem,teps_per_w|noc")
    return out


if __name__ == "__main__":
    main()
