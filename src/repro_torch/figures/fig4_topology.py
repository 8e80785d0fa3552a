"""Paper Fig. 4: NoC topology/width/frequency sweep on 64x64 tiles.

Configs are :class:`repro_torch.dse.space.DesignPoint`\\ s: figure
reproduction and the DSE sweep share one code path; this figure is the
named compile-time/pre-silicon slice of the space (topology x link width
x NoC frequency at a fixed 64x64 deployment).

Expected trends: mesh width 2x -> ~2x perf; torus ~2.6x geomean over 32-bit
mesh (up to ~8x for SPMV); hierarchical torus adds ~+9% perf and ~+19%
energy efficiency; 2GHz NoC adds little perf (~3%) at 3x cost.
"""
from __future__ import annotations

from ..dse.space import DesignPoint
from .common import emit, improvements, load_datasets, sweep

SIDE = 64
DIE = 16  # 16 chiplets of 16x16 tiles (paper: 16 chiplets of 32x32)

BASE = DesignPoint(grid_side=SIDE, die_side=DIE, mem_tech="hbm",
                   dies_per_package=16)

POINTS = {
    "mesh32": BASE.with_(topology="mesh", noc_width_bits=32),
    "mesh64": BASE.with_(topology="mesh", noc_width_bits=64),
    "torus64": BASE.with_(topology="torus", noc_width_bits=64),
    "hier64": BASE.with_(topology="hier_torus", noc_width_bits=64),
    "hier64_2ghz": BASE.with_(topology="hier_torus", noc_width_bits=64,
                              noc_freq_ghz=2.0),
}


def configs():
    return {name: p.engine_config() for name, p in POINTS.items()}


def main(scale: int = 16):
    data = load_datasets(scale)
    rows = sweep(configs(), data)
    out = []
    for metric in ("teps", "teps_per_watt", "teps_per_dollar"):
        imp = improvements(rows, "mesh32", metric)
        for c, v in imp.items():
            out.append(("fig4", c, metric, f"{v:.3f}"))
    emit(out, "figure,config,metric,geomean_improvement_over_mesh32")
    return rows, out


if __name__ == "__main__":
    main()
