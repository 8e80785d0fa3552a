"""DCRA NoC topology model: mesh / torus / hierarchical (tile-NoC + die-NoC).

Reproduces the paper's §III-A network structure analytically:
* tiles in an R×C grid, grouped into dies of (dr×dc) tiles;
* the *tile-NoC* connects all tiles (mesh or folded torus — folding makes all
  links near-equal length, paper Fig. 2);
* the *die-NoC* hops once per die (radix-9 edge routers) — the paper's
  mechanism for cutting long-distance hop counts;
* topology is a runtime ("software") configuration — exactly the paper's
  reconfigurability claim — so the same ``TileGrid`` can be evaluated as any
  topology, including a torus spanning multiple dies/packages.

Vectorised hop/energy accounting: callers pass arrays of (src_tile,
dst_tile) and get hop counts / wire lengths back (numpy, no python loops).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import numpy as np

TOPOLOGIES = ("mesh", "torus", "hier_torus")


@dataclass(frozen=True)
class TileGrid:
    rows: int
    cols: int
    topology: str = "hier_torus"
    die_rows: int = 32            # tiles per die edge (32x32 default, §V-B)
    die_cols: int = 32
    noc_width_bits: int = 64      # Fig. 4 sweeps 32/64
    noc_freq_ghz: float = 1.0     # Fig. 4 tests 2.0 (double-pumped)

    @property
    def n_tiles(self) -> int:
        return self.rows * self.cols

    @property
    def dies(self) -> Tuple[int, int]:
        return (max(1, self.rows // self.die_rows),
                max(1, self.cols // self.die_cols))

    def coords(self, tile: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        return tile // self.cols, tile % self.cols

    # ---- hop counting --------------------------------------------------
    def _axis_hops(self, a, b, n, torus: bool):
        d = np.abs(a - b)
        return np.minimum(d, n - d) if torus else d

    def hops(self, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
        """Router-to-router hops per message (vectorised)."""
        sr, sc = self.coords(src)
        dr, dc = self.coords(dst)
        if self.topology == "mesh":
            return self._axis_hops(sr, dr, self.rows, False) + \
                   self._axis_hops(sc, dc, self.cols, False)
        if self.topology == "torus":
            return self._axis_hops(sr, dr, self.rows, True) + \
                   self._axis_hops(sc, dc, self.cols, True)
        # hierarchical: intra-die torus; inter-die: travel to the die portal
        # (one hop per die on the die-NoC, paper Fig. 2), then local delivery.
        sdr, sdc = sr // self.die_rows, sc // self.die_cols
        ddr, ddc = dr // self.die_rows, dc // self.die_cols
        same_die = (sdr == ddr) & (sdc == ddc)
        # intra-die component (torus folded within the die)
        intra = (self._axis_hops(sr % self.die_rows, dr % self.die_rows,
                                 self.die_rows, True)
                 + self._axis_hops(sc % self.die_cols, dc % self.die_cols,
                                   self.die_cols, True))
        # to-portal + die-NoC hops (torus over dies) + from-portal
        n_dr, n_dc = self.dies
        die_hops = self._axis_hops(sdr, ddr, n_dr, True) + \
                   self._axis_hops(sdc, ddc, n_dc, True)
        # average distance to the portal ~ half the die diameter
        portal = (self.die_rows + self.die_cols) // 4
        return np.where(same_die, intra, portal * 2 + die_hops)

    def die_crossings(self, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
        """# of die-to-die link traversals (for energy: 0.55 pJ/bit each)."""
        sr, sc = self.coords(src)
        dr, dc = self.coords(dst)
        sdr, sdc = sr // self.die_rows, sc // self.die_cols
        ddr, ddc = dr // self.die_rows, dc // self.die_cols
        if self.topology == "hier_torus":
            n_dr, n_dc = self.dies
            return self._axis_hops(sdr, ddr, n_dr, True) + \
                   self._axis_hops(sdc, ddc, n_dc, True)
        # flat topologies cross die boundaries along the path
        return np.abs(sdr - ddr) + np.abs(sdc - ddc)

    # ---- aggregate properties -------------------------------------------
    def bisection_links(self) -> int:
        base = min(self.rows, self.cols)
        mult = {"mesh": 1, "torus": 2, "hier_torus": 2}[self.topology]
        return base * mult

    def bisection_bytes_per_cycle(self) -> float:
        return self.bisection_links() * self.noc_width_bits / 8.0

    def avg_uniform_hops(self) -> float:
        """Mean hops under uniform random traffic.

        Exact closed form for the flat topologies (per-axis expectation of
        the distance between two independent uniform coordinates, summed
        over the two axes): mesh ``E|a-b| = (n^2-1)/(3n)``; torus
        ``E[min(d, n-d)] = n/4`` (even ``n``) or ``(n^2-1)/(4n)`` (odd).
        ``hier_torus`` has no simple closed form (the portal detour makes
        the axes non-separable), so it stays a seeded Monte-Carlo sample.
        """
        if self.topology == "mesh":
            def axis(n):
                return (n * n - 1) / (3.0 * n)
            return axis(self.rows) + axis(self.cols)
        if self.topology == "torus":
            def axis(n):
                return n / 4.0 if n % 2 == 0 else (n * n - 1) / (4.0 * n)
            return axis(self.rows) + axis(self.cols)
        n = 4096
        rng = np.random.default_rng(0)
        s = rng.integers(0, self.n_tiles, n)
        d = rng.integers(0, self.n_tiles, n)
        return float(self.hops(s, d).mean())

    def with_(self, **kw) -> "TileGrid":
        return dataclasses.replace(self, **kw)
