"""Graph analytics on the PyTorch port: all seven apps (the paper's six +
k-core) on one dataset, with the paper's target metrics (TEPS, TEPS/W,
TEPS/$) and the design-space comparison the paper advocates (SRAM-only
vs HBM packaging); counterpart of ``examples/graph_analytics.py``.

``--distributed`` also runs every app as a TaskProgram on 8 virtual
shards of ``--device`` (the card unless named) through the owner-routed
NoC layer in ``repro_torch.core.routing``, checks each against its numpy
oracle and prints per-app rounds / routed messages / IQ drops, then the
Pareto-guided launch (``config="auto"``) for BFS.

  PYTHONPATH=src python examples/graph_analytics_torch.py [--scale 12]
      [--distributed] [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core.cache import DRAMConfig, SRAMConfig
from repro_torch.core.fabric import Fabric
from repro_torch.core.task_engine import EngineConfig
from repro_torch.core.topology import TileGrid
from repro_torch.figures.common import APPS, evaluate
from repro_torch.sparse import datasets, ref

N_SHARDS = 8
KCORE_K = 16


def run_distributed(g, device=None):
    """All seven apps on ``N_SHARDS`` virtual shards of ``device``, then
    BFS under ``autoconfigure(g, "bfs")``; prints a row each and returns
    ``[(name, got, want, stats)]`` with the dense vector ``x`` and the
    histogram's elements."""
    from repro_torch.dse.autoconfig import autoconfigure
    from repro_torch.sparse.options import LaunchOptions
    from repro_torch.sparse.program import AppStats
    from repro_torch.sparse.torch_apps import (dcra_bfs, dcra_histogram,
                                               dcra_kcore, dcra_pagerank,
                                               dcra_spmv, dcra_sssp, dcra_wcc)
    fabric = Fabric.fake(N_SHARDS, device=device)
    stream = LaunchOptions(capacity_factor=3.0)
    x = np.random.default_rng(0).random(g.n)
    els = datasets.histogram_data(1 << 14, 256)
    hdr = f"{'app':10s} {'rounds':>7s} {'messages':>10s} {'drops':>7s} " \
          f"{'max_err':>10s}"
    print(f"distributed path ({N_SHARDS} shards on {fabric.device}, "
          f"owner-routed rounds)")
    print(hdr)
    print("-" * len(hdr))
    rows = []

    def row(name, got, want, stats):
        err = float(np.max(np.abs(np.asarray(got, np.float64) -
                                  np.asarray(want, np.float64))))
        print(f"{name:10s} {stats.rounds:7d} {stats.total_messages:10d} "
              f"{stats.total_drops:7d} {err:10.2e}")
        rows.append((name, got, want, stats))

    y, drops = dcra_spmv(g, x, fabric, options=stream)
    row("spmv", y, ref.spmv_ref(g, x),
        AppStats(1, np.array([g.nnz]), np.array([int(drops)])))
    h, drops = dcra_histogram(els, 256, fabric, options=stream)
    row("histogram", h, ref.histogram_ref(els, 256),
        AppStats(1, np.array([len(els)]), np.array([int(drops)])))
    d, st = dcra_bfs(g, 0, fabric)
    row("bfs", d, ref.bfs_ref(g, 0), st)
    s, st = dcra_sssp(g, 0, fabric)
    want = ref.sssp_ref(g, 0)
    row("sssp", np.where(np.isfinite(s), s, -1),
        np.where(np.isfinite(want), want, -1), st)
    p, st = dcra_pagerank(g, fabric)
    row("pagerank", p, ref.pagerank_ref(g), st)
    w, st = dcra_wcc(g, fabric)
    row("wcc", w, ref.wcc_ref(g), st)
    k, st = dcra_kcore(g, KCORE_K, fabric)
    row("kcore", k, ref.kcore_ref(g, KCORE_K), st)
    print()

    # Pareto-guided launch: pick the deployment from the tracked frontier
    # instead of hand-tuning capacity_factor (repro_torch.dse.autoconfig)
    lc = autoconfigure(g, "bfs")
    print(f"auto-config (bfs, objective=teps): {lc.point.point_id} "
          f"[{lc.source}]")
    d, st = dcra_bfs(g, 0, fabric,    # reuse the resolved config
                     options=LaunchOptions(config=lc))
    row("bfs[auto]", d, ref.bfs_ref(g, 0), st)
    print()
    return rows, x, els


def packaging_table(g):
    """DCRA-HBM 32x32 against DCRA-SRAM 64x64 for every app: TEPS, TEPS/W,
    TEPS/$ from the analytic stack."""
    packagings = {
        "DCRA-HBM (32x32)": EngineConfig(
            grid=TileGrid(32, 32, "hier_torus", die_rows=16, die_cols=16),
            sram=SRAMConfig(kb_per_tile=512), dram=DRAMConfig(present=True)),
        "DCRA-SRAM (64x64)": EngineConfig(
            grid=TileGrid(64, 64, "hier_torus", die_rows=16, die_cols=16),
            sram=SRAMConfig(kb_per_tile=512), dram=DRAMConfig(present=False)),
    }
    hdr = f"{'packaging':20s} {'app':10s} {'TEPS':>10s} {'TEPS/W':>10s} " \
          f"{'TEPS/$':>10s}"
    print(hdr)
    print("-" * len(hdr))
    for pname, cfg in packagings.items():
        for app in APPS:
            r = evaluate(cfg, g, app)
            print(f"{pname:20s} {app:10s} {r.teps:10.2e} "
                  f"{r.teps_per_watt:10.2e} {r.teps_per_dollar:10.2e}")
        print()


def main(argv=None):
    """The dataset line, ``--distributed``'s rows and the packaging table;
    returns the graph and :func:`run_distributed`'s result (``None``
    without ``--distributed``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=12)
    ap.add_argument("--distributed", action="store_true",
                    help="also run the seven apps on virtual shards")
    ap.add_argument("--device", default=None,
                    help="torch device of --distributed (default: the card)")
    args = ap.parse_args(argv)

    g = datasets.rmat(args.scale, edge_factor=16)
    print(f"RMAT-{args.scale}: V={g.n} E={g.nnz} "
          f"({g.memory_bytes() / 2**20:.1f} MB CSR)\n")

    runs = run_distributed(g, args.device) if args.distributed else None
    packaging_table(g)
    return g, runs


if __name__ == "__main__":
    main()
