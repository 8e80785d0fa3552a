"""A graph app on the port's owner-routed rounds: the configuration's graph
made on the device from the seed, handed to the port as its CSR, packed
and kept on the card (``resident_setup``), then one client's launches
back to back (a closed loop): ``launch_program(prog, ...)``, ``block()``,
``result()``.

End-to-end: ``teps`` (the edges the window's answers needed, over the
window) and ``setup_s`` (process start to window start: imports, the
graph, the port's packing and resident copy, one warm launch, and on a
checkout's first run the kernels' build). The traffic file names the app
(``apps/<app>.py``), its parameters and how many answers are checked.
"""
from __future__ import annotations

import importlib
import sys
import time
from dataclasses import dataclass
from typing import Any

from dcra_bench.gen import kron, seeds
from dcra_bench.harness import Run
from dcra_bench.trace import Window

TAG_SAMPLE = 301


@dataclass
class Launch:
    params: dict
    kept: Any
    stats: Any          # the port's AppStats


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_graph(cfg, seed, device):
    return kron.kron(cfg["scale"], cfg["degree"], cfg["initiator"], seed,
                     device, tuple(cfg["weights"]))


def run(ctx) -> Run:
    import torch
    from repro_torch.core.fabric import Fabric
    from repro_torch.sparse import program
    from repro_torch.sparse.csr import CSR
    from repro_torch.sparse.options import LaunchOptions
    from repro_torch.sparse.torch_apps import PROGRAMS
    cfg, tr, dev, spans = ctx.config, ctx.traffic, ctx.device, ctx.spans
    app = importlib.import_module(f"dcra_bench.apps.{tr['app']}")
    prog = PROGRAMS[app.PROGRAM]

    with spans("generate"):
        g = make_graph(cfg, ctx.seed, dev)
        roots = (kron.roots(g, tr["roots"], ctx.seed) if app.NEEDS_ROOTS
                 else None)
        row_ptr, col_idx, values = g.host()
        n = g.n
        del g
    csr = CSR(row_ptr, col_idx, values)
    fab = Fabric.fake(cfg["shards"], device=dev)
    opts = LaunchOptions(capacity_factor=float(cfg["capacity_factor"]),
                         round_mode=cfg["round_mode"])

    def launch(i):
        return program.launch_program(prog, csr, fab, options=opts,
                                      params=app.launch_params(tr, roots, i),
                                      setup=resident)

    with spans("pack"):
        resident = program.resident_setup(program._graph_setup(
            csr, cfg["shards"], undirected=prog.undirected, seed=opts.seed),
            dev)
        _sync(dev)
    with spans("warm"):
        for i in range(int(tr.get("warm_launches", 1))):
            launch(i).result()
        _sync(dev)

    launches = []
    program.reset_host_reads()
    with Window(ctx) as win:
        i = 0
        while True:
            params = app.launch_params(tr, roots, i)
            with spans("launch"):
                fut = launch(i)
            with spans("block"):
                fut.block()
            with spans("result"):
                states, stats = fut.result()
            launches.append(Launch(params, app.kept(states), stats))
            i += 1
            if time.perf_counter() - win.t_start >= ctx.seconds:
                win.close()
                break
    setup_s = win.t_start - ctx.t0
    host_reads = program.HOST_READS["reads"]
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    del resident, fab, states
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    with spans("check"):
        rows = torch.repeat_interleave(
            torch.arange(n, device=dev),
            torch.from_numpy(row_ptr[1:] - row_ptr[:-1]).to(dev),
            output_size=len(col_idx))
        cols = torch.from_numpy(col_idx).to(dev).long()
        work = app.work(rows, cols, n, launches, tr)
        sample = seeds.sample(len(launches), tr["checked_answers"],
                              ctx.seed, TAG_SAMPLE)
        checks, failed = app.check(rows, cols, n, launches, sample, tr)
        del rows, cols
    rounds = sum(L.stats.rounds for L in launches)
    width = e_max(row_ptr, cfg["shards"])
    print(f"graph: n {n}, nnz {len(col_idx)}, E_max {width} on "
          f"{cfg['shards']} shards; {len(launches)} launches, {rounds} "
          f"rounds, {sum(work)} edges in {win.seconds:.3f} s; spans "
          f"{ {k: round(spans.total(k), 3) for k in spans.samples} }",
          file=sys.stderr)
    return Run(
        e2e={"teps": sum(work) / win.seconds, "setup_s": setup_s},
        checks=checks, attempted=len(launches), failed=len(failed),
        memory_peak_bytes=peak, spans=spans, trace=win.summary,
        counters={"host_reads": host_reads, "rounds": rounds,
                  "launches": len(launches)},
        work={"n": n, "nnz": len(col_idx), "shards": cfg["shards"],
              "capacity_factor": float(cfg["capacity_factor"]),
              "e_max": width,
              "messages": [L.stats.messages for L in launches],
              "drops": [L.stats.drops for L in launches],
              "window_s": win.seconds})


def e_max(row_ptr, shards: int) -> int:
    """The most stored edges whose source one shard owns (vertex ``v`` on
    shard ``v % shards``): the width of a shard's edge block."""
    import numpy as np
    deg = np.diff(row_ptr)
    n = len(deg)
    pad = -n % shards
    per_shard = np.concatenate([deg, np.zeros(pad, deg.dtype)]).reshape(
        -1, shards).sum(0)
    return max(8, int(per_shard.max()))
