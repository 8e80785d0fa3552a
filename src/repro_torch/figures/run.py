"""Figure harness: one module per paper table/figure.

``python -m repro_torch.figures.run [--scale N] [--quick] [--device D]``
runs every figure and prints CSV blocks. --quick uses small graphs, the
route bench's quick grid and the serving bench's smoke leg on 4 shards;
the default scale 16 matches the paper's vertices-per-tile regime.
:mod:`.moe_dispatch`, :mod:`.route_bench`, :mod:`.noc_routing` and
:mod:`.serve_bench` run on ``--device`` (the card unless named); the
rest is numpy. ``route_bench`` writes its artifact to
:data:`ROUTE_OUT` under the working directory, never over the committed
card baseline ``BENCH_route_torch.json``. Unlike the reference's harness, ``noc_routing``
and ``serve_bench`` run in this process: their shards are virtual
shards of one device, so no device topology has to be kept apart.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

#: where ``route_bench`` writes its artifact (``build/`` is not committed)
ROUTE_OUT = os.path.join("build", "BENCH_route_torch.json")


def figures(scale: int, device=None, quick: bool = False
            ) -> List[Tuple[str, Callable]]:
    """The modules in order, each as ``(name, call)``; ``quick`` gives
    the two benches their short legs."""
    from . import (fig4_topology, fig5_sram, fig6_pus, fig7_freq, fig8_hbm,
                   fig10_queues, fig11_scaling, moe_dispatch, noc_routing,
                   roofline_table, route_bench, serve_bench)
    on = [] if device is None else ["--device", str(device)]

    def route():
        os.makedirs(os.path.dirname(ROUTE_OUT), exist_ok=True)
        return route_bench.main((["--quick"] if quick else [])
                                + ["--out", ROUTE_OUT] + on)

    return [
        ("fig4_topology", lambda: fig4_topology.main(scale)),
        ("fig5_sram", lambda: fig5_sram.main(scale)),
        ("fig6_pus", lambda: fig6_pus.main(scale)),
        ("fig7_freq", lambda: fig7_freq.main(scale)),
        ("fig8_hbm", lambda: fig8_hbm.main(scale)),
        ("fig10_queues", lambda: fig10_queues.main(scale)),
        ("fig11_scaling", lambda: fig11_scaling.main(scale)),
        ("moe_dispatch", lambda: moe_dispatch.main(device)),
        # the routing hot path's times -> ROUTE_OUT (gated against the
        # committed --quick baseline by repro_torch.dse.route_compare)
        ("route_bench", route),
        ("noc_routing", lambda: noc_routing.main(scale=min(scale, 11),
                                                 device=device)),
        ("serve_bench", lambda: serve_bench.main(
            (["--smoke", "--devices", "4"] if quick else []) + on)),
        ("roofline_table", roofline_table.main),
    ]


def run_all(scale: int, device=None, quick: bool = False,
            skip: Sequence[str] = ()
            ) -> Tuple[Dict, List[str], Dict[str, float]]:
    """Every figure but those named in ``skip``, a failure reported and
    the rest run on: ``(results by name, failed names, seconds by
    name)``."""
    results, failures, seconds = {}, [], {}
    for name, fn in figures(scale, device, quick):
        if name in skip:
            continue
        t = time.perf_counter()
        print(f"== {name} ==", flush=True)
        try:
            results[name] = fn()
        except Exception as e:  # keep the suite running, but gate at exit
            print(f"{name},ERROR,{type(e).__name__}: {e}", file=sys.stderr)
            failures.append(name)
        seconds[name] = time.perf_counter() - t
        print(f"# {name} took {seconds[name]:.1f}s", flush=True)
    return results, failures, seconds


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=16)
    ap.add_argument("--quick", action="store_true",
                    help="scale-12 graphs, the benches' short legs")
    ap.add_argument("--device", default=None,
                    help="torch device of the modules that run on one "
                         "(default: the card)")
    args = ap.parse_args(argv)
    scale = 12 if args.quick else args.scale
    _, failures, _ = run_all(scale, args.device, args.quick)
    if failures:
        print(f"FAILED figures: {', '.join(failures)}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
