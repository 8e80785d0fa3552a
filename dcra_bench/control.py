"""The controls of the comparison that decides ``correct``: the plain
reference put in the port's place in the precision below the one the
configuration states (or, where a graph answer is exact, with its
dropless guarantee broken), judged by the same check as a run. A sound
check must find each control wrong.

``python3 dcra_bench/control.py --workload <cell> --seeds 1 2 3`` reads
the control at the cell's own size, one line of JSON a seed; the runs
themselves never run it. :func:`control_checks` is what the CPU tests
call at a small size.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: the share of a BFS round's edge visits the control drops
BFS_DROP_SHARE = 0.01


def control_checks(config, traffic, seed: int, device):
    """The checks a run would print, with the control in the port's
    place."""
    import torch
    from dcra_bench.drivers import graph_app, moe_layer
    if config["driver"] == "moe_layer":
        from dcra_bench.gen import moe_inputs
        params = moe_inputs.weights(config, seed, device)
        means = moe_inputs.topic_means(config, traffic, params["router"],
                                       seed, device)
        steps = seeds_sample(traffic, seed)
        kept = {j: None for j in steps}
        checks, _ = moe_layer.check(config, traffic, seed, params, means,
                                    kept, torch.zeros(len(steps)), device,
                                    fp8=True)
        return checks
    import importlib
    from dcra_bench.gen import kron
    app = importlib.import_module(f"dcra_bench.apps.{traffic['app']}")
    g = graph_app.make_graph(config, seed, device)
    roots = (kron.roots(g, traffic["roots"], seed) if app.NEEDS_ROOTS
             else None)
    n = traffic["checked_answers"]
    launches = [graph_app.Launch(app.launch_params(traffic, roots, i), None,
                                 _NoDrops()) for i in range(n)]
    rows, cols = g.rows(), g.col_idx.long()
    control = {"drop_share": BFS_DROP_SHARE, "seed": seed}
    checks, _ = app.check(rows, cols, g.n, launches, list(range(n)),
                          traffic, control=control)
    return checks


def seeds_sample(traffic, seed):
    from dcra_bench.drivers.moe_layer import TAG_SAMPLE
    from dcra_bench.gen import seeds
    return seeds.sample(traffic["sample_range"], traffic["checked_steps"],
                        seed, TAG_SAMPLE)


class _NoDrops:
    """The stats of a launch the control stands in for: no drop."""
    total_drops = 0


def main(argv):
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from dcra_bench import harness
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    harness.set_cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    spec = harness.load_spec()
    cell = harness.find_cell(spec, args.workload)
    config = harness.load_config(spec, cell["config"])
    traffic = harness.load_traffic(cell["traffic"])
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        t = time.perf_counter()
        checks = control_checks(config, traffic, seed, dev)
        print(json.dumps({
            "workload": cell["name"], "seed": seed,
            "seconds": time.perf_counter() - t,
            "checks": {c.name: {"value": c.value, "limit": c.limit,
                                "failed": not c.ok} for c in checks}}),
            flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
