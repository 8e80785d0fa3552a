"""The roofline / dry-run tables from ``dryrun_results_torch.json``
(counterpart of ``repro/launch/report.py:10-66``).

The text is the reference's for the same records; a term the port does
not have (``None``: the collective term, the compiler's temp bytes)
prints as "—". Cells measured on the card (``dryrun --measure``) get a
table of their own.

  PYTHONPATH=src python -m repro_torch.launch.report [PATH]
"""
from __future__ import annotations

import json
import sys
from collections import defaultdict

DASH = "—"


def _e(v) -> str:
    return DASH if v is None else f"{v:.2e}"


def _f3(v) -> str:
    return DASH if v is None else f"{v:.3f}"


def _gib(v) -> str:
    return DASH if v is None else f"{v / 2**30:.1f}"


def fmt_row(r):
    if "skipped" in r:
        return (f"| {r['arch']} | {r['shape']} | {r['mesh']} | — | — | — | "
                f"skip: quadratic attn (DESIGN.md §5) | — | — |")
    if "error" in r:
        return (f"| {r['arch']} | {r['shape']} | {r['mesh']} | — | — | — | "
                f"ERROR | — | — |")
    return (f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{_e(r['compute_s'])} | {_e(r['memory_s'])} | "
            f"{_e(r['collective_s'])} | {r['bottleneck']} | "
            f"{r['model_flops_ratio']:.2f} | "
            f"{_gib(r.get('temp_size_in_bytes', 0))} |")


def roofline_table(results):
    lines = [
        "| arch | shape | mesh | compute_s | memory_s | collective_s | "
        "bottleneck | 6ND/HLO | temp GiB |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    order = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2,
             "long_500k": 3}
    rs = sorted(results, key=lambda r: (r["arch"], order.get(r["shape"], 9),
                                        r["mesh"]))
    for r in rs:
        if r.get("tag"):
            continue            # variants go to §Perf, not the baseline table
        lines.append(fmt_row(r))
    return "\n".join(lines)


def summary(results):
    base = [r for r in results if "compute_s" in r and not r.get("tag")]
    bn = defaultdict(int)
    for r in base:
        bn[r["bottleneck"]] += 1
    compiled = len(base)
    skipped = sum(1 for r in results if "skipped" in r)
    errors = sum(1 for r in results if "error" in r)
    temps = [r.get("temp_size_in_bytes", 0) for r in base]
    known = [t for t in temps if t is not None]
    peak = max(known, default=0) if known or not temps else None
    return (f"{compiled} cells compiled, {skipped} documented skips, "
            f"{errors} errors; bottlenecks: {dict(bn)}; "
            f"max temp/device {_gib(peak)} GiB")


def measured_table(results):
    """The cells timed on the card: the reduced cell's analytic terms
    beside its measured step, and each term's share of it."""
    lines = ["| arch | shape | reduced | step ms | peak GiB | compute_s | "
             "memory_s | compute share | memory share |",
             "|---|---|---|---|---|---|---|---|---|"]
    for r in results:
        m = r.get("measured")
        if not m:
            continue
        peak = m["peak_bytes"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {', '.join(m['reduced'])} | "
            f"{m['step_ms']:.2f} ({m['device_name']}, {m['timer']}) | "
            f"{DASH if peak is None else f'{peak / 2**30:.2f}'} | "
            f"{m['compute_s']:.2e} | {m['memory_s']:.2e} | "
            f"{_f3(m['compute_share'])} | {_f3(m['memory_share'])} |")
    return "\n".join(lines)


def main(path="dryrun_results_torch.json"):
    with open(path) as f:
        results = json.load(f)
    print(summary(results))
    print()
    print(roofline_table(results))
    if any(r.get("measured") for r in results):
        print()
        print(measured_table(results))


if __name__ == "__main__":
    main(*sys.argv[1:])
