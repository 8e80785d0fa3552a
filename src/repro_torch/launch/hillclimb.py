"""Hill-climbing driver: hypothesis -> change -> re-lay-out -> measure
(counterpart of ``repro/launch/hillclimb.py:21-133``).

Each VARIANT is one hypothesis applied to one of the three chosen cells,
the reference's list as it is. Results are appended (tagged) to
``dryrun_results_torch.json``; the baseline rows keep ``tag=""``. The
sweep loop (resume, per-variant error capture, incremental JSON writes)
is :func:`repro_torch.dse.driver.run_sweep`; this module only declares
the variants. On the port a variant moves the analytic terms (dispatch,
capacity, remat) and the argument bytes under the specs (``fsdp``,
``param_dtype``); the collective terms its hypotheses speak of are
XLA's and stay ``None`` (see :mod:`repro_torch.launch.roofline`).

  PYTHONPATH=src python -m repro_torch.launch.hillclimb [--only CELL]
"""
from __future__ import annotations

import argparse

from ..dse.driver import SweepTask, run_sweep
from .dryrun import DEFAULT_OUT, lower_cell

# (cell, tag, kwargs, hypothesis)
VARIANTS = [
    # ---- cell A: mixtral-8x22b decode_32k multi (worst roofline frac) ----
    ("A", ("mixtral-8x22b", "decode_32k", True), "A1-serve-nofsdp",
     dict(fsdp=False),
     "decode re-gathers FSDP-sharded weights every token; serving should "
     "keep weights resident (replicated over data) -> collective ~ -90%"),
    ("A", ("mixtral-8x22b", "decode_32k", True), "A2-serve-nofsdp-einsum",
     dict(fsdp=False, dispatch_impl="einsum"),
     "is the DCRA dispatch or the einsum dispatch cheaper at batch-decode "
     "scale? (einsum moves [G,t,E,C] masks; DCRA moves cap-bounded payload)"),
    # ---- cell B: olmoe-1b-7b train_4k multi (paper technique, top-8) -----
    ("B", ("olmoe-1b-7b", "train_4k", True), "B0-einsum-baseline",
     dict(dispatch_impl="einsum"),
     "PAPER-BASELINE: flat GShard-style dense-mask dispatch (the 'mesh NoC' "
     "equivalent) — expect more collective bytes than DCRA routing"),
    ("B", ("olmoe-1b-7b", "train_4k", True), "B1-flat-dispatch",
     dict(hierarchical=False),
     "hierarchical (2-stage, die-NoC) vs flat single-stage dispatch with "
     "pod-replicated experts: flat avoids stage-2 but doubles expert-weight "
     "gradient reduction across pods"),
    ("B", ("olmoe-1b-7b", "train_4k", True), "B2-cap-1.0",
     dict(capacity_factor=1.0),
     "IQ size (capacity factor) 1.25 -> 1.0: -20% dispatch payload at the "
     "cost of more drops (paper Fig. 10 inverse)"),
    ("B", ("olmoe-1b-7b", "train_4k", True), "B3-no-remat",
     dict(remat="none"),
     "remat recomputes the fwd (incl. its gathers) in bwd; with memory "
     "headroom, dropping remat removes the recompute gathers"),
    # ---- cell C: mixtral-8x22b train_4k multi (representative at scale) --
    ("C", ("mixtral-8x22b", "train_4k", True), "C0-einsum-baseline",
     dict(dispatch_impl="einsum"),
     "PAPER-BASELINE: dense-mask dispatch for the 8x22B config"),
    ("C", ("mixtral-8x22b", "train_4k", True), "C1-no-remat",
     dict(remat="none"),
     "drop remat: -1 fwd recompute of FSDP/SP gathers (memory permitting)"),
    ("C", ("mixtral-8x22b", "train_4k", True), "C2-nofsdp",
     dict(fsdp=False),
     "weights resident (no FSDP): kills per-layer weight all-gathers; "
     "memory_analysis must still fit 16GB/chip"),
    # ---- round 2 (informed by round-1 breakdowns) -------------------------
    ("C", ("mixtral-8x22b", "train_4k", True), "C3-bf16-params",
     dict(param_dtype="bf16"),
     "params at rest in fp32 are gathered BEFORE the bf16 cast; storing "
     "matrices in bf16 (fp32 Adam moments) halves every FSDP/TP gather"),
    ("C", ("mixtral-8x22b", "train_4k", True), "C4-bf16-einsum",
     dict(param_dtype="bf16", dispatch_impl="einsum"),
     "paper-baseline einsum under the bf16-at-rest regime (fair compare)"),
    ("B", ("olmoe-1b-7b", "train_4k", True), "B4-bf16-params",
     dict(param_dtype="bf16"),
     "same bf16-at-rest hypothesis on the top-8 dispatch cell"),
    ("B", ("olmoe-1b-7b", "train_4k", True), "B5-bf16-flat-cap1",
     dict(param_dtype="bf16", hierarchical=False, capacity_factor=1.0),
     "compose the three confirmed wins: bf16 gathers + flat dispatch + "
     "tighter IQ"),
    ("A", ("mixtral-8x22b", "decode_32k", True), "A3-nofsdp-cap1",
     dict(fsdp=False, capacity_factor=1.0),
     "remaining decode collective after A1: dispatch payload; tighter IQ "
     "capacity trims the padded buckets"),
    # ---- round 3: per-kind breakdown showed 487GiB/dev of all-gathers on
    # cell C = the dispatch re-gathering the seq-sharded residual over the
    # expert axis then slicing 1/8. Fix: accept seq sharded over the whole
    # dispatch group (now the default) --------------------------------------
    ("C", ("mixtral-8x22b", "train_4k", True), "C5-seqgroup-dispatch",
     dict(),
     "dispatch consumes the SP seq-sharded residual directly (tokens "
     "distinct per expert-rank): kills the 8x pre-gather + slice"),
    ("B", ("olmoe-1b-7b", "train_4k", True), "B6-seqgroup-dispatch",
     dict(),
     "same fix on the top-8 cell (seq sharded over the fused 16-way group)"),
    ("B", ("olmoe-1b-7b", "train_4k", True), "B7-seqgroup-flat-cap1",
     dict(hierarchical=False, capacity_factor=1.0),
     "compose with the round-1 wins"),
    ("C", ("mixtral-8x22b", "train_4k", True), "C6-seqgroup-einsum",
     dict(dispatch_impl="einsum"),
     "paper-baseline einsum against the optimized DCRA path (fair compare "
     "on the new residual layout)"),
]


def _task(cell_id, cell, tag, kwargs, hypothesis) -> SweepTask:
    arch, shape, mp = cell

    def run():
        print(f"== {tag}: {hypothesis}", flush=True)
        rec = lower_cell(arch, shape, mp, tag=tag, **kwargs)
        rec["variant_kwargs"] = {k: str(v) for k, v in kwargs.items()}
        return rec

    return SweepTask(
        key=tag, run=run,
        meta={"arch": arch, "shape": shape,
              "mesh": "multi" if mp else "single", "tag": tag,
              "hypothesis": hypothesis})


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None, help="cell id A/B/C or tag")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--retry-errors", action="store_true",
                    help="re-run previously errored variants on resume")
    args = ap.parse_args(argv)

    tasks = [_task(*variant) for variant in VARIANTS
             if not args.only or args.only in (variant[0], variant[2])]
    results = run_sweep(tasks, out=args.out, resume=True,
                        retry_errors=args.retry_errors,
                        key_of=lambda r: r.get("tag"))
    print("hillclimb pass done")
    return results


if __name__ == "__main__":
    main()
