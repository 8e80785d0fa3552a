"""Wall-clock benchmark of the routing hot path (counterpart of
``benchmarks/route_bench.py``).

``python -m repro_torch.figures.route_bench [--quick]
[--out BENCH_route_torch.json] [--reps N] [--device D]`` emits schema
``dcra-route-bench/v2`` with two kinds of cells:

* **op-level** ``cells`` — one owner-route-shaped ``bucket()`` round
  (rank + capacity test + slot scatter, payload + one metadata column)
  per ``route_impl`` over an N x S grid, with ``speedup_vs_onehot`` per
  impl: the within-run ratio :mod:`repro_torch.dse.route_compare` gates;
* **round-level** ``round_cells`` — ``ROUNDS`` rounds of a min-relay
  (payload gather -> admission -> receive-reduce -> frontier update, the
  per-shard work of one ``run_program`` round), timed in both round
  shapes per impl: ``lockstep`` (``bucket`` + ``reduce_received``) and
  ``pipelined`` (``local_route_reduce``, the fold of the receive-reduce
  into admission). The final state and the per-round drop stream of all
  six impl x mode pairs are asserted bit-identical before any timing;
  ``round_speedup`` (lockstep ms / pipelined ms per impl) is gated like
  the op-level ratios.

Every array lies on one shard, ``[1, N]``. A sample is a block of
back-to-back calls of one impl, as many as fill about ``BLOCK_S`` with
the fastest impl's calls, timed between one pair of CUDA events on the
card (the card idle before the block) or by the host clock on the CPU,
with the garbage collector off; each impl's ms a call is the median of
its samples, and each ratio the median over reps of the ratio of that
rep's two samples (``speedup_vs_onehot``: onehot's over the impl's;
``round_speedup``: lockstep's over pipelined's). The calls are launch-
or host-bound on the card: a call timed alone moves with the host's
wake-up from the last synchronise, which a block averages away, and the
host's speed drifts from second to second, which a ratio of samples
taken moments apart cancels. The rounds are a Python loop that writes
each round's drop count into a device tensor, with no host read of its
own.
``pallas_lowering`` names what the ``"pallas"`` impl ran: on the
card the route kernels' designs that ran (``kernels.route.PATHS``),
``"cuda:<design>+..."``; on the CPU ``"plain"``, the kernels' plain
PyTorch versions. On the card the artifact also carries the card's name
and power limit.
"""
from __future__ import annotations

import argparse
import gc
import json
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.fabric import resolve_device
from ..core.queues import round8
from ..core.routing import bucket, local_route_reduce, reduce_received
from ..kernels import route as kroute
from .common import card_record

QUICK_GRID = [(4096, 8), (4096, 64), (16384, 16), (65536, 8), (65536, 64),
              (131072, 128)]
FULL_GRID = QUICK_GRID + [(262144, 64), (262144, 256)]
# Round-level cells are ~ROUNDS x the op cost, so use a smaller grid that
# still ends on the headline cell the gate tracks.
ROUND_QUICK_GRID = [(16384, 16), (65536, 64), (131072, 128)]
ROUND_FULL_GRID = ROUND_QUICK_GRID + [(262144, 256)]
ROUNDS = 6
IMPLS = ("onehot", "sort", "pallas")
MODES = ("lockstep", "pipelined")
SCHEMA = "dcra-route-bench/v2"
#: seconds of the fastest impl's calls in one timing sample
BLOCK_S = 2e-3


def timed(fn: Callable, device: torch.device, calls: int = 1) -> float:
    """Seconds a call of ``calls`` back-to-back ``fn()``: CUDA events
    around the block on the card (after a synchronise, so the card
    starts idle), the host clock on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        return (time.perf_counter() - t0) / calls
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / calls


def _samples(fns: Dict, est: List[float], reps: int, cap_reps: int,
             device: torch.device) -> Dict[object, np.ndarray]:
    """Seconds a call of each of ``fns``, one sample a rep. A sample is a
    block of back-to-back calls holding about :data:`BLOCK_S` of the
    fastest; reps grow until every impl has about 150 ms of samples (at
    most ``cap_reps``), and the impls interleave within each rep so load
    drift hits all of them alike. The collector is off while timing."""
    fastest = max(min(est), 1e-5)
    calls = max(1, round(BLOCK_S / fastest))
    reps = max(reps, min(cap_reps, int(0.15 / (calls * fastest)) + 1))
    times: Dict = {key: [] for key in fns}
    enabled = gc.isenabled()
    gc.collect(1)             # the young generations: cheap in any heap
    gc.disable()
    try:
        for _ in range(reps):
            for key, f in fns.items():
                times[key].append(timed(f, device, calls))
    finally:
        if enabled:
            gc.enable()
    return {key: np.asarray(t) for key, t in times.items()}


def _ms(times: Dict) -> Dict:
    """Median ms a call of each sample list."""
    return {key: float(np.median(t) * 1e3) for key, t in times.items()}


def _ratio(num: np.ndarray, den: np.ndarray) -> float:
    """The median over reps of ``num / den``, each rep's two samples
    taken moments apart, so a drift of the host's speed cancels."""
    return float(np.median(num / den))


def cell_inputs(n: int, s: int, device) -> Dict[str, torch.Tensor]:
    """An op cell's tasks, the reference's draws in its order: ``dest``
    int32, ``valid`` bool, ``vals`` float32 ``[1, n, 1]``, ``slot_ids``
    int32, each ``[1, n]``."""
    rng = np.random.default_rng(n + s)
    dest = rng.integers(0, s, n).astype(np.int32)
    valid = rng.random(n) < 0.9
    vals = rng.random((n, 1)).astype(np.float32)
    slot_ids = rng.integers(0, n, n).astype(np.int32)
    return {k: torch.from_numpy(v)[None].to(device)
            for k, v in (("dest", dest), ("valid", valid), ("vals", vals),
                         ("slot_ids", slot_ids))}


def bucket_op(inp: Dict[str, torch.Tensor], s: int, cap: int, impl: str):
    """One owner-route ``bucket()`` round on ``inp``:
    ``(xb, ints, task_slot, n_drop)``."""
    return bucket(inp["vals"], inp["dest"], inp["valid"], [inp["slot_ids"]],
                  s, cap, impl=impl)


def _bench_cell(n: int, s: int, reps: int, device) -> Dict:
    cap = round8(2 * n // max(s, 1))
    inp = cell_inputs(n, s, device)
    fns, outs, est = {}, {}, []
    for impl in IMPLS:
        f = (lambda impl=impl: bucket_op(inp, s, cap, impl))
        outs[impl] = f()                                  # warm (builds)
        est.append(timed(f, device, 3))                   # estimate
        fns[impl] = f
    times = _samples(fns, est, reps, 100, device)
    ms = _ms(times)
    # the bench is only meaningful if the impls agree — assert it here
    ref = outs["onehot"]
    for impl in ("sort", "pallas"):
        got = outs[impl]
        assert torch.equal(ref[0], got[0]), (n, s, impl)
        assert torch.equal(ref[3], got[3]), (n, s, impl)
    return {"n": n, "s": s, "cap": cap, "ms": ms,
            "speedup_vs_onehot": {i: _ratio(times["onehot"], times[i])
                                  for i in IMPLS}}


def round_inputs(n: int, s: int, device) -> Dict[str, torch.Tensor]:
    """A round cell's min-relay, the reference's draws in its order:
    ``src`` (int64, for indexing), ``dest`` and ``slot_ids`` int32,
    ``w`` float32, each ``[1, n]``; ``state0`` ``[1, n_local]`` (+inf
    but vertex 0 at 0)."""
    n_local = max(n // 4, s)
    rng = np.random.default_rng(n + s + 1)
    src = rng.integers(0, n_local, n)
    dest = rng.integers(0, s, n).astype(np.int32)
    slot_ids = rng.integers(0, n_local, n).astype(np.int32)
    w = (rng.random(n) + 0.05).astype(np.float32)
    out = {k: torch.from_numpy(v)[None].to(device)
           for k, v in (("src", src), ("dest", dest), ("slot_ids", slot_ids),
                        ("w", w))}
    state0 = torch.full((1, n_local), float("inf"), dtype=torch.float32,
                        device=device)
    state0[0, 0] = 0.0
    out["state0"] = state0
    return out


def round_step(state, frontier, inp, s: int, cap: int, impl: str,
               mode: str):
    """One min-relay round on ``[1, n_local]``: ``(state, frontier,
    n_drop [1])``."""
    n_local = state.shape[1]
    active = frontier[:, inp["src"][0]]
    vals = state[:, inp["src"][0]] + inp["w"]
    if mode == "lockstep":
        xb, (slot_b,), _, nd = bucket(vals, inp["dest"], active,
                                      [inp["slot_ids"]], s, cap, impl=impl)
        upd = reduce_received(slot_b, xb, n_local, "min", impl=impl)
    else:
        upd, nd = local_route_reduce(vals, inp["slot_ids"], inp["dest"],
                                     active, s, cap, n_local, "min",
                                     impl=impl)
    return torch.minimum(state, upd), upd < state, nd


def run_rounds(inp, s: int, cap: int, impl: str, mode: str):
    """``ROUNDS`` rounds from ``state0``: ``(state [n_local], drops
    [ROUNDS] int32)``, both on the inputs' device."""
    state = inp["state0"]
    frontier = torch.isfinite(state)
    drops = torch.zeros(ROUNDS, dtype=torch.int32, device=state.device)
    for r in range(ROUNDS):
        state, frontier, nd = round_step(state, frontier, inp, s, cap, impl,
                                         mode)
        drops[r:r + 1].copy_(nd)
    return state[0], drops


def _bench_round_cell(n: int, s: int, reps: int, device) -> Dict:
    cap = round8(2 * n // max(s, 1))
    inp = round_inputs(n, s, device)
    fns, outs, est = {}, {}, []
    for impl in IMPLS:
        for mode in MODES:
            f = (lambda impl=impl, mode=mode: run_rounds(inp, s, cap, impl,
                                                         mode))
            outs[impl, mode] = f()                        # warm (builds)
            est.append(timed(f, device, 3))               # estimate
            fns[impl, mode] = f
    # bit-identity across shapes AND impls before any timing
    ref_state, ref_drops = outs["onehot", "lockstep"]
    for key, (got_state, got_drops) in outs.items():
        assert torch.equal(ref_state, got_state), (n, s, key)
        assert torch.equal(ref_drops, got_drops), (n, s, key)
    times = _samples(fns, est, reps, 50, device)
    med = _ms(times)
    ms = {mode: {impl: med[impl, mode] for impl in IMPLS}
          for mode in MODES}
    return {"n": n, "s": s, "cap": cap, "rounds": ROUNDS, "round_ms": ms,
            "round_speedup": {i: _ratio(times[i, "lockstep"],
                                        times[i, "pipelined"])
                              for i in IMPLS}}


def _designs() -> Dict[str, Dict[str, int]]:
    return {k: dict(v) for k, v in kroute.PATHS.items()}


def lowering(device: torch.device, before: Dict[str, Dict[str, int]]
             ) -> str:
    """What the ``"pallas"`` impl ran since ``before`` (a copy of
    ``PATHS``): on the card ``"cuda:"`` and the designs, sorted and
    joined by ``+``; on the CPU ``"plain"``."""
    if device.type != "cuda":
        return "plain"
    ran = sorted({path for w, paths in kroute.PATHS.items()
                  for path, c in paths.items() if c > before[w][path]})
    return "cuda:" + "+".join(ran)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="the committed baseline's grid")
    ap.add_argument("--out", default="BENCH_route_torch.json")
    ap.add_argument("--reps", type=int, default=0,
                    help="timing reps per impl (0 = 7 quick / 9 full)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    grid = QUICK_GRID if args.quick else FULL_GRID
    round_grid = ROUND_QUICK_GRID if args.quick else ROUND_FULL_GRID
    reps = args.reps or (7 if args.quick else 9)
    before = _designs()
    cells: List[Dict] = []
    for n, s in grid:
        cell = _bench_cell(n, s, reps, device)
        cells.append(cell)
        sp = cell["speedup_vs_onehot"]
        print(f"route_bench,N={n},S={s},cap={cell['cap']},"
              f"onehot={cell['ms']['onehot']:.3f}ms,"
              f"sort={sp['sort']:.2f}x,pallas={sp['pallas']:.2f}x",
              flush=True)
    round_cells: List[Dict] = []
    for n, s in round_grid:
        cell = _bench_round_cell(n, s, reps, device)
        round_cells.append(cell)
        sp = cell["round_speedup"]
        print(f"round_bench,N={n},S={s},cap={cell['cap']},"
              f"rounds={cell['rounds']},"
              f"lockstep={cell['round_ms']['lockstep']['pallas']:.3f}ms,"
              f"pipelined:onehot={sp['onehot']:.2f}x,"
              f"sort={sp['sort']:.2f}x,pallas={sp['pallas']:.2f}x",
              flush=True)
    bench = {
        "schema": SCHEMA,
        "backend": device.type,
        "pallas_lowering": lowering(device, before),
        "quick": bool(args.quick),
        "impls": list(IMPLS),
        "cells": cells,
        "round_cells": round_cells,
    }
    if device.type == "cuda":
        bench["device"] = card_record(device)
    with open(args.out, "w") as f:
        json.dump(bench, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"# wrote {args.out} ({len(cells)} cells, "
          f"{len(round_cells)} round cells)")
    return bench


if __name__ == "__main__":
    main()
