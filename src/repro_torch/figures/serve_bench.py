"""Resident serving under sustained mixed-tenant traffic (counterpart of
``benchmarks/serve_bench.py``).

Drives the :class:`repro_torch.serve.engine.ProgramServer` with a
synthetic multi-tenant request stream (BFS + SSSP roots over resident
graphs), after a one-shot pre-warm of every (program, graph, width)
shape class, and reports the serving metrics: request throughput,
per-tenant p50/p99 latency — split into **queue-wait** (submit ->
launch) and **device time** (launch -> harvest) — round-function cache
hit rate, fused-launch count, padding overhead, and the NoC-drop ledger.

``--depth`` sets ``ServeOptions.inflight_depth``: at depth k the server
keeps k fused launches in flight and forms batch k+1 while batch k
computes. ``--smoke`` is the short leg that *asserts* the serving
invariants (>= 1 cache hit after warm-up, zero builds under load, zero
drops, the batched column bit-identical to a standalone launch) and
prints ``RESULT ok``; with ``--depth k > 1`` it also runs the same
stream at depth 1 and asserts the overlapped responses bit-identical
(results, statuses, reasons, per-tenant ledger). ``--bench-out PATH``
measures the synchronous drain against the overlapped drain on one
stream and writes the ``dcra-serve-bench/v1`` artifact gated by
:mod:`repro_torch.dse.serve_compare`; on the card it carries the card's
name and power limit. ``--reps K`` (odd, default 1: one sync drain, then
one overlapped, as the reference) alternates the two drains K times and
keeps the median pair's ratio (each pair's seconds in ``pairs_s``): on
a host whose speed drifts by tens of percent from one second to the
next, one pair's ratio is mostly that drift. The collector runs between
pairs, never inside one.

``--chaos SEED`` runs the stream fault-free once, then replays it under
:func:`repro_torch.serve.seeded_chaos_plan` (one launch fault, one
device-side fault, one host loss that halves the fabric) with retries
and a circuit breaker, and *asserts* the fault-tolerance contract: every
planned fault fired in order, the ledger stayed exact, at least one
retry and one breaker open/close cycle happened, and the responses are
bit-identical to the fault-free run's.

  PYTHONPATH=src python -m repro_torch.figures.serve_bench [--devices 8]
      [--requests 48] [--tenants 6] [--depth 3] [--fairness drr]
      [--donate] [--smoke] [--chaos SEED] [--bench-out PATH [--reps K]]
      [--device cpu]

``--devices N`` is the number of virtual shards of one device
(``Fabric.fake(N)``). ``--fabric`` is accepted and changes nothing: the
port's server always launches through a
:class:`~repro_torch.core.fabric.Fabric`.
"""
from __future__ import annotations

import argparse
import gc
import json
import time
from typing import Optional, Sequence

import numpy as np

from ..core.fabric import Fabric, resolve_device
from ..serve import (ProgramServer, Request, STATUS_OK, ServeOptions,
                     seeded_chaos_plan)
from ..sparse import datasets
from ..sparse import program as program_mod
from ..sparse.program import run_program
from ..sparse.torch_apps import BFS, SSSP
from .common import card_record, emit

PROGRAMS = ("bfs", "sssp")
STANDALONE = {"bfs": BFS, "sssp": SSSP}
BENCH_SCHEMA = "dcra-serve-bench/v1"


def make_stream(graphs, tenants: int, requests: int, seed: int = 0):
    """Round-robin tenants over (program, graph) classes, random roots."""
    rng = np.random.default_rng(seed)
    names = sorted(graphs)
    classes = len(PROGRAMS) * len(names)
    reqs = []
    for i in range(requests):
        gname = names[(i // len(PROGRAMS)) % len(names)]
        reqs.append(Request(
            # tenant advances once per full (program, graph) cycle, so
            # same-class requests rotate tenants and batches fuse wide
            req_id=i, tenant=f"tenant{(i // classes) % tenants}",
            program=PROGRAMS[i % len(PROGRAMS)], graph=gname,
            root=int(rng.integers(graphs[gname].n))))
    return reqs


def serve_stream(fabric, graphs, stream, width, serve_options):
    """Pre-warm + run one stream on a fresh server; returns the server
    and the timing/build envelope."""
    server = ProgramServer(fabric, graphs, batch_width=width,
                           serve_options=serve_options)
    t0 = time.perf_counter()
    server.prewarm(PROGRAMS)
    warm_s = time.perf_counter() - t0
    traces0 = program_mod.cache_stats()["kernel_traces"]
    t0 = time.perf_counter()
    responses = server.run(stream)
    serve_s = time.perf_counter() - t0
    new_traces = program_mod.cache_stats()["kernel_traces"] - traces0
    server.stats.verify()
    return server, responses, warm_s, serve_s, new_traces


def _quant(xs, q):
    if not xs:
        return 0.0
    s = sorted(xs)
    return s[min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))]


def bench_row(mode, opts, responses, serve_s, new_traces, snap):
    """One dcra-serve-bench/v1 row: throughput + the latency split."""
    ok = [r for r in responses if r.status == STATUS_OK]
    return {
        "mode": mode, "depth": opts.inflight_depth,
        "fairness": opts.fairness, "donate": opts.donate_buffers,
        "serve_s": serve_s,
        "throughput_rps": len(responses) / serve_s if serve_s else 0.0,
        "p50_latency_s": _quant([r.latency_s for r in ok], 0.50),
        "p99_latency_s": _quant([r.latency_s for r in ok], 0.99),
        "p50_queue_wait_s": _quant([r.queue_wait_s for r in ok], 0.50),
        "p99_queue_wait_s": _quant([r.queue_wait_s for r in ok], 0.99),
        "p50_device_s": _quant([r.device_s for r in ok], 0.50),
        "p99_device_s": _quant([r.device_s for r in ok], 0.99),
        "launches": snap["launches"],
        "cache_hit_rate": snap["cache_hit_rate"],
        "re_traces": new_traces,
    }


def _signature(responses):
    """The bit-identity signature: results, statuses, reasons — and
    nothing wall-clock."""
    return [(r.req_id, r.tenant, r.status, r.retriable, r.reason,
             None if r.result is None else r.result.tobytes(),
             r.batch_drops, r.batch_messages, r.rounds, r.batch_width)
            for r in sorted(responses, key=lambda r: r.req_id)]


def _ledger(server):
    return {t: (s.submitted, s.served, s.rejected, s.failed)
            for t, s in server.stats.tenants.items()}


def _chaos(args, fabric, graphs, stream, n_dev):
    """The chaos leg: a fault-free reference sizes the plan (its launch
    count bounds the injectable indices), then the same stream replays
    under the seeded plan with retries and a breaker. Every fault must
    fire, exactly one host loss must shrink the fabric, and the
    responses must be bit-identical to the reference's: min-reduce
    programs do not care how many shards finished the job. The smoke's
    zero-build assert does not apply: the shrink re-prewarms the
    affected classes."""
    ref_srv, ref_resp, _, _, _ = serve_stream(
        fabric, graphs, stream, args.width, ServeOptions())
    n_ref = ref_srv.stats.snapshot()["launches"]
    plan = seeded_chaos_plan(args.chaos, n_ref,
                             keep_devices=max(1, n_dev // 2))
    planned = dict(plan.at)
    chaos_opts = ServeOptions(inflight_depth=args.depth,
                              fairness=args.fairness,
                              max_retries=3, breaker_threshold=1)
    srv = ProgramServer(fabric, graphs, batch_width=args.width,
                        serve_options=chaos_opts, failure_plan=plan)
    srv.prewarm(PROGRAMS)
    responses = srv.run(stream)
    srv.stats.verify()
    snap = srv.stats.snapshot()

    def reduced(rs):
        return [(r.req_id, r.tenant, r.status, r.retriable,
                 None if r.result is None else r.result.tobytes())
                for r in sorted(rs, key=lambda r: r.req_id)]

    assert plan.exhausted, f"unfired faults: {plan.at}"
    assert [k for _, k in plan.fired] == [planned[i]
                                          for i in sorted(planned)], \
        f"fault order diverged from the plan: {plan.fired}"
    assert snap["host_losses"] == 1, snap
    assert snap["retries"] > 0, "no request ever retried"
    assert snap["breaker_opens"] >= 1 and snap["breaker_closes"] >= 1, \
        snap
    assert all(r.status == STATUS_OK for r in responses), \
        [r.reason for r in responses if r.status != STATUS_OK]
    assert reduced(responses) == reduced(ref_resp), \
        "chaos responses diverged from the fault-free reference"
    assert _ledger(srv) == _ledger(ref_srv), \
        "chaos per-tenant ledger diverged from the fault-free reference"
    print(f"# chaos seed={args.chaos} plan={planned} "
          f"retries={snap['retries']} "
          f"breaker_opens={snap['breaker_opens']} "
          f"devices {n_dev} -> {srv.fabric.n_devices}")
    print("RESULT chaos ok")


def _bench_out(args, fabric, graphs, stream, n_dev, device):
    """Sync vs overlapped on the same stream: the trajectory artifact.
    With ``--reps K > 1`` the two drains alternate K times, each on a
    fresh server, the odd pairs overlapped first: each row is its mode's median run (by serve seconds),
    its ``re_traces`` the sum over all K, and ``overlap_speedup`` the
    median of the K back-to-back pairs' ratios."""
    sync_opts = ServeOptions(inflight_depth=1)
    over_opts = ServeOptions(inflight_depth=max(2, args.depth),
                             fairness=args.fairness,
                             donate_buffers=args.donate)
    modes = (("sync", sync_opts), ("overlapped", over_opts))
    runs = {mode: [] for mode, _ in modes}
    sigs = []
    enabled = gc.isenabled()
    try:
        for k in range(args.reps):
            gc.collect(1)       # the last pair's garbage; none inside
            gc.disable()        # a pair's drains
            # every other pair runs overlapped first, so a drift of the
            # host's speed within a pair cancels over the pairs
            for mode, o in (modes if k % 2 == 0 else modes[::-1]):
                srv, resp, _, serve_s, tr = serve_stream(
                    fabric, graphs, stream, args.width, o)
                runs[mode].append((serve_s, resp, tr, srv.stats.snapshot()))
                sigs.append(_signature(resp))
            if enabled:
                gc.enable()
    finally:
        if enabled:
            gc.enable()
    assert all(sig == sigs[0] for sig in sigs), \
        "overlapped responses diverged from the synchronous drain"
    rows = []
    for mode, o in modes:
        serve_s, resp, _, snap = sorted(runs[mode],
                                        key=lambda r: r[0])[args.reps // 2]
        rows.append(bench_row(mode, o, resp, serve_s,
                              sum(r[2] for r in runs[mode]), snap))
    # each pair's sync seconds over its overlapped seconds (for one pair,
    # the overlapped drain's throughput over the sync drain's)
    speedup = float(np.median([a[0] / b[0] for a, b in zip(
        runs["sync"], runs["overlapped"])]))
    bench = {
        "schema": BENCH_SCHEMA,
        "backend": device.type,
        "config": {"devices": n_dev, "width": args.width,
                   "tenants": args.tenants, "requests": args.requests,
                   "vertices": args.vertices,
                   "depth": over_opts.inflight_depth,
                   "fairness": over_opts.fairness,
                   "donate": over_opts.donate_buffers},
        "rows": rows,
        "overlap_speedup": speedup,
    }
    if args.reps > 1:
        bench["config"]["reps"] = args.reps
        bench["pairs_s"] = [[a[0], b[0]] for a, b in zip(
            runs["sync"], runs["overlapped"])]
    if device.type == "cuda":
        bench["device"] = card_record(device)
    with open(args.bench_out, "w") as f:
        json.dump(bench, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"# wrote {args.bench_out}: overlapped "
          f"{rows[1]['throughput_rps']:.1f} req/s vs sync "
          f"{rows[0]['throughput_rps']:.1f} req/s "
          f"({speedup:.2f}x, depth={over_opts.inflight_depth}"
          + (f", median of {args.reps} pairs" if args.reps > 1 else "")
          + ")")


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=8,
                    help="virtual shards of the device")
    ap.add_argument("--tenants", type=int, default=6)
    ap.add_argument("--requests", type=int, default=48)
    ap.add_argument("--width", type=int, default=4,
                    help="tenant columns per fused launch")
    ap.add_argument("--vertices", type=int, default=192)
    ap.add_argument("--depth", type=int, default=1,
                    help="inflight window depth (1 = synchronous drain)")
    ap.add_argument("--fairness", choices=("fifo", "drr"), default="fifo")
    ap.add_argument("--donate", action="store_true",
                    help="donate retired batch state buffers to the next "
                         "launch of the shape class")
    ap.add_argument("--smoke", action="store_true",
                    help="short stream; assert serving invariants")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="run the stream twice — fault-free, then under "
                         "the seeded chaos plan (one launch fault, one "
                         "device fault, one host loss) — and assert the "
                         "chaos run converges to the same responses")
    ap.add_argument("--fabric", action="store_true",
                    help="accepted; the server always launches through "
                         "a Fabric")
    ap.add_argument("--bench-out", default=None, metavar="PATH",
                    help="measure sync vs overlapped drain and write the "
                         "dcra-serve-bench/v1 artifact")
    ap.add_argument("--reps", type=int, default=1,
                    help="--bench-out: alternate the two drains this many "
                         "times (odd; the median pair's ratio)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    if args.reps < 1 or args.reps % 2 == 0:
        ap.error(f"--reps must be odd and >= 1, got {args.reps}")
    if args.smoke:
        args.tenants = min(args.tenants, 4)
        args.requests = min(args.requests, 16)

    device = resolve_device(args.device)
    n_dev = args.devices
    fabric = Fabric.fake(n_dev, device=device)
    graphs = {
        "wiki": datasets.wiki_like(args.vertices, avg_degree=6, seed=3),
        "er": datasets.erdos_renyi(args.vertices, avg_degree=4, seed=7),
    }
    opts = ServeOptions(inflight_depth=args.depth, fairness=args.fairness,
                        donate_buffers=args.donate)
    stream = make_stream(graphs, args.tenants, args.requests)

    if args.chaos is not None:
        _chaos(args, fabric, graphs, stream, n_dev)
        return
    if args.bench_out:
        _bench_out(args, fabric, graphs, stream, n_dev, device)
        return

    server, responses, warm_s, serve_s, new_traces = serve_stream(
        fabric, graphs, stream, args.width, opts)
    snap = server.stats.snapshot()
    rows = [(t, s["submitted"], s["served"], s["rejected"], s["failed"],
             f"{s['p50_latency_s'] * 1e3:.1f}",
             f"{s['p99_latency_s'] * 1e3:.1f}",
             f"{s['p50_queue_wait_s'] * 1e3:.1f}",
             f"{s['p50_device_s'] * 1e3:.1f}")
            for t, s in sorted(snap["tenants"].items())]
    emit(rows, "tenant,submitted,served,rejected,failed,p50_ms,p99_ms,"
               "p50_wait_ms,p50_device_ms")
    print(f"# devices={n_dev} width={args.width} depth={args.depth} "
          f"fairness={args.fairness} surface=fabric "
          f"prewarm={warm_s:.1f}s "
          f"serve={serve_s:.1f}s "
          f"throughput={args.requests / serve_s:.1f} req/s")
    print(f"# launches={snap['launches']} "
          f"batched={snap['batched_requests']} "
          f"pad_columns={snap['pad_columns']} "
          f"cache_hit_rate={snap['cache_hit_rate']:.2f} "
          f"re_traces={new_traces} noc_drops={snap['noc_drops']} "
          f"p50_round={snap['p50_round_latency_s'] * 1e3:.1f}ms "
          f"p99_round={snap['p99_round_latency_s'] * 1e3:.1f}ms")

    if args.smoke:
        assert all(r.status == STATUS_OK for r in responses), \
            [r.reason for r in responses if r.status != STATUS_OK]
        assert snap["cache_hits"] >= 1, snap
        assert new_traces == 0, f"{new_traces} builds under load"
        assert snap["noc_drops"] == 0, snap   # default sizing is drop-free
        # one spot-check: the batched column matches a standalone launch
        r0 = responses[0]
        (ref,), _ = run_program(STANDALONE[stream[0].program],
                                graphs[stream[0].graph], fabric,
                                params={"root": stream[0].root})
        assert np.array_equal(np.asarray(r0.result), np.asarray(ref)), \
            "batched result != standalone"
        if args.depth > 1:
            # the overlapped leg: the same stream at depth 1 must produce
            # bit-identical responses AND ledger, with zero builds
            ref_srv, ref_resp, _, _, ref_traces = serve_stream(
                fabric, graphs, stream, args.width, ServeOptions())
            assert ref_traces == 0, f"{ref_traces} builds (sync leg)"
            assert _signature(responses) == _signature(ref_resp), \
                f"depth={args.depth} responses != synchronous drain"
            assert _ledger(server) == _ledger(ref_srv), \
                f"depth={args.depth} ledger != synchronous drain"
        print("RESULT ok")


if __name__ == "__main__":
    main()
