#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each reporting on its own lines; any failure raises and the
script exits non-zero with no result line:

1. card: ``nvidia-smi`` name and power limit, device name, kernel build
   (``nvcc`` for ``sm_90a``) and its seconds;
2. host setup: RMAT-22 (numpy), its CSR and the packing onto 64 shards;
3. kernels vs their plain PyTorch versions on the card, at the main
   path's shapes and at edge cases, with times, bounds and a library
   yardstick for the reduce;
4. BFS on RMAT-22, flat (64 shards) and pod/portal (8 x 8): equal to the
   numpy oracle, no drops, bit-identical to the plain-torch path
   (``route_impl="sort"``), every kernel launched, TEPS and the
   per-round kernel times;
5. SSSP and WCC on RMAT-18, flat (8) and pod/portal (2 x 4), equal to
   their oracles.

The line before the last is the JSON kernel table, the last line
``{"ok": true, "device": {...}}``. It needs a CUDA card and the
repository around it: without either it exits with code 2.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3, NVIDIA data sheet
SEED = 1
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/route.cu"
REPLACES = {"bucket_rank": "src/repro/kernels/route.py:120",
            "bucket_scatter": "src/repro/kernels/route.py:282",
            "reduce_received": "src/repro/kernels/route.py:359"}
# substrings of each wrapper's CUDA kernels, for the profiler's table
KERNEL_NAMES = {"bucket_rank": ("rank_count_kernel", "rank_scan_kernel",
                                "rank_kernel"),
                "bucket_scatter": ("fill_kernel", "scatter_kernel"),
                "reduce_received": ("reduce_init_kernel", "reduce_kernel",
                                    "reduce_finish_kernel")}


def log(*parts):
    print(*parts, flush=True)


def cuda_ms(fn, reps):
    """Mean device milliseconds of ``fn()`` over ``reps`` runs after one
    warm-up, by CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes):
    return n_bytes / HBM_BYTES_PER_S * 1e3


# ---------------------------------------------------------------------------
# phase 3: kernels vs their plain versions
# ---------------------------------------------------------------------------

def rand_tasks(rng, s, n, nb, k, d, p_valid, device):
    import torch
    dest = torch.tensor(rng.integers(0, nb, (s, n)), dtype=torch.int32)
    valid = torch.tensor(rng.random((s, n)) < p_valid)
    x = torch.tensor(rng.random((s, n, d)), dtype=torch.float32)
    aux = [torch.tensor(rng.integers(-1, 1 << 20, (s, n)), dtype=torch.int32)
           for _ in range(k)]
    return (x.to(device), dest.to(device), valid.to(device),
            [a.to(device) for a in aux])


def check_bucket(route, x, dest, valid, aux, nb, cap):
    import torch
    got_rank = route.bucket_rank(dest, valid, nb)
    want_rank = route.plain_bucket_rank(dest, valid, nb)
    if not torch.equal(got_rank, want_rank):
        raise AssertionError(f"bucket_rank differs at {tuple(dest.shape)}, "
                             f"{nb} buckets")
    got = route.bucket_scatter(x, dest, valid, aux, nb, cap)
    want = route.plain_bucket_scatter(x, dest, valid, aux, nb, cap)
    same = (torch.equal(got[0], want[0]) and len(got[1]) == len(want[1])
            and all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
            and torch.equal(got[2], want[2]) and torch.equal(got[3], want[3]))
    if not same:
        raise AssertionError(f"bucket_scatter differs at {tuple(x.shape)}, "
                             f"{nb} buckets, cap {cap}")
    return int(want[3].sum())


def check_reduce(route, slot, val, n_local, integer_valued):
    """min and store bit-identical. add: exact when every value is a
    whole number and every slot's sum stays below 2^24 (no f32 sum of
    such numbers rounds); otherwise both sides are f32 atomic sums in
    some order, each within (k-1)*2^-24*sum|v| of the exact sum for a
    slot of k terms, so they agree within max(1e-6, 2*k*2^-24)*sum|v|
    (1e-6 covers k <= 8)."""
    import torch
    for op in ("min", "store"):
        got = route.reduce_received(slot, val, n_local, op)
        want = route.plain_reduce_received(slot, val, n_local, op)
        if not torch.equal(got, want):
            raise AssertionError(f"reduce_received {op} differs")
    got = route.reduce_received(slot, val, n_local, "add")
    want = route.plain_reduce_received(slot, val, n_local, "add")
    err = (got - want).abs()
    if not err.numel():
        return 0.0, 0.0
    if integer_valued:
        if not torch.equal(got, want):
            raise AssertionError("reduce_received add differs on "
                                 "integer-valued payloads")
        return 0.0, 0.0
    scale = route.plain_reduce_received(slot, val.abs(), n_local, "add")
    terms = route.plain_reduce_received(slot, torch.ones_like(val),
                                        n_local, "add")
    tol = torch.clamp(2 * terms * 2.0 ** -24, min=1e-6) * scale
    if bool((err > tol).any()):
        raise AssertionError(f"reduce_received add off by "
                             f"{float(err.max())}")
    return float(err.max()), float((err / scale.clamp(min=1e-30)).max())


def kernel_edge_cases(route, device):
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED)
    cases = [  # (S, N, buckets, cap, k, D, p_valid)
        (1, 0, 4, 2, 1, 1, 0.9), (1, 1, 4, 2, 1, 1, 0.9),
        (7, 1031, 7, 5, 2, 1, 0.9), (64, 5003, 64, 9, 1, 1, 0.9),
        (3, 4097, 8, 1, 2, 3, 0.9), (7, 2048, 7, 3, 1, 1, 0.0),
        (1, 3000, 1, 3000, 1, 1, 1.0), (64, 1031, 8, 2, 2, 1, 0.5)]
    drops = 0
    for s, n, nb, cap, k, d, p in cases:
        x, dest, valid, aux = rand_tasks(rng, s, n, nb, k, d, p, device)
        drops += check_bucket(route, x, dest, valid, aux, nb, cap)
        n_local = 3 * nb + 1
        slot = torch.tensor(rng.integers(-1, n_local + 2, (s, n)),
                            dtype=torch.int32, device=device)
        whole = torch.tensor(rng.integers(-9, 10, (s, n)),
                             dtype=torch.float32, device=device)
        check_reduce(route, slot, whole, n_local, integer_valued=True)
        check_reduce(route, slot, whole * 0.37, n_local, integer_valued=False)
    if drops == 0:
        raise AssertionError("edge cases never dropped")
    torch.cuda.synchronize()
    log(f"kernels: {len(cases)} edge cases bit-identical to the plain "
        f"versions ({drops} drops exercised)")


def main_shape_kernels(route, routing, setup, device):
    """The kernels at the flat BFS round's shapes: 64 shards, N = E_max,
    cap from capacity factor 4, every edge an active task."""
    import numpy as np
    import torch
    from repro_torch.core.queues import QueueConfig
    n_local, _, dst_np, w_np, e_max = setup
    s = 64
    cap = routing.resolve_flat_cap(QueueConfig.from_factor(4.0), "T3", e_max,
                                   s, clamp=True)
    dst = torch.from_numpy(dst_np).to(device).view(s, e_max)
    x = torch.from_numpy(w_np).to(device).view(s, e_max, 1)
    valid = dst >= 0
    dest = (dst.clamp(min=0) % s).to(torch.int32)
    aux = [(dst.clamp(min=0) // s).to(torch.int32)]
    drops = check_bucket(route, x, dest, valid, aux, s, cap)
    if drops:
        raise AssertionError(f"{drops} drops at the main shape")
    xb, ints, _, _ = route.plain_bucket_scatter(x, dest, valid, aux, s, cap)
    recv_val, (recv_slot,) = routing.fused_all_to_all(xb, ints, (s,), 0)
    recv_val = recv_val[..., 0].contiguous()
    err, rel = check_reduce(route, recv_slot, recv_val, n_local,
                            integer_valued=False)
    log(f"kernel reduce_received at the main shape: min and store "
        f"bit-identical; add max |err| {err} = {rel:.3e} of the slot's "
        f"sum of |v| (f32 atomics in another order)")
    ones = torch.ones_like(recv_val)
    check_reduce(route, recv_slot, ones, n_local, integer_valued=True)
    torch.cuda.synchronize()

    tasks = s * e_max
    slots = s * s * cap
    m = recv_slot.numel()
    rows = {}
    # the library call's index: a received entry goes to its shard's
    # slot, an empty one to a scratch cell of its own past the s*n_local
    # outputs (one shared spare cell would serialise its atomics)
    flat_idx = torch.where(
        recv_slot >= 0,
        torch.arange(s, device=device)[:, None] * n_local + recv_slot.long(),
        s * n_local + torch.arange(m, device=device).view(s, -1)).reshape(-1)
    flat_val = recv_val.reshape(-1)
    y0 = torch.full((s * n_local + m,), float("inf"), device=device)

    def library_call():
        y0.scatter_reduce_(0, flat_idx, flat_val, "amin")

    for name, kern, plain, n_bytes, lib in [
            ("bucket_rank",
             lambda: route.bucket_rank(dest, valid, s),
             lambda: route.plain_bucket_rank(dest, valid, s),
             tasks * (4 + 1 + 4), None),
            ("bucket_scatter",
             lambda: route.bucket_scatter(x, dest, valid, aux, s, cap),
             lambda: route.plain_bucket_scatter(x, dest, valid, aux, s, cap),
             tasks * (4 + 4 + 1 + 4 + 4) + slots * (4 + 4) + s * 4, None),
            ("reduce_received",
             lambda: route.reduce_received(recv_slot, recv_val, n_local,
                                           "min"),
             lambda: route.plain_reduce_received(recv_slot, recv_val,
                                                 n_local, "min"),
             m * (4 + 4) + s * n_local * 4, library_call)]:
        rows[name] = {
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES[name], "launches": 0,
            "max_abs_err": err if name == "reduce_received" else 0.0,
            "ms": cuda_ms(kern, 5), "plain_ms": cuda_ms(plain, 2),
            "bound_ms": bound_ms(n_bytes), "bound_by": "bytes",
            "library_ms": cuda_ms(lib, 5) if lib else None}
        r = rows[name]
        log(f"kernel {name}: S={s} N={e_max} cap={cap}: {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms (no yardstick), bound "
            f"{r['bound_ms']:.4f} ms ({n_bytes} B / 3.35 TB/s)"
            + (f", scatter_reduce_ {r['library_ms']:.4f} ms" if lib else ""))
    if not torch.equal(y0[:s * n_local].view(s, n_local),
                       route.reduce_received(recv_slot, recv_val, n_local,
                                             "min")):
        raise AssertionError("the scatter_reduce_ yardstick computes "
                             "another function")
    return rows


# ---------------------------------------------------------------------------
# phase 4/5: the apps
# ---------------------------------------------------------------------------

def profile_kernels(fn, rounds):
    """One run of ``fn`` under torch.profiler: ``(device ms per round of
    each wrapper's kernels, device ms of all kernels, wall ms of the run,
    the five costliest device ops as (name, ms))``; ``None`` in place of
    the first where the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per = {k: 0.0 for k in KERNEL_NAMES}
    total = 0.0
    ops = []
    for ev in prof.key_averages():
        us = float(getattr(ev, "device_time_total", 0.0)
                   or getattr(ev, "cuda_time_total", 0.0) or 0.0)
        if not us:
            continue
        total += us
        ops.append((ev.key[:60], us / 1e3))
        for wrapper, names in KERNEL_NAMES.items():
            if any(nm in ev.key for nm in names):
                per[wrapper] += us
                break
    if total == 0.0:
        return None, 0.0, wall_ms, []
    top = sorted(ops, key=lambda o: -o[1])[:5]
    return ({k: v / 1e3 / max(rounds, 1) for k, v in per.items()},
            total / 1e3, wall_ms, top)


def run_bfs(g, root, want, setup, layout, fabric, opts, route):
    import numpy as np
    import torch
    from repro_torch.sparse.torch_apps import dcra_bfs
    route.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dist, stats = dcra_bfs(g, root, fabric, options=opts, setup=setup)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(route.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not np.array_equal(dist, want):
        raise AssertionError(f"BFS {layout}: distances differ from the "
                             f"oracle at {int((dist != want).sum())} vertices")
    if stats.total_drops:
        raise AssertionError(f"BFS {layout}: {stats.total_drops} drops")
    if not all(launches.values()):
        raise AssertionError(f"BFS {layout}: a kernel never launched: "
                             f"{launches}")
    plain, pstats = dcra_bfs(g, root, fabric, setup=setup,
                             options=opts.with_(route_impl="sort"))
    if not (np.array_equal(plain, dist) and pstats.rounds == stats.rounds
            and np.array_equal(pstats.messages, stats.messages)
            and np.array_equal(pstats.drops, stats.drops)):
        raise AssertionError(f"BFS {layout}: kernel path differs from the "
                             f"plain-torch path")
    per_round, device_ms, wall_ms, top = profile_kernels(
        lambda: dcra_bfs(g, root, fabric, options=opts, setup=setup),
        stats.rounds)
    reached_edges = int(g.degrees()[want >= 0].sum())
    log(f"bfs {layout}: rounds={stats.rounds} messages="
        f"{stats.messages.tolist()} drops=0 run_s={run_s:.4f} "
        f"TEPS={reached_edges / run_s:.4e} (reached edges {reached_edges}) "
        f"peak_mem_gb={peak_gb:.2f} launches={launches} "
        f"plain-torch path bit-identical")
    if per_round is None:
        log(f"bfs {layout}: per-round kernel times not measured (the "
            f"profiler saw no device time)")
    else:
        log(f"bfs {layout}: per-round kernel ms "
            + json.dumps({k: round(v, 4) for k, v in per_round.items()})
            + f", all device kernels {device_ms:.2f} ms of the profiled "
            f"run's {wall_ms:.2f} ms (device busy {device_ms / wall_ms:.3f})")
        log(f"bfs {layout}: costliest device ops (ms in the run): "
            + "; ".join(f"{name} {ms:.2f}" for name, ms in top))
    return launches


def small_apps(device):
    import numpy as np
    from repro_torch.core.fabric import Fabric
    from repro_torch.sparse import datasets, ref
    from repro_torch.sparse.options import LaunchOptions
    from repro_torch.sparse.torch_apps import dcra_sssp, dcra_wcc
    g = datasets.rmat(18, seed=SEED)
    root = int(np.argmax(g.degrees()))
    want_d, want_l = ref.sssp_ref(g, root), ref.wcc_ref(g)
    for layout, fab, opts in [
            ("flat 8", Fabric.fake(8, device=device), LaunchOptions()),
            ("pod 2x4", Fabric.virtual((2, 4), ("pod", "data"),
                                       device=device),
             LaunchOptions(pod_axis="pod", capacity_factor=2.0))]:
        d, st = dcra_sssp(g, root, fab, options=opts)
        lab, st2 = dcra_wcc(g, fab, options=opts)
        if not np.array_equal(d, want_d) or st.total_drops:
            raise AssertionError(f"SSSP {layout} differs from the oracle")
        if not np.array_equal(lab, want_l) or st2.total_drops:
            raise AssertionError(f"WCC {layout} differs from the oracle")
        log(f"sssp/wcc rmat-18 {layout}: nnz={g.nnz} sssp rounds={st.rounds} "
            f"wcc rounds={st2.rounds} components={len(np.unique(lab))}: "
            f"equal to the oracles, 0 drops")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside the script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.core import routing
    from repro_torch.core.fabric import Fabric
    from repro_torch.kernels import _build
    from repro_torch.kernels import route
    from repro_torch.sparse import datasets, ref
    from repro_torch.sparse.options import LaunchOptions
    from repro_torch.sparse.program import _graph_setup

    # ---- 1: card + build ---------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    log(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"numpy {np.__version__}")
    rec = _build.build_record()
    log(f"build: {Path(rec['path']).name} in {rec['seconds']:.2f} s "
        f"(nvcc sm_90a)")

    # ---- 2: host setup -----------------------------------------------------
    t0 = time.perf_counter()
    g = datasets.rmat(22, seed=SEED)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    setup = _graph_setup(g, 64)
    t_pack = time.perf_counter() - t0
    root = int(np.argmax(g.degrees()))
    t0 = time.perf_counter()
    want = ref.bfs_ref(g, root)
    t_ref = time.perf_counter() - t0
    log(f"setup rmat-22: n={g.n} nnz={g.nnz} E_max={setup[-1]} "
        f"generate+CSR {t_gen:.2f} s, pack onto 64 shards {t_pack:.2f} s, "
        f"oracle BFS {t_ref:.2f} s (numpy)")

    # ---- 3: kernels vs plain ----------------------------------------------
    kernel_edge_cases(route, device)
    rows = main_shape_kernels(route, routing, setup, device)

    # ---- 4: BFS on RMAT-22 -------------------------------------------------
    launches = {k: 0 for k in route.LAUNCHES}
    for layout, fab, opts in [
            ("flat 64", Fabric.fake(64, device=device),
             LaunchOptions(capacity_factor=4.0)),
            ("pod 8x8", Fabric.virtual((8, 8), ("pod", "data"),
                                       device=device),
             LaunchOptions(pod_axis="pod", capacity_factor=2.0))]:
        got = run_bfs(g, root, want, setup, layout, fab, opts, route)
        for k, v in got.items():
            launches[k] += v
    for k in rows:
        rows[k]["launches"] = launches[k]

    # ---- 5: SSSP and WCC on RMAT-18 ---------------------------------------
    small_apps(device)

    log(json.dumps({"kernels": list(rows.values())}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
