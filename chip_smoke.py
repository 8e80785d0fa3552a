#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each reporting on its own lines; any failure raises and the
script exits non-zero with no result line:

1. card: ``nvidia-smi`` name and power limit, device name, kernel build
   (one ``nvcc`` for ``sm_90a`` per source, all started together) and
   its seconds; each kernel's registers, spills and shared memory from
   ``-Xptxas -v`` (the register-blocked kernels must not spill), and the
   ``HGMMA`` instructions that ``cuobjdump -sass`` finds in each library
   (the gmm and flash-attention libraries must have some); the kernel
   that SDPA runs in float32 at the flash shape, named by a profiled
   run;
2. host setup: RMAT-22 (numpy), its CSR and the packing onto 64 shards;
3. kernels vs their plain PyTorch versions on the card, at the main
   paths' shapes and at edge cases, with times, bounds and library
   yardsticks: the three route kernels and the histogram kernel; the
   BSR SpMV kernels at edge cases on both designs (split, rowblock: an
   out-of-range block column, R = 1, Kb off the slice count, an
   unaligned x), the split design bit-identical over two runs, and at a
   synthetic shape (its row is timed in phase 9);
4. BFS on RMAT-22, flat (64 shards) and pod/portal (8 x 8): equal to the
   numpy oracle, no drops, bit-identical to the plain-torch path
   (``route_impl="sort"``), every kernel launched, TEPS and the
   per-round kernel times;
5. PageRank on RMAT-22, flat 64, 20 rounds: every vertex within its
   float32 error bound of the float64 oracle and of the plain-torch
   path, and within 1e-4 of both relative to the largest rank;
6. SpMV on RMAT-22, flat 64 and pod/portal 8 x 8: every row within its
   float32 error bound of the oracle and of the plain-torch path, and
   within 1e-4 of both relative to the largest |y|;
7. histogram of 2^28 elements over 4096 bins: one shard (the histogram
   kernel's local reduce), flat 64 and pod/portal 8 x 8, equal to the
   oracle;
8. SSSP, WCC and k-core on RMAT-18, flat (8) and pod/portal (2 x 4),
   equal to their oracles;
9. ``spmv_csr`` end to end (the BSR kernel, split design, asserted from
   ``PATHS``) on an Erdos-Renyi graph of 2^14 vertices, against the
   oracle within the BSR tolerance; then the BSR kernel on the same
   arrays against its plain version, timed for the kernel table, and
   the rowblock design on an x 4 bytes off alignment, timed beside it;
10. the MoE layer of OLMoE-1B-7B at full width (d_model 2048, 64 experts
   top-8, d_expert 1024; float32 weights from ``torch.Generator`` seed
   1) through ``moe_dcra`` on three virtual packagings: (data 2, expert
   8, tp 1) fused, (data 2, expert 4, tp 2) with a tp-sharded FFN, and
   (pod 2, data 1, expert 4, tp 2) two-stage. At the config's capacity
   factor 1.25 on x [8, 2048, 2048]: drops per bucket, layer ms,
   tokens/s, peak GB, route-kernel launches, one profiled run. With no
   drop (dispatch queue at factor 8) on x [2, 2048, 2048]: held to the
   port's ``moe_einsum`` (factor 8, capacity the whole group) within
   1e-4 of max|out|;
11. the grouped-matmul and flash-attention kernels against their plain
   versions at edge cases on every design (gmm: wgmma, blocked, simt;
   flash: wgmma, blocked, simt), then ``ops.gmm`` at phase 10's expert
   buckets (the fused packaging's ``xe`` of all shards, w = wg, the real
   expert of every row tile) in float32 and in bf16, and
   ``ops.flash_attention`` at OLMoE's attention widths (B 2, H 16, S
   4096, hd 128, causal, bf16 and float32), each on the design its launch
   plan names (asserted from the wrappers' ``PATHS``) and timed beside
   its bound, its plain version and one PyTorch call (``torch.bmm``,
   ``scaled_dot_product_attention``, whose float32 kernel phase 1
   names); the bf16 gmm and the float32 flash also on the simt kernels,
   through inputs that start 2 or 4 bytes off a 16-byte boundary. The
   gmm, flash and BSR C entry points must refuse a launch plan altered
   in any field.

Each path of phases 4-7, 9, 10 and 11 runs with every kernel's launch
count set to 0 just before it and read just after; the kernel table
sums them.
The line before the last is the JSON kernel table (the gmm row carries
its bf16 run under ``bf16_*`` keys, the flash row its float32 run under
``f32_*``; ``design`` and ``f32_design`` on the BSR and flash rows name
the design that ran), the last line ``{"ok": true, "device": {...}}``.
It needs a CUDA card and the repository around it: without either it
exits with code 2.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3, NVIDIA data sheet
F32_FLOP_PER_S = 67e12             # H100 SXM float32 outside the tensor cores
BF16_FLOP_PER_S = 989e12           # H100 SXM bf16 tensor cores, dense
U = 2.0 ** -24                     # unit roundoff of float32
SEED = 1
CSRC = "src/repro_torch/kernels/csrc/"
SOURCES = {"bucket_rank": CSRC + "route.cu", "bucket_scatter": CSRC + "route.cu",
           "reduce_received": CSRC + "route.cu",
           "histogram": CSRC + "histogram.cu", "bsr_spmv": CSRC + "spmv.cu",
           "gmm": CSRC + "gmm.cu",
           "flash_attention": CSRC + "flash_attention.cu"}
REPLACES = {"bucket_rank": "src/repro/kernels/route.py:120",
            "bucket_scatter": "src/repro/kernels/route.py:282",
            "reduce_received": "src/repro/kernels/route.py:359",
            "histogram": "src/repro/kernels/histogram.py:38",
            "bsr_spmv": "src/repro/kernels/spmv.py:39",
            "gmm": "src/repro/kernels/moe_gmm.py:29",
            "flash_attention": "src/repro/kernels/flash_attention.py:66"}
# substrings of each wrapper's CUDA kernels, for the profiler's table
KERNEL_NAMES = {"bucket_rank": ("rank_count_kernel", "rank_scan_kernel",
                                "rank_kernel"),
                "bucket_scatter": ("fill_kernel", "scatter_kernel"),
                "reduce_received": ("reduce_init_kernel", "reduce_kernel",
                                    "reduce_finish_kernel"),
                "histogram": ("hist_kernel",),
                "bsr_spmv": ("bsr_spmv_kernel", "bsr_split_kernel",
                             "bsr_combine_kernel"),
                "gmm": ("gmm_kernel", "gmm_blocked_kernel",
                        "gmm_wgmma_kernel"),
                "flash_attention": ("flash_kernel", "flash_wgmma_kernel",
                                    "flash_blocked_kernel")}
#: libraries whose kernels must use the tensor cores' wgmma (HGMMA in SASS)
WGMMA_LIBS = ("gmm", "flash_attention")
#: kernels that must not spill (``-Xptxas -v``): the register-blocked ones
NO_SPILL = ("gmm_blocked_kernel", "flash_blocked_kernel", "bsr_split_kernel")
#: designs each of ``plans_refused``'s launches covers: gmm 4, flash 4, BSR 2
PLAN_DESIGNS = 10
CARD = ("cuda", 0)
SCALE, SMALL_SCALE = 22, 18        # RMAT scales of the main and small graphs
HIST_N, HIST_BINS = 1 << 28, 4096
BSR_TIMED = (2048, 32, 128, 2048)  # R, Kb, BS, Ncb
ER_VERTICES = 1 << 14              # spmv_csr's graph
MOE_ARCH = "olmoe-1b-7b"
MOE_TOKENS = (8, 2048)             # x [B, S, d_model] at the config's factor
MOE_CHECK_TOKENS = (2, 2048)       # the no-drop comparison with the einsum
MOE_PACKAGINGS = [  # (label, fabric shape, axis names, MeshInfo options)
    ("fused (data 2, expert 8, tp 1)", (2, 8, 1), ("data", "expert", "tp"),
     {}),
    ("tp-sharded FFN (data 2, expert 4, tp 2)", (2, 4, 2),
     ("data", "expert", "tp"), {"fuse_tp": False}),
    ("two-stage (pod 2, data 1, expert 4, tp 2)", (2, 1, 4, 2),
     ("pod", "data", "expert", "tp"), {"pod_axis": "pod"})]
FLASH_SHAPE = (2, 16, 4096, 128)   # B, H, S, hd: OLMoE's attention widths


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


def bound_ms(n_bytes, n_flops=0, flop_rate=F32_FLOP_PER_S):
    """The least time for the work: the larger of the bytes over the HBM
    rate and the operations over the card's rate for their type (float32
    outside the tensor cores unless ``flop_rate`` says otherwise)."""
    return max(n_bytes / HBM_BYTES_PER_S, n_flops / flop_rate) * 1e3


def kernel_modules():
    from repro_torch.kernels import (flash_attention, histogram, moe_gmm,
                                     route, spmv)
    return route, histogram, spmv, moe_gmm, flash_attention


def reset_launches():
    for mod in kernel_modules():
        mod.reset_launches()


def read_launches():
    counts = {}
    for mod in kernel_modules():
        counts.update(mod.LAUNCHES)
    return counts


class MainPath:
    """One main path's run: every launch count set to 0 on entry, read on
    exit into ``self.launches``; ``need`` names the kernels the path must
    have launched."""

    def __init__(self, name, need, totals):
        self.name, self.need, self.totals = name, need, totals

    def __enter__(self):
        import torch
        torch.cuda.synchronize()
        reset_launches()
        return self

    def __exit__(self, kind, *_):
        import torch
        torch.cuda.synchronize()
        self.launches = read_launches()
        if kind is not None:
            return False
        missing = [k for k in self.need if not self.launches[k]]
        if missing:
            raise AssertionError(f"{self.name}: kernels never launched: "
                                 f"{missing} ({self.launches})")
        for k, v in self.launches.items():
            self.totals[k] += v
        return False


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
            "name": name, "route": "cuda", "source": SOURCES[name],
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

def is_port_kernel(key, name):
    """Whether the profiler's kernel ``key`` is the port's kernel ``name``.
    The port's kernels sit in a top-level anonymous namespace, so a
    PyTorch kernel of the same name (``at::native::reduce_kernel``) or
    one that contains it is not counted."""
    for prefix in ("(anonymous namespace)::", "void (anonymous namespace)::"):
        if key.startswith(prefix + name):
            return key[len(prefix) + len(name):][:1] in ("(", "<")
    return False


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
            if any(is_port_kernel(ev.key, nm) for nm in names):
                per[wrapper] += us
                break
    if total == 0.0:
        return None, 0.0, wall_ms, []
    top = sorted(ops, key=lambda o: -o[1])[:5]
    return ({k: v / 1e3 / max(rounds, 1) for k, v in per.items()},
            total / 1e3, wall_ms, top)


ROUTE_KERNELS = ("bucket_rank", "bucket_scatter", "reduce_received")


def run_bfs(g, root, want, setup, layout, fabric, opts, totals):
    import numpy as np
    import torch
    from repro_torch.sparse.torch_apps import dcra_bfs
    torch.cuda.reset_peak_memory_stats()
    with MainPath(f"BFS {layout}", ROUTE_KERNELS, totals) as path:
        t0 = time.perf_counter()
        dist, stats = dcra_bfs(g, root, fabric, options=opts, setup=setup)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not np.array_equal(dist, want):
        raise AssertionError(f"BFS {layout}: distances differ from the "
                             f"oracle at {int((dist != want).sum())} vertices")
    if stats.total_drops:
        raise AssertionError(f"BFS {layout}: {stats.total_drops} drops")
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
        f"peak_mem_gb={peak_gb:.2f} launches={path.launches} "
        f"plain-torch path bit-identical")
    log_profile(f"bfs {layout}", per_round, device_ms, wall_ms, top)


# ---------------------------------------------------------------------------
# phase 3: the histogram and BSR kernels vs their plain versions
# ---------------------------------------------------------------------------

def leaf_edge_cases(device):
    """Histogram bit-identical to ``plain_histogram`` (ids below 0 and past
    the last bin present, 2^20 bins for the global-memory branch); BSR
    within ``2*Kb*BS*2^-24`` of each row's sum of |a*x| of the plain
    einsum (full float32) on the design its plan names: split at BS
    32 / 64 / 128, R = 1, Kb off the slice count and BS past one pass,
    rowblock at BS off 4 and with x 4 bytes off alignment; a block column
    outside [0, Ncb) as a zero x tile on both; the split design
    bit-identical over two runs. Returns the worst BSR error /
    tolerance."""
    import numpy as np
    import torch
    from repro_torch.kernels import histogram as hist
    from repro_torch.kernels import spmv
    rng = np.random.default_rng(SEED)
    n_cases = 0
    for n in (0, 1, 997, (1 << 20) + 3):
        for bins in (1, 61, 4096, 1 << 20):
            ids = torch.from_numpy(rng.integers(-7, bins + 7, n + 1).astype(
                np.int32)).to(device)
            for e in (ids[:n], ids[1:]):          # 16-byte aligned or not
                if not torch.equal(hist.histogram(e, bins),
                                   hist.plain_histogram(e, bins)):
                    raise AssertionError(f"histogram differs at N={n}, "
                                         f"{bins} bins")
                n_cases += 1
    worst = 0.0
    shapes = [  # (R, Kb, BS, Ncb, x off alignment, design)
        (4, 3, 32, 6, False, "split"), (8, 2, 64, 8, False, "split"),
        (2, 5, 128, 4, False, "split"), (6, 4, 64, 9, False, "split"),
        (3, 7, 128, 5, False, "split"), (1, 9, 128, 3, False, "split"),
        (50, 20, 16, 9, False, "split"), (2, 3, 256, 4, False, "split"),
        (5, 3, 30, 7, False, "rowblock"), (6, 4, 64, 9, True, "rowblock")]
    for r, kb, bs, ncb, off, design in shapes:
        bc = torch.from_numpy(rng.integers(0, ncb, (r, kb)).astype(
            np.int32)).to(device)
        blocks = torch.from_numpy((rng.random((r, kb, bs, bs)) - 0.5).astype(
            np.float32)).to(device)
        x = torch.from_numpy((rng.random(ncb * bs) - 0.5).astype(
            np.float32)).to(device)
        if off:                          # a view 4 bytes into its storage
            x = torch.zeros(x.numel() + 1, device=device)[1:].copy_(x)
        spmv.reset_launches()
        worst = max(worst, bsr_check(spmv, bc, blocks, x))
        ran_only(spmv, design)
        # a column out of range reads a zero x tile: as the plain version
        # with that column at 0 and its block zero
        bc[0, 0] = ncb if r % 2 else -1
        keep = ((bc >= 0) & (bc < ncb))[..., None, None]
        got = spmv.bsr_spmv(bc, blocks, x)
        worst = max(worst, bsr_check(spmv, torch.where(keep[..., 0, 0], bc, 0),
                                     blocks * keep, x, got))
        if design == "split" and not torch.equal(got, spmv.bsr_spmv(
                bc, blocks, x)):
            raise AssertionError(f"bsr_spmv split: two runs differ at "
                                 f"{tuple(blocks.shape)}")
    torch.cuda.synchronize()
    log(f"kernels: histogram {n_cases} cases bit-identical to the plain "
        f"version; bsr_spmv {len(shapes)} shapes on the design each plan "
        f"names, each also with a block column out of range, within "
        f"tolerance of the plain version (worst |err| / tol {worst:.4f}); "
        f"the split design bit-identical over two runs")
    return worst


def ran_only(mod, want):
    """Every launch since ``mod.reset_launches()`` ran the ``want``
    design."""
    if mod.PATHS[want] != sum(mod.PATHS.values()):
        raise AssertionError(f"{mod.__name__}: expected the {want} design "
                             f"only, ran {mod.PATHS}")


def bsr_check(spmv, bc, blocks, x, got=None):
    """The kernel (or ``got``, its result on other inputs that must give
    the same function) against the plain einsum in full float32: worst
    ratio of |err| to ``2*Kb*BS*2^-24 * sum |a*x|`` over the rows (must
    be <= 1)."""
    import torch
    kb, bs = blocks.shape[1], blocks.shape[2]
    torch.backends.cuda.matmul.allow_tf32 = False
    want = spmv.plain_bsr_spmv(bc, blocks, x)
    scale = spmv.plain_bsr_spmv(bc, blocks.abs(), x.abs())
    if got is None:
        got = spmv.bsr_spmv(bc, blocks, x)
    tol = 2 * kb * bs * 2.0 ** -24 * scale
    ratio = float(((got - want).abs() / tol.clamp(min=1e-30)).max())
    if not bool(((got - want).abs() <= tol).all()):
        raise AssertionError(f"bsr_spmv off by {ratio:.3f} x the tolerance "
                             f"at {tuple(blocks.shape)}")
    return ratio


def leaf_timed(device, ids):
    """The histogram kernel's row at the main path's shape (the 2^28 ids
    over 4096 bins); the BSR kernel at the synthetic shape R = 2048,
    Kb = 32, BS = 128, Ncb = 2048, logged beside the row that
    :func:`run_spmv_csr` times at the main path's shape."""
    import torch
    from repro_torch.kernels import histogram as hist
    from repro_torch.kernels import spmv
    rows = {}
    n = ids.numel()
    got = hist.histogram(ids, HIST_BINS)
    if not torch.equal(got, hist.plain_histogram(ids, HIST_BINS)):
        raise AssertionError("histogram differs at the timed shape")
    lib = torch.bincount(ids, minlength=HIST_BINS)
    if not torch.equal(lib.int(), got):
        raise AssertionError("the bincount yardstick computes another "
                             "function")
    n_bytes = 4 * n + 4 * HIST_BINS
    rows["histogram"] = row(
        "histogram", 0.0, cuda_ms(lambda: hist.histogram(ids, HIST_BINS), 5),
        cuda_ms(lambda: hist.plain_histogram(ids, HIST_BINS), 2), n_bytes,
        cuda_ms(lambda: torch.bincount(ids, minlength=HIST_BINS), 5))
    log_row(rows["histogram"], f"N={n} bins={HIST_BINS}", n_bytes,
            "torch.bincount")

    r, kb, bs, ncb = BSR_TIMED
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    blocks = torch.rand(r, kb, bs, bs, generator=gen, device=device) - 0.5
    # distinct sorted block columns a row, so the library's BSR is valid
    bc = torch.rand(r, ncb, generator=gen, device=device).argsort(1)[:, :kb]
    bc = bc.sort(1).values.to(torch.int32).contiguous()
    x = torch.rand(ncb * bs, generator=gen, device=device) - 0.5
    synthetic = bsr_row(spmv, bc, blocks, x)
    log_row(synthetic, f"R={r} Kb={kb} BS={bs} Ncb={ncb} (synthetic shape, "
            f"no path runs it)", synthetic["n_bytes"], synthetic["lib_note"])
    del blocks
    torch.cuda.empty_cache()
    return rows


def bsr_bytes_flops(r, kb, bs, ncb):
    """What ``bsr_spmv`` must move and do: every block read once, x read
    once (its repeated tiles come from L2 and shared memory), y written
    once, the block columns read once; two flops a block entry."""
    return (4 * r * kb * bs * bs + 4 * ncb * bs + 4 * r * bs + 4 * r * kb,
            2 * r * kb * bs * bs)


def bsr_row(spmv, bc, blocks, x):
    """The BSR kernel against the plain einsum on these inputs (on the
    split design, asserted, and bit-identical over two runs), then its
    time, the plain version's, the bound and the library call's; the
    rowblock design, reached through a copy of x 4 bytes off alignment,
    is checked and timed beside it (logged)."""
    import torch
    r, kb, bs, _ = blocks.shape
    ncb = x.numel() // bs
    spmv.reset_launches()
    ratio = bsr_check(spmv, bc, blocks, x)
    got = spmv.bsr_spmv(bc, blocks, x)
    ran_only(spmv, "split")
    if not torch.equal(got, spmv.bsr_spmv(bc, blocks, x)):
        raise AssertionError(f"bsr_spmv split: two runs differ at R={r} "
                             f"Kb={kb}")
    err = float((got - spmv.plain_bsr_spmv(bc, blocks, x)).abs().max())
    n_bytes, n_flops = bsr_bytes_flops(r, kb, bs, ncb)
    lib_ms, lib_note = bsr_library_ms(bc, blocks, x, got, r, kb, bs, ncb)
    out = row("bsr_spmv", err, cuda_ms(lambda: spmv.bsr_spmv(bc, blocks, x), 5),
              cuda_ms(lambda: spmv.plain_bsr_spmv(bc, blocks, x), 2), n_bytes,
              lib_ms, n_flops)
    xu = torch.zeros(x.numel() + 1, device=x.device)[1:].copy_(x)
    spmv.reset_launches()
    bsr_check(spmv, bc, blocks, xu)
    rowblock_ms = cuda_ms(lambda: spmv.bsr_spmv(bc, blocks, xu), 5)
    ran_only(spmv, "rowblock")
    del xu
    log(f"kernel bsr_spmv at R={r} Kb={kb} BS={bs} Ncb={ncb}, design split "
        f"{spmv.launch_plan(r, kb, bs)}: max |err| {err} vs the plain "
        f"einsum, {ratio:.4f} of the tolerance, two runs bit-identical; "
        f"{out['ms'] / out['bound_ms']:.3f}x its bound; the rowblock design "
        f"(x 4 bytes off alignment) {rowblock_ms:.4f} ms")
    return {**out, "n_bytes": n_bytes, "lib_note": lib_note,
            "design": "split"}


def bsr_library_ms(bc, blocks, x, want, r, kb, bs, ncb):
    """``torch.sparse_bsr_tensor(...) @ x`` where the installed torch runs
    it on the card for float32: ``(ms or None, what was timed)``."""
    import torch
    if kb > 1 and not bool((bc[:, 1:] > bc[:, :-1]).all()):
        return None, ("sparse BSR @ x: none (padded rows repeat block column "
                      "0, which a BSR tensor may not)")
    crow = torch.arange(0, r * kb + 1, kb, device=x.device, dtype=torch.int64)
    col = bc.long().reshape(-1)

    def bsr(values):                       # values [nnz blocks, BS, BS]
        return torch.sparse_bsr_tensor(crow, col,
                                       values.reshape(r * kb, bs, bs),
                                       size=(r * bs, ncb * bs))
    try:
        a = bsr(blocks)
        y = (a @ x[:, None])[:, 0]
        scale = 2 * kb * bs * 2.0 ** -24 * (bsr(blocks.abs())
                                            @ x.abs()[:, None])[:, 0]
        if not bool(((y - want).abs() <= 2 * scale).all()):
            # a yardstick that computes another function times nothing
            return None, (f"sparse BSR @ x: none (off the kernel by "
                          f"{float((y - want).abs().max())})")
        return cuda_ms(lambda: a @ x[:, None], 5), "torch sparse BSR @ x"
    except (RuntimeError, NotImplementedError) as exc:
        first = str(exc).strip().splitlines()[0] if str(exc).strip() else ""
        return None, f"sparse BSR @ x: none ({type(exc).__name__}: {first})"


def row(name, err, ms, plain_ms, n_bytes, library_ms, n_flops=0,
        flop_rate=F32_FLOP_PER_S):
    by = ("bytes" if n_bytes / HBM_BYTES_PER_S >= n_flops / flop_rate
          else "operations")
    return {"name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms(n_bytes, n_flops, flop_rate), "bound_by": by,
            "library_ms": library_ms}


def log_row(r, shape, n_bytes, library):
    lib = (f"{library} {r['library_ms']:.4f} ms" if r["library_ms"]
           is not None else library)
    log(f"kernel {r['name']}: {shape}: {r['ms']:.4f} ms, plain "
        f"{r['plain_ms']:.4f} ms (no yardstick), bound {r['bound_ms']:.4f} ms "
        f"(by {r['bound_by']}; {n_bytes} B / 3.35 TB/s), {lib}")


def reduce_add_timed(routing, device, ids, rows):
    """``reduce_received`` add at the routed histogram's flat shape (64
    shards, e_local = 2^22, cap from factor 2.0, n_local = 64), with
    ``scatter_reduce_`` sum beside it; all three exact (whole numbers)."""
    import torch
    from repro_torch.core.queues import QueueConfig
    from repro_torch.kernels import route
    s = 64
    e_local = ids.numel() // s
    n_local = -(-HIST_BINS // s)
    cap = routing.resolve_flat_cap(QueueConfig.from_factor(2.0), "T3",
                                   e_local, s)
    dest = ids.view(s, e_local)
    recv_slot, recv_val, n_drop = routing.owner_route(
        torch.ones(s, e_local, device=device), dest // s, dest % s,
        dest >= 0, s, cap)
    if int(n_drop.sum()):
        raise AssertionError("drops at the routed histogram shape")
    m = recv_slot.numel()
    got = route.reduce_received(recv_slot, recv_val, n_local, "add")
    if not torch.equal(got, route.plain_reduce_received(
            recv_slot, recv_val, n_local, "add")):
        raise AssertionError("reduce_received add differs at the histogram "
                             "shape")
    flat_idx = torch.where(
        recv_slot >= 0,
        torch.arange(s, device=device)[:, None] * n_local + recv_slot.long(),
        s * n_local + torch.arange(m, device=device).view(s, -1)).reshape(-1)
    flat_val = recv_val.reshape(-1)
    y0 = torch.zeros(s * n_local + m, device=device)

    def library_call():
        y0.zero_()
        y0.scatter_reduce_(0, flat_idx, flat_val, "sum")

    library_call()
    if not torch.equal(y0[:s * n_local].view(s, n_local), got):
        raise AssertionError("the scatter_reduce_ sum yardstick computes "
                             "another function")
    n_bytes = m * (4 + 4) + s * n_local * 4
    r = rows["reduce_received"]
    r["add_ms"] = cuda_ms(lambda: route.reduce_received(
        recv_slot, recv_val, n_local, "add"), 5)
    r["add_bound_ms"] = bound_ms(n_bytes)
    r["add_library_ms"] = cuda_ms(library_call, 5)
    log(f"kernel reduce_received add at the routed histogram shape: S={s} "
        f"M={m // s} n_local={n_local}: {r['add_ms']:.4f} ms, bound "
        f"{r['add_bound_ms']:.4f} ms ({n_bytes} B / 3.35 TB/s), "
        f"scatter_reduce_ sum {r['add_library_ms']:.4f} ms; exact (whole "
        f"numbers), equal to the plain version")


# ---------------------------------------------------------------------------
# phases 5-9: the add-reduce and stream apps
# ---------------------------------------------------------------------------

def rel_err(got, want):
    import numpy as np
    return float(np.max(np.abs(np.asarray(got, np.float64) - want))
                 / np.max(np.abs(want)))


def held_to(tag, got, want, tol):
    """Fail unless ``|got - want| <= tol`` at every entry; the worst ratio
    of the error to its entry's bound."""
    import numpy as np
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    bad = err > tol
    if bad.any():
        i = int(np.argmax(np.where(bad, err - tol, -np.inf)))
        raise AssertionError(f"{tag}: {int(bad.sum())} entries off their "
                             f"bound, e.g. #{i}: |err| {err[i]} > {tol[i]}")
    return float(np.max(np.where(tol > 0, err / np.where(tol > 0, tol, 1),
                                 0.0)))


def spmv_bounds(g, x):
    """Per row of ``y = A @ x``: ``(bound against the float64 oracle,
    bound between two float32 runs)``. A term ``v = fl(A[r, c] fl(x[c]))``
    is within ``gamma_2 |t|`` of ``t = A[r, c] x[c]``; any float32 sum of
    the row's k terms is within ``gamma_{k-1} sum|v|`` of theirs. So a run
    is within ``gamma_{k+1} sum|t|`` of the oracle and two runs of the same
    terms within ``2 gamma_k sum|t|`` of each other; the factor 1 + 2^-20
    covers the float64 oracle's own rounding."""
    import numpy as np
    from repro_torch.kernels.route import gamma
    k = np.diff(g.row_ptr).astype(np.float64)
    mag = np.bincount(g.row_of(), weights=np.abs(
        g.values.astype(np.float64) * x[g.col_idx]), minlength=g.n)
    slack = 1 + 2.0 ** -20
    return gamma(k + 1) * mag * slack, 2 * gamma(k) * mag * slack


def pagerank_bound(g, device, damping=0.85, iters=20, n_dev=64):
    """Per vertex, a bound on ``|rank - oracle|`` for the port's float32
    PageRank on ``n_dev`` shards, carried through the rounds in float64 on
    the card. One round of the port: ``c_u = fl(rank_u / deg_u)``; the
    add-reduce of vertex v's k in-edge terms (within ``gamma_{k-1}`` of
    their sum of magnitudes); the dangling mass, a sum over each shard's
    ``n_local`` slots and then over the shards (within ``gamma_{n_local +
    n_dev}``); then ``fl(a + fl(d32 fl(upd + fl(dangling inv_n))))`` with
    ``a = fl(fl32(1 - d) inv_n)``, at most six roundings a term (within
    ``gamma_6`` of its magnitude). Errors carried from the round before
    reach v through the same sums."""
    import numpy as np
    import torch
    from repro_torch.kernels.route import gamma
    f64 = torch.float64
    n = g.n
    src = torch.from_numpy(g.row_of()).to(device)
    dst = torch.from_numpy(g.col_idx.astype(np.int64)).to(device)
    deg = torch.bincount(src, minlength=n).to(f64)
    k_in = torch.bincount(dst, minlength=n).to(f64)
    dang = deg == 0
    g_in = gamma(k_in + 1)       # the add-reduce and the division
    g_dang = gamma(-(-n // n_dev) + n_dev)
    g_upd = gamma(6)
    r = torch.full((n,), 1.0 / n, dtype=f64, device=device)
    e = r * U                    # the float32 start value
    zero = torch.zeros(n, dtype=f64, device=device)
    a = (1 - damping) / n
    for _ in range(iters):
        inv_deg = torch.where(dang, 0.0, 1.0 / deg.clamp(min=1))
        s = zero.clone().index_add_(0, dst, (r * inv_deg)[src])
        es = zero.clone().index_add_(0, dst, (e * inv_deg)[src])
        d_mass, d_err = r[dang].sum(), e[dang].sum()
        err_upd = es + g_in * (s + es)
        err_dang = d_err + g_dang * (d_mass + d_err)
        e = (damping * (err_upd + err_dang / n)
             + g_upd * (a + damping * (s + err_upd + (d_mass + err_dang) / n)))
        r = a + damping * (s + d_mass / n)
    del src, dst
    return e.cpu().numpy() * (1 + 2.0 ** -20)


def run_pagerank(g, setup, device, totals):
    import numpy as np
    import torch
    from repro_torch.core.fabric import Fabric
    from repro_torch.sparse import ref
    from repro_torch.sparse.options import LaunchOptions
    from repro_torch.sparse.torch_apps import dcra_pagerank
    t0 = time.perf_counter()
    want = ref.pagerank_ref(g)
    t_ref = time.perf_counter() - t0
    fab = Fabric.fake(64, device=device)
    opts = LaunchOptions(capacity_factor=4.0)
    torch.cuda.reset_peak_memory_stats()
    with MainPath("PageRank flat 64", ROUTE_KERNELS, totals) as path:
        t0 = time.perf_counter()
        rank, st = dcra_pagerank(g, fab, options=opts, setup=setup)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    err = rel_err(rank, want)
    if st.total_drops or st.rounds != 20 or not err < 1e-4:
        raise AssertionError(f"PageRank: rounds {st.rounds}, drops "
                             f"{st.total_drops}, rel err {err}")
    plain, pst = dcra_pagerank(g, fab, setup=setup,
                               options=opts.with_(route_impl="sort"))
    err_plain = rel_err(rank, plain)
    if not (err_plain < 1e-4 and np.array_equal(pst.messages, st.messages)
            and np.array_equal(pst.drops, st.drops)):
        raise AssertionError(f"PageRank: kernel path off the plain-torch "
                             f"path by {err_plain}")
    t0 = time.perf_counter()
    bound = pagerank_bound(g, device)
    t_bound = time.perf_counter() - t0
    w_oracle = held_to("PageRank vs the oracle", rank, want, bound)
    w_plain = held_to("PageRank vs the plain-torch path", rank, plain,
                      2 * bound)
    per_round, device_ms, wall_ms, top = profile_kernels(
        lambda: dcra_pagerank(g, fab, options=opts, setup=setup), st.rounds)
    log(f"pagerank rmat-{SCALE} flat 64: rounds=20 messages/round="
        f"{int(st.messages[0])} drops=0 run_s={run_s:.4f} "
        f"edges*iters/s={g.nnz * 20 / run_s:.4e} peak_mem_gb={peak_gb:.2f} "
        f"max|err|/max(rank): oracle {err:.3e}, plain-torch path "
        f"{err_plain:.3e}; oracle {t_ref:.2f} s (numpy); launches "
        f"{path.launches}")
    log(f"pagerank flat 64: every vertex within its float32 error bound "
        f"(median bound / rank {float(np.median(bound / want)):.3e}, "
        f"computed in {t_bound:.2f} s); worst |err| / bound: oracle "
        f"{w_oracle:.3e}, plain-torch path {w_plain:.3e}")
    log_profile("pagerank flat 64", per_round, device_ms, wall_ms, top)


def log_profile(tag, per_round, device_ms, wall_ms, top):
    if per_round is None:
        log(f"{tag}: per-round kernel times not measured (the profiler saw "
            f"no device time)")
        return
    log(f"{tag}: per-round kernel ms "
        + json.dumps({k: round(v, 4) for k, v in per_round.items() if v})
        + f", all device kernels {device_ms:.2f} ms of the profiled "
        f"run's {wall_ms:.2f} ms (device busy {device_ms / wall_ms:.3f})")
    log(f"{tag}: costliest device ops (ms in the run): "
        + "; ".join(f"{name} {ms:.2f}" for name, ms in top))


def run_spmv(g, device, totals):
    import numpy as np
    import torch
    from repro_torch.core.fabric import Fabric
    from repro_torch.sparse import ref
    from repro_torch.sparse.options import LaunchOptions
    from repro_torch.sparse.torch_apps import dcra_spmv, spmv_task_stream
    x = np.random.default_rng(SEED).random(g.n)
    want = ref.spmv_ref(g, x)
    tol_oracle, tol_runs = spmv_bounds(g, x)
    t0 = time.perf_counter()
    spmv_task_stream(g, x, 64)
    stream_s = time.perf_counter() - t0
    for layout, fab, opts in [
            ("flat 64", Fabric.fake(64, device=device),
             LaunchOptions(capacity_factor=2.0)),
            ("pod 8x8", Fabric.virtual((8, 8), ("pod", "data"),
                                       device=device),
             LaunchOptions(pod_axis="pod", capacity_factor=2.0))]:
        torch.cuda.reset_peak_memory_stats()
        with MainPath(f"SpMV {layout}", ROUTE_KERNELS, totals) as path:
            t0 = time.perf_counter()
            y, drops = dcra_spmv(g, x, fab, options=opts)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        err = rel_err(y, want)
        if drops or not err < 1e-4:
            raise AssertionError(f"SpMV {layout}: drops {drops}, rel err "
                                 f"{err}")
        w_oracle = held_to(f"SpMV {layout} vs the oracle", y, want,
                           tol_oracle)
        plain, pdrops = dcra_spmv(g, x, fab,
                                  options=opts.with_(route_impl="sort"))
        err_plain = rel_err(y, plain.astype(np.float64))
        if pdrops or not err_plain < 1e-4:
            raise AssertionError(f"SpMV {layout}: kernel path off the "
                                 f"plain-torch path by {err_plain}")
        w_plain = held_to(f"SpMV {layout} vs the plain-torch path", y, plain,
                          tol_runs)
        log(f"spmv rmat-{SCALE} {layout}: drops=0 stream build {stream_s:.2f} s "
            f"(numpy) run_s={run_s:.4f} (stream build included) "
            f"nnz/s={g.nnz / run_s:.4e} peak_mem_gb={peak_gb:.2f} "
            f"max|err|/max|y|: oracle {err:.3e}, plain-torch path "
            f"{err_plain:.3e}; every row within its float32 bound, worst "
            f"|err| / bound: oracle {w_oracle:.3e}, plain-torch path "
            f"{w_plain:.3e}; launches {path.launches}")


def run_histogram(els, device, totals):
    import numpy as np
    import torch
    from repro_torch.core.fabric import Fabric
    from repro_torch.sparse import ref
    from repro_torch.sparse.options import LaunchOptions
    from repro_torch.sparse.torch_apps import dcra_histogram
    want = ref.histogram_ref(els, HIST_BINS)
    for layout, fab, opts, need in [
            ("1 shard", Fabric.fake(1, device=device), None, ("histogram",)),
            ("flat 64", Fabric.fake(64, device=device), None, ROUTE_KERNELS),
            # stage 2 of the pod path holds n_intra * cap1 * factor slots a
            # shard: factor 1.25 keeps it at 0.4e9 slots (2.0: 1.1e9)
            ("pod 8x8", Fabric.virtual((8, 8), ("pod", "data"),
                                       device=device),
             LaunchOptions(pod_axis="pod", capacity_factor=1.25),
             ROUTE_KERNELS)]:
        torch.cuda.reset_peak_memory_stats()
        with MainPath(f"histogram {layout}", need, totals) as path:
            t0 = time.perf_counter()
            counts, drops = dcra_histogram(els, HIST_BINS, fab, options=opts)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if drops or not np.array_equal(counts, want):
            raise AssertionError(f"histogram {layout}: drops {drops}, "
                                 f"differs from the oracle")
        log(f"histogram {len(els)} / {HIST_BINS} bins {layout}: equal to the "
            f"oracle, drops=0 run_s={run_s:.4f} elements/s="
            f"{len(els) / run_s:.4e} peak_mem_gb={peak_gb:.2f} launches "
            f"{path.launches}")


def small_apps(device):
    import numpy as np
    from repro_torch.core.fabric import Fabric
    from repro_torch.sparse import datasets, ref
    from repro_torch.sparse.options import LaunchOptions
    from repro_torch.sparse.torch_apps import dcra_kcore, dcra_sssp, dcra_wcc
    g = datasets.rmat(SMALL_SCALE, seed=SEED)
    root = int(np.argmax(g.degrees()))
    want_d, want_l = ref.sssp_ref(g, root), ref.wcc_ref(g)
    want_k = ref.kcore_ref(g, 12)
    for layout, fab, opts in [
            ("flat 8", Fabric.fake(8, device=device), LaunchOptions()),
            ("pod 2x4", Fabric.virtual((2, 4), ("pod", "data"),
                                       device=device),
             LaunchOptions(pod_axis="pod", capacity_factor=2.0))]:
        d, st = dcra_sssp(g, root, fab, options=opts)
        lab, st2 = dcra_wcc(g, fab, options=opts)
        core, st3 = dcra_kcore(g, 12, fab, options=opts)
        if not np.array_equal(d, want_d) or st.total_drops:
            raise AssertionError(f"SSSP {layout} differs from the oracle")
        if not np.array_equal(lab, want_l) or st2.total_drops:
            raise AssertionError(f"WCC {layout} differs from the oracle")
        if not np.array_equal(core, want_k) or st3.total_drops:
            raise AssertionError(f"k-core {layout} differs from the oracle")
        log(f"sssp/wcc/kcore rmat-{SMALL_SCALE} {layout}: nnz={g.nnz} sssp rounds="
            f"{st.rounds} wcc rounds={st2.rounds} components="
            f"{len(np.unique(lab))} kcore(k=12) rounds={st3.rounds} "
            f"survivors={int((core >= 0).sum())}: equal to the oracles, "
            f"0 drops")


def run_spmv_csr(device, totals, rows):
    """``spmv_csr`` on Erdos-Renyi 2^14 (bs 128) against the oracle within
    the BSR tolerance; then the kernel on the same BSR arrays on the card
    against the plain einsum, timed there for the kernel table."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.sparse import datasets, ref
    from repro_torch.kernels import spmv
    g = datasets.erdos_renyi(ER_VERTICES, seed=SEED)
    x = np.random.default_rng(SEED).random(g.n)
    with MainPath("spmv_csr", ("bsr_spmv",), totals) as path:
        t0 = time.perf_counter()
        y = ops.spmv_csr(g, x, bs=128, device=device).cpu().numpy()
        run_s = time.perf_counter() - t0
    ran_only(spmv, "split")
    bc, blocks = ops.csr_to_bsr(g, 128)
    kb = bc.shape[1]
    scale = np.bincount(g.row_of(), weights=np.abs(
        g.values.astype(np.float64) * x[g.col_idx]), minlength=g.n)
    tol = 2 * kb * 128 * 2.0 ** -24 * scale
    err = np.abs(y - ref.spmv_ref(g, x))
    if not np.all(err <= tol):
        raise AssertionError("spmv_csr off the oracle beyond the BSR "
                             "tolerance")
    log(f"spmv_csr erdos-renyi {g.n} (nnz {g.nnz}, bs 128, Kb {kb}): within "
        f"the BSR tolerance of the oracle (worst |err| / tol "
        f"{float(np.max(err / np.maximum(tol, 1e-300))):.4f}), run_s "
        f"{run_s:.4f} (host BSR build included); launches {path.launches}")
    # the arrays spmv_csr hands the kernel, made again on the card
    xp = np.zeros(bc.shape[0] * 128, np.float32)
    xp[:g.n] = x.astype(np.float32)
    r = bsr_row(spmv, torch.from_numpy(bc).to(device),
                torch.from_numpy(blocks).to(device),
                torch.from_numpy(xp).to(device))
    rows["bsr_spmv"] = {k: v for k, v in r.items()
                        if k not in ("n_bytes", "lib_note")}
    log_row(rows["bsr_spmv"], f"R={bc.shape[0]} Kb={kb} BS=128 "
            f"Ncb={bc.shape[0]} (spmv_csr's shape)", r["n_bytes"],
            r["lib_note"])


# ---------------------------------------------------------------------------
# phase 10: the MoE layer of OLMoE-1B-7B
# ---------------------------------------------------------------------------

BUCKET_KERNELS = ("bucket_rank", "bucket_scatter")


def moe_setup(device):
    """OLMoE-1B-7B's config, its MoE parameters and the tokens, from
    ``torch.Generator`` seed ``SEED`` on the card."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.moe import init_moe
    cfg = get_config(MOE_ARCH)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    params = init_moe(gen, cfg)
    x = torch.randn(*MOE_TOKENS, cfg.d_model, generator=gen, device=device)
    return cfg, params, x


def drop_report(stats):
    """Per bucket stage: its capacity, dropped of routed tasks, and the
    most any one bucket dropped."""
    return "; ".join(
        f"{stage} cap {stats.caps[stage]}: {int(drp.sum())} of "
        f"{int(adm.sum() + drp.sum())} tasks dropped, most in one bucket "
        f"{int(drp.max())} ({drp.numel()} buckets)"
        for stage, (adm, drp) in stats.buckets.items())


def same_routing(tag, got, stats, want, want_stats, scale):
    """Two ``moe_dcra`` runs on the same tokens that must route alike (the
    bucket kernels and the plain ``"sort"`` route): top-k ids and every
    bucket's admitted and dropped counts equal, outputs within 1e-5 of
    max|out| (the combine's ``index_add_`` adds its K terms in any order).
    Returns the largest |difference|."""
    import torch
    if not torch.equal(stats.topk_ids, want_stats.topk_ids):
        raise AssertionError(f"{tag}: top-k ids differ from the sort route")
    for stage, counts in want_stats.buckets.items():
        if not all(torch.equal(a, b) for a, b in zip(stats.buckets[stage],
                                                       counts)):
            raise AssertionError(f"{tag}: {stage} bucket counts differ from "
                                 f"the sort route")
    err = float((got - want).abs().max())
    if not err <= 1e-5 * scale:
        raise AssertionError(f"{tag}: max |out - sort route| {err} above "
                             f"1e-5 of max|out| {scale}")
    return err


def run_moe(device, totals):
    """Phase 10: ``moe_dcra`` on the three packagings at the config's
    capacity factor (drops, layer ms, tokens/s, peak GB, one profiled
    run), each output held to the no-drop ``moe_einsum`` on the same
    tokens when nothing dropped (to the plain sort route when something
    did); without drops on the smaller x against the einsum; and on
    skewed tokens that overflow the buckets, against the sort route.
    Returns the fused packaging's stats (its expert buckets feed phase
    11) and the parameters."""
    import dataclasses
    import math
    import torch
    from repro_torch.core.dispatch import MeshInfo, dispatch_queues, moe_dcra
    from repro_torch.core.fabric import Fabric
    from repro_torch.core.queues import QueueConfig
    from repro_torch.models.moe import moe_einsum
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cfg, params, x = moe_setup(device)
    torch.cuda.synchronize()
    n_tokens = x.shape[0] * x.shape[1]
    mc = cfg.moe
    log(f"moe {MOE_ARCH}: d_model {cfg.d_model}, {mc.num_experts} experts "
        f"top-{mc.top_k}, d_expert {mc.d_expert}, capacity factor "
        f"{mc.capacity_factor}; weights "
        f"{sum(p.numel() * p.element_size() for p in params.values()) / 1e9:.2f}"
        f" GB float32 and x {tuple(x.shape)} from torch.Generator seed {SEED} "
        f"in {time.perf_counter() - t0:.2f} s; TF32 off")

    # the no-drop result on every token: at factor 8 every expert holds
    # its whole group (capacity 8 K / E tokens a token, K = 8, E = 64), so
    # a token's output is its own whatever the grouping, and the einsum
    # runs on slices of MOE_CHECK_TOKENS[0] sequences (8.6 GB each)
    cfg8 = dataclasses.replace(cfg, moe=dataclasses.replace(
        mc, capacity_factor=8.0))
    nb = MOE_CHECK_TOKENS[0]
    t1 = time.perf_counter()
    want = torch.cat([moe_einsum(params, x[i:i + nb], cfg8)[0]
                      for i in range(0, x.shape[0], nb)])
    torch.cuda.synchronize()
    log(f"moe_einsum oracle (capacity factor 8: every expert holds its "
        f"whole group) on x {tuple(x.shape)} in slices of {nb} sequences: "
        f"{time.perf_counter() - t1:.2f} s")
    sort_queues = dataclasses.replace(dispatch_queues(mc), route_impl="sort")
    fused_stats = None
    for label, shape, names, kw in MOE_PACKAGINGS:
        info = MeshInfo(Fabric.virtual(shape, names, device=device), **kw)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with MainPath(f"MoE {label}", BUCKET_KERNELS, totals) as path:
            out, aux, stats = moe_dcra(params, x, cfg, info,
                                       return_stats=True)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(2):
                moe_dcra(params, x, cfg, info)
            torch.cuda.synchronize()
            layer_ms = (time.perf_counter() - t1) / 2 * 1e3
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if (tuple(out.shape) != tuple(x.shape)
                or not bool(torch.isfinite(out).all())
                or not math.isfinite(float(aux))):
            raise AssertionError(f"MoE {label}: output {tuple(out.shape)} "
                                 f"not finite or of the wrong shape")
        if stats.total_dropped == 0:
            scale = float(want.abs().max())
            err = float((out - want).abs().max())
            if not err <= 1e-4 * scale:
                raise AssertionError(f"MoE {label}: no drop, yet max |out - "
                                     f"moe_einsum| {err} above 1e-4 of "
                                     f"max|out| {scale}")
            held = (f"no drop: max |out - moe_einsum| {err:.3e} = "
                    f"{err / scale:.3e} of max|out| (bound 1e-4)")
        else:
            ref, _, ref_stats = moe_dcra(params, x, cfg, info,
                                         queues=sort_queues,
                                         return_stats=True)
            err = same_routing(f"MoE {label}", out, stats, ref, ref_stats,
                               float(ref.abs().max()))
            held = (f"drops: counts equal to the sort route's, max |out - "
                    f"sort route| {err:.3e}")
            del ref, ref_stats
        log(f"moe {label}: layer {layer_ms:.2f} ms (mean of 2 runs, host "
            f"clock, synchronised), tokens/s {n_tokens / layer_ms * 1e3:.4e}, "
            f"peak {peak_gb:.2f} GB, aux {float(aux):.6f}, launches in the "
            f"3 runs {path.launches}; {drop_report(stats)}; {held}")
        if not kw:
            per_round, device_ms, wall_ms, top = profile_kernels(
                lambda: moe_dcra(params, x, cfg, info), 1)
            log_profile(f"moe {label}", per_round, device_ms, wall_ms, top)
            fused_stats = stats
        del out, stats

    # no drop: every bucket holds 8x its average load. Factor 8 on all
    # three queues would compound (the portal and expert queues size from
    # their already padded inputs: 512x on the pod path), so the dispatch
    # queue takes 8 and the two after it 1.0 of their inputs.
    xs = x[:nb, :MOE_CHECK_TOKENS[1]].contiguous()
    want = want[:nb, :MOE_CHECK_TOKENS[1]]
    del x
    scale = float(want.abs().max())
    queues = QueueConfig(default_iq=None, iq_factors={
        "dispatch": 8.0, "portal": 1.0, "expert": 1.0})
    for label, shape, names, kw in MOE_PACKAGINGS:
        info = MeshInfo(Fabric.virtual(shape, names, device=device), **kw)
        torch.cuda.empty_cache()
        with MainPath(f"MoE {label} no-drop", BUCKET_KERNELS, totals) as path:
            got, _, stats = moe_dcra(params, xs, cfg, info, queues=queues,
                                     return_stats=True)
        err = float((got - want).abs().max())
        if stats.total_dropped or not err <= 1e-4 * scale:
            raise AssertionError(f"MoE {label} x {tuple(xs.shape)}: "
                                 f"{stats.total_dropped} drops, max |err| "
                                 f"{err} vs the einsum (max|out| {scale})")
        log(f"moe {label} x {tuple(xs.shape)}, no drop (caps "
            f"{stats.caps}): max |out - moe_einsum| {err:.3e} = "
            f"{err / scale:.3e} of max|out| (bound 1e-4); launches "
            f"{path.launches}")
        del got, stats

    # skewed tokens: every other token leans on one shared direction, so
    # half of them pick the same experts and the capped buckets overflow
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 1)
    xk = xs.clone()
    xk[:, ::2] = 0.25 * xs[:, ::2] + 2 * torch.randn(
        cfg.d_model, generator=gen, device=device)
    for label, shape, names, kw in MOE_PACKAGINGS:
        info = MeshInfo(Fabric.virtual(shape, names, device=device), **kw)
        with MainPath(f"MoE {label} skewed", BUCKET_KERNELS, totals) as path:
            got, _, stats = moe_dcra(params, xk, cfg, info,
                                     return_stats=True)
        ref, _, ref_stats = moe_dcra(params, xk, cfg, info,
                                     queues=sort_queues, return_stats=True)
        if not stats.total_dropped:
            raise AssertionError(f"MoE {label}: the skewed tokens dropped "
                                 f"nothing at factor {mc.capacity_factor}")
        err = same_routing(f"MoE {label} skewed", got, stats, ref, ref_stats,
                           float(ref.abs().max()))
        log(f"moe {label} x {tuple(xk.shape)} skewed, factor "
            f"{mc.capacity_factor}: {drop_report(stats)}; top-k ids and "
            f"every bucket's admitted and dropped counts equal to the sort "
            f"route's, max |out - sort route| {err:.3e}; launches "
            f"{path.launches}")
        del got, ref, stats, ref_stats
    return fused_stats, params


# ---------------------------------------------------------------------------
# phase 11: grouped matmul and flash attention vs their plain versions
# ---------------------------------------------------------------------------

#: a bf16 flash kernel's mean distance from the plain version, as a share
#: of the distance with p left unrounded (``unrounded_share``): about
#: 0.002 when p is rounded as the plain version rounds it, 1 when not
P_ROUNDED_SHARE = 0.1


def gmm_check(gmm_mod, x, w, gids, rt, ft=128):
    """The kernel against the plain version (float32, TF32 off) within
    ``moe_gmm.error_bound``: the worst |err| and |err| / bound."""
    want = gmm_mod.plain_gmm(x, w, gids, rt)
    got = gmm_mod.gmm(x, w, gids, rt=rt, ft=ft)
    tol = gmm_mod.error_bound(x, w, gids, rt, want)
    err = (got.float() - want.float()).abs()
    ratio = float((err / tol.clamp(min=1e-30)).max())
    if not bool((err <= tol).all()):
        raise AssertionError(f"gmm off by {ratio:.3f} x its tolerance at "
                             f"x {tuple(x.shape)} w {tuple(w.shape)} rt {rt} "
                             f"{x.dtype}")
    return float(err.max()), ratio


def flash_check(flash_mod, q, k, v, causal):
    """The kernel against the plain version within
    ``flash_attention.error_bound`` per element, and in bf16 nearer it
    than the plain version with p unrounded (``P_ROUNDED_SHARE``): the
    worst |err|, |err| / bound and the share (None in float32)."""
    import torch
    want = flash_mod.plain_flash_attention(q, k, v, causal)
    got = flash_mod.flash_attention(q, k, v, causal)
    err = (got.float() - want.float()).abs()
    tol = flash_mod.error_bound(q, k, v, causal, want)
    ratio = float((err / tol).max())
    if not bool((err <= tol).all()):
        raise AssertionError(f"flash_attention off by {ratio:.3f} x its "
                             f"tolerance at {tuple(q.shape)} {q.dtype} "
                             f"causal={causal}")
    share = None
    if q.dtype == torch.bfloat16 and q.shape[-2] > 1:
        share = flash_mod.unrounded_share(q, k, v, causal, got, want)
        if not share <= P_ROUNDED_SHARE:
            raise AssertionError(f"flash_attention bf16 at {tuple(q.shape)}: "
                                 f"mean |err| is {share:.4f} of the plain "
                                 f"version's with p unrounded (limit "
                                 f"{P_ROUNDED_SHARE}): p not rounded as the "
                                 f"plain version rounds it")
    return float(err.max()), ratio, share


def gmm_flash_edge_cases(device):
    """gmm at rt 8 / 32 / 64 / 128, D and F off the kernels' tiles, one
    expert, bf16 and float32, on each design (wgmma, blocked, simt, as
    launch_plan picks it), F off ft refused, a group id out of range
    giving zero rows on every design; flash at one causal tile,
    non-causal, a ragged S, hd off 16 and 128, hd 64 / 96 / 128 at S 128
    / 300 / 1024 in bf16 (wgmma), float32 at hd 4 / 80 / 100 / 128, S 1,
    a ragged S past one 128-row tile and non-causal (blocked), bf16 with
    hd off 8, float32 with hd off 4 and a float32 view 4 bytes off
    alignment (simt), constant V; and the gmm, flash and BSR C entry
    points refusing, on every design, a launch plan that differs from
    their own geometry in any field."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import moe_gmm
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(SEED)
    f32, bf16 = torch.float32, torch.bfloat16

    def rand(*shape, dtype=f32):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device, dtype)

    worst = 0.0
    cases = [  # (T, D, F, E, rt, ft, dtype, design)
        (64, 40, 64, 3, 8, 128, f32, "simt"),
        (512, 32, 256, 4, 64, 128, f32, "blocked"),
        (384, 128, 128, 3, 128, 128, f32, "blocked"),
        (192, 72, 128, 1, 64, 128, f32, "blocked"),
        (192, 36, 90, 2, 64, 90, f32, "simt"),
        (320, 48, 96, 2, 32, 128, bf16, "simt"),
        (192, 36, 96, 2, 64, 96, bf16, "simt"),
        (256, 64, 128, 2, 128, 128, bf16, "wgmma"),
        (384, 72, 200, 3, 64, 200, bf16, "wgmma"),
        (512, 200, 136, 2, 128, 136, bf16, "wgmma"),
        (320, 64, 128, 3, 64, 128, bf16, "wgmma"),
        (768, 64, 256, 3, 192, 128, bf16, "wgmma"),
        (128, 2048, 192, 5, 64, 64, f32, "blocked")]
    for t, d, f, e, rt, ft, dt, design in cases:
        gids = torch.from_numpy(rng.integers(0, e, t // rt).astype(
            np.int32)).to(device)
        moe_gmm.reset_launches()
        worst = max(worst, gmm_check(moe_gmm, rand(t, d, dtype=dt),
                                     rand(e, d, f, dtype=dt), gids, rt,
                                     ft)[1])
        ran_only(moe_gmm, design)
    try:
        moe_gmm.gmm(rand(128, 16), rand(2, 16, 192),
                    torch.zeros(1, dtype=torch.int32, device=device))
    except ValueError:
        pass
    else:
        raise AssertionError("gmm took F = 192 with 128-column tiles")
    if device.type == "cuda":          # the plain version raises instead
        for dt, rt, design in ((f32, 64, "blocked"), (bf16, 64, "wgmma"),
                               (f32, 32, "simt"), (bf16, 32, "simt")):
            moe_gmm.reset_launches()
            ids = torch.tensor([7, 1], dtype=torch.int32, device=device)
            ones = moe_gmm.gmm(torch.ones(128, 16, device=device, dtype=dt),
                               torch.ones(2, 16, 64, device=device, dtype=dt),
                               ids.repeat_interleave(64 // rt), rt=rt)
            ran_only(moe_gmm, design)
            if not (bool((ones[:64] == 0).all())
                    and bool((ones[64:] == 16).all())):
                raise AssertionError(f"gmm {design} {dt}: a group id out of "
                                     f"range did not give zero rows")
        refused = plans_refused(device)
    worst_f, worst_share = 0.0, 0.0
    flash_cases = [  # (BH, S, hd, dtype, causal, design)
        (4, 64, 128, f32, True, "blocked"), (4, 128, 64, f32, False,
                                             "blocked"),
        (2, 100, 80, f32, True, "blocked"), (1, 1, 8, f32, True, "blocked"),
        (2, 300, 128, f32, True, "blocked"), (3, 200, 4, f32, True,
                                              "blocked"),
        (2, 300, 100, f32, False, "blocked"), (1, 1, 4, f32, False,
                                               "blocked"),
        (2, 100, 30, f32, True, "simt"), (2, 129, 7, f32, False, "simt"),
        (2, 200, 64, f32, True, "simt"),      # q, k, v 4 bytes off alignment
        (2, 100, 20, bf16, True, "simt"),
        (4, 256, 128, bf16, True, "wgmma"), (3, 200, 32, bf16, False, "wgmma"),
        (2, 128, 64, bf16, True, "wgmma"), (2, 300, 96, bf16, True, "wgmma"),
        (2, 300, 128, bf16, False, "wgmma"),
        (2, 1024, 128, bf16, False, "wgmma"),
        (2, 1024, 64, bf16, True, "wgmma"), (1, 1, 8, bf16, True, "wgmma")]
    for bh, s, hd, dt, causal, design in flash_cases:
        q, k, v = (rand(bh, s, hd, dtype=dt) for _ in range(3))
        if design == "simt" and dt == f32 and hd % 4 == 0:
            q, k, v = (torch.zeros(t.numel() + 1, device=device)[1:].copy_(
                t.reshape(-1)).view(t.shape) for t in (q, k, v))
        flash.reset_launches()
        _, ratio, share = flash_check(flash, q, k, v, causal)
        ran_only(flash, design)
        worst_f, worst_share = max(worst_f, ratio), max(worst_share,
                                                        share or 0.0)
        const = flash.flash_attention(q, k, torch.ones_like(v), causal)
        if not bool(((const.float() - 1).abs() <= 1e-5).all()):
            raise AssertionError("flash_attention of a constant V is not "
                                 "that constant")
    torch.cuda.synchronize()
    log(f"kernels: gmm {len(cases)} edge cases within tolerance of the plain "
        f"version on the design each plan names (worst |err| / tol "
        f"{worst:.4f}), F off the column tile refused, an out-of-range group "
        f"id zero rows on every design; flash_attention {len(flash_cases)} "
        f"edge cases (worst |err| / tol {worst_f:.4f}; bf16 mean |err| "
        f"{worst_share:.4f} of the p-unrounded plain version's at worst), "
        f"constant V exact to 1e-5"
        + (f"; {refused} altered launch plans refused by the C launchers "
           f"({PLAN_DESIGNS} designs)" if device.type == "cuda" else ""))


def plans_refused(device):
    """Each design of gmm, flash attention and the BSR SpMV launched
    through its C entry point with its own launch plan (must succeed) and
    with each field of that plan altered (must be refused, nothing
    launched): :data:`PLAN_DESIGNS` designs, 7 fields each. Returns the
    count refused."""
    import torch
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import moe_gmm, spmv
    from repro_torch.kernels._build import library
    from repro_torch.kernels._launch import as_c
    stream = torch.cuda.current_stream(device).cuda_stream
    refused = 0

    def each(plan, code, launch, what):
        nonlocal refused
        if launch(as_c(plan, code)) != 0:
            raise AssertionError(f"{what}: its own plan {plan} was refused")
        for i in range(1, 8):  # rows, grid x/y/z, threads, stages, smem
            c = as_c(plan, code)
            c[i] += 8 if i in (1, 5, 7) else 1
            if launch(c) == 0:
                raise AssertionError(f"{what}: launched a plan with field "
                                     f"{i} altered from {plan}")
            refused += 1
    gids = torch.zeros(8, dtype=torch.int32, device=device)
    for dt, rt in ((torch.float32, 64), (torch.bfloat16, 64),
                   (torch.float32, 32), (torch.bfloat16, 32)):
        x = torch.ones(256, 64, device=device, dtype=dt)
        w = torch.ones(2, 64, 128, device=device, dtype=dt)
        out = torch.empty(256, 128, device=device, dtype=dt)
        plan = moe_gmm.launch_plan(256, 64, 128, rt, dt)
        each(plan, moe_gmm.PATH_CODES[plan.path],
             lambda c: library("gmm").dcra_gmm(
                 x.data_ptr(), w.data_ptr(), gids.data_ptr(), out.data_ptr(),
                 256, 64, 128, rt, 2, moe_gmm.DTYPES.index(dt), c, stream),
             f"gmm {plan.path} {dt}")
    for dt, hd in ((torch.float32, 64), (torch.float32, 30),
                   (torch.bfloat16, 64), (torch.bfloat16, 128)):
        q = torch.ones(2, 100, hd, device=device, dtype=dt)
        o = torch.empty_like(q)
        plan = flash.launch_plan(2, 100, hd, dt)
        each(plan, flash.PATH_CODES[plan.path],
             lambda c: library("flash_attention").dcra_flash_attention(
                 q.data_ptr(), q.data_ptr(), q.data_ptr(), o.data_ptr(), 2,
                 100, hd, hd ** -0.5, 1, flash.DTYPES.index(dt), c, stream),
             f"flash_attention {plan.path} {dt} hd {hd}")
    for bs in (32, 30):
        r, kb = 3, 5
        bc = torch.zeros(r, kb, dtype=torch.int32, device=device)
        blocks = torch.ones(r, kb, bs, bs, device=device)
        x = torch.ones(2 * bs, device=device)
        y = torch.empty(r * bs, device=device)
        plan = spmv.launch_plan(r, kb, bs)
        scratch = torch.empty(plan.grid[0] // r, r * bs, device=device)
        each(plan, spmv.PATH_CODES[plan.path],
             lambda c: library("spmv").dcra_bsr_spmv(
                 bc.data_ptr(), blocks.data_ptr(), x.data_ptr(), r, kb, bs, 2,
                 y.data_ptr(), scratch.data_ptr(), c, stream),
             f"bsr_spmv {plan.path} bs {bs}")
    torch.cuda.synchronize()
    if refused != 7 * PLAN_DESIGNS:
        raise AssertionError(f"{refused} altered plans refused, expected "
                             f"{7 * PLAN_DESIGNS}")
    return refused


def gmm_operand(stats):
    """The fused packaging's expert buckets of all shards as one gmm
    operand: ``(x [S * E_local * cap_e, D], the expert of every row tile,
    rt)``, rt the largest of 128/64/32/16/8 dividing cap_e."""
    import torch
    xe = stats.expert_rows
    s, n, d = xe.shape
    cap_e = n // stats.e_local
    rt = next(r for r in (128, 64, 32, 16, 8) if cap_e % r == 0)
    experts = (stats.expert_base[:, None]
               + torch.arange(stats.e_local, device=xe.device)[None])
    gids = experts.repeat_interleave(cap_e // rt, dim=1).reshape(-1)
    return xe.reshape(s * n, d), gids.to(torch.int32).contiguous(), rt, \
        experts.reshape(-1), cap_e


def run_gmm(device, totals, stats, params):
    """``ops.gmm`` at phase 10's expert buckets with w = wg, in float32 (the
    kernel table's row) and bf16 (``bf16_*`` keys), each on the design its
    launch plan names, against the plain version, timed beside
    ``torch.bmm`` over the buckets in the same type as the yardstick. In
    bf16 the simt kernel, which no earlier run timed at this shape, is
    timed too on a copy of x that starts 2 bytes into its storage (the
    input that selects it: TMA needs 16-byte aligned bases)."""
    import torch
    from repro_torch.kernels import moe_gmm, ops
    torch.backends.cuda.matmul.allow_tf32 = False
    x32, gids, rt, bucket_experts, cap_e = gmm_operand(stats)
    w32 = params["wg"]
    t, d = x32.shape
    e, _, f = w32.shape
    n_flops = 2 * t * d * f
    out = None
    for dt, rate, tag in ((torch.float32, F32_FLOP_PER_S, "float32"),
                          (torch.bfloat16, BF16_FLOP_PER_S, "bf16")):
        x, w = x32.to(dt), w32.to(dt)
        design = moe_gmm.launch_plan(t, d, f, rt, dt).path
        with MainPath(f"ops.gmm {tag} at the MoE expert buckets", ("gmm",),
                      totals) as path:
            ops.gmm(x, w, gids, rt=rt)
        if moe_gmm.PATHS[design] != 1 or design == "simt":
            raise AssertionError(f"ops.gmm {tag} at the main shape ran "
                                 f"{moe_gmm.PATHS}, not the redesigned "
                                 f"kernel")
        err, ratio = gmm_check(moe_gmm, x, w, gids, rt)
        wsel = w[bucket_experts.long()]             # [S * E_local, D, F]
        xb = x.view(-1, cap_e, d)
        got = moe_gmm.gmm(x, w, gids, rt=rt)
        lib = torch.bmm(xb, wsel).view(t, f)
        tol = moe_gmm.error_bound(x, w, gids, rt, got)
        lib_ok = bool(((lib.float() - got.float()).abs() <= tol).all())
        del got, lib, tol
        n_bytes = x.element_size() * (t * d + e * d * f + t * f) \
            + 4 * gids.numel()
        r = row("gmm", err, cuda_ms(lambda: ops.gmm(x, w, gids, rt=rt), 5),
                cuda_ms(lambda: moe_gmm.plain_gmm(x, w, gids, rt), 2),
                n_bytes,
                cuda_ms(lambda: torch.bmm(xb, wsel), 5) if lib_ok else None,
                n_flops, rate)
        simt_ms = None
        if tag == "bf16":
            xu = torch.empty(t * d + 1, dtype=dt, device=device)[1:].view(t, d)
            xu.copy_(x)
            moe_gmm.reset_launches()
            simt_ms = cuda_ms(lambda: moe_gmm.gmm(xu, w, gids, rt=rt), 2)
            if moe_gmm.PATHS["simt"] != sum(moe_gmm.PATHS.values()):
                raise AssertionError(f"gmm bf16 on an unaligned x ran "
                                     f"{moe_gmm.PATHS}, not the simt kernel")
            del xu
        log(f"kernel gmm {tag} at the fused packaging's expert buckets: x "
            f"[{t}, {d}] ({stats.expert_rows.shape[0]} shards x "
            f"{stats.e_local} experts x cap_e {cap_e}), w [{e}, {d}, {f}], "
            f"rt {rt}, design {design} "
            f"{moe_gmm.launch_plan(t, d, f, rt, dt)}: max |err| {err:.3e} vs "
            f"the plain version ({ratio:.4f} of the tolerance); launches "
            f"{path.launches}")
        log_row(r, f"T={t} D={d} F={f} E={e} rt={rt} {tag}", n_bytes,
                f"torch.bmm over the [S*E_local, cap_e, D] buckets in {tag}"
                if lib_ok else "torch.bmm: none (off the kernel's tolerance)")
        log(f"kernel gmm {tag}: "
            + (f"the simt kernel on an unaligned copy of x {simt_ms:.4f} ms; "
               if simt_ms is not None else "")
            + f"{n_flops:.4e} flops / "
            f"{rate / 1e12:.0f} TFLOP/s = {n_flops / rate * 1e3:.4f} ms, "
            f"{n_bytes} B / 3.35 TB/s = "
            f"{n_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms; achieved "
            f"{n_flops / r['ms'] / 1e9:.1f} TFLOP/s")
        del wsel, xb, x, w
        if out is None:
            out = r
        else:
            out.update({f"bf16_{key}": r[key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")})
    return out


def run_flash(device, totals):
    """``ops.flash_attention`` at OLMoE's attention widths, causal, in
    bf16 (the kernel table's row, on wgmma) and float32 (``f32_*`` keys,
    on the blocked kernel), each against the plain version, timed beside
    SDPA; in float32 also the simt kernel (on copies of q, k, v 4 bytes
    off alignment)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import ops
    torch.backends.cuda.matmul.allow_tf32 = False
    b, h, s, hd = FLASH_SHAPE
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    base = [torch.randn(b, h, s, hd, generator=gen, device=device)
            for _ in range(3)]
    n_flops = 4 * b * h * hd * s * (s + 1) // 2     # the causal half
    out = None
    for dt, rate, tag in ((torch.bfloat16, BF16_FLOP_PER_S, "bf16"),
                          (torch.float32, F32_FLOP_PER_S, "float32")):
        q, k, v = (t.to(dt) for t in base)
        design = flash.launch_plan(b * h, s, hd, dt).path
        with MainPath(f"ops.flash_attention {tag}", ("flash_attention",),
                      totals) as path:
            ops.flash_attention(q, k, v, causal=True)
        if design != ("wgmma" if tag == "bf16" else "blocked") \
                or flash.PATHS[design] != 1:
            raise AssertionError(f"ops.flash_attention {tag} at the main "
                                 f"shape ran {flash.PATHS}")

        def three(t):
            return t.reshape(b * h, s, hd)
        err, ratio, share = flash_check(flash, three(q), three(k), three(v),
                                        True)
        want = flash.plain_flash_attention(three(q), three(k), three(v), True)
        lib = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        lib_ok = bool(((three(lib).float() - want.float()).abs()
                       <= flash.error_bound(three(q), three(k), three(v),
                                            True, want)).all())
        del want, lib
        n_bytes = 4 * b * h * s * hd * q.element_size()
        r = row("flash_attention", err,
                cuda_ms(lambda: ops.flash_attention(q, k, v, causal=True), 5),
                cuda_ms(lambda: flash.plain_flash_attention(
                    three(q), three(k), three(v), True), 2), n_bytes,
                cuda_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True), 5) if lib_ok else None,
                n_flops, rate)
        log(f"kernel flash_attention {tag} causal B={b} H={h} S={s} hd={hd}, "
            f"design {design} {flash.launch_plan(b * h, s, hd, dt)}: "
            f"max |err| {err:.3e} vs the plain version ({ratio:.4f} of the "
            f"tolerance"
            + (f"; mean |err| {share:.4f} of the p-unrounded plain "
               f"version's" if share is not None else "")
            + f"); launches {path.launches}")
        log_row(r, f"{tag}, {n_flops:.4e} flops over "
                f"{rate / 1e12:.0f} TFLOP/s, achieved "
                f"{n_flops / r['ms'] / 1e9:.1f} TFLOP/s", n_bytes,
                "scaled_dot_product_attention(is_causal=True)" if lib_ok
                else "SDPA: none (off the kernel's tolerance)")
        r["design"] = design
        if out is None:
            out = r
            continue
        out.update({f"f32_{key}": r[key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "design")})
        flash_f32_simt(flash, q, k, v, three)
    return out


def flash_f32_simt(flash, q, k, v, three):
    """The float32 simt kernel at the main shape, reached through copies of
    q, k, v that start 4 bytes off a 16-byte boundary: held to the error
    bound and timed (logged, beside the blocked kernel's row)."""
    import torch
    qu, ku, vu = (torch.zeros(t.numel() + 1, device=t.device)[1:].copy_(
        t.reshape(-1)).view(three(t).shape) for t in (q, k, v))
    flash.reset_launches()
    _, ratio, _ = flash_check(flash, qu, ku, vu, True)
    ms = cuda_ms(lambda: flash.flash_attention(qu, ku, vu, True), 2)
    ran_only(flash, "simt")
    log(f"kernel flash_attention float32 on the simt kernel (q, k, v 4 bytes "
        f"off alignment): {ms:.4f} ms, {ratio:.4f} of the tolerance")


def sdpa_kernels(device):
    """The device kernels of three float32 ``scaled_dot_product_attention``
    calls at :data:`FLASH_SHAPE`, causal, by the profiler
    (:func:`profile_kernels`): ``"name ms; ..."`` a call, or why none was
    seen. Run before any other profiled run: in phase 11, after the
    earlier phases' profiled runs, the profiler has seen no device kernel
    of this call (cause not found)."""
    import torch
    import torch.nn.functional as F
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    q, k, v = (torch.randn(*FLASH_SHAPE, generator=gen, device=device)
               for _ in range(3))

    def calls():
        for _ in range(3):
            F.scaled_dot_product_attention(q, k, v, is_causal=True)
    _, total, _, top = profile_kernels(calls, 3)
    return ("; ".join(f"{name} {ms / 3:.4f} ms" for name, ms in top)
            or f"no device kernel seen by the profiler ({total} ms)")


def _demangle(names):
    """Kernel names without namespace or arguments (``gmm_kernel<float,
    64>``), or as they are where no demangler is found."""
    tool = shutil.which("c++filt") or shutil.which("cu++filt")
    if not tool or not names:
        return list(names)
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True).stdout.splitlines()
    if len(out) != len(names):
        return list(names)
    return [re.sub(r"^(void )?\(anonymous namespace\)::", "", n).split("(")[0]
            for n in out]


def ptxas_report(log_text):
    """``[(kernel, registers, spill store bytes, spill load bytes, shared
    bytes)]`` from nvcc's ``-Xptxas -v`` output."""
    rows, name = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            rows[name] = [0, 0, 0, 0]
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            rows[name][1:3] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rows[name][0] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            rows[name][3] = int(m.group(1)) if m else 0
    names = list(rows)
    return [(short, *rows[n]) for short, n in zip(_demangle(names), names)]


def kernel_resources(recs):
    """Print each library's kernels with their registers, spills and
    static shared memory (``-Xptxas -v``) and its count of ``HGMMA``
    instructions (``cuobjdump -sass``); fail if a kernel of
    :data:`NO_SPILL` spills or a library of :data:`WGMMA_LIBS` has no
    HGMMA. Returns ``{library: HGMMA count or None}`` (None without
    cuobjdump)."""
    tool = shutil.which("cuobjdump")
    if tool is None and os.path.exists("/usr/local/cuda/bin/cuobjdump"):
        tool = "/usr/local/cuda/bin/cuobjdump"
    counts = {}
    for lib, rec in recs.items():
        log_path = Path(rec["log"])
        text = log_path.read_text() if log_path.exists() else ""
        for kern, regs, st, ld, smem in ptxas_report(text):
            log(f"ptxas {lib}: {kern}: {regs} registers, spill stores {st} "
                f"B, spill loads {ld} B, static smem {smem} B")
            if (st or ld) and kern.split("<")[0] in NO_SPILL:
                raise AssertionError(f"{kern} spills ({st} B stored, {ld} B "
                                     f"loaded): a register-blocked kernel "
                                     f"must keep its tiles in registers")
        if tool is None:
            counts[lib] = None
            continue
        sass = subprocess.run([tool, "-sass", str(rec["path"])],
                              capture_output=True, text=True,
                              check=True).stdout
        counts[lib] = len(re.findall(r"\bHGMMA\.", sass))
    log("cuobjdump -sass HGMMA instructions: " + (", ".join(
        f"{k} {v}" for k, v in counts.items()) if tool else "cuobjdump not "
        "found, not counted"))
    missing = [k for k in WGMMA_LIBS if counts.get(k) == 0]
    if missing:
        raise AssertionError(f"no HGMMA instruction in {missing}: the wgmma "
                             f"kernels did not compile to the tensor cores")
    return counts


def phase(name, t0):
    log(f"phase {name}: {time.perf_counter() - t0:.2f} s")
    return time.perf_counter()


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
    from repro_torch.sparse import datasets, ref
    from repro_torch.sparse.options import LaunchOptions
    from repro_torch.sparse.program import _graph_setup
    from repro_torch.kernels import route
    t_start = t0 = time.perf_counter()

    # ---- 1: card + build ---------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    device = torch.device(*CARD)
    name = torch.cuda.get_device_name(0)
    log(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"numpy {np.__version__}")
    recs = _build.build()
    log("build (nvcc sm_90a, one process a source, all at once): "
        + ", ".join(f"{Path(r['path']).name} {r['seconds']:.2f} s"
                    for r in recs.values()))
    hgmma = kernel_resources(recs)
    log(f"SDPA float32 at B={FLASH_SHAPE[0]} H={FLASH_SHAPE[1]} "
        f"S={FLASH_SHAPE[2]} hd={FLASH_SHAPE[3]} causal runs: "
        f"{sdpa_kernels(device)}")
    t0 = phase("1 (card, build)", t0)

    # ---- 2: host setup -----------------------------------------------------
    g = datasets.rmat(SCALE, seed=SEED)
    t_gen = time.perf_counter() - t0
    t1 = time.perf_counter()
    setup = _graph_setup(g, 64)
    t_pack = time.perf_counter() - t1
    root = int(np.argmax(g.degrees()))
    t1 = time.perf_counter()
    want = ref.bfs_ref(g, root)
    t_ref = time.perf_counter() - t1
    t1 = time.perf_counter()
    els = datasets.histogram_data(HIST_N, HIST_BINS, seed=SEED)
    t_hist = time.perf_counter() - t1
    log(f"setup rmat-{SCALE}: n={g.n} nnz={g.nnz} E_max={setup[-1]} "
        f"generate+CSR {t_gen:.2f} s, pack onto 64 shards {t_pack:.2f} s, "
        f"oracle BFS {t_ref:.2f} s; histogram_data({HIST_N}, {HIST_BINS}) "
        f"{t_hist:.2f} s (numpy)")
    t0 = phase("2 (host setup)", t0)

    # ---- 3: kernels vs plain ----------------------------------------------
    kernel_edge_cases(route, device)
    rows = main_shape_kernels(route, routing, setup, device)
    leaf_edge_cases(device)
    ids = torch.from_numpy(els.astype(np.int32)).to(device)
    rows.update(leaf_timed(device, ids))
    reduce_add_timed(routing, device, ids, rows)
    del ids
    torch.cuda.empty_cache()
    t0 = phase("3 (kernels vs plain)", t0)

    # ---- 4: BFS on RMAT-22 -------------------------------------------------
    totals = {k: 0 for k in SOURCES}
    for layout, fab, opts in [
            ("flat 64", Fabric.fake(64, device=device),
             LaunchOptions(capacity_factor=4.0)),
            ("pod 8x8", Fabric.virtual((8, 8), ("pod", "data"),
                                       device=device),
             LaunchOptions(pod_axis="pod", capacity_factor=2.0))]:
        run_bfs(g, root, want, setup, layout, fab, opts, totals)
    t0 = phase("4 (BFS rmat-22)", t0)

    # ---- 5-7: PageRank, SpMV, histogram ------------------------------------
    run_pagerank(g, setup, device, totals)
    t0 = phase("5 (PageRank rmat-22)", t0)
    del setup
    run_spmv(g, device, totals)
    t0 = phase("6 (SpMV rmat-22)", t0)
    del g
    run_histogram(els, device, totals)
    del els
    t0 = phase("7 (histogram 2^28)", t0)

    # ---- 8-9: SSSP, WCC, k-core on RMAT-18; spmv_csr -----------------------
    small_apps(device)
    t0 = phase("8 (SSSP/WCC/k-core rmat-18)", t0)
    run_spmv_csr(device, totals, rows)
    t0 = phase("9 (spmv_csr)", t0)

    # ---- 10-11: the MoE layer; gmm and flash attention ---------------------
    moe_stats, moe_params = run_moe(device, totals)
    t0 = phase("10 (MoE OLMoE-1B-7B)", t0)
    gmm_flash_edge_cases(device)
    rows["gmm"] = run_gmm(device, totals, moe_stats, moe_params)
    del moe_stats, moe_params
    torch.cuda.empty_cache()
    rows["flash_attention"] = run_flash(device, totals)
    t0 = phase("11 (gmm, flash attention)", t0)

    rows = {k: rows[k] for k in SOURCES}           # the table's order
    for k in rows:
        rows[k]["launches"] = totals[k]
    for k in WGMMA_LIBS:
        rows[k]["hgmma"] = hgmma[k]
    if not all(totals.values()):
        raise AssertionError(f"a kernel was never launched on a main path: "
                             f"{totals}")
    log(f"whole run {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": list(rows.values())}))
    # the port drives one card (its shards are virtual)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
