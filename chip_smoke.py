#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --bfs-rounds [SRC]   # BFS flat 64's round only
    python3 chip_smoke.py --rank-grid [SRC]    # the rank kernel's grid only
    python3 chip_smoke.py --dse                # phase 14 alone (after 2)
    python3 chip_smoke.py --scale-out          # phase 15 alone (after 2)
    python3 chip_smoke.py --lm                 # phase 16 alone (after the build)
    python3 chip_smoke.py --train              # phase 17 alone (after the build)
    python3 chip_smoke.py --recurrent          # phase 18 alone (after the build)
    python3 chip_smoke.py --dryrun             # phase 19 alone (after the build)
    python3 chip_smoke.py --serve-out          # phase 20 alone (after the build)
    python3 chip_smoke.py --figures            # phase 21 alone (after the build)
    python3 chip_smoke.py --benches [DIR]      # phase 22 alone (after the build)
    python3 chip_smoke.py --bench-spread DIR...  # phase 22's ratios over passes
    python3 chip_smoke.py --repeat [SRC] [--deterministic]  # OLMoE run twice

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
   yardsticks: the bucket scatter on both designs (staged, also on
   inputs 4 bytes off alignment; ranked on a payload ``WIDE_D`` wide,
   the input it serves) and the rank kernel, bit-identical at edge cases
   (1024 buckets, cap 1 and cap >= N, N = 0 and off the tile, drops) and
   at the flat BFS round, staged over two runs; the rank kernel
   (``lookback``) over a grid of N x buckets (64 shards of 2^16, 2^20 and
   E_max tasks, one shard of RMAT-22's every edge; 1, 64 and 1024
   buckets), bit-identical and over two runs, with ``torch.cumsum`` beside
   it at one bucket; the reduce on both
   designs (private; atomic off alignment)
   with whole, fractional and NaN payloads (a slot that received {+NaN,
   5} reads +inf under min, {-NaN, 5} reads 0 under store), n_local at
   the private threshold and one past, timed by min, store and add at
   the flat BFS / PageRank round and by add at the routed histogram,
   beside ``scatter_reduce_``; a grid of shapes on both designs of each
   (scatter N x S: staged at D 1, ranked at ``WIDE_D`` where its slots
   fit; reduce n_local) that sets the private threshold; the
   histogram kernel; the BSR SpMV kernels at edge cases on both designs
   (split, rowblock: an out-of-range block column, R = 1, Kb off the
   slice count, an unaligned x), the split design bit-identical over two
   runs, and at a synthetic shape (its row is timed in phase 9);
4. BFS on RMAT-22, flat (64 shards) and pod/portal (8 x 8): equal to the
   numpy oracle, no drops, bit-identical to the plain-torch path
   (``route_impl="sort"``), every kernel launched, TEPS and the
   per-round kernel times;
5. PageRank on RMAT-22, flat 64, 20 rounds: every vertex within its
   float32 error bound of the float64 oracle and of the plain-torch
   path, and within 1e-4 of both relative to the largest rank;
6. SpMV on RMAT-22, flat 64 and pod/portal 8 x 8: every row within its
   float32 error bound of the oracle and of the plain-torch path, and
   within 1e-4 of both relative to the largest |y|. The numpy work of
   phases 5 and 6 (the two oracles, SpMV's bounds and one build of its
   task stream, which the plain-torch runs route) runs in a process of
   its own (``--host-oracles``) while the card runs phases 2-5, and
   then phase 12's packing onto one shard;
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
   4096, hd 128, causal, bf16 and float32; the edge cases include hd
   112, zamba2's head width, on wgmma and blocked), each on the design its launch
   plan names (asserted from the wrappers' ``PATHS``) and timed beside
   its bound, its plain version and one PyTorch call (``torch.bmm``,
   ``scaled_dot_product_attention``, whose float32 kernel phase 1
   names); the bf16 gmm and the float32 flash also on the simt kernels,
   through inputs that start 2 or 4 bytes off a 16-byte boundary. The
   gmm, flash and BSR C entry points must refuse a launch plan altered
   in any field, and so must the bucket-scatter and reduce entry points
   (both designs each);
12. pipelined rounds on RMAT-22 (phase 2's packing): BFS flat 64, pod
   8 x 8 and on one shard (where the receive-reduce folds into
   admission: the rank kernel, ``lookback``, and the reduce run, the
   scatter must not)
   bit-identical to lockstep (states, rounds, message and drop
   streams); PageRank flat 64, 20 rounds, with lockstep's message and
   drop streams and ranks within twice phase 5's float32 bound of
   lockstep's. For each mode: TEPS or edges*iters/s (best of 3), and
   from one profiled launch the device ms a round, the busy share, the
   host-to-card copies by source memory (pinned or pageable) and the
   host's blocking reads a round;
13. the resident server: RMAT-20 (Graph500 parameters, seed 1) on 64
   shards behind a ``ProgramServer`` of batch width 4 (a product graph
   of 4 * 2^20 vertices), 32 requests from 4 tenants, BFS and SSSP,
   roots from a seeded generator, served in lockstep, pipelined, with
   donated buffers and in lockstep at inflight depth 3 (the four
   servers share the first one's resident packing): pre-warm adds
   one key a class, no build and no drop under load,
   ``ServingStats.verify()``, each pass's peak card memory, the four
   passes equal response by response and 8 sampled responses bit-identical to
   standalone ``run_program`` runs; requests/s, p50/p99 latency and the
   busy share of a profiled pass. Then one ``MoEService`` dispatch of
   OLMoE-1B-7B (x [8, 2048, 2048], the config's factor) through a
   server, against a direct ``moe_dcra`` call within 1e-5 of max|out|;
14. the analytic stack and ``config="auto"`` (``repro_torch.dse``):
   (a) the quick DSE sweep (24 points, 5 apps, RMAT-8 and the wiki-like
   graph) with its revalidation on 8 shards of the card, equal to the
   committed ``BENCH_dse.json`` (point ids, frontier, per-app slices,
   signatures, every metric within 1e-12 relative, the 14 revalidation
   entries); (b) ``shardcheck`` of its highest-TEPS frontier point on
   RMAT-18 (edge factor 8) over 64 shards, all seven apps, executable
   messages, drops and rounds equal to the port's analytic twin, with
   the card's and the twin's seconds; (c) ``dcra_bfs`` with
   ``config="auto"`` on RMAT-22 flat 64 from phase 4's root and on pod
   8 x 8 at the largest RMAT scale whose pod wire fits 16 GiB: the
   resolved ``LaunchConfig`` (source, point, score, caps),
   autoconfigure's host seconds, drops a round and TEPS, bit-identical
   to the plain-torch path under the same ``LaunchConfig``. The flat
   half's ``autoconfigure(g, "bfs")`` runs in the ``--host-oracles``
   process beside phases 2-13 (it walks RMAT-22 for 35 s), and the
   launch's call gets that resolution once its graph's signature is
   checked;
15. scale-out: two worker processes (new processes of this script,
   ``--scale-out-worker``, started after the build, so no worker runs
   ``nvcc``) share the card (``cuda:0`` in both) as one
   ``Fabric.distributed`` over gloo on 127.0.0.1, the crossing half of
   every exchange staged through pinned host memory. Each loads RMAT-22
   and its packing onto 64 shards that the parent wrote (building them
   took each worker 62 s), builds the rest of its inputs from the seed
   and runs, in order: BFS on RMAT-22 from phase
   4's root, flat 64 (32 shards a process, factor 4) in lockstep and
   pipelined, pod 8 x 8 (four pods a process: only the portal stage
   crosses, factor 2) in lockstep; SSSP, WCC, k-core (k 12) and
   PageRank (20 rounds) on RMAT-18, flat 8 and pod 2 x 4; the routed
   histogram of ``histogram_data(2^24, 4096, seed=1)`` on flat 8. Each
   run equal to the one-process run of its
   shape on the same card (states bit for bit, PageRank within twice
   its float32 bound; rounds, message and drop streams), no drop, the
   scatter ``staged`` and the reduce on the one-process run's design in
   each worker; wall seconds and rates beside the one-process run's,
   bytes out and host seconds of the staged exchange a round (wait,
   device-to-host, gloo, host-to-device), each worker's peak card
   memory. A worker that fails, or a peer that times out, fails the
   phase;
16. the decoder LMs' serving path (``repro_torch.models``,
   ``launch/serve.py``): granite-8b at its published width (36 layers,
   d_model 4096, 32/8 heads, hd 128, d_ff 14336, vocab 49152; 33.0 GB of
   float32 weights from ``torch.Generator`` seed 1 on the card) on
   ``synth_batch`` tokens at train_4k cut to [2, 4096]: one forward in
   float32 and one in bf16 with every attention layer on the flash
   kernel (36 launches a forward, ``blocked`` / ``wgmma`` from ``PATHS``),
   each against the same forward on the torch path (``kernel=False``)
   within ``logit_bound``, and the kernel at each forward's own shape
   (layer 0's q, k, v after the GQA expansion, [64, 4096, 128]) against
   its plain version within ``error_bound``; ``serve`` of 4 prompts x
   128 tokens, 32 generated, float32 cache (tokens/s, ms a decode step,
   the decode's logits at the last prompt position against the
   forward's); then OLMoE-1B-7B at its width (16 layers, 27.7 GB) with a
   ``MeshInfo`` over phase 10's fused packaging, every MoE layer through
   ``moe_dcra`` (no drop), on [2, 2048] against the same weights with
   the einsum MoE, routing differences only at near ties, and the kernel
   at layer 0's [32, 2048, 128] against its plain version. Forward ms
   (warm, no instrumentation patched in), peak bytes;
17. the decoder LMs' training path (``optim/adamw.py``,
   ``launch/steps.py``, ``launch/train.py``, ``checkpoint/``,
   ``runtime/fault_tolerance.py::run_training``): (a) OLMoE-1B-7B at its
   published width with its depth cut from 16 to 4 layers (1.88e9
   float32 parameters; with gradients and AdamW's two moments about 30
   GB), remat ``block``, every MoE layer through ``moe_dcra`` on phase
   10's fused packaging at the config's factor 1.25, 3 AdamW steps
   (``make_train_step``, ``default_optimizer()``) on ``synth_batch``
   tokens at train_4k cut to [2, 4096]: step 1 against the same step on
   the plain sort route from the same weights and batch (loss, every
   gradient leaf, the parameters after it; top-k routing layer by
   layer, a difference only at a near tie), the scatter ``staged``
   and launched 2 x 2 times a layer a step (forward, remat's
   recompute), no flash launch (training takes the torch attention
   path), drops a layer; step 1 run a second time from the same weights
   and batch, its loss, every gradient leaf and every parameter after
   it bit-identical to the first run's; ms a step, tokens/s and peak
   bytes of steps 2-3; (b) ``launch/train.py``'s ``main`` on reduced
   granite-8b, 20 steps at peak 3e-3, warmup 5: the loss below 0.7 of
   its first; (c)
   ``run_training`` of the same trainer with a failure at step 7 and a
   checkpoint every 5 steps: one restart, final step 20, the losses of
   the run without the failure;
18. the recurrent, hybrid and encoder-decoder LMs (``models/rwkv6.py``,
   ``models/mamba2.py``, ``RWKVLM`` / ``HybridLM`` / ``EncDecLM``) at their
   published widths, float32 weights from ``torch.Generator`` seed 1 on
   the card, ``synth_batch`` at train_4k cut to batch 2: (a) zamba2-7b
   (81 Mamba2 layers, d_model 3584, 32/32 heads of 112 in the shared
   block, d_ff 14336, vocab 32000, ssm state 64; 27.0 GB) on [2, 4096]:
   one forward in float32 and one in bf16, the shared block on flash (13
   launches each, ``blocked`` / ``wgmma`` from ``PATHS``), each against
   the torch path (float32 within ``logit_bound``; bf16 no farther from
   the float32 logits than the torch path's bf16 run plus that bound),
   the kernel at the block's own [64, 4096, 112] against its plain
   version, layer 0's chunked SSD (chunk 256) against ``ssd_scan`` within
   1e-3 of max|y|, ``serve`` of 2 prompts x 64 tokens with 16 generated
   (decode logits at the last prompt position against the forward's);
   (b) rwkv6-7b (32 layers, d_model 4096, 64 WKV heads of 64, d_ff
   14336, vocab 65536; 30.1 GB): the same forwards (no kernel runs on
   this path), layer 0's chunked WKV against ``wkv_scan`` within 1e-4,
   ``serve``; (c) seamless-m4t-large-v2 (24 encoder and 24 decoder
   layers, d_model 1024, 16/16 heads of 64, vocab 256206; 8.1 GB) on
   frames [2, 2048] and tokens [2, 2048]: the forwards with 24 non-causal
   (encoder) and 24 causal (decoder) flash launches each, the kernel at
   each mask's first inputs against its plain version, and 16 decode
   steps over ``precompute_cross_kv`` of the encoder's output against the
   forward's logits; (d) zamba2-7b training at its width with its depth
   cut from 81 to 12 layers (two applications of the shared block, 1.37e9
   parameters), remat ``block``, 3 AdamW steps on [2, 4096]: every
   gradient leaf and loss finite, no flash launch; ms a step, tokens/s,
   peak bytes;
19. the LM launch runtime (``repro_torch.launch.{mesh,sharding,analytic,
   roofline,report,dryrun}``): (a) every arch x shape x {single, multi}
   cell (the ten archs x train_4k, prefill_32k, decode_32k, long_500k
   where ``shape_cells`` has it: 68 cells, 12 skips) built on the meta
   device with its spec tables applied, on H100 figures; the report's
   summary and the bottleneck counts by arch (the whole table into
   ``build/dryrun_table.md``); (c) the four example scripts
   (``examples/*_torch.py``) as subprocesses on the card at small
   arguments, each exiting 0; (d) ``compress_psum`` over one axis of a
   two-process 2 x 2 ``Fabric.distributed`` over gloo (``--psum-worker``
   processes, the card in both), equal bit for bit to the one-process
   virtual fabric's; then, alone on the card, (b) ``lower_cell(...,
   measure=True)`` of granite-8b train_4k, prefill_32k, decode_32k and
   OLMoE-1B-7B train_4k (through ``moe_dcra`` on phase 10's fused
   packaging) at their published widths, depth, batch and cache cut to
   ``dryrun.MEASURE_AT``: the step's ms by CUDA events, peak bytes, the
   reduced cell's analytic compute and memory terms and their share of
   the step, the flash and scatter launches; the prefill's flash kernel
   held to its plain version on layer 0's q, k, v at S = 32768
   (``long_flash_check``), and the
   measured model's logits held within ``logit_bound`` of its torch
   attention path (prefill), or no farther than ``logit_bound`` beyond
   the plain sort route's from the float32 forward's and bit-identical
   to a second run of itself (OLMoE);
20. the serving tier and the MoE layer on a distributed fabric: two
   worker processes (``--serve-out-worker``, started after the build)
   share the card as one ``Fabric.distributed`` ``("portal", "data")``
   (2, 32) over gloo, one pod a process. Here first, the one-process
   server of phase 13 on the same (2, 32) shape, from phase 13's resident
   packing. In the workers, which load RMAT-20 and phase 13's packing
   onto 64 shards from files the parent writes: (a)
   phase 13's server (RMAT-20, batch width 4, the first 8 of its 32
   requests, a BFS and an SSSP launch: all 32 took 125 s a pass, 16 took
   65 s, lockstep) across the two processes, every response
   bit-identical to phase 13's, rounds, messages and drops equal to the
   one-process server's, no build under load and no drop, the scatter
   ``staged`` and the reduce ``atomic`` in each, both workers'
   responses equal; requests/s beside phase 13's and the gloo seconds a
   launch; (b) the stream's first 4 requests with a host loss at launch
   0 keeping 32 shards (16 a process), from (a)'s warm classes and
   resident packing: the server re-packs onto 32 shards, re-pre-warms
   the BFS class and serves every request equal to (a) (16 requests with
   the loss at launch 2 took 89 s); (c) one
   dispatch of OLMoE-1B-7B's MoE layer through a server's ``MoEService``
   lane on phase 10's two-stage packaging with one pod a process (the
   portal stage crosses), x [8, 2048, 2048] at factor 1.25, within 1e-5
   of max|out| of ``moe_dcra`` on the virtual packaging, the lane's own
   dispatch's drops per bucket equal to the virtual packaging's, the
   scatter launches; (d) one gradient of that layer on
   x [2, 2048, 2048] with phase 10's no-drop queues, loss ``sum(out *
   r) + aux``: the loss and every leaf (four weights, x) within 1e-5 of
   its max|g| of the one-process run, both processes' weight gradients
   identical. A failing worker, or a peer that times out, fails the
   phase;
21. the paper's figure harness (``repro_torch.figures``) and the
   graph-analytics example: (1) ``figures.run`` at ``--quick`` (scale
   12, cut from the paper's 16: the full set takes minutes of host
   numpy) on the card, every module run and every number of its CSV
   finite, ``moe_dispatch``'s einsum timed on the card; the roofline
   table on phase 19's records (68 cells, the collective term "—");
   (2) ``noc_routing`` at the reference's defaults (RMAT-11, 8 shards, 2
   pods) and at RMAT-18 on 64 shards in 8 pods, each mode a path: no
   drop, BFS and the histogram bit-identical to the oracle, SpMV every
   row within its float32 bound, ms a call, the hierarchical die
   crossings below the flat ones; (3)
   ``examples/graph_analytics_torch.py --distributed --scale 12`` on
   the card: the seven apps and the auto-configured BFS with no drop,
   each bit-identical to its oracle or within its float32 bound
   (PageRank, SpMV), and the packaging table. ``figures.run`` must list
   the reference's twelve modules; its two timing benches run in phase
   22 only;
22. the two timing benches (``repro_torch.figures.route_bench``,
   ``serve_bench``) and their gates: (1) ``route_bench --quick`` on the
   card at its own reps (a sample a block of back-to-back calls of about
   2 ms, each ratio the median over reps of one rep's two samples): one
   ``bucket()`` round per impl (onehot, sort, the kernels) at 6 N x S
   cells, and 6 rounds of a min-relay per impl in
   lockstep (``bucket`` + ``reduce_received``) and pipelined
   (``local_route_reduce``) at 3 cells, each impl's output and each
   round cell's final state and drop stream asserted bit-identical
   before timing; the rank kernel ``lookback``, the scatter ``staged``
   and the reduce ``private`` only, from ``PATHS``; each cell's ms and
   ratios, and the host's blocking reads in one round cell by impl and
   mode (torch's sync debug mode); (2) ``serve_bench`` on 8 shards:
   ``--smoke --depth 3`` (no build under load, no drop, a column equal
   to a standalone launch, depth 3 equal to depth 1: ``RESULT ok``),
   ``--chaos 0`` (a launch fault, a device fault and a host loss from 8
   shards to 4, retries and the breaker, responses equal to the
   fault-free run's: ``RESULT chaos ok``), ``--depth 3 --reps 101
   --bench-out`` (101 alternations of the sync and overlapped drains,
   every other pair overlapped first): requests/s and p50/p99; (3)
   ``repro_torch.dse.route_compare`` and ``serve_compare`` of this
   run's artifacts (``chiprun_out/benches``) against the committed
   ``BENCH_route_torch.json`` and ``BENCH_serve_torch.json`` from the
   card, each exiting 0. The whole
   run gates ``serve_compare`` only; ``route_compare`` runs under
   ``--benches``, since the kernels' op ratios move by more than half
   the gate's tolerance from process to process.

Each path of phases 4-7, 9-22 runs with every kernel's launch count set
to 0 just before it and read just after; the kernel table sums them,
and the run fails if a kernel of the table launched on no path. Each app
and MoE path asserts from the route wrappers' ``PATHS`` that the scatter
ran ``staged`` only, and the reduce ``atomic`` (BFS, PageRank, the
server: n_local 65,536; one shard: 4,194,304) or ``private`` (the routed
histogram: 64). The rank kernel runs on its one design (``lookback``,
asserted the same way) where the receive-reduce folds into admission:
one shard's pipelined BFS and the route bench's pipelined rounds. Every number the script prints about the card stands beside
``nvidia-smi``'s name and power limit.
The line before the last is the JSON kernel table (the gmm row carries
its bf16 run under ``bf16_*`` keys, the flash row its float32 run under
``f32_*``; ``design`` and ``f32_design`` on the BSR and flash rows name
the design that ran), the last line ``{"ok": true, "device": {...}}``.
It needs a CUDA card and the repository around it: without either it
exits with code 2.
"""
from __future__ import annotations

import atexit
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CHILDREN = []                      # processes started here, stopped at exit
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
KERNEL_NAMES = {"bucket_rank": ("rank_lookback_kernel",),
                "bucket_scatter": ("fill_kernel", "scatter_kernel",
                                   "staged_count_kernel", "staged_scan_kernel",
                                   "staged_fill_kernel", "staged_place_kernel"),
                "reduce_received": ("reduce_init_kernel", "reduce_kernel",
                                    "reduce_private_kernel",
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
NO_SPILL = ("gmm_blocked_kernel", "flash_blocked_kernel", "bsr_split_kernel",
            "staged_place_kernel", "reduce_private_kernel")
#: designs each of ``plans_refused``'s launches covers: bucket rank 1,
#: bucket scatter 2, reduce 2, gmm 4, flash 4, BSR 2
PLAN_DESIGNS = 15
CARD = ("cuda", 0)
#: ``nvidia-smi``'s name and power limit of the card, beside every number
SMI = "card not read"
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
#: the route kernels' grid (phase 3): scatter tasks a shard (and E_max)
#: by shards; the reduce's stream (shards, entries a shard) by n_local,
#: up to the largest n_local whose one private copy fills a block's
#: shared memory (58,112) and BFS's 65,536 past it
GRID_TASKS, GRID_SHARDS = (1 << 16, 1 << 20), (8, 64)
GRID_STREAM = (64, 1 << 23)
GRID_LOCALS = (64, 1024, 8192, 16384, 32768, 58112, 65536)
#: a payload too wide for the staged scatter's tile staging at any
#: bucket count: what takes the ranked design; the grid runs it where
#: its payload and slots take at most GRID_WIDE_BYTES
WIDE_D = 32
GRID_WIDE_BYTES = 16 << 30
#: the rank grid (phase 3): tasks a shard at 64 shards (and E_max), then
#: every edge of RMAT-22 on one shard, by bucket counts; a share of valid
#: tasks near the one-shard BFS round's (84,738,637 of 128,306,514)
GRID_RANK_TASKS, GRID_RANK_BUCKETS = (1 << 16, 1 << 20), (1, 64, 1024)
GRID_RANK_VALID = 0.66
#: RMAT-22's E_max on 64 shards and its edge count (phase 2 prints both):
#: the shapes ``--rank-grid`` runs without building the graph
RMAT22_E_MAX, RMAT22_NNZ = 2_235_449, 128_306_514


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
    exit into ``self.launches`` (and the route wrappers' designs into
    ``self.paths``); ``need`` names the kernels the path must have
    launched, ``designs`` the only design each route wrapper may have run
    (``{"bucket_scatter": "staged", ...}``)."""

    def __init__(self, name, need, totals, designs=None):
        self.name, self.need, self.totals = name, need, totals
        self.designs = designs or {}

    def __enter__(self):
        import torch
        torch.cuda.synchronize()
        reset_launches()
        return self

    def __exit__(self, kind, *_):
        import torch
        torch.cuda.synchronize()
        self.launches = read_launches()
        from repro_torch.kernels import route
        self.paths = {k: dict(v) for k, v in route.PATHS.items()}
        if kind is not None:
            return False
        missing = [k for k in self.need if not self.launches[k]]
        if missing:
            raise AssertionError(f"{self.name}: kernels never launched: "
                                 f"{missing} ({self.launches})")
        for wrapper, want in self.designs.items():
            ran_only(self.paths[wrapper], want, f"{self.name}: {wrapper}")
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


def off_alignment(t):
    """A copy of ``t`` that starts one element (4 bytes, 1 for bool) into
    its storage: the inputs that reach the ``atomic`` reduce; the scatter
    takes its ``staged`` design on them as on aligned ones."""
    flat = t.new_empty(t.numel() + 1)[1:]
    return flat.view(t.shape).copy_(t)


def nan_stream(slot, val, n_local):
    """``val`` with a +NaN (sign bit clear) and a -NaN (set) in every
    shard, at slots 0 and ``n_local - 1``."""
    import torch
    nans = torch.tensor([0x7FC00000, -0x00400000], dtype=torch.int32,
                        device=val.device).view(torch.float32)
    slot, val = slot.clone(), val.clone()
    slot[:, :2] = torch.tensor([0, n_local - 1], dtype=torch.int32)
    val[:, :2] = nans
    return slot, val


def check_reduce_nan(route, slot, val, n_local):
    """A stream with NaNs of both signs against the plain version: min and
    store equal (the plain version reads +inf and 0 where a NaN landed),
    add NaN where the plain version has NaN and equal elsewhere (whole
    numbers)."""
    import torch
    for op in route.REDUCE_OPS:
        got = route.reduce_received(slot, val, n_local, op)
        want = route.plain_reduce_received(slot, val, n_local, op)
        if not (torch.equal(got.isnan(), want.isnan())
                and torch.equal(got.nan_to_num(), want.nan_to_num())):
            raise AssertionError(f"reduce_received {op} differs on a "
                                 f"stream with NaNs")


def reduce_designs(route, s, m, n_local):
    """``(prep, design)`` for each design the reduce wrapper can take on
    ``[s, m]`` inputs: ``prep`` leaves an input as it is (the plan's
    design on aligned inputs) or copies it 4 bytes off alignment
    (atomic)."""
    return [(lambda t: t, route.reduce_received_plan(s, m, n_local).path),
            (off_alignment, "atomic")]


def kernel_edge_cases(route, device):
    """The bucket scatter on both designs (staged at the case's payload,
    on fresh inputs and on copies off alignment; ranked at a payload
    ``WIDE_D`` wide) bit-identical to the plain version, the rank kernel
    too; the reduce on both designs (private where the plan names it,
    atomic off alignment), with whole-number, fractional and NaN
    payloads; the NaN reads of the reference on both; n_local at the
    private threshold and one past."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED)
    cases = [  # (S, N, buckets, cap, k, D, p_valid)
        (1, 0, 4, 2, 1, 1, 0.9), (1, 1, 4, 2, 1, 1, 0.9),
        (7, 1031, 7, 5, 2, 1, 0.9), (64, 5003, 64, 9, 1, 1, 0.9),
        (3, 4097, 8, 1, 2, 3, 0.9), (7, 2048, 7, 3, 1, 1, 0.0),
        (1, 3000, 1, 3000, 1, 1, 1.0), (64, 1031, 8, 2, 2, 1, 0.5),
        (2, 5003, 1024, 3, 2, 1, 0.9), (5, 12289, 37, 40, 2, 1, 0.6)]
    drops = 0
    designs = set()
    for s, n, nb, cap, k, d, p in cases:
        for design, width, shifted in (("staged", d, False),
                                       ("staged", d, True),
                                       ("ranked", WIDE_D, False)):
            x, dest, valid, aux = rand_tasks(rng, s, n, nb, k, width, p,
                                             device)
            if shifted:
                x, dest, valid = map(off_alignment, (x, dest, valid))
                aux = [off_alignment(a) for a in aux]
            route.reset_launches()
            drops += check_bucket(route, x, dest, valid, aux, nb, cap)
            ran_only(route.PATHS["bucket_scatter"], design, "bucket_scatter")
        locals_ = [3 * nb + 1]
        if nb == 1024:
            locals_ += [route.PRIVATE_MAX_LOCAL, route.PRIVATE_MAX_LOCAL + 1]
        for n_local in locals_:
            slot = torch.tensor(rng.integers(-1, n_local + 2, (s, n)),
                                dtype=torch.int32, device=device)
            whole = torch.tensor(rng.integers(-9, 10, (s, n)),
                                 dtype=torch.float32, device=device)
            for prep, design in reduce_designs(route, s, n, n_local):
                route.reset_launches()
                check_reduce(route, prep(slot), prep(whole), n_local,
                             integer_valued=True)
                check_reduce(route, prep(slot), prep(whole * 0.37), n_local,
                             integer_valued=False)
                if n >= 2:
                    check_reduce_nan(route, *map(prep, nan_stream(
                        slot, whole, n_local)), n_local)
                if n:
                    ran_only(route.PATHS["reduce_received"], design,
                             "reduce_received")
                designs.add(design)
    if drops == 0 or designs != {"private", "atomic"}:
        raise AssertionError(f"edge cases: {drops} drops, reduce designs "
                             f"{designs}")
    nan_reads(route, device)
    torch.cuda.synchronize()
    log(f"kernels: {len(cases)} edge cases bit-identical to the plain "
        f"versions on both scatter designs (staged, also 4 bytes off "
        f"alignment; ranked at D {WIDE_D}), {drops} drops exercised; the "
        f"reduce on both designs "
        f"with whole, fractional and NaN payloads, n_local up to the "
        f"private threshold {route.PRIVATE_MAX_LOCAL} and one past")


def nan_reads(route, device):
    """On both reduce designs: a slot that receives {+NaN, 5} reads +inf
    under min, one that receives {-NaN, 5} reads 0 under store, in either
    order, as the reference gives."""
    import torch
    slot = torch.tensor([[0, 0, 1, 1, 2, 2, 3]], dtype=torch.int32,
                        device=device)
    bits = [0x7FC00000, 0x40A00000, 0x40A00000, 0x7FC00000, -0x00400000,
            0x40A00000, 0x40000000]          # +NaN, 5, 5, +NaN, -NaN, 5, 2
    val = torch.tensor([bits], dtype=torch.int32,
                       device=device).view(torch.float32)
    inf = float("inf")
    for prep, design in reduce_designs(route, *slot.shape, 4):
        sl, v = prep(slot), prep(val)
        route.reset_launches()
        got_min = route.reduce_received(sl, v, 4, "min")[0].tolist()
        got_store = route.reduce_received(sl, v, 4, "store")[0].tolist()
        ran_only(route.PATHS["reduce_received"], design, "reduce_received")
        if got_min != [inf, inf, inf, 2.0] or got_store != [0, 0, 0, 2.0]:
            raise AssertionError(f"reduce_received {design}: NaN reads "
                                 f"min {got_min}, store {got_store}")


def scatter_bytes(s, n, d, k, slots):
    """The bytes ``bucket_scatter`` must move: x, dest, valid and the aux
    columns read and task_slot written once a task, xb and the aux slots
    written once, n_drop."""
    return s * n * (4 * d + 4 + 1 + 4 * k + 4) + slots * (4 * d + 4 * k) + \
        s * 4


def main_shape_kernels(route, routing, setup, device):
    """The kernels at the flat BFS round's shapes: 64 shards, N = E_max,
    cap from capacity factor 4, every edge an active task. The scatter
    (staged, also through views 4 bytes off alignment; the ranked design
    is timed in :func:`route_grid` at the payload it serves); the reduce
    of that round's stream (n_local 65,536: the atomic design) by min and
    store (BFS, SSSP) and by add (PageRank's flat round has the same
    stream shape), each with ``scatter_reduce_`` beside it."""
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
    route.reset_launches()
    drops = check_bucket(route, x, dest, valid, aux, s, cap)
    ran_only(route.PATHS["bucket_scatter"], "staged", "bucket_scatter")
    if drops:
        raise AssertionError(f"{drops} drops at the main shape")
    xu, du, vu = off_alignment(x), off_alignment(dest), off_alignment(valid)
    au = [off_alignment(aux[0])]
    route.reset_launches()
    check_bucket(route, xu, du, vu, au, s, cap)
    ran_only(route.PATHS["bucket_scatter"], "staged", "bucket_scatter")
    del xu, du, vu, au
    first = route.bucket_scatter(x, dest, valid, aux, s, cap)
    second = route.bucket_scatter(x, dest, valid, aux, s, cap)
    if not all(torch.equal(a, b) for a, b in zip(
            (first[0], *first[1], *first[2:]),
            (second[0], *second[1], *second[2:]))):
        raise AssertionError("bucket_scatter staged: two runs differ at the "
                             "main shape")
    xb, ints = first[0], first[1]
    del first, second
    recv_val, (recv_slot,) = routing.fused_all_to_all(xb, ints, (s,), 0)
    del xb, ints
    recv_val = recv_val[..., 0].contiguous()
    design = route.reduce_received_plan(*recv_slot.shape, n_local).path
    route.reset_launches()
    err, rel = check_reduce(route, recv_slot, recv_val, n_local,
                            integer_valued=False)
    ran_only(route.PATHS["reduce_received"], design, "reduce_received")
    log(f"kernel reduce_received at the main shape ({design}): min and store "
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
    y0 = torch.empty(s * n_local + m, device=device)
    init = {"amin": float("inf"), "amax": float("-inf"), "sum": 0.0}

    def library_call(how):
        # the outputs reset (16 MB), not the spare cells: they only absorb
        # the empty entries
        def call():
            y0[:s * n_local].fill_(init[how])
            y0.scatter_reduce_(0, flat_idx, flat_val, how)
        return call

    n_bytes = scatter_bytes(s, e_max, 1, 1, slots)
    reduce_bytes = m * (4 + 4) + s * n_local * 4
    route.reset_launches()
    rank_row = {
        "name": "bucket_rank", "route": "cuda",
        "source": SOURCES["bucket_rank"], "replaces": REPLACES["bucket_rank"],
        "launches": 0, "max_abs_err": 0.0,
        "ms": cuda_ms(lambda: route.bucket_rank(dest, valid, s), 5),
        "plain_ms": cuda_ms(lambda: route.plain_bucket_rank(dest, valid, s),
                            2),
        "bound_ms": bound_ms(tasks * (4 + 1 + 4)), "bound_by": "bytes",
        "library_ms": None, "design": "lookback"}
    ran_only(route.PATHS["bucket_rank"], "lookback", "bucket_rank")
    rows["bucket_rank"] = rank_row
    log(f"kernel bucket_rank: S={s} N={e_max}, {s} buckets: lookback "
        f"{rank_row['ms']:.4f} ms "
        f"({rank_row['ms'] / rank_row['bound_ms']:.3f}x its bound), plain "
        f"{rank_row['plain_ms']:.4f} ms (no yardstick), bound "
        f"{rank_row['bound_ms']:.4f} ms ({tasks * 9} B / 3.35 TB/s) "
        f"[{SMI}]")

    route.reset_launches()
    r = row("bucket_scatter", 0.0,
            cuda_ms(lambda: route.bucket_scatter(x, dest, valid, aux, s, cap),
                    5),
            cuda_ms(lambda: route.plain_bucket_scatter(x, dest, valid, aux, s,
                                                       cap), 2),
            n_bytes, None)
    ran_only(route.PATHS["bucket_scatter"], "staged", "bucket_scatter")
    r["design"] = "staged"
    rows["bucket_scatter"] = r
    log(f"kernel bucket_scatter: S={s} N={e_max} cap={cap}: staged "
        f"{r['ms']:.4f} ms ({r['ms'] / r['bound_ms']:.3f}x its bound), "
        f"plain {r['plain_ms']:.4f} ms (no yardstick), bound "
        f"{r['bound_ms']:.4f} ms ({n_bytes} B / 3.35 TB/s); bit-identical "
        f"to the plain version, also 4 bytes off alignment, and over two "
        f"runs")

    times = {}
    route.reset_launches()
    for op, how in (("min", "amin"), ("store", "amax"), ("add", "sum")):
        times[op] = (
            cuda_ms(lambda: route.reduce_received(recv_slot, recv_val,
                                                  n_local, op), 5),
            cuda_ms(lambda: route.plain_reduce_received(recv_slot, recv_val,
                                                        n_local, op), 2),
            cuda_ms(library_call(how), 5))
        want = route.reduce_received(recv_slot, recv_val, n_local, op)
        got = y0[:s * n_local].view(s, n_local)
        if op == "min":
            got = torch.where(torch.isfinite(got), got, float("inf"))
        elif op == "store":
            got = torch.where(torch.isfinite(got), got, 0.0)
        if op != "add" and not torch.equal(got, want):
            raise AssertionError(f"the scatter_reduce_ {how} yardstick "
                                 f"computes another function")
    ran_only(route.PATHS["reduce_received"], design, "reduce_received")
    r = row("reduce_received", err, *times["min"][:2], reduce_bytes,
            times["min"][2])
    r["design"] = design
    for op in ("store", "add"):
        r[f"{op}_bfs_ms"], r[f"{op}_bfs_plain_ms"], \
            r[f"{op}_bfs_library_ms"] = times[op]
    rows["reduce_received"] = r
    log(f"kernel reduce_received at the flat BFS / PageRank round: S={s} "
        f"M={m // s} n_local={n_local}, {design} design: min "
        f"{times['min'][0]:.4f} ms (scatter_reduce_ amin "
        f"{times['min'][2]:.4f}), store {times['store'][0]:.4f} ms (amax "
        f"{times['store'][2]:.4f}), add {times['add'][0]:.4f} ms (sum "
        f"{times['add'][2]:.4f}); bound {r['bound_ms']:.4f} ms "
        f"({reduce_bytes} B / 3.35 TB/s); plain min/store/add "
        f"{times['min'][1]:.4f} / {times['store'][1]:.4f} / "
        f"{times['add'][1]:.4f} ms (no yardstick)")
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


def profile_kernels(fn, rounds, copies=None):
    """One run of ``fn`` under torch.profiler: ``(device ms per round of
    each wrapper's kernels, device ms of all kernels, wall ms of the run,
    the five costliest device ops as (name, ms))``; ``None`` in place of
    the first where the profiler saw no device time. A dict passed as
    ``copies`` receives the ms of the host-to-card copies by their
    source memory (``"Pageable"``, ``"Pinned"``)."""
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
        if copies is not None and ev.key.startswith("Memcpy HtoD"):
            kind = "Pinned" if "Pinned" in ev.key else "Pageable"
            copies[kind] = copies.get(kind, 0.0) + us / 1e3
        for wrapper, names in KERNEL_NAMES.items():
            if any(is_port_kernel(ev.key, nm) for nm in names):
                per[wrapper] += us
                break
    if total == 0.0:
        return None, 0.0, wall_ms, []
    top = sorted(ops, key=lambda o: -o[1])[:5]
    return ({k: v / 1e3 / max(rounds, 1) for k, v in per.items()},
            total / 1e3, wall_ms, top)


ROUTE_KERNELS = ("bucket_scatter", "reduce_received")
#: the only designs the route wrappers may run on each path: staged on
#: every path; the reduce's atomic at BFS's and PageRank's n_local 65,536,
#: private at the routed histogram's 64
STAGED_ATOMIC = {"bucket_scatter": "staged", "reduce_received": "atomic"}
STAGED_PRIVATE = {"bucket_scatter": "staged", "reduce_received": "private"}


def run_bfs(g, root, want, setup, layout, fabric, opts, totals):
    import numpy as np
    import torch
    from repro_torch.sparse.torch_apps import dcra_bfs
    torch.cuda.reset_peak_memory_stats()
    with MainPath(f"BFS {layout}", ROUTE_KERNELS, totals,
                  STAGED_ATOMIC) as path:
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
        f"route designs {path.paths}; plain-torch path bit-identical")
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
        ran_only(spmv.PATHS, design, "bsr_spmv")
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


def ran_only(paths, want, what):
    """Every launch counted in ``paths`` (a wrapper's entry of ``PATHS``)
    since the last reset ran the ``want`` design, and there was one."""
    if not paths[want] or paths[want] != sum(paths.values()):
        raise AssertionError(f"{what}: expected the {want} design only, "
                             f"ran {paths}")


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
    ran_only(spmv.PATHS, "split", "bsr_spmv")
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
    ran_only(spmv.PATHS, "rowblock", "bsr_spmv")
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
    shards, e_local = 2^22, cap from factor 2.0, n_local = 64) on the
    private design and, through views 4 bytes off alignment, the atomic
    one, with ``scatter_reduce_`` sum beside them; all exact (whole
    numbers)."""
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
    want = route.plain_reduce_received(recv_slot, recv_val, n_local, "add")
    su, vu = off_alignment(recv_slot), off_alignment(recv_val)
    times = {}
    for design, (sl, v) in (("private", (recv_slot, recv_val)),
                            ("atomic", (su, vu))):
        route.reset_launches()
        if not torch.equal(route.reduce_received(sl, v, n_local, "add"),
                           want):
            raise AssertionError(f"reduce_received add ({design}) differs at "
                                 f"the histogram shape")
        times[design] = cuda_ms(lambda: route.reduce_received(
            sl, v, n_local, "add"), 5)
        ran_only(route.PATHS["reduce_received"], design, "reduce_received")
    del su, vu
    flat_idx = torch.where(
        recv_slot >= 0,
        torch.arange(s, device=device)[:, None] * n_local + recv_slot.long(),
        s * n_local + torch.arange(m, device=device).view(s, -1)).reshape(-1)
    flat_val = recv_val.reshape(-1)
    y0 = torch.zeros(s * n_local + m, device=device)

    def library_call():
        y0[:s * n_local].zero_()          # the outputs, not the spare cells
        y0.scatter_reduce_(0, flat_idx, flat_val, "sum")

    library_call()
    if not torch.equal(y0[:s * n_local].view(s, n_local), want):
        raise AssertionError("the scatter_reduce_ sum yardstick computes "
                             "another function")
    n_bytes = m * (4 + 4) + s * n_local * 4
    r = rows["reduce_received"]
    r["add_ms"] = times["private"]
    r["add_design"] = "private"
    r["add_atomic_ms"] = times["atomic"]
    r["add_bound_ms"] = bound_ms(n_bytes)
    r["add_plain_ms"] = cuda_ms(lambda: route.plain_reduce_received(
        recv_slot, recv_val, n_local, "add"), 2)
    r["add_library_ms"] = cuda_ms(library_call, 5)
    log(f"kernel reduce_received add at the routed histogram shape: S={s} "
        f"M={m // s} n_local={n_local}: private {r['add_ms']:.4f} ms "
        f"({r['add_ms'] / r['add_bound_ms']:.3f}x its bound), atomic "
        f"(inputs 4 bytes off alignment) {r['add_atomic_ms']:.4f} ms, bound "
        f"{r['add_bound_ms']:.4f} ms ({n_bytes} B / 3.35 TB/s), "
        f"scatter_reduce_ sum {r['add_library_ms']:.4f} ms, plain "
        f"{r['add_plain_ms']:.4f} ms (no yardstick); exact (whole numbers) "
        f"on both designs, equal to the plain version")


def rank_grid(device, e_max, nnz):
    """The rank kernel over ``GRID_RANK_TASKS`` and ``e_max`` tasks a shard
    at 64 shards and ``nnz`` at one shard, by ``GRID_RANK_BUCKETS``:
    dests uniform over the buckets, a share ``GRID_RANK_VALID`` valid,
    from a seeded generator on the card. Each cell bit-identical to the
    plain version and over two runs, timed (CUDA events, mean of 5) beside
    its bound and, at one bucket, ``torch.cumsum(valid, 1,
    dtype=torch.int32)`` (an inclusive scan; the exclusive rank is one
    subtraction more). Works with any ``repro_torch`` whose ``bucket_rank``
    has this signature (``--rank-grid SRC`` runs it on another tree).
    Returns the cells."""
    import torch
    from repro_torch.kernels import route
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    cells = []
    for s, n in [*((64, n) for n in (*GRID_RANK_TASKS, e_max)), (1, nnz)]:
        r = torch.randint(0, 1 << 30, (s, n), generator=gen, device=device,
                          dtype=torch.int32)
        valid = torch.rand(s, n, generator=gen, device=device) \
            < GRID_RANK_VALID
        for nb in GRID_RANK_BUCKETS:
            dest = r % nb
            route.reset_launches()
            got = route.bucket_rank(dest, valid, nb)
            if not torch.equal(got, route.plain_bucket_rank(dest, valid,
                                                            nb)):
                raise AssertionError(f"rank grid: bucket_rank differs at "
                                     f"S={s} N={n} nb={nb}")
            cell = {"s": s, "n": n, "nb": nb,
                    "ms": cuda_ms(lambda: route.bucket_rank(dest, valid, nb),
                                  5),
                    "bound_ms": bound_ms(s * n * (4 + 1 + 4)),
                    "library_ms": None}
            if not torch.equal(route.bucket_rank(dest, valid, nb), got):
                raise AssertionError(f"rank grid: two runs differ at S={s} "
                                     f"N={n} nb={nb}")
            design = "kernel"
            if "bucket_rank" in getattr(route, "PATHS", {}):
                ran_only(route.PATHS["bucket_rank"], "lookback",
                         "bucket_rank")
                design = "lookback"
            if nb == 1:
                cell["library_ms"] = cuda_ms(
                    lambda: torch.cumsum(valid, 1, dtype=torch.int32), 5)
            cells.append(cell)
            log(f"grid bucket_rank S={s} N={n} nb={nb}: {design} "
                f"{cell['ms']:.4f} ms ({cell['ms'] / cell['bound_ms']:.3f}x "
                f"its bound), bound {cell['bound_ms']:.4f} ms"
                + (f", cumsum {cell['library_ms']:.4f} ms" if nb == 1 else "")
                + f"; bit-identical to the plain version and over two runs "
                f"[{SMI}]")
            del dest, got
        del r, valid
        torch.cuda.empty_cache()
    return cells


def rank_grid_only(src):
    """``--rank-grid [SRC]``: :func:`rank_grid` with the ``repro_torch``
    found under ``SRC`` (default: this checkout's ``src``; another
    checkout's, to compare two trees on one card) at RMAT-22's shapes,
    with the card's name and power limit."""
    global SMI
    sys.path.insert(0, str(Path(src).resolve()))
    import repro_torch
    import torch
    SMI = card_name()
    log(f"rank-grid: repro_torch from {Path(repro_torch.__file__).parent} "
        f"[{SMI}]")
    rank_grid(torch.device(*CARD), RMAT22_E_MAX, RMAT22_NNZ)
    return 0


def card_name():
    """``nvidia-smi``'s name and power limit of the card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def route_grid(routing, device, e_max, rows):
    """Both designs of each route kernel over a small grid of shapes, on
    the card: the scatter at N in {2^16, 2^20, E_max} tasks a shard by S
    in {8, 64} shards (n_buckets S, cap from factor 4, every task valid,
    k 1), staged at D 1 (the paths' payload) and ranked at ``WIDE_D``
    (the payload it serves) where that payload and its slots take at
    most ``GRID_WIDE_BYTES``, each bit-identical to the plain version;
    the ranked cell at S 8 and E_max is the table row's ``ranked_*``.
    And the reduce of a stream of 64 shards x 2^23 entries (half empty,
    the rest uniform over the outputs; whole-number values) into each of
    ``GRID_LOCALS`` by add and by min, private launched with its own plan
    wherever it fits a block (not at 65,536), atomic through views off
    alignment. What sets ``route.PRIVATE_MAX_LOCAL``. Returns the grid,
    also kept in the table rows."""
    import torch
    from repro_torch.core.queues import QueueConfig
    from repro_torch.kernels import route
    from repro_torch.kernels._build import library
    from repro_torch.kernels._launch import as_c
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    scatter = []
    for s in GRID_SHARDS:
        for n in (*GRID_TASKS, e_max):
            cap = routing.resolve_flat_cap(QueueConfig.from_factor(4.0), "T3",
                                           n, s, clamp=True)
            slots = s * s * cap
            dest = torch.randint(0, s, (s, n), generator=gen, device=device,
                                 dtype=torch.int32)
            valid = torch.ones(s, n, dtype=torch.bool, device=device)
            aux = [torch.randint(0, 1 << 20, (s, n), generator=gen,
                                 device=device, dtype=torch.int32)]
            cell = {"s": s, "n": n, "cap": cap}
            for design, d in (("staged", 1), ("ranked", WIDE_D)):
                if 4 * d * (s * n + slots) > GRID_WIDE_BYTES:
                    cell[f"{design}_ms"] = cell[f"{design}_bound_ms"] = None
                    continue
                x = torch.rand(s, n, d, generator=gen, device=device)
                route.reset_launches()
                check_bucket(route, x, dest, valid, aux, s, cap)
                cell[f"{design}_ms"] = cuda_ms(
                    lambda: route.bucket_scatter(x, dest, valid, aux, s, cap),
                    3)
                ran_only(route.PATHS["bucket_scatter"], design,
                         "bucket_scatter")
                cell[f"{design}_bound_ms"] = bound_ms(
                    scatter_bytes(s, n, d, 1, slots))
                del x
            scatter.append(cell)
            log(f"grid bucket_scatter S={s} N={n} cap={cap}: staged (D 1) "
                f"{cell['staged_ms']:.4f} ms, bound "
                f"{cell['staged_bound_ms']:.4f} ms; ranked (D {WIDE_D}) "
                f"{cell['ranked_ms']} ms, bound {cell['ranked_bound_ms']} ms"
                + ("" if cell["ranked_ms"] else
                   f" (ranked: more than {GRID_WIDE_BYTES >> 30} GiB)"))
            del dest, valid, aux
            torch.cuda.empty_cache()
    wide = next(c for c in scatter if c["s"] == 8 and c["n"] == e_max)
    r = rows["bucket_scatter"]
    r["ranked_ms"], r["ranked_bound_ms"] = wide["ranked_ms"], \
        wide["ranked_bound_ms"]
    r["ranked_shape"] = {"s": 8, "n": e_max, "d": WIDE_D, "k": 1,
                         "cap": wide["cap"]}

    s, m = GRID_STREAM
    stream = torch.cuda.current_stream(device).cuda_stream
    lib = library("route")
    reduce = []
    for n_local in GRID_LOCALS:
        q = torch.randint(0, n_local, (s, m), generator=gen, device=device,
                          dtype=torch.int32)
        slot = torch.where(torch.rand(s, m, generator=gen, device=device)
                           < 0.5, -1, q).to(torch.int32)
        del q
        val = torch.randint(-9, 10, (s, m), generator=gen,
                            device=device).float()
        su, vu = off_alignment(slot), off_alignment(val)
        plan = route.private_plan(s, m, n_local)
        fits = plan.smem_bytes <= route.SMEM_LIMIT
        cell = {"s": s, "m": m, "n_local": n_local,
                "bound_ms": bound_ms(s * m * 8 + s * n_local * 4)}
        for op in ("add", "min"):
            want = route.plain_reduce_received(slot, val, n_local, op)
            route.reset_launches()
            if not torch.equal(route.reduce_received(su, vu, n_local, op),
                               want):
                raise AssertionError(f"grid: atomic {op} differs at "
                                     f"n_local {n_local}")
            cell[f"atomic_{op}_ms"] = cuda_ms(lambda: route.reduce_received(
                su, vu, n_local, op), 3)
            ran_only(route.PATHS["reduce_received"], "atomic",
                     "reduce_received")
            if not fits:
                cell[f"private_{op}_ms"] = None
                continue
            y = torch.empty(s, n_local, device=device)

            def private():
                err = lib.dcra_reduce_received(
                    slot.data_ptr(), val.data_ptr(), s, m, n_local,
                    route.REDUCE_OPS.index(op), y.data_ptr(),
                    as_c(plan, route.PATH_CODES["reduce_received"]["private"]),
                    stream)
                if err:
                    raise RuntimeError(f"private reduce: CUDA error {err}")
            private()
            if not torch.equal(y, want):
                raise AssertionError(f"grid: private {op} differs at "
                                     f"n_local {n_local}")
            cell[f"private_{op}_ms"] = cuda_ms(private, 3)
        reduce.append(cell)
        log(f"grid reduce_received S={s} M={m} n_local={n_local}: add "
            f"private {cell['private_add_ms']} ms, atomic "
            f"{cell['atomic_add_ms']:.4f} ms; min private "
            f"{cell['private_min_ms']} ms, atomic {cell['atomic_min_ms']:.4f} "
            f"ms; bound {cell['bound_ms']:.4f} ms"
            + ("" if fits else " (private: one copy does not fit a block)"))
        del slot, val, su, vu
    torch.cuda.empty_cache()
    rows["bucket_scatter"]["grid"] = scatter
    rows["reduce_received"]["grid"] = reduce
    return scatter, reduce


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


def host_oracles_start(g):
    """Phases 5, 6 and 12's numpy work on RMAT-22 (the PageRank oracle;
    SpMV's oracle, bounds and task stream; the packing onto one shard)
    started in a process of its own (``--host-oracles``), so that it runs
    while the card runs phases 2-11. Writes ``g`` for it into ``build/host_oracles``; returns ``(process,
    directory)`` for :func:`host_oracle`."""
    import numpy as np
    out_dir = ROOT / "build" / "host_oracles"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    for k in ("row_ptr", "col_idx", "values"):
        np.save(out_dir / f"g_{k}.npy", getattr(g, k))
    with open(out_dir / "log.txt", "w") as f:
        proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--host-oracles",
             str(out_dir)], stdout=f, stderr=subprocess.STDOUT,
            cwd=str(ROOT))
    CHILDREN.append(proc)
    return proc, out_dir


def host_result(oracles, name, suffix, wait=600):
    """The path of ``name`` + ``suffix`` from the ``--host-oracles``
    process and the seconds it took there, once it is written; fails if
    the process failed or took longer than ``wait`` seconds."""
    proc, out_dir = oracles
    path = out_dir / f"{name}{suffix}"
    deadline = time.perf_counter() + wait
    while not path.exists():
        if proc.poll() not in (None, 0) or time.perf_counter() > deadline:
            proc.kill()
            raise AssertionError(
                f"--host-oracles (rc {proc.poll()}) gave no {name}:\n"
                + (out_dir / "log.txt").read_text()[-3000:])
        time.sleep(0.2)
    return path, json.loads((out_dir / f"{name}.json").read_text())


def host_oracle(oracles, name):
    """``name``'s array from the ``--host-oracles`` process and the seconds
    it took there (:func:`host_result`)."""
    import numpy as np
    path, seconds = host_result(oracles, name, ".npy")
    return np.load(path), seconds


def host_oracles_worker(out_dir):
    """``--host-oracles DIR``: loads the graph :func:`host_oracles_start`
    wrote and writes, each as soon as it is done (renamed into place, its
    seconds beside it): ``ref.pagerank_ref``; for SpMV's ``x`` (drawn as
    :func:`run_spmv` draws it) ``ref.spmv_ref``, :func:`spmv_bounds` and
    ``spmv_task_stream`` onto 64 shards; then ``_graph_setup(g, 1)``;
    last, phase 14's ``autoconfigure(g, "bfs")``, pickled. Numpy only: it
    never touches the card."""
    import pickle
    import numpy as np
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.dse.autoconfig import autoconfigure
    from repro_torch.sparse import ref
    from repro_torch.sparse.csr import CSR
    from repro_torch.sparse.program import _graph_setup
    from repro_torch.sparse.torch_apps import spmv_task_stream
    out_dir = Path(out_dir)
    g = CSR(*(np.load(out_dir / f"g_{k}.npy")
              for k in ("row_ptr", "col_idx", "values")))

    def put(name, a, t0):
        np.save(out_dir / f"{name}.part.npy", a)
        (out_dir / f"{name}.json").write_text(
            json.dumps(time.perf_counter() - t0))
        os.replace(out_dir / f"{name}.part.npy", out_dir / f"{name}.npy")
    t0 = time.perf_counter()
    put("pagerank", ref.pagerank_ref(g), t0)
    x = spmv_x(g)
    t0 = time.perf_counter()
    put("spmv_y", ref.spmv_ref(g, x), t0)
    t0 = time.perf_counter()
    tol_oracle, tol_runs = spmv_bounds(g, x)
    put("spmv_tol_oracle", tol_oracle, t0)
    put("spmv_tol_runs", tol_runs, t0)
    t0 = time.perf_counter()
    dest, vals = spmv_task_stream(g, x, 64)
    put("spmv_vals", vals, t0)
    put("spmv_dest", dest, t0)
    del dest, vals
    t0 = time.perf_counter()
    n_local, src_slot, dst, w, e_max = _graph_setup(g, 1)
    for k, a in (("src_slot", src_slot), ("dst", dst), ("w", w)):
        put(f"setup1_{k}", a, t0)
    put("setup1", np.array([n_local, e_max]), t0)
    del src_slot, dst, w
    t0 = time.perf_counter()
    lc = autoconfigure(g, "bfs")
    (out_dir / "auto_bfs.part").write_bytes(pickle.dumps(lc))
    (out_dir / "auto_bfs.json").write_text(
        json.dumps(time.perf_counter() - t0))
    os.replace(out_dir / "auto_bfs.part", out_dir / "auto_bfs.pkl")
    return 0


def host_autoconfig(oracles):
    """Phase 14's flat ``autoconfigure(g, "bfs")`` on RMAT-22 from the
    ``--host-oracles`` process (it ran beside phases 2-13) and the host
    seconds it took there (:func:`host_result`)."""
    import pickle
    path, seconds = host_result(oracles, "auto_bfs", ".pkl")
    return pickle.loads(path.read_bytes()), seconds


def host_setup1(oracles):
    """``_graph_setup(g, 1)`` from the ``--host-oracles`` process and the
    seconds it took there."""
    (n_local, e_max), seconds = host_oracle(oracles, "setup1")
    return ((int(n_local),) + tuple(host_oracle(oracles, f"setup1_{k}")[0]
                                    for k in ("src_slot", "dst", "w"))
            + (int(e_max),)), seconds


def spmv_x(g):
    """Phase 6's dense vector, from the seed."""
    import numpy as np
    return np.random.default_rng(SEED).random(g.n)


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


def run_pagerank(g, setup, device, totals, oracles):
    import numpy as np
    import torch
    from repro_torch.core.fabric import Fabric
    from repro_torch.sparse.options import LaunchOptions
    from repro_torch.sparse.torch_apps import dcra_pagerank
    t0 = time.perf_counter()
    want, t_ref = host_oracle(oracles, "pagerank")
    t_wait = time.perf_counter() - t0
    fab = Fabric.fake(64, device=device)
    opts = LaunchOptions(capacity_factor=4.0)
    torch.cuda.reset_peak_memory_stats()
    with MainPath("PageRank flat 64", ROUTE_KERNELS, totals,
                  STAGED_ATOMIC) as path:
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
        f"{err_plain:.3e}; oracle {t_ref:.2f} s (numpy, beside phases 2-5; "
        f"waited {t_wait:.2f} s for it); launches "
        f"{path.launches}, route designs {path.paths}")
    log(f"pagerank flat 64: every vertex within its float32 error bound "
        f"(median bound / rank {float(np.median(bound / want)):.3e}, "
        f"computed in {t_bound:.2f} s); worst |err| / bound: oracle "
        f"{w_oracle:.3e}, plain-torch path {w_plain:.3e}")
    log_profile("pagerank flat 64", per_round, device_ms, wall_ms, top)
    return rank, st, bound


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


def run_spmv(g, device, totals, oracles):
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core.fabric import Fabric
    from repro_torch.sparse.options import LaunchOptions
    from repro_torch.sparse.program import run_program
    from repro_torch.sparse.torch_apps import SPMV, dcra_spmv
    x = spmv_x(g)
    want, _ = host_oracle(oracles, "spmv_y")
    tol_oracle, _ = host_oracle(oracles, "spmv_tol_oracle")
    tol_runs, _ = host_oracle(oracles, "spmv_tol_runs")
    dest, stream_s = host_oracle(oracles, "spmv_dest")
    vals, _ = host_oracle(oracles, "spmv_vals")

    def built_stream(data, params, n_dev, seed):
        # the plain runs route the stream dcra_spmv builds (64 shards,
        # seed 0), built once beside phases 2-5
        if n_dev != 64 or seed != 0:
            raise ValueError("the stream was built for 64 shards, seed 0")
        return dest, vals, g.n
    spmv_built = dataclasses.replace(SPMV, stream=built_stream)
    for layout, fab, opts in [
            ("flat 64", Fabric.fake(64, device=device),
             LaunchOptions(capacity_factor=2.0)),
            ("pod 8x8", Fabric.virtual((8, 8), ("pod", "data"),
                                       device=device),
             LaunchOptions(pod_axis="pod", capacity_factor=2.0))]:
        torch.cuda.reset_peak_memory_stats()
        with MainPath(f"SpMV {layout}", ROUTE_KERNELS, totals,
                      {"bucket_scatter": "staged"}) as path:
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
        plain, pst = run_program(spmv_built, (g, x), fab, dataset=g,
                                 options=opts.with_(route_impl="sort"))
        pdrops = pst.total_drops
        err_plain = rel_err(y, plain.astype(np.float64))
        if pdrops or not err_plain < 1e-4:
            raise AssertionError(f"SpMV {layout}: kernel path off the "
                                 f"plain-torch path by {err_plain}")
        w_plain = held_to(f"SpMV {layout} vs the plain-torch path", y, plain,
                          tol_runs)
        log(f"spmv rmat-{SCALE} {layout}: drops=0 stream build {stream_s:.2f} s "
            f"(numpy, beside phases 2-5) run_s={run_s:.4f} (stream build included) "
            f"nnz/s={g.nnz / run_s:.4e} peak_mem_gb={peak_gb:.2f} "
            f"max|err|/max|y|: oracle {err:.3e}, plain-torch path "
            f"{err_plain:.3e}; every row within its float32 bound, worst "
            f"|err| / bound: oracle {w_oracle:.3e}, plain-torch path "
            f"{w_plain:.3e}; launches {path.launches}, route designs "
            f"{path.paths}")


def run_histogram(els, device, totals):
    import numpy as np
    import torch
    from repro_torch.core.fabric import Fabric
    from repro_torch.sparse import ref
    from repro_torch.sparse.options import LaunchOptions
    from repro_torch.sparse.torch_apps import dcra_histogram
    want = ref.histogram_ref(els, HIST_BINS)
    for layout, fab, opts, need, designs in [
            ("1 shard", Fabric.fake(1, device=device), None, ("histogram",),
             None),
            ("flat 64", Fabric.fake(64, device=device), None, ROUTE_KERNELS,
             STAGED_PRIVATE),
            # stage 2 of the pod path holds n_intra * cap1 * factor slots a
            # shard: factor 1.25 keeps it at 0.4e9 slots (2.0: 1.1e9)
            ("pod 8x8", Fabric.virtual((8, 8), ("pod", "data"),
                                       device=device),
             LaunchOptions(pod_axis="pod", capacity_factor=1.25),
             ROUTE_KERNELS, STAGED_PRIVATE)]:
        torch.cuda.reset_peak_memory_stats()
        with MainPath(f"histogram {layout}", need, totals,
                      designs) as path:
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
            f"{path.launches}" + (f", route designs {path.paths}" if designs
                                  else ""))


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
    ran_only(spmv.PATHS, "split", "bsr_spmv")
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

BUCKET_KERNELS = ("bucket_scatter",)
STAGED = {"bucket_scatter": "staged"}


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
        with MainPath(f"MoE {label}", BUCKET_KERNELS, totals,
                      STAGED) as path:
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
        with MainPath(f"MoE {label} no-drop", BUCKET_KERNELS, totals,
                      STAGED) as path:
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
        with MainPath(f"MoE {label} skewed", BUCKET_KERNELS, totals,
                      STAGED) as path:
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
    non-causal, a ragged S, hd off 16 and 128, hd 64 / 96 / 112 / 128 at S
    128 / 256 / 300 / 1024 in bf16 (wgmma), float32 at hd 4 / 80 / 100 /
    112 / 128, S 1,
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
        ran_only(moe_gmm.PATHS, design, "gmm")
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
            ran_only(moe_gmm.PATHS, design, "gmm")
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
        (2, 1024, 64, bf16, True, "wgmma"), (1, 1, 8, bf16, True, "wgmma"),
        # zamba2's shared block: hd 112 (a 224-byte TMA row, 16 zero
        # columns padding it to 128 on wgmma)
        (2, 300, 112, f32, True, "blocked"), (2, 256, 112, f32, False,
                                              "blocked"),
        (2, 300, 112, bf16, True, "wgmma"), (2, 256, 112, bf16, False,
                                             "wgmma")]
    for bh, s, hd, dt, causal, design in flash_cases:
        q, k, v = (rand(bh, s, hd, dtype=dt) for _ in range(3))
        if design == "simt" and dt == f32 and hd % 4 == 0:
            q, k, v = (torch.zeros(t.numel() + 1, device=device)[1:].copy_(
                t.reshape(-1)).view(t.shape) for t in (q, k, v))
        flash.reset_launches()
        _, ratio, share = flash_check(flash, q, k, v, causal)
        ran_only(flash.PATHS, design, "flash_attention")
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
    """Each design of the bucket rank, the bucket scatter, the reduce, gmm,
    flash attention and the BSR SpMV launched through its C entry point with its own
    launch plan (must succeed) and with each field of that plan altered
    (must be refused, nothing launched): :data:`PLAN_DESIGNS` designs, 7
    fields each. Returns the count refused."""
    import torch
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import moe_gmm, route, spmv
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
    s, n, nb, cap = 2, 5000, 4, 3000
    ints = torch.zeros(2, s, n, dtype=torch.int32, device=device)
    valid = torch.ones(s, n, dtype=torch.bool, device=device)
    plan = route.bucket_rank_plan(s, n, nb)
    status = torch.empty(route.rank_scratch_ints(plan), dtype=torch.int32,
                         device=device)
    pos = torch.empty(s, n, dtype=torch.int32, device=device)
    each(plan, route.PATH_CODES["bucket_rank"][plan.path],
         lambda c: library("route").dcra_bucket_rank(
             ints[0].data_ptr(), valid.data_ptr(), s, n, nb,
             status.data_ptr(), pos.data_ptr(), c, stream),
         f"bucket_rank {plan.path}")
    slots = torch.empty(1, s, nb * cap, dtype=torch.int32, device=device)
    task_slot = torch.empty(s, n, dtype=torch.int32, device=device)
    n_drop = torch.empty(s, dtype=torch.int32, device=device)
    scratch = torch.empty(s * (2 + 1) * nb, dtype=torch.int32, device=device)
    for d in (1, WIDE_D):                   # staged, ranked
        x = torch.ones(s, n, d, device=device)
        xb = torch.empty(s, nb * cap, d, device=device)
        plan = route.bucket_scatter_plan(s, n, d, 1, nb, cap)
        each(plan, route.PATH_CODES["bucket_scatter"][plan.path],
             lambda c: library("route").dcra_bucket_scatter(
                 x.data_ptr(), ints[0].data_ptr(), valid.data_ptr(),
                 ints[1].data_ptr(), ints[0].data_ptr(), s, n, d, 1, nb, cap,
                 xb.data_ptr(), slots.data_ptr(), task_slot.data_ptr(),
                 n_drop.data_ptr(), scratch.data_ptr(), c, stream),
             f"bucket_scatter {plan.path}")
    y = torch.empty(s, 64, device=device)
    for aligned in (True, False):
        plan = route.reduce_received_plan(s, n, 64, aligned)
        each(plan, route.PATH_CODES["reduce_received"][plan.path],
             lambda c: library("route").dcra_reduce_received(
                 ints[0].data_ptr(), x.data_ptr(), s, n, 64, 0, y.data_ptr(),
                 c, stream),
             f"reduce_received {plan.path}")
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
    ran_only(flash.PATHS, "simt", "flash_attention")
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


# ---------------------------------------------------------------------------
# phase 12: pipelined rounds against lockstep on RMAT-22
# ---------------------------------------------------------------------------

#: what one shard's pipelined BFS launches: the rank kernel and the reduce
#: (``local_route_reduce``), never the scatter
FOLD_KERNELS = ("bucket_rank", "reduce_received")
FOLD_DESIGNS = {"bucket_rank": "lookback", "reduce_received": "atomic"}


def timed_launches(run, reps=3):
    """Host seconds of ``reps`` synchronised runs of ``run``."""
    import torch
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def mode_report(tag, run, rounds, work, unit):
    """Best of 3 host-clock runs of ``run`` (``work`` units each) and one
    profiled run: device ms a round, busy share, the host-to-card copies
    by source memory, the host's blocking reads a round (counted in the
    profiled run)."""
    from repro_torch.sparse import program
    times = timed_launches(run)
    copies = {}
    program.reset_host_reads()
    per_round, device_ms, wall_ms, top = profile_kernels(run, rounds,
                                                         copies)
    reads = program.HOST_READS["reads"]
    busy = device_ms / wall_ms if wall_ms else 0.0
    log(f"{tag}: {unit} {work / min(times):.4e} (best of 3, run_s "
        f"{[round(t, 4) for t in times]}); profiled run: device "
        f"{device_ms / max(rounds, 1):.4f} ms a round, busy {busy:.3f}, "
        f"host-to-card copies "
        + (", ".join(f"{k} {v:.2f} ms" for k, v in sorted(copies.items()))
           or "none listed")
        + f", blocking host reads {reads / max(rounds, 1):.3f} a round "
        f"({reads} in {rounds} rounds) [{SMI}]")
    log_profile(tag, per_round, device_ms, wall_ms, top)


def same_run(tag, a, b):
    """Two graph-program runs with the same states (bit for bit), rounds
    and per-round message and drop counts."""
    import numpy as np
    (sa, ta), (sb, tb) = a, b
    if not (all(np.array_equal(x, y) for x, y in zip(sa, sb))
            and ta.rounds == tb.rounds
            and np.array_equal(ta.messages, tb.messages)
            and np.array_equal(ta.drops, tb.drops)):
        raise AssertionError(f"{tag}: pipelined differs from lockstep")


def copy_report(setup, device):
    """One launch's edge arrays onto the card, best of 3 on the host clock
    (synchronised): a pageable ``.to(device)`` (the launch before pinned
    staging) against ``program._to_device`` (the host memcpy into pinned
    memory and the non-blocking copy); and the non-blocking copy from
    pinned memory alone by CUDA events. The profiler misses copies in
    some runs (``PERF.md`` §7); this does not depend on it."""
    import torch
    from repro_torch.sparse import program
    arrays = setup[1:4]
    n_bytes = sum(a.nbytes for a in arrays)

    def best(fn):
        return min(timed_launches(fn)) * 1e3
    pageable = best(lambda: [torch.from_numpy(a).to(device)
                             for a in arrays])
    staged = best(lambda: program._to_device(arrays, device))
    pins = program._to_device(arrays, device)[1]
    dma = cuda_ms(lambda: [p.to(device, non_blocking=True) for p in pins], 3)
    log(f"host-to-card copy of one launch's edges ({n_bytes} B): pageable "
        f".to(device) {pageable:.2f} ms; pinned staging {staged:.2f} ms "
        f"(host memcpy and copy), of which the copy from pinned memory "
        f"{dma:.2f} ms (CUDA events, {n_bytes / dma / 1e6:.1f} GB/s) "
        f"[{SMI}]")


def rank_at_fold(route, setup1, want, device):
    """``bucket_rank`` at the shape its path gives it, one shard's
    pipelined BFS: every edge of RMAT-22 on one shard, one bucket, the
    active tasks of BFS's busiest round (the edges whose source is one
    hop from the root). Bit-identical to the plain version and over two
    runs, on the lookback design; its row's times, bound and the nearest
    library call, ``torch.cumsum(valid, 1, dtype=torch.int32)`` (an
    inclusive scan: the exclusive rank is one subtraction more)."""
    import torch
    _, src_slot, dst, _, e_max = setup1
    dest = torch.zeros(1, e_max, dtype=torch.int32, device=device)
    hop = torch.from_numpy(want == 1).to(device)
    valid = ((hop[torch.from_numpy(src_slot).to(device).long()])
             & (torch.from_numpy(dst).to(device) >= 0)).view(1, e_max)
    route.reset_launches()
    got = route.bucket_rank(dest, valid, 1)
    plain = route.plain_bucket_rank(dest, valid, 1)
    if not (torch.equal(got, plain)
            and torch.equal(route.bucket_rank(dest, valid, 1), got)):
        raise AssertionError("bucket_rank at one shard's BFS round differs "
                             "from its plain version or between two runs")
    del got, plain
    active = int(valid.sum())
    out = {"ms": cuda_ms(lambda: route.bucket_rank(dest, valid, 1), 5),
           "plain_ms": cuda_ms(lambda: route.plain_bucket_rank(dest, valid,
                                                                1), 2),
           "library_ms": cuda_ms(
               lambda: torch.cumsum(valid, 1, dtype=torch.int32), 5),
           "bound_ms": bound_ms(e_max * (4 + 1 + 4)), "max_abs_err": 0.0}
    ran_only(route.PATHS["bucket_rank"], "lookback", "bucket_rank")
    log(f"kernel bucket_rank at one shard's BFS round (S=1 N={e_max}, 1 "
        f"bucket, {active} active): lookback {out['ms']:.4f} ms "
        f"({out['ms'] / out['bound_ms']:.3f}x its bound), plain "
        f"{out['plain_ms']:.4f} ms (no yardstick), cumsum "
        f"{out['library_ms']:.4f} ms, bound {out['bound_ms']:.4f} ms "
        f"({e_max * 9} B / 3.35 TB/s); bit-identical to the plain version "
        f"and over two runs [{SMI}]")
    reduce_at_fold(route, want, src_slot, dst, valid, device)
    torch.cuda.empty_cache()
    return out


def reduce_at_fold(route, want, src_slot, dst, valid, device):
    """``reduce_received`` at the shape the fold gives it in the same
    round: S 1, n_local = n, every edge an entry, the inactive ones at
    slot -1, the values BFS's payload (the source's distance + 1, after
    round 1). Min: bit-identical to the plain version; the kernel's and
    the plain version's times and the bound, logged."""
    import torch
    e_max, n = valid.shape[1], want.shape[0]
    hops = torch.from_numpy(want).to(device)
    dist = torch.where((hops >= 0) & (hops <= 1), hops.float(), float("inf"))
    vals = (dist[torch.from_numpy(src_slot).to(device).long()] + 1.0
            ).view(1, e_max)
    seg = torch.where(valid, torch.from_numpy(dst).to(device).view(1, e_max),
                      -1).to(torch.int32)
    del hops, dist
    plan = route.reduce_received_plan(1, e_max, n)
    got = route.reduce_received(seg, vals, n, "min")
    plain = route.plain_reduce_received(seg, vals, n, "min")
    if not torch.equal(got, plain):
        raise AssertionError("reduce_received at one shard's BFS round "
                             "differs from its plain version")
    del got, plain
    ms = cuda_ms(lambda: route.reduce_received(seg, vals, n, "min"), 5)
    plain_ms = cuda_ms(lambda: route.plain_reduce_received(seg, vals, n,
                                                           "min"), 2)
    n_bytes = e_max * 8 + n * 4
    log(f"kernel reduce_received (min, {plan.path}) at one shard's BFS "
        f"round (S=1 M={e_max}, n_local {n}, {int(valid.sum())} live): "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound_ms(n_bytes):.4f} ms ({n_bytes} B / 3.35 TB/s); "
        f"bit-identical to the plain version [{SMI}]")


def run_pipelined(g, root, want, setup, device, totals, pagerank,
                  packed1=None):
    """Phase 12: BFS on RMAT-22 in lockstep and pipelined rounds, flat 64,
    pod 8 x 8 and one shard (``fold_local``), bit-identical; PageRank
    flat 64, 20 rounds, the same message and drop streams and ranks
    within phase 5's float32 bound (twice it: both sides carry one) of
    lockstep. Each mode once more for its rates, copies and reads.
    ``packed1`` is ``(_graph_setup(g, 1), seconds)`` packed elsewhere
    (:func:`host_setup1`), or packed here. Returns the rank kernel's
    times at the one-shard path's shape (:func:`rank_at_fold`)."""
    import numpy as np
    from repro_torch.core.fabric import Fabric
    from repro_torch.sparse import program
    from repro_torch.sparse.options import LaunchOptions
    from repro_torch.sparse.torch_apps import BFS, PAGERANK
    reached = int(g.degrees()[want >= 0].sum())
    copy_report(setup, device)
    given = packed1 is not None
    if not given:
        t0 = time.perf_counter()
        packed1 = program._graph_setup(g, 1), time.perf_counter() - t0
    setup1, pack_s = packed1
    log(f"pipelined: pack onto 1 shard {pack_s:.2f} s (numpy"
        + (", beside phases 2-11" if given else "")
        + f") (E_max {setup1[-1]})")
    for layout, fab, opts, stp in [
            ("flat 64", Fabric.fake(64, device=device),
             LaunchOptions(capacity_factor=4.0), setup),
            ("pod 8x8", Fabric.virtual((8, 8), ("pod", "data"),
                                       device=device),
             LaunchOptions(pod_axis="pod", capacity_factor=2.0), setup),
            ("1 shard", Fabric.fake(1, device=device),
             LaunchOptions(capacity_factor=4.0), setup1)]:
        runs = {}
        for mode in ("lockstep", "pipelined"):
            o = opts.with_(round_mode=mode)

            def run(o=o, fab=fab, stp=stp):
                return program.run_program(BFS, g, fab, options=o,
                                           params={"root": root}, setup=stp)
            fold = layout == "1 shard" and mode == "pipelined"
            with MainPath(f"BFS {layout} {mode}",
                          FOLD_KERNELS if fold else ROUTE_KERNELS, totals,
                          FOLD_DESIGNS if fold else STAGED_ATOMIC) as path:
                runs[mode] = run()
            if fold and path.launches["bucket_scatter"]:
                raise AssertionError(f"BFS 1 shard pipelined: the scatter "
                                     f"ran ({path.launches})")
            (dist,), st = runs[mode]
            if not np.array_equal(np.where(np.isfinite(dist), dist, -1),
                                  want) or st.total_drops:
                raise AssertionError(f"BFS {layout} {mode}: differs from "
                                     f"the oracle or dropped")
            log(f"bfs {layout} {mode}: rounds {st.rounds}, launches "
                f"{path.launches}, route designs {path.paths}")
            mode_report(f"bfs {layout} {mode}", run, st.rounds, reached,
                        "TEPS")
        same_run(f"BFS {layout}", runs["lockstep"], runs["pipelined"])
        log(f"bfs {layout}: pipelined bit-identical to lockstep (states, "
            f"rounds, message and drop streams)")
    from repro_torch.kernels import route
    rank_row = rank_at_fold(route, setup1, want, device)
    del setup1
    rank_l, st_l, bound = pagerank
    fab = Fabric.fake(64, device=device)

    def pagerank_run(mode):
        opts = LaunchOptions(capacity_factor=4.0, round_mode=mode)
        return lambda: program.run_program(
            PAGERANK, g, fab, options=opts,
            params={"damping": 0.85, "iters": 20}, setup=setup)
    with MainPath("PageRank flat 64 pipelined", ROUTE_KERNELS, totals,
                  STAGED_ATOMIC) as path:
        (rank, _, _), st = pagerank_run("pipelined")()
    if not (st.rounds == st_l.rounds == 20
            and np.array_equal(st.messages, st_l.messages)
            and np.array_equal(st.drops, st_l.drops)):
        raise AssertionError("PageRank pipelined: streams differ from "
                             "lockstep")
    worst = held_to("PageRank pipelined vs lockstep", rank, rank_l,
                    2 * bound)
    log(f"pagerank flat 64 pipelined: message and drop streams equal to "
        f"lockstep's, every vertex within twice its float32 bound of "
        f"lockstep's rank (worst |err| / bound {worst:.3e}); launches "
        f"{path.launches}")
    for mode in ("lockstep", "pipelined"):
        mode_report(f"pagerank flat 64 {mode}", pagerank_run(mode), 20,
                    g.nnz * 20, "edges*iters/s")
    return rank_row


# ---------------------------------------------------------------------------
# phase 13: the server on the card
# ---------------------------------------------------------------------------

SERVE_SCALE = 20                   # RMAT scale of the resident graph
SERVE_REQUESTS, SERVE_WIDTH, SERVE_TENANTS = 32, 4, 4
SERVE_SAMPLES = 8                  # responses held to standalone runs
SERVE_PROFILED = 16                # requests of the profiled pass


def serve_requests(n_vertices):
    """The stream: ``SERVE_REQUESTS`` requests from ``SERVE_TENANTS``
    tenants, BFS and SSSP in turns of one request a tenant (so FIFO
    fills every batch), roots from a seeded numpy generator."""
    import numpy as np
    from repro_torch.serve import Request
    roots = np.random.default_rng(SEED).integers(0, n_vertices,
                                                 SERVE_REQUESTS)
    return [Request(i, f"tenant{i % SERVE_TENANTS}",
                    "bfs" if (i // SERVE_TENANTS) % 2 == 0 else "sssp",
                    f"rmat{SERVE_SCALE}", root=int(roots[i]))
            for i in range(SERVE_REQUESTS)]


def quantile(xs, q):
    """Nearest-rank quantile, as ``repro_torch.serve.stats``."""
    s = sorted(xs)
    return s[min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))]


def serve_pass(tag, srv, reqs, totals, width):
    """One pass of the stream through ``srv`` on a path of its own:
    responses, the cache deltas and the host seconds."""
    import torch
    from repro_torch.sparse import program
    c0 = program.cache_stats()
    with MainPath(tag, ROUTE_KERNELS, totals, STAGED_ATOMIC) as path:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        resps = srv.run(reqs)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
    c1 = program.cache_stats()
    delta = {k: c1[k] - c0[k] for k in c0}
    srv.stats.verify()
    bad = [r for r in resps if r.status != "ok"]
    if bad or delta["misses"] or delta["kernel_traces"]:
        raise AssertionError(f"{tag}: {len(bad)} responses not ok "
                             f"({bad[:1]}), cache {delta}")
    drops = sum(r.batch_drops for r in resps)
    if drops or srv.stats.noc_drops:
        raise AssertionError(f"{tag}: {drops} drops")
    lat = [r.latency_s for r in resps]
    rounds = sorted({r.rounds for r in resps})
    log(f"{tag}: {len(reqs)} requests in {wall:.4f} s, requests/s "
        f"{len(reqs) / wall:.4e}, latency p50 {quantile(lat, 0.5):.4f} s "
        f"p99 {quantile(lat, 0.99):.4f} s, {srv.stats.launches} launches of "
        f"width {width} at inflight depth "
        f"{srv.serve_options.inflight_depth}, rounds "
        f"{rounds[0]}-{rounds[-1]}, cache {delta}, no drop, stats verified; "
        f"peak card memory above the resident graph {peak} B; launches "
        f"{path.launches} [{SMI}]")
    return resps, wall


def run_server(device, totals):
    """Phase 13: RMAT-20 resident on 64 shards behind a ``ProgramServer``
    of batch width 4 (the product graph: 4 * 2^20 vertices), the
    request stream served in lockstep, pipelined, with donated buffers
    and in lockstep with three launches in flight: pre-warm keys, no build and no drop under load, the stats
    ledger, sampled responses bit-identical to standalone
    ``run_program`` runs (outside the timed passes); requests/s, p50/p99
    latency and, from a profiled pass over the first requests, the busy
    share. Then one ``MoEService`` dispatch of OLMoE-1B-7B at full
    width against a direct ``moe_dcra`` call."""
    import numpy as np
    import torch
    from repro_torch.core.fabric import Fabric
    from repro_torch.serve import (ProgramServer, ServeOptions,
                                   tenant_graph)
    from repro_torch.sparse import datasets, program
    from repro_torch.sparse.options import LaunchOptions
    from repro_torch.sparse.torch_apps import BFS, SSSP
    t0 = time.perf_counter()
    g = datasets.rmat(SERVE_SCALE, seed=SEED)
    t_gen = time.perf_counter() - t0
    tg = tenant_graph(g, SERVE_WIDTH)
    log(f"serve rmat-{SERVE_SCALE}: n={g.n} nnz={g.nnz}, product graph of "
        f"width {SERVE_WIDTH}: n={tg.n} nnz={tg.nnz}; generate "
        f"{t_gen:.2f} s, expand {time.perf_counter() - t0 - t_gen:.2f} s")
    fab = Fabric.fake(64, device=device)
    name = f"rmat{SERVE_SCALE}"
    reqs = serve_requests(g.n)
    passes = {}
    # one resident packing of the product graph for the four servers (the
    # same graph, fabric and seed): the first pre-warm packs it
    resident = {}
    # the depth-3 pass shares the lockstep pass's keys: its pre-warm
    # adds none
    for tag, opts, so, n_new in [
            ("lockstep", LaunchOptions(), ServeOptions(), 1),
            ("pipelined", LaunchOptions(round_mode="pipelined"),
             ServeOptions(), 1),
            ("donated", LaunchOptions(), ServeOptions(donate_buffers=True),
             1),
            ("lockstep depth 3", LaunchOptions(),
             ServeOptions(inflight_depth=3), 0)]:
        srv = ProgramServer(fab, {name: g}, batch_width=SERVE_WIDTH,
                            options=opts, serve_options=so)
        shared = bool(resident)
        srv._resident.update(resident)
        t0 = time.perf_counter()
        keys0 = set(program.cache_keys())
        warm = srv.prewarm(("bfs", "sssp"))
        new = set(program.cache_keys()) - keys0
        want_keys = {(p, name): n_new for p in ("bfs", "sssp")}
        if ({k: len(v) for k, v in warm.items()} != want_keys
                or len(new) != 2 * n_new
                or set().union(*map(set, warm.values())) != new):
            raise AssertionError(f"serve {tag}: pre-warm added {len(new)} "
                                 f"keys, by class {warm}")
        resident = srv._resident
        log(f"serve {tag}: pre-warm {time.perf_counter() - t0:.2f} s (the "
            f"resident packing "
            f"{'shared from the first server' if shared else 'included'}), "
            f"{n_new} new key each for bfs and sssp")
        passes[tag], wall = serve_pass(f"serve {tag}", srv, reqs, totals,
                                       SERVE_WIDTH)
        if tag == "lockstep":
            # one profiled pass: the four passes' busy shares lay within
            # 0.471-0.507 (chip run B, PR 25)
            rate = len(reqs) / wall
            _, device_ms, wall_ms, top = profile_kernels(
                lambda: srv.run(reqs[:SERVE_PROFILED]), 1)
            log(f"serve {tag}: profiled pass over {SERVE_PROFILED} "
                f"requests: device {device_ms:.2f} ms of {wall_ms:.2f} ms "
                f"(busy {device_ms / wall_ms if wall_ms else 0.0:.3f}); "
                f"costliest device ops (ms): "
                + "; ".join(f"{op} {ms:.2f}" for op, ms in top)
                + f" [{SMI}]")
            srv.stats.verify()
        del srv
    base = [r.result for r in passes["lockstep"]]
    for tag in ("pipelined", "donated", "lockstep depth 3"):
        if not all(np.array_equal(a, r.result)
                   for a, r in zip(base, passes[tag])):
            raise AssertionError(f"serve {tag}: responses differ from the "
                                 f"lockstep pass")
    setup = program._graph_setup(g, 64)
    picks = range(0, SERVE_REQUESTS, SERVE_REQUESTS // SERVE_SAMPLES)
    for i in picks:
        r = reqs[i]
        (d,), _ = program.run_program(BFS if r.program == "bfs" else SSSP,
                                      g, fab, params={"root": r.root},
                                      setup=setup)
        if not np.array_equal(d, base[i]):
            raise AssertionError(f"serve: response {i} differs from its "
                                 f"standalone run")
    log(f"serve: the pipelined, donated and depth-3 passes equal the "
        f"lockstep pass "
        f"response by response; responses {list(picks)} bit-identical to "
        f"standalone run_program runs of their roots")
    del setup, passes
    torch.cuda.empty_cache()
    run_moe_service(device, totals)
    # phase 20 serves the same graph from the same packing
    return base[:SERVE_OUT_REQUESTS], rate, g, resident


def run_moe_service(device, totals):
    """One ``MoEService`` dispatch through a ``ProgramServer``: 8 requests
    of [2048, 2048] tokens (x [8, 2048, 2048], the config's capacity
    factor) on the fused packaging, against a direct ``moe_dcra`` call on
    the same weights within 1e-5 of max|out| (the combine adds in any
    order)."""
    import torch
    from repro_torch.core.dispatch import MeshInfo, moe_dcra
    from repro_torch.core.fabric import Fabric
    from repro_torch.serve import MoEService, ProgramServer, Request
    cfg, params, x = moe_setup(device)
    label, shape, names, kw = MOE_PACKAGINGS[0]
    info = MeshInfo(Fabric.virtual(shape, names, device=device), **kw)
    svc = MoEService(cfg, params, info, batch=MOE_TOKENS[0],
                     seq=MOE_TOKENS[1])
    srv = ProgramServer(info.mesh, {}, moe=svc)
    blocks = x.cpu().numpy()
    reqs = [Request(i, f"tenant{i}", "moe", payload=blocks[i])
            for i in range(MOE_TOKENS[0])]
    srv.prewarm(("moe",))
    with MainPath("MoE service", BUCKET_KERNELS, totals, STAGED) as path:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resps = srv.run(reqs)
        serve_ms = (time.perf_counter() - t0) * 1e3
    srv.stats.verify()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want, _ = moe_dcra(params, x, cfg, info)
    torch.cuda.synchronize()
    direct_ms = (time.perf_counter() - t0) * 1e3
    want = want.cpu()
    scale = float(want.abs().max())
    err = max(float((torch.from_numpy(r.result) - want[i]).abs().max())
              for i, r in enumerate(resps))
    if ([r.status for r in resps] != ["ok"] * len(reqs) or svc.traces != 1
            or not err <= 1e-5 * scale):
        raise AssertionError(f"MoE service: statuses "
                             f"{[r.status for r in resps]}, builds "
                             f"{svc.traces}, max |err| {err} vs max|out| "
                             f"{scale}")
    log(f"moe service {label}: one dispatch of {len(reqs)} requests x "
        f"{tuple(blocks.shape[1:])}: {serve_ms:.2f} ms through the server "
        f"(host copies of x and out included), direct moe_dcra "
        f"{direct_ms:.2f} ms; max |out - moe_dcra| {err:.3e} = "
        f"{err / scale:.3e} of max|out| (bound 1e-5); launches "
        f"{path.launches} [{SMI}]")


# ---------------------------------------------------------------------------
# phase 14: the analytic stack, config="auto" and the DSE revalidation
# ---------------------------------------------------------------------------

DSE_SCALE, DSE_SHARDS = 8, 8        # (a): the committed sweep's scale, shards
TWIN_SCALE, TWIN_SHARDS = 18, 64    # (b): RMAT scale (edge factor 8), shards
TWIN_APPS = ("spmv", "histogram", "bfs", "sssp", "wcc", "pagerank", "kcore")
#: (c): the pod half runs at the largest RMAT scale whose reckoned wire,
#: stage 2's S * n_pods * cap2 * 8 B plus stage 1's S * n_intra * cap1 *
#: 12 B (value, slot, pod coordinate), fits this
POD_WIRE_BYTES = 16 << 30
POD_SHAPE = (8, 8)
REL_METRIC = 1e-12                  # (a): metrics against the committed file
STAGED_ONLY = {"bucket_scatter": "staged"}


def same_bench(bench, committed):
    """(a)'s check: the same 24 point ids, every metric and per-cell
    number within ``REL_METRIC`` relative, the same configs, frontier
    flags, ``pareto``, ``app_frontiers``, ``dataset_signatures``, and
    the revalidation entries equal one by one."""
    ids = [r["point_id"] for r in bench["points"]]
    want = [r["point_id"] for r in committed["points"]]
    if ids != want or len(ids) != 24:
        raise AssertionError(f"DSE: point ids differ from the committed "
                             f"file ({len(ids)} against {len(want)})")
    worst = 0.0
    for got, ref in zip(bench["points"], committed["points"]):
        if got["config"] != ref["config"] or got["pareto"] != ref["pareto"]:
            raise AssertionError(f"DSE {ref['point_id']}: config or "
                                 f"frontier flag differs")
        if (list(got["metrics"]) != list(ref["metrics"])
                or list(got["per_cell"]) != list(ref["per_cell"])):
            raise AssertionError(f"DSE {ref['point_id']}: metrics or cells "
                                 f"differ")
        pairs = [(got["metrics"][k], v) for k, v in ref["metrics"].items()]
        for cell, vals in ref["per_cell"].items():
            pairs += [(got["per_cell"][cell][k], v) for k, v in vals.items()]
        for a, b in pairs:
            worst = max(worst, abs(a - b) / max(abs(b), 1e-300))
    if worst > REL_METRIC:
        raise AssertionError(f"DSE: a metric differs from the committed "
                             f"file by {worst:.3e} relative")
    for key in ("pareto", "app_frontiers", "dataset_signatures"):
        if bench[key] != committed[key]:
            raise AssertionError(f"DSE: {key} differs from the committed "
                                 f"file")
    reval, want_reval = bench["revalidation"], committed["revalidation"]
    if len(reval) != 14 or reval != want_reval:
        bad = [(a, b) for a, b in zip(reval, want_reval) if a != b]
        raise AssertionError(f"DSE: revalidation differs from the committed "
                             f"file ({len(reval)} entries; first differing "
                             f"{bad[:1]})")
    return worst


def dse_sweep(device, totals):
    """(a) the quick sweep with its revalidation on the card."""
    from repro_torch.dse.space import ConfigSpace
    from repro_torch.dse.sweep import QUICK_APPS, run
    committed = json.loads((ROOT / "BENCH_dse.json").read_text())
    timings = {}
    with MainPath("DSE quick sweep", ROUTE_KERNELS, totals,
                  STAGED_ONLY) as path:
        t0 = time.perf_counter()
        bench = run(ConfigSpace.quick(), QUICK_APPS, DSE_SCALE, top_k=2,
                    n_dev=DSE_SHARDS, out=None, quick=True, device=device,
                    timings=timings)
        sweep_s = time.perf_counter() - t0
    worst = same_bench(bench, committed)
    exe_s = sum(v for k, v in timings.items() if k.endswith("executable"))
    ana_s = sum(v for k, v in timings.items() if k.endswith("analytic"))
    log(f"dse quick sweep: 24 points x {len(QUICK_APPS)} apps x 2 datasets "
        f"(scale {DSE_SCALE}) in {sweep_s:.2f} s, of which the "
        f"revalidation's executables {exe_s:.2f} s on the card and its "
        f"twin {ana_s:.2f} s on the host; equal to the committed "
        f"BENCH_dse.json (ids, pareto, app_frontiers, dataset_signatures; "
        f"metrics within {worst:.3e} relative, bound {REL_METRIC:g}; the 14 "
        f"revalidation entries entry by entry, {DSE_SHARDS} shards at "
        f"scale {DSE_SCALE}); launches {path.launches}, route designs "
        f"{path.paths} [{SMI}]")
    ranked = sorted((r for r in bench["points"] if r.get("pareto")),
                    key=lambda r: -r["metrics"]["teps_geomean"])
    return ranked[0]


def twin_at_scale(best, device, totals):
    """(b) ``shardcheck`` of the frontier's highest-TEPS point on
    RMAT-``TWIN_SCALE`` over ``TWIN_SHARDS`` virtual shards of the card,
    every app: the executables' messages, drops and rounds against the
    port's analytic twin."""
    from repro_torch.dse.shardcheck import check_point
    check = {"point_id": best["point_id"],
             "iq_capacity": best["config"]["iq_capacity"],
             "apps": list(TWIN_APPS)}
    timings = {}
    with MainPath(f"shardcheck rmat-{TWIN_SCALE}", ROUTE_KERNELS, totals,
                  STAGED_ONLY) as path:
        t0 = time.perf_counter()
        res = check_point(check, TWIN_SHARDS, TWIN_SCALE, 0, device=device,
                          timings=timings)
        wall = time.perf_counter() - t0
    for r in res:
        e, a = r["executable"], r["analytic"]
        log(f"shardcheck rmat-{TWIN_SCALE} x {TWIN_SHARDS} {r['app']} "
            f"(cap {r['cap']}): executable messages {e['messages']} drops "
            f"{e['drops']} rounds {e.get('rounds', 1)} in "
            f"{timings[r['app'] + ' executable']:.2f} s on the card; twin "
            f"{a['messages']} / {a['drops']} / {a.get('rounds', 1)} in "
            f"{timings[r['app'] + ' analytic']:.2f} s on the host; "
            f"{'equal' if r['ok'] else 'DIFFERENT'}")
    bad = [r["app"] for r in res if not r["ok"]]
    if bad or len(res) != len(TWIN_APPS):
        raise AssertionError(f"shardcheck rmat-{TWIN_SCALE}: executable and "
                             f"twin differ for {bad}")
    exe_s = sum(v for k, v in timings.items() if k.endswith("executable"))
    ana_s = sum(v for k, v in timings.items() if k.endswith("analytic"))
    log(f"shardcheck rmat-{TWIN_SCALE} x {TWIN_SHARDS} ({best['point_id']}): "
        f"all {len(res)} apps equal to the twin; {wall:.2f} s in all, "
        f"executables {exe_s:.2f} s (card, synchronised), twin {ana_s:.2f} s "
        f"(host), the graph programs' packing {timings['packing']:.2f} s "
        f"(host, shared); launches {path.launches}, route designs "
        f"{path.paths} [{SMI}]")


class Recorded:
    """Wraps ``repro_torch.dse.autoconfig.autoconfigure`` while in use:
    every ``LaunchConfig`` an ``config="auto"`` launch resolves, with its
    host seconds, lands in ``self.calls``. With ``given`` (a
    ``LaunchConfig`` and its seconds, resolved by the same function on the
    same graph in the ``--host-oracles`` process) the launch's call
    returns it, once its graph's signature and its app are checked."""

    def __init__(self, given=None):
        self.given = given

    def __enter__(self):
        from repro_torch.dse import autoconfig
        self.module, self.real, self.calls = autoconfig, \
            autoconfig.autoconfigure, []

        def recording(*args, **kwargs):
            t0 = time.perf_counter()
            if self.given is None:
                lc = self.real(*args, **kwargs)
            else:
                lc, seconds = self.given
                g, app = args[:2]
                if (app != "bfs" or kwargs.get("objective", "teps") != "teps"
                        or autoconfig.signature_of(g) != lc.signature):
                    raise AssertionError(f"autoconfigure({app}, {kwargs}) "
                                         f"on another graph than the one "
                                         f"resolved beside phases 2-13")
                t0 -= seconds
            self.calls.append((lc, time.perf_counter() - t0))
            return lc
        autoconfig.autoconfigure = recording
        return self

    def __exit__(self, *_):
        self.module.autoconfigure = self.real
        return False


def hier_wire_bytes(e_max, n_intra, n_pods, n_dev):
    """The pod path's wire at ``device_queues(pod=True)`` (factor n_dev):
    stage 1 (3 columns) plus stage 2 (2 columns), 4 B a column."""
    from repro_torch.core.queues import QueueConfig
    from repro_torch.core.routing import resolve_hier_caps
    cap1, cap2 = resolve_hier_caps(QueueConfig.from_factor(float(n_dev)),
                                   "T3", e_max, n_intra, n_pods)
    return (n_dev * n_intra * cap1 * 12 + n_dev * n_pods * cap2 * 8,
            (cap1, cap2))


def e_max_of(g, n_dev):
    """``_pack_edges``' E_max without packing: the largest per-shard
    count of edges by source owner."""
    import numpy as np
    own = np.bincount(np.arange(g.n) % n_dev, weights=g.degrees(),
                      minlength=n_dev)
    return max(8, int(own.max()))


def pod_graph(g, e_max22):
    """The largest RMAT scale whose pod wire (:func:`hier_wire_bytes`)
    fits ``POD_WIRE_BYTES``: scales whose wire, scaled down from RMAT-22's
    E_max, is above 4x the budget are skipped unbuilt; the rest are built
    and reckoned from their own E_max. Returns ``(scale, graph, E_max,
    wire bytes, caps, reckonings)``."""
    from repro_torch.sparse import datasets
    n_intra, n_pods = POD_SHAPE[1], POD_SHAPE[0]
    n_dev = n_intra * n_pods
    seen = []
    for s in range(SCALE, 7, -1):
        guess, _ = hier_wire_bytes(e_max22 >> (SCALE - s), n_intra, n_pods,
                                   n_dev)
        if guess > 4 * POD_WIRE_BYTES:
            seen.append((s, "scaled", guess))
            continue
        gs = g if s == SCALE else datasets.rmat(s, seed=SEED)
        e_max = e_max_of(gs, n_dev)
        wire, caps = hier_wire_bytes(e_max, n_intra, n_pods, n_dev)
        seen.append((s, "built", wire))
        if wire <= POD_WIRE_BYTES:
            return s, gs, e_max, wire, caps, seen
    raise AssertionError(f"no RMAT scale's pod wire fits: {seen}")


def auto_bfs(tag, g, root, fabric, setup, totals, given=None):
    """One ``dcra_bfs(..., options=LaunchOptions(config="auto"))`` on
    ``fabric`` and the same launch with ``route_impl="sort"`` under the
    ``LaunchConfig`` it resolved: bit-identical states and ``AppStats``.
    Drops are the resolved point's capacity semantics, so no oracle.
    ``given``: the resolution made beside phases 2-13 (:class:`Recorded`);
    its seconds count as the autoconfiguration's, not the launch's."""
    import numpy as np
    import torch
    from repro_torch.core.routing import resolve_caps
    from repro_torch.sparse.options import LaunchOptions
    from repro_torch.sparse.torch_apps import dcra_bfs
    with Recorded(given) as rec:
        with MainPath(f"BFS auto {tag}", ROUTE_KERNELS, totals,
                      STAGED_ONLY) as path:
            t0 = time.perf_counter()
            dist, stats = dcra_bfs(g, root, fabric, setup=setup,
                                   options=LaunchOptions(config="auto"))
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0 + (given[1] if given else 0)
    if len(rec.calls) != 1:
        raise AssertionError(f"BFS auto {tag}: {len(rec.calls)} "
                             f"auto-configurations, expected 1")
    lc, auto_s = rec.calls[0]
    plain, pstats = dcra_bfs(g, root, fabric, setup=setup,
                             options=LaunchOptions(config=lc,
                                                   route_impl="sort"))
    if not (np.array_equal(plain, dist) and pstats.rounds == stats.rounds
            and np.array_equal(pstats.messages, stats.messages)
            and np.array_equal(pstats.drops, stats.drops)):
        raise AssertionError(f"BFS auto {tag}: kernel path differs from the "
                             f"plain-torch path under the same LaunchConfig")
    e_max = setup[-1] if setup is not None else e_max_of(g,
                                                         fabric.n_devices)
    pod_axis = lc.pod_axis_for(fabric)
    queues = lc.device_queues(fabric.n_devices, e_max,
                              pod=pod_axis is not None)
    caps, pods = resolve_caps(fabric, queues, "T3", e_max, "data", pod_axis,
                              clamp=True)
    reached = int(g.degrees()[dist >= 0].sum())
    launch_s = run_s - auto_s
    where = ("in the --host-oracles process beside phases 2-13, handed to "
             "the launch here" if given else "on the host")
    log(f"bfs auto {tag} (rmat n={g.n} nnz={g.nnz}, root {root}): "
        f"autoconfigure {auto_s:.2f} s {where} (its evaluator's BFS "
        f"root, vertex 0, has out-degree {int(g.degrees()[0])}) -> "
        f"{lc.source} "
        f"{lc.point.point_id} score {lc.score:.6f} (signature "
        f"{lc.signature}); pod axis {pod_axis}, pods {pods}, caps {caps} "
        f"(E_max {e_max}); rounds {stats.rounds}, messages "
        f"{stats.messages.tolist()}, drops {stats.drops.tolist()} (total "
        f"{stats.total_drops}); reached {int((dist >= 0).sum())} vertices, "
        f"{reached} edges; launch {launch_s:.4f} s past the "
        f"autoconfiguration, TEPS {reached / launch_s:.4e}; launches "
        f"{path.launches}, route designs {path.paths}; plain-torch path "
        f"under the same LaunchConfig bit-identical [{SMI}]")
    return lc, auto_s


def run_dse(g, setup, root, device, totals, given=None):
    """Phase 14: (a) the quick DSE sweep with its revalidation on the
    card, held to the committed ``BENCH_dse.json``; (b) ``shardcheck`` of
    its highest-TEPS frontier point on RMAT-``TWIN_SCALE`` over
    ``TWIN_SHARDS`` shards, every app against the twin; (c) the
    auto-configured BFS on RMAT-22, flat 64, from phase 4's root (its
    autoconfiguration ``given`` when the ``--host-oracles`` process made
    it beside phases 2-13: :func:`host_autoconfig`), and on pod 8 x 8 at
    the largest scale whose wire fits ``POD_WIRE_BYTES``."""
    import numpy as np
    from repro_torch.core.fabric import Fabric
    best = dse_sweep(device, totals)
    twin_at_scale(best, device, totals)
    auto_bfs("flat 64", g, root, Fabric.fake(64, device=device), setup,
             totals, given)
    s, gs, e_max, wire, caps, seen = pod_graph(g, setup[-1])
    log(f"pod half: RMAT-{s} (n={gs.n} nnz={gs.nnz} E_max {e_max}) is the "
        f"largest scale whose wire at factor 64 fits {POD_WIRE_BYTES} B: "
        f"{wire} B, caps {caps}; reckoned: "
        + ", ".join(f"RMAT-{sc} {how} {b} B" for sc, how, b in seen))
    auto_bfs(f"pod {POD_SHAPE[0]}x{POD_SHAPE[1]} rmat-{s}", gs,
             int(np.argmax(gs.degrees())),
             Fabric.virtual(POD_SHAPE, ("pod", "data"), device=device),
             None, totals)


# ---------------------------------------------------------------------------
# phase 15: scale-out, two processes sharing the card
# ---------------------------------------------------------------------------

SCALE_OUT_PROCS = 2
SCALE_OUT_HIST_N = 1 << 24
SCALE_OUT_PG_TIMEOUT = 300          # seconds: the gloo group's collectives
SCALE_OUT_WAIT = 600                # seconds the parent waits for a worker
KCORE_K = 12
SCALE_OUT_POD = dict(pod_axis="pod", capacity_factor=2.0)
#: (tag, data, app, fabric shape, axis names, LaunchOptions fields)
SCALE_OUT_RUNS = (
    ("bfs flat 64 lockstep", "rmat22", "bfs", (64,), ("data",),
     dict(capacity_factor=4.0)),
    ("bfs flat 64 pipelined", "rmat22", "bfs", (64,), ("data",),
     dict(capacity_factor=4.0, round_mode="pipelined")),
    ("bfs pod 8x8 lockstep", "rmat22", "bfs", (8, 8), ("pod", "data"),
     SCALE_OUT_POD),
    *((f"{app} {lay}", "rmat18", app, shape, names, kw)
      for app in ("sssp", "wcc", "kcore", "pagerank")
      for lay, shape, names, kw in (("flat 8", (8,), ("data",), {}),
                                    ("pod 2x4", (2, 4), ("pod", "data"),
                                     SCALE_OUT_POD))),
    ("histogram flat 8", "hist", "histogram", (8,), ("data",), {}),
)


RMAT22_ARRAYS = ("row_ptr", "col_idx", "values", "src_slot", "dst", "w")


def save_rmat22(out_dir, g, setup):
    """Phase 2's RMAT-22 and its packing onto 64 shards into ``out_dir``,
    for the phase-15 workers to load instead of building them again."""
    import numpy as np
    n_local, src_slot, dst, w, e_max = setup
    for k, a in zip(RMAT22_ARRAYS, (g.row_ptr, g.col_idx, g.values,
                                    src_slot, dst, w)):
        np.save(out_dir / f"rmat22_{k}.npy", a)
    (out_dir / "rmat22.json").write_text(json.dumps([int(n_local),
                                                     int(e_max)]))


def load_rmat22(out_dir):
    """``(g, setup)`` as :func:`save_rmat22` wrote them."""
    import numpy as np
    from repro_torch.sparse.csr import CSR
    a = {k: np.load(out_dir / f"rmat22_{k}.npy") for k in RMAT22_ARRAYS}
    n_local, e_max = json.loads((out_dir / "rmat22.json").read_text())
    return (CSR(a["row_ptr"], a["col_idx"], a["values"]),
            (n_local, a["src_slot"], a["dst"], a["w"], e_max))


def scale_out_data(g22=None, setup22=None):
    """Phase 15's inputs, from the seed: RMAT-22 and its packing onto 64
    shards (phase 2's, reused when given), RMAT-18 and its packings onto
    8 shards (directed, and both directions for WCC and k-core), and the
    histogram stream; BFS and SSSP start at the highest-degree vertex.
    Packings are set-up, outside the timed runs, as phase 4's."""
    import numpy as np
    from repro_torch.sparse import datasets
    from repro_torch.sparse.program import _graph_setup
    if g22 is None:
        g22 = datasets.rmat(SCALE, seed=SEED)
        setup22 = _graph_setup(g22, 64)
    g18 = datasets.rmat(SMALL_SCALE, seed=SEED)
    return {"rmat22": (g22, {False: setup22},
                       int(np.argmax(g22.degrees()))),
            "rmat18": (g18, {u: _graph_setup(g18, 8, undirected=u)
                             for u in (False, True)},
                       int(np.argmax(g18.degrees()))),
            "hist": datasets.histogram_data(SCALE_OUT_HIST_N, HIST_BINS,
                                            seed=SEED)}


def scale_out_run(spec, data, fabric):
    """One run of :data:`SCALE_OUT_RUNS` on ``fabric``: ``(states, rounds,
    messages, drops, work)``, ``work`` the edges (TEPS), edges x rounds
    or elements the run's rate counts."""
    import numpy as np
    from repro_torch.sparse import program
    from repro_torch.sparse.options import LaunchOptions
    from repro_torch.sparse.torch_apps import PROGRAMS, dcra_histogram
    _, key, app, _, _, kw = spec
    opts = LaunchOptions(**kw)
    if app == "histogram":
        y, dropped = dcra_histogram(data[key], HIST_BINS, fabric,
                                    options=opts)
        return ((y,), 1, np.array([len(data[key])]), np.array([dropped]),
                len(data[key]))
    g, setups, root = data[key]
    params = {"bfs": {"root": root}, "sssp": {"root": root}, "wcc": {},
              "kcore": {"k": float(KCORE_K)},
              "pagerank": {"damping": 0.85, "iters": 20}}[app]
    prog = PROGRAMS[app]
    states, st = program.run_program(prog, g, fabric, options=opts,
                                     params=params,
                                     setup=setups[prog.undirected])
    if app in ("bfs", "sssp"):
        work = int(g.degrees()[np.isfinite(states[0])].sum())
    else:
        work = g.nnz * st.rounds
    return states, st.rounds, st.messages, st.drops, work


def scale_out_worker(coord, pid, out_dir):
    """``--scale-out-worker COORD PID DIR``: one process of phase 15. Joins
    the gloo group at ``COORD`` as process ``PID`` with a fabric of each
    run's shape on the card, loads RMAT-22 and its packing from ``DIR``
    (:func:`save_rmat22`), builds the rest of phase 15's inputs from the
    seed, runs :data:`SCALE_OUT_RUNS` in order, and writes
    each run's states (``p<PID>_<i>.npy``) and a record of its wall
    seconds, rounds, streams, launches, route designs, exchange counters
    and peak card memory (``p<PID>.json``) into ``DIR``. It loads the
    kernels the parent built and fails if it had to build one."""
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.fabric import Fabric
    from repro_torch.kernels import _build, route
    pid, out_dir = int(pid), Path(out_dir)
    built = [k for k, r in _build.build().items() if r["seconds"]]
    if built:
        raise AssertionError(f"worker {pid} built {built}: the parent "
                             f"builds every kernel before it starts")
    device = torch.device(*CARD)
    fabs = {}

    def fabric(shape, names):
        if (shape, names) not in fabs:
            fabs[shape, names] = Fabric.distributed(
                shape, names, coordinator_address=coord,
                num_processes=SCALE_OUT_PROCS, process_id=pid, device=device,
                timeout=SCALE_OUT_PG_TIMEOUT)
        return fabs[shape, names]
    t0 = time.perf_counter()
    fabric((64,), ("data",))
    join_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    data = scale_out_data(*load_rmat22(out_dir))
    setup_s = time.perf_counter() - t0
    records = []
    for i, spec in enumerate(SCALE_OUT_RUNS):
        fab = fabric(spec[3], spec[4])
        torch.cuda.synchronize()
        reset_launches()
        fab.exchange.reset_stats()
        torch.cuda.reset_peak_memory_stats()
        dist.barrier()                 # both processes start the clock together
        t0 = time.perf_counter()
        states, rounds, msgs, drops, work = scale_out_run(spec, data, fab)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        records.append({
            "tag": spec[0], "wall_s": wall, "rounds": int(rounds),
            "messages": np.asarray(msgs).tolist(),
            "drops": np.asarray(drops).tolist(), "work": int(work),
            "launches": read_launches(),
            "paths": {k: dict(v) for k, v in route.PATHS.items()},
            "exchange": dict(fab.exchange.stats),
            "peak_bytes": int(torch.cuda.max_memory_allocated()),
            "local_shards": list(fab.local_shards),
            "dcn_axes": list(fab.dcn_axes())})
        np.save(out_dir / f"p{pid}_{i}.npy", np.stack(states))
    (out_dir / f"p{pid}.json").write_text(json.dumps(
        {"join_s": join_s, "setup_s": setup_s, "records": records}))
    dist.destroy_process_group()
    return 0


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_workers(out_dir, flag="--scale-out-worker", wait=SCALE_OUT_WAIT):
    """Start :data:`SCALE_OUT_PROCS` workers (new processes of this
    script with ``flag``, ``cuda:0`` in each) and wait for all of them; a
    worker that fails, or a wait past ``wait`` seconds, stops the others
    and raises with the tails of their logs."""
    coord = f"127.0.0.1:{free_port()}"
    logs = [out_dir / f"p{pid}.log" for pid in range(SCALE_OUT_PROCS)]
    procs = []
    try:
        for pid, path in enumerate(logs):
            with open(path, "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()),
                     flag, coord, str(pid), str(out_dir)],
                    stdout=f, stderr=subprocess.STDOUT, cwd=str(ROOT)))
        deadline = time.perf_counter() + wait
        while any(p.poll() is None for p in procs):
            if (any(p.returncode not in (None, 0) for p in procs)
                    or time.perf_counter() > deadline):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    rcs = [p.returncode for p in procs]
    if any(rcs):
        tails = "\n".join(f"--- worker {pid} (rc {rc}):\n"
                          + path.read_text()[-3000:]
                          for pid, (rc, path) in enumerate(zip(rcs, logs)))
        raise AssertionError(f"{flag}: workers ended with {rcs}\n{tails}")
    return [json.loads((out_dir / f"p{pid}.json").read_text())
            for pid in range(SCALE_OUT_PROCS)]


def run_scale_out(device, totals, g22=None, setup22=None):
    """Phase 15: :data:`SCALE_OUT_RUNS` in one process on the card (virtual
    fabrics), then in two worker processes that share the card over one
    gloo group (``Fabric.distributed``, shards process-major: 32 of 64
    flat shards a process, four of eight pods, so on the pod fabric only
    the portal stage crosses). Each worker's run must equal the
    one-process run of its shape: states bit for bit (PageRank within
    twice its float32 bound), rounds, message and drop streams; no drop;
    the scatter ``staged`` and the reduce on the one-process run's design
    in each worker. Prints each run's rates beside the one-process run's,
    the bytes and host seconds of the staged exchange a round, and each
    worker's peak card memory; the workers' launches join ``totals``."""
    import numpy as np
    import torch
    from repro_torch.core.fabric import Fabric
    from repro_torch.kernels import route
    data = scale_out_data(g22, setup22)
    refs = []
    for spec in SCALE_OUT_RUNS:
        fab = Fabric.virtual(spec[3], spec[4], device=device)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        out = scale_out_run(spec, data, fab)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        design = max(route.PATHS["reduce_received"],
                     key=route.PATHS["reduce_received"].get)
        ran_only(route.PATHS["reduce_received"], design,
                 f"scale-out {spec[0]}, one process: reduce_received")
        refs.append((out, wall, design))
        if int(np.sum(out[3])):
            raise AssertionError(f"scale-out {spec[0]}: the one-process run "
                                 f"dropped {int(np.sum(out[3]))} tasks")
    bound = pagerank_bound(data["rmat18"][0], device, n_dev=8)
    out_dir = ROOT / "build" / "scale_out"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    g22, setups22, _ = data["rmat22"]
    save_rmat22(out_dir, g22, setups22[False])
    log(f"scale-out: RMAT-22 and its packing written for the workers in "
        f"{time.perf_counter() - t0:.2f} s [{SMI}]")
    del data, g22, setups22
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    workers = run_workers(out_dir)
    log(f"scale-out: {SCALE_OUT_PROCS} workers on {device} "
        f"(gloo over 127.0.0.1, staged through pinned host memory) "
        f"{time.perf_counter() - t0:.2f} s in all; join s "
        f"{[round(w['join_s'], 2) for w in workers]}, inputs (RMAT-22 "
        f"loaded, the rest from the seed) s "
        f"{[round(w['setup_s'], 2) for w in workers]} [{SMI}]")
    for i, spec in enumerate(SCALE_OUT_RUNS):
        tag, key, app = spec[:3]
        (states, rounds, msgs, drops, work), ref_wall, design = refs[i]
        unit = {"bfs": "TEPS", "sssp": "TEPS", "histogram": "elements/s"
                }.get(app, "edges*rounds/s")
        want = np.stack(states)
        for pid, w in enumerate(workers):
            rec = w["records"][i]
            got = np.load(out_dir / f"p{pid}_{i}.npy")
            same = (rec["rounds"] == rounds
                    and rec["messages"] == np.asarray(msgs).tolist()
                    and rec["drops"] == np.asarray(drops).tolist())
            if app == "pagerank":
                held_to(f"scale-out {tag} p{pid} ranks", got[0], want[0],
                        2 * bound)
                same = same and np.array_equal(got[1:], want[1:])
            else:
                same = same and np.array_equal(got, want)
            if not same or sum(rec["drops"]):
                raise AssertionError(f"scale-out {tag} p{pid}: differs from "
                                     f"the one-process run or dropped")
            missing = [k for k in ROUTE_KERNELS if not rec["launches"][k]]
            if missing:
                raise AssertionError(f"scale-out {tag} p{pid}: never "
                                     f"launched {missing}")
            ran_only(rec["paths"]["bucket_scatter"], "staged",
                     f"scale-out {tag} p{pid}: bucket_scatter")
            ran_only(rec["paths"]["reduce_received"], design,
                     f"scale-out {tag} p{pid}: reduce_received")
            for k, v in rec["launches"].items():
                totals[k] += v
            ex = rec["exchange"]
            r = max(rec["rounds"], 1)
            log(f"scale-out {tag} p{pid} (shards {rec['local_shards']}, "
                f"crossing {rec['dcn_axes']}): wall {rec['wall_s']:.4f} s, "
                f"rounds {rec['rounds']}, {unit} "
                f"{rec['work'] / rec['wall_s']:.4e} (one process: wall "
                f"{ref_wall:.4f} s, {work / ref_wall:.4e}); exchanges "
                f"{ex['calls']}, bytes out {ex['bytes_out']} "
                f"({ex['bytes_out'] / r:.4e} a round); host s a round: wait "
                f"{ex['wait_s'] / r:.4f} d2h {ex['d2h_s'] / r:.4f} gloo "
                f"{ex['gloo_s'] / r:.4f} h2d {ex['h2d_s'] / r:.4f}; peak card "
                f"memory {rec['peak_bytes']} B; launches {rec['launches']} "
                f"[{SMI}]")
        log(f"scale-out {tag}: both processes equal to the one-process run "
            f"(states{' (ranks within twice the float32 bound)' if app == 'pagerank' else ''}, "
            f"rounds, message and drop streams), no drop, reduce {design}")
    log(f"scale-out: peak card memory a worker "
        f"{[max(r['peak_bytes'] for r in w['records']) for w in workers]} B"
        f" [{SMI}]")
    shutil.rmtree(out_dir, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 16: the decoder LMs' serving path
# ---------------------------------------------------------------------------

LM_ARCH = "granite-8b"
LM_TOKENS = (2, 4096)              # TRAIN_4K cut to batch 2
LM_SERVE = (4, 128, 32)            # prompts, prompt length, generated
LM_MOE_TOKENS = (2, 2048)          # OLMoE: TRAIN_4K cut to batch 2, seq 2048
#: OLMoE's dispatch queues in phase 16: the dispatch bucket at factor 8
#: holds every task a shard sends and the expert bucket at 1.0 of its
#: (already padded) input every task a data slice can send one expert, so
#: nothing can drop; factor 8 on both would size the expert bucket at
#: 16,384 rows, about 60 GB of expert-FFN operands beside 27.7 GB of
#: weights
LM_MOE_QUEUES = {"dispatch": 8.0, "portal": 1.0, "expert": 1.0}


def logit_bound(cfg, dtype, seq_len):
    """How far two runs of one model may lie apart, as a share of
    max|logit|, where they differ only in the order of their sums (the
    flash kernel's online softmax against the direct softmax, GEMMs of
    other shapes). In float32 each layer's longest dot product (n terms:
    d_ff or the expert's width, d_model, the keys) perturbs the residual
    stream by about sqrt(n) unit roundoffs, once in each run, and the L
    layers add: ``2 L sqrt(n) 2^-24``. In bf16 the logits are rounded to
    bf16, so two values one ulp apart differ by up to 2^-7 of their size,
    and the two runs round the stream at other points, about two ulps a
    layer that add as a random walk: ``2^-7 (1 + 2 sqrt(L))`` (a narrow
    36-layer granite on the CPU: 0.022 against 0.10). L counts every
    layer the stream passes: an encoder's too, and a hybrid's
    applications of its shared block."""
    import math
    import torch
    L = cfg.num_layers + cfg.encoder_layers
    if cfg.hybrid_attn_period:
        L += cfg.num_layers // cfg.hybrid_attn_period
    if dtype == torch.bfloat16:
        return 2.0 ** -7 * (1 + 2 * math.sqrt(L))
    ff = cfg.moe.d_expert if cfg.moe is not None else cfg.d_ff
    n = max(ff, cfg.d_model, cfg.num_heads * cfg.resolved_head_dim, seq_len)
    return 2 * L * math.sqrt(n) * U


def lm_batch(cfg, tokens):
    """``synth_batch`` at ``TRAIN_4K`` cut to ``tokens`` (batch, seq)."""
    import dataclasses
    from repro_torch.configs import TRAIN_4K
    from repro_torch.data.pipeline import synth_batch
    shape = dataclasses.replace(TRAIN_4K, global_batch=tokens[0],
                                seq_len=tokens[1])
    return synth_batch(cfg, shape, 0, seed=SEED)


def timed_forward(model, batch, reps=1, **kw):
    """``model.forward(batch)`` ``reps + 1`` times, the first to warm:
    (logits, ms of the last run on the host clock around synchronised
    calls, peak bytes of the runs)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(reps + 1):
        logits = None      # free the last run's logits before the next
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = model.forward(batch, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    return logits, ms, torch.cuda.max_memory_allocated()


def logits_held(tag, got, want, bound):
    """max |got - want| against ``bound`` of max|want|, both finite:
    (err, share)."""
    import torch
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    if not (err <= bound * scale and bool(torch.isfinite(got).all())):
        raise AssertionError(f"{tag}: max |dlogit| {err} above {bound:.3e} "
                             f"of max|logit| {scale} (or not finite)")
    return err, err / scale


class FirstFlashInputs:
    """Within: keeps copies of the first ``ops.flash_attention`` call's
    q, k, v as [B*H, S, hd], and its ``causal`` (layer 0's attention,
    after the glue's GQA expansion: the kernel's input on the main path)
    in ``self.seen``, and the first call of each mask in ``self.by_mask``
    (``{causal: (q, k, v, causal)}``: an encoder-decoder's first encoder
    and first decoder layer); ``self.masks`` lists every call's
    ``causal``."""

    def __enter__(self):
        from repro_torch.kernels import ops
        self.ops, self.real, self.seen = ops, ops.flash_attention, None
        self.by_mask, self.masks = {}, []

        def keep(q, k, v, causal=True):
            self.masks.append(causal)
            if causal not in self.by_mask:
                self.by_mask[causal] = tuple(
                    t.reshape(-1, *t.shape[2:]).clone()
                    for t in (q, k, v)) + (causal,)
                if self.seen is None:
                    self.seen = self.by_mask[causal]
            return self.real(q, k, v, causal=causal)
        ops.flash_attention = keep
        return self

    def __exit__(self, *_):
        self.ops.flash_attention = self.real
        return False


def lm_flash_check(tag, seen, want_shape):
    """The flash kernel on the q, k, v a model forward gave it (a
    :class:`FirstFlashInputs`' ``seen``) against its plain version within
    ``error_bound``, as phase 11 holds it (:func:`flash_check`)."""
    from repro_torch.kernels import flash_attention as flash
    q, k, v, causal = seen
    if tuple(q.shape) != want_shape:
        raise AssertionError(f"{tag}: the kernel got {tuple(q.shape)}, "
                             f"want {want_shape}")
    err, ratio, share = flash_check(flash, q, k, v, causal)
    log(f"lm {tag}: flash_attention at layer 0's q, k, v "
        f"{tuple(q.shape)} {q.dtype} causal={causal} (design "
        f"{flash.launch_plan(*q.shape, q.dtype).path}): max |err| "
        f"{err:.3e} vs the plain version, {ratio:.4f} of error_bound"
        + (f"; mean |err| {share:.4f} of the p-unrounded plain version's"
           if share is not None else "") + f" [{SMI}]")


#: the shortest prefix :func:`long_flash_check` holds the share on (phases
#: 11, 16, 18 hold it at S <= 4096)
SHARE_S = 4096


def plain_flash_f64(q, k, v, causal):
    """:func:`plain_flash_attention`'s arithmetic in float64, p rounded to
    v's type at the same running max and key tiles: the plain version
    with its float32 sums made near exact."""
    from repro_torch.kernels import flash_attention as flash
    import torch
    bh, s, hd = q.shape
    qd, tk = q.double(), flash.TILE
    m = torch.full((bh, s), flash.NEG_INF, dtype=torch.float64,
                   device=q.device)
    l = torch.zeros(bh, s, dtype=torch.float64, device=q.device)
    acc = torch.zeros(bh, s, hd, dtype=torch.float64, device=q.device)
    qi = torch.arange(s, device=q.device)[:, None]
    for k0 in range(0, s, tk):
        kt, vt = k[:, k0:k0 + tk].double(), v[:, k0:k0 + tk].double()
        sc = torch.matmul(qd, kt.transpose(1, 2)) * hd ** -0.5
        if causal:
            kj = torch.arange(k0, k0 + kt.shape[1], device=q.device)[None]
            sc = torch.where(kj <= qi, sc, flash.NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1))
        p = torch.exp(sc - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.matmul(p.to(v.dtype).double(),
                                                    vt)
        m = m_new
    return acc / torch.clamp(l, min=1e-30)[..., None]


def long_flash_check(tag, seen, want_shape):
    """The flash kernel on a long causal prefill's layer-0 q, k, v (a
    :class:`FirstFlashInputs`' ``seen``): every element within
    ``error_bound`` of the plain version at the full S; the p-rounding
    share (``unrounded_share``'s ratio) held to :data:`P_ROUNDED_SHARE`
    on the first :data:`SHARE_S` positions and each doubling up to S,
    each reported beside the kernel's and the plain version's distance
    to :func:`plain_flash_f64` rounded to the output's type (where a
    kernel that summed exactly would lie): the rounding gap the share
    divides by shrinks as the rows grow longer, so a kernel whose sums
    drift shows it at long S first. A causal row's output depends on the
    keys before it alone, so the first s rows of either full output are
    that output on the first s positions."""
    import torch
    from repro_torch.kernels import flash_attention as flash
    q, k, v, causal = seen
    if tuple(q.shape) != want_shape or not causal:
        raise AssertionError(f"{tag}: the kernel got {tuple(q.shape)} "
                             f"causal={causal}, want {want_shape} causal")
    want = flash.plain_flash_attention(q, k, v, causal)
    got = flash.flash_attention(q, k, v, causal)
    err = (got.float() - want.float()).abs()
    ratio = float((err / flash.error_bound(q, k, v, causal, want)).max())
    if not ratio <= 1:
        raise AssertionError(f"{tag}: flash_attention off by {ratio:.3f} x "
                             f"its tolerance at {tuple(q.shape)}")
    shares, s = [], SHARE_S
    while s <= q.shape[1]:
        w, g = want[:, :s].float(), got[:, :s].float()
        u = flash.plain_flash_attention(q[:, :s], k[:, :s],
                                        v[:, :s].float(), causal)
        gap = float((u.float() - w).abs().mean())
        exact = plain_flash_f64(q[:, :s], k[:, :s], v[:, :s],
                                causal).to(q.dtype).float()
        shares.append((s, float((g - w).abs().mean()) / gap,
                       float((g - exact).abs().mean()) / gap,
                       float((w - exact).abs().mean()) / gap))
        del u, exact
        s *= 2
    over = [(n, a) for n, a, _, _ in shares if not a <= P_ROUNDED_SHARE]
    if over:
        raise AssertionError(f"{tag}: mean |err| as a share of the plain "
                             f"version's with p unrounded (limit "
                             f"{P_ROUNDED_SHARE}) at S: {over}")
    log(f"lm {tag}: flash_attention at layer 0's q, k, v {tuple(q.shape)} "
        f"{q.dtype} causal (design "
        f"{flash.launch_plan(*q.shape, q.dtype).path}): max |err| "
        f"{float(err.max()):.3e} vs the plain version, {ratio:.4f} of "
        f"error_bound; mean |err| as a share of the p-unrounded plain "
        f"version's, by prefix S (kernel vs plain; kernel vs the float64 "
        f"sums; plain vs the float64 sums): "
        + ", ".join(f"{n} {a:.4f}; {b:.4f}; {c:.4f}"
                    for n, a, b, c in shares)
        + f" (held: limit {P_ROUNDED_SHARE}) [{SMI}]")


def lm_forwards(tag, model, batch, dtype, design, totals, masks=None,
                ref=None):
    """One forward on the kernel path (a main path: one flash launch an
    attention layer on ``design``, of the masks ``masks`` in order
    (default: causal, one a layer); the first kernel inputs of each mask
    kept and the kernel held to its plain version on them), then the
    same forward with every attention layer on the torch path
    (``kernel=False``): the logits within :func:`logit_bound`, each
    forward's ms and peak bytes (warm, the kernel path's first logits
    held). ``design`` None: a model without attention, no launch at all.
    ``ref``: the float32 logits of the same model, for a bf16 run whose
    stack amplifies a rounding (a Mamba2 stack with random weights moves
    its bf16 logits 0.12-0.21 of max|logit| from its float32 ones on the
    CPU): then the kernel path's logits are held to lie within
    :func:`logit_bound` farther from ``ref`` than the torch path's, and
    their distance to the torch path's is reported. Returns the kernel
    path's logits."""
    import torch
    from repro_torch.kernels import flash_attention as flash
    cfg = model.cfg
    if masks is None:
        masks = [True] * (cfg.num_layers if design else 0)
    L = len(masks)
    need = ("flash_attention",) if L else ()
    with MainPath(f"{tag} forward", need, totals) as path:
        with FirstFlashInputs() as first:
            got, ms, _ = timed_forward(model, batch, reps=0)
    on_design = flash.PATHS[design] if design else 0
    if (path.launches["flash_attention"] != L or on_design != L
            or first.masks != masks):
        raise AssertionError(f"{tag}: flash launches {path.launches}, "
                             f"designs {flash.PATHS}, masks {first.masks}; "
                             f"want {L} on {design}, masks {masks}")
    B, S = got.shape[:2]
    for seen in first.by_mask.values():
        lm_flash_check(tag, seen, (B * cfg.num_heads, seen[0].shape[1],
                                   cfg.resolved_head_dim))
    del first.seen, first.by_mask
    _, ms_warm, peak = timed_forward(model, batch)
    want, ms_plain, peak_plain = timed_forward(model, batch, kernel=False)
    bound = logit_bound(cfg, dtype, batch["tokens"].shape[1])
    if ref is None:
        err, share = logits_held(f"{tag} kernel vs torch path", got, want,
                                 bound)
        held = ""
    else:
        scale = float(ref.abs().max())
        err = float((got.float() - want.float()).abs().max())
        share = err / float(want.float().abs().max())
        e_k, e_p = (float((t.float() - ref).abs().max()) / scale
                    for t in (got, want))
        if not (e_k <= e_p + bound and bool(torch.isfinite(got).all())):
            raise AssertionError(f"{tag}: the kernel path's logits "
                                 f"{e_k:.4e} of max|logit| from the float32 "
                                 f"forward's, the torch path's {e_p:.4e}; "
                                 f"bound {bound:.4e} more")
        held = (f"; from the float32 forward's logits: kernel path "
                f"{e_k:.4e}, torch path {e_p:.4e} of max|logit| (held: "
                f"kernel <= torch + bound), kernel vs torch reported")
    kernels = (f"flash launches {path.launches['flash_attention']} "
               f"(design {design}: {on_design}, causal "
               f"{sum(masks)}, non-causal {L - sum(masks)})" if L else
               "no kernel on this path (no attention: kernel=False is the "
               "same forward)")
    log(f"lm {tag}: logits {tuple(got.shape)} {got.dtype}; {kernels}; "
        f"forward {ms:.2f} ms first, {ms_warm:.2f} "
        f"ms warm ({B * S / ms_warm * 1e3:.4e} tokens/s), peak "
        f"{peak} B; kernel=False (the torch attention path) {ms_plain:.2f} "
        f"ms warm, "
        f"peak {peak_plain} B; max |dlogit| {err:.4e} = {share:.4e} of "
        f"max|logit| (bound {bound:.4e}){held} [{SMI}]")
    del want
    return got


def lm_serve(model, totals, device, shape=None):
    """``launch/serve.py::serve`` on the model: ``shape`` (prompts, prompt
    length, generated; default ``LM_SERVE``) prompts from
    ``torch.Generator`` seed ``SEED``, a float32 cache; tokens/s, ms a
    decode step (each step synchronised), peak bytes; the teacher-forced
    decode's logits at the last prompt position held to the kernel-path
    forward's there within :func:`logit_bound`. Decode attends by the
    torch path (no kernel launch)."""
    import torch
    from repro_torch.launch.serve import serve
    cfg = model.cfg
    B, P, G = shape or LM_SERVE
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                            device=device, dtype=torch.int32)
    steps, at = [], {}
    decode = model.decode_step

    def timed_step(cache, tokens, pos):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = decode(cache, tokens, pos)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
        if pos == P - 1:
            at["logits"] = out[0][:, -1].clone()
        return out
    model.decode_step = timed_step
    try:
        torch.cuda.reset_peak_memory_stats()
        with MainPath(f"serve {cfg.name}", (), totals) as path:
            t0 = time.perf_counter()
            ids = serve(cfg, model, prompts, G)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
    finally:
        del model.decode_step
    if any(path.launches.values()):
        raise AssertionError(f"serve: decode launched kernels "
                             f"{path.launches}")
    if tuple(ids.shape) != (B, G) or not bool(
            ((ids >= 0) & (ids < model.embed.shape[0])).all()):
        raise AssertionError(f"serve: ids {tuple(ids.shape)} out of range")
    with torch.inference_mode():
        want, _ = model.forward({"tokens": prompts})
    bound = logit_bound(cfg, torch.float32, P)
    err, share = logits_held("serve decode vs forward", at["logits"],
                             want[:, P - 1], bound)
    log(f"lm serve {cfg.name}: {B} prompts x {P} tokens, {G} generated, "
        f"float32 cache: {B * G / wall:.4e} tokens/s ({wall:.3f} s, "
        f"prefill by {P - 1} teacher-forced steps); ms a decode step mean "
        f"{sum(steps) / len(steps):.3f}, max {max(steps):.3f}, mean after "
        f"the first {sum(steps[1:]) / (len(steps) - 1):.3f} over "
        f"{len(steps)} steps; peak {peak} B; decode logits at position "
        f"{P - 1} vs the kernel-path forward: max |dlogit| {err:.4e} = "
        f"{share:.4e} of max|logit| (bound {bound:.4e}); launches "
        f"{path.launches} [{SMI}]")


def moe_routing(params, x, cfg):
    """The routing ``moe_einsum`` computes for x [B, S, D] (its token
    groups, so the same bits): (probs [B, S, E], the top-k expert ids of
    each token sorted [B, S, K], the gap between its k-th and (k+1)-th
    probability [B, S])."""
    from repro_torch.models.moe import GROUP_SIZE, router_probs, topk
    B, S, D = x.shape
    g = min(GROUP_SIZE, B * S)
    probs, _ = router_probs(params, x.reshape(B * S // g, g, D), cfg.moe)
    K = cfg.moe.top_k
    vals, ids = topk(probs, K + 1)
    return (probs.reshape(B, S, -1), ids[..., :K].sort(-1).values.reshape(
        B, S, K), (vals[..., K - 1] - vals[..., K]).reshape(B, S))


def routing_differences(dcra_runs, einsum_runs):
    """Per layer, the tokens the two runs sent to other experts. Each must
    sit at a near tie: the einsum run's gap between its k-th and (k+1)-th
    probability at most ``2 max|dp| + 2^-20``, dp the two runs'
    probabilities at that layer (from their own inputs, by the einsum's
    function). Returns ([differences a layer], the first position of each
    sequence at or after which some layer routed differently)."""
    import torch
    counts, first = [], None
    for layer, ((ids_d, probs_d), (probs_e, ids_e, gap_e)) in enumerate(
            zip(dcra_runs, einsum_runs)):
        diff = (ids_d != ids_e).any(-1)                      # [B, S]
        tau = 2 * float((probs_d - probs_e).abs().max()) + 2.0 ** -20
        if bool((gap_e[diff] > tau).any()):
            raise AssertionError(
                f"layer {layer}: {int(diff.sum())} tokens routed apart, "
                f"gaps {gap_e[diff][:8].tolist()} above the runs' noise "
                f"{tau:.3e}")
        counts.append(int(diff.sum()))
        S = diff.shape[1]
        pos = torch.where(diff, torch.arange(S, device=diff.device), S)
        at = pos.amin(1)
        first = at if first is None else torch.minimum(first, at)
    return counts, first


def lm_olmoe(device, totals):
    """OLMoE-1B-7B at full width: a ``MeshInfo`` over phase 10's fused
    packaging (data 2, expert 8, tp 1), so every MoE layer runs
    ``moe_dcra`` (a wrapper gives it :data:`LM_MOE_QUEUES` and asks it for
    its stats: drops, top-k ids), against the same weights with no
    ``MeshInfo`` (``moe_einsum`` at factor 8: each expert holds its whole
    group; a wrapper keeps its routing). The forwards are timed after,
    with neither wrapper in place (the dispatch given only its queues).
    Routing is a top-k: where the two runs' inputs (1e-6 apart: other
    sums, ``index_add_``'s order) meet a near tie, a token may take
    another expert and, through attention, move the later positions of
    its sequence. So every routing difference must sit at a near tie
    (:func:`routing_differences`), and the logits are held to
    :func:`logit_bound` at every position before its sequence's first
    difference."""
    import dataclasses
    import functools
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import dispatch
    from repro_torch.core.dispatch import MeshInfo
    from repro_torch.core.fabric import Fabric
    from repro_torch.core.queues import QueueConfig
    from repro_torch.models import moe
    from repro_torch.models.model_zoo import build_model
    cfg = get_config(MOE_ARCH)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))
    label, shape, names, kw = MOE_PACKAGINGS[0]
    info = MeshInfo(Fabric.virtual(shape, names, device=device), **kw)
    t0 = time.perf_counter()
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    model = build_model(cfg, mesh_info=info).init(gen)
    torch.cuda.synchronize()
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"lm {MOE_ARCH}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k}; weights "
        f"{n_bytes} B float32 from torch.Generator seed {SEED} on the card "
        f"in {time.perf_counter() - t0:.2f} s; MeshInfo {label}, queues "
        f"{LM_MOE_QUEUES}")
    einsum = build_model(cfg, device=device)
    einsum.load(model.tree())
    batch = lm_batch(cfg, LM_MOE_TOKENS)
    B, S = LM_MOE_TOKENS
    K, n_sh = cfg.moe.top_k, info.mesh.n_devices
    # the fused packaging's x spec: batch over data, seq over the group
    x_spec = ("data", ("expert", "tp"), None)
    drops, dcra_runs, einsum_runs = [], [], []
    dcra, moe_einsum = dispatch.moe_dcra, moe.moe_einsum
    queues = QueueConfig(default_iq=None, iq_factors=LM_MOE_QUEUES)
    sized = functools.partial(dcra, queues=queues)

    def dcra_counted(params, x, c, i):
        out, aux, stats = dcra(params, x, c, i, return_stats=True,
                               queues=queues)
        drops.append(int(stats.total_dropped))
        ids = info.mesh.unshard(stats.topk_ids.reshape(
            n_sh, B // 2, S // 8, K), x_spec)
        dcra_runs.append((ids.sort(-1).values, moe_routing(params, x, c)[0]))
        return out, aux

    def einsum_seen(params, x, c):
        einsum_runs.append(moe_routing(params, x, c))
        return moe_einsum(params, x, c)
    dispatch.moe_dcra, moe.moe_einsum = dcra_counted, einsum_seen
    try:
        with torch.inference_mode():
            with MainPath(f"{MOE_ARCH} forward (moe_dcra)",
                          ("flash_attention", "bucket_scatter"), totals,
                          STAGED) as path:
                with FirstFlashInputs() as first_in:
                    got, _ = model.forward(batch)
            want, _ = einsum.forward(batch)
    finally:
        dispatch.moe_dcra, moe.moe_einsum = dcra, moe_einsum
    counts, first = routing_differences(dcra_runs, einsum_runs)
    L = cfg.num_layers
    if (path.launches["flash_attention"] != L or drops[:L] != [0] * L):
        raise AssertionError(f"{MOE_ARCH}: launches {path.launches}, drops "
                             f"a layer {drops[:L]}")
    keep = torch.arange(S, device=device)[None] < first[:, None]
    bound = logit_bound(cfg, torch.float32, S)
    err, share = logits_held(f"{MOE_ARCH} moe_dcra vs moe_einsum",
                             got[keep], want[keep], bound)
    whole = float((got - want).abs().max())
    lm_flash_check(MOE_ARCH, first_in.seen,
                   (B * cfg.num_heads, S, cfg.resolved_head_dim))
    del got, want, first_in.seen, dcra_runs[:], einsum_runs[:]
    # timed with nothing patched in but the dispatch's queue sizing
    dispatch.moe_dcra = sized
    try:
        with torch.inference_mode():
            _, ms, peak = timed_forward(model, batch)
    finally:
        dispatch.moe_dcra = dcra
    with torch.inference_mode():
        _, ms_e, peak_e = timed_forward(einsum, batch)
    log(f"lm {MOE_ARCH} x {LM_MOE_TOKENS}: flash launches "
        f"{path.launches['flash_attention']}, bucket_scatter "
        f"{path.launches['bucket_scatter']}, drops {sum(drops[:L])} over {L} "
        f"layers; forward {ms:.2f} ms warm ({B * S / ms * 1e3:.4e} "
        f"tokens/s), peak {peak} B; einsum MoE {ms_e:.2f} ms warm, peak "
        f"{peak_e} B; tokens routed apart (all at near ties) a layer "
        f"{counts}; at the {int(keep.sum())} of {B * S} positions before "
        f"their sequence's first: max |dlogit| {err:.4e} = {share:.4e} of "
        f"max|logit| (bound {bound:.4e}); at all positions {whole:.4e} "
        f"[{SMI}]")


def run_lm(device, totals):
    """Phase 16: granite-8b at full width, random float32 weights from
    ``torch.Generator`` seed ``SEED`` on the card; forwards of tokens
    ``LM_TOKENS`` in float32 and bf16 on the kernel path against the
    torch path; ``serve``; then OLMoE-1B-7B through ``moe_dcra``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    model = build_model(cfg, device=device).init(gen)
    torch.cuda.synchronize()
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"lm {LM_ARCH} (arXiv:2405.04324): {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, hd "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; "
        f"weights {n_bytes} B float32 ({cfg.param_count()} parameters) from "
        f"torch.Generator seed {SEED} on the card in "
        f"{time.perf_counter() - t0:.2f} s; tokens synth_batch at train_4k "
        f"cut to batch {LM_TOKENS[0]} (from 256), seq {LM_TOKENS[1]}")
    batch = lm_batch(cfg, LM_TOKENS)
    with torch.inference_mode():
        lm_forwards(f"{LM_ARCH} float32", model, batch, torch.float32,
                    "blocked", totals)
        bf16 = build_model(cfg, dtype=torch.bfloat16, device=device)
        bf16.load(model.tree())
        lm_forwards(f"{LM_ARCH} bf16", bf16, batch, torch.bfloat16, "wgmma",
                    totals)
        del bf16
    torch.cuda.empty_cache()
    lm_serve(model, totals, device)
    del model
    torch.cuda.empty_cache()
    lm_olmoe(device, totals)
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 17: the decoder LMs' training path
# ---------------------------------------------------------------------------

TRAIN_LAYERS = 4                   # OLMoE-1B-7B cut from 16 layers
TRAIN_TOKENS = (2, 4096)           # TRAIN_4K cut from batch 256
TRAIN_STEPS = 3
#: step 1 on the kernel path against the sort route: the loss within this
#: share of itself, every gradient leaf within this share of its max|g|
#: (the bounds the CPU tests hold the port to the reference by; the two
#: routes admit the same tasks and no sum adds by index, so where they
#: route alike they agree bit for bit)
TRAIN_LOSS_REL, TRAIN_GRAD_REL = 1e-5, 1e-4
#: (b) the CLI: reduced granite-8b at tests/test_system.py's peak and warmup
TRAIN_CLI = ["--arch", "granite-8b", "--reduced", "--steps", "20",
             "--lr", "3e-3", "--warmup", "5"]
#: (c) the restart: a failure at step 7, a checkpoint every 5 steps; the
#: replayed steps run the same ops on the same values, so the losses must
#: equal the uninterrupted run's within RESTART_REL, relative (equal on
#: the H100; on the CPU two uninterrupted runs of these 20 steps differ
#: by up to 1.3e-7, their sums not repeatable bit for bit)
RESTART_AT, RESTART_EVERY, RESTART_REL = 7, 5, 1e-6


class KeepGrads:
    """An optimiser that hands every call to ``opt`` and keeps copies of
    the gradients of its first call (``self.grads``; ``keep``: in host
    memory unless named)."""

    def __init__(self, opt, keep=None):
        self.opt, self.grads, self.calls = opt, None, 0
        self.keep = keep or host_copy

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params):
        if not self.calls:
            self.grads = self.keep(grads)
        self.calls += 1
        return self.opt.update(grads, state, params)


class RoutingSpy:
    """Within: every ``moe_dcra`` call runs with ``queues`` (``None``: the
    config's) and returns its stats to this spy; the first ``n`` calls (a
    forward's layers: remat's recompute follows) keep their drops, and
    their top-k ids [B, S, K] sorted with the router probabilities and
    top-k gaps :func:`moe_routing` gives on the call's own x."""

    def __init__(self, info, tokens, n, queues=None):
        self.info, self.tokens, self.n, self.queues = info, tokens, n, queues
        self.drops, self.runs = [], []

    def __enter__(self):
        import torch
        from repro_torch.core import dispatch
        self.dispatch, self.real = dispatch, dispatch.moe_dcra
        B, S = self.tokens
        n_sh = self.info.mesh.n_devices
        x_spec = ("data", ("expert", "tp"), None)    # the fused packaging

        def spy(params, x, cfg, info):
            out, aux, stats = self.real(params, x, cfg, info,
                                        queues=self.queues,
                                        return_stats=True)
            if len(self.runs) < self.n:
                K = cfg.moe.top_k
                with torch.no_grad():
                    ids = info.mesh.unshard(stats.topk_ids.reshape(
                        n_sh, B // 2, S // 8, K), x_spec).sort(-1).values
                    probs, _, gap = moe_routing(params, x.detach(), cfg)
                self.drops.append(int(stats.total_dropped))
                self.runs.append((ids, probs, gap))
            return out, aux
        dispatch.moe_dcra = spy
        return self

    def __exit__(self, *_):
        self.dispatch.moe_dcra = self.real
        return False


def host_copy(tree):
    """A copy of each tensor of ``tree`` in host memory."""
    return {k: v.detach().to("cpu", copy=True) for k, v in tree.items()}


def same_bits(a, b):
    """``(bit-identical, max|a - b|)`` of two tensors of one shape."""
    ints = {1: "uint8", 2: "int16", 4: "int32", 8: "int64"}
    import torch
    t = getattr(torch, ints[a.element_size()])
    equal = a.dtype == b.dtype and torch.equal(a.contiguous().view(t),
                                               b.contiguous().view(t))
    return equal, 0.0 if equal else float((a.float() - b.float()).abs().max())


def grads_held(got, want, device):
    """Every gradient leaf of ``got`` within :data:`TRAIN_GRAD_REL` of its
    max|g| of ``want``'s (host copies, compared on the card leaf by
    leaf). Returns the largest share."""
    worst = 0.0
    for k, w in want.items():
        w, g = w.to(device), got[k].to(device)
        scale = float(w.abs().max())
        share = float((g - w).abs().max()) / max(scale, 1e-30)
        if not share <= TRAIN_GRAD_REL:
            raise AssertionError(f"train step: gradient {k} {share:.3e} of "
                                 f"max|g| {scale:.3e} from the sort route")
        worst = max(worst, share)
    return worst


def params_held(params, want, p0, grads, lr1, eps, device):
    """The parameters after AdamW's first step (update ``lr (g' / (|g'| +
    eps) + wd p)``, g' the clipped gradient) against the sort route's: an
    entry whose gradient is near 0 may take the other sign, so every
    entry within ``2 lr`` plus 2 float32 ulps of |p|; where |g'| is at
    least 1e-3 of the leaf's max and large enough that the runs' gradient
    difference (at most ``TRAIN_GRAD_REL`` of the max) moves ``g' / (|g'|
    + eps)`` by under 1e-3 (|g'|^2 >= 1e3 eps TRAIN_GRAD_REL max|g'|),
    within 1e-3 of lr plus the ulps. Returns (largest difference, largest
    over the firm entries, the firm share)."""
    import torch
    norm = torch.sqrt(sum(torch.sum(torch.square(g.to(device)))
                          for g in grads.values()))
    scale = float(torch.clamp(1.0 / (norm + 1e-9), max=1.0))
    worst = worst_firm = 0.0
    firm_n = total = 0
    for k, p in params.items():
        w, q0 = want[k].to(device), p0[k].to(device)
        g = grads[k].to(device) * scale
        err = (p.detach() - w).abs()
        ulp = 2.0 ** -22 * q0.abs()
        gmax = float(g.abs().max())
        floor = max(1e-3 * gmax, (1e3 * eps * TRAIN_GRAD_REL * gmax) ** 0.5)
        firm = g.abs() >= floor
        if not bool((err <= 2 * lr1 + ulp).all()) or not bool(
                (err[firm] <= 1e-3 * lr1 + ulp[firm]).all()):
            raise AssertionError(f"train step: parameter {k} {float(err.max())}"
                                 f" from the sort route's (lr {lr1})")
        worst = max(worst, float(err.max()))
        if bool(firm.any()):
            worst_firm = max(worst_firm, float(err[firm].max()))
        firm_n += int(firm.sum())
        total += firm.numel()
    return worst, worst_firm, firm_n / total


def train_step_again(model, params, p0, batch, loss, grads):
    """Step 1 on the kernel path once more, from the host copy ``p0`` and
    the same batch: the loss, every gradient leaf (``grads``, the first
    run's host copies) and every parameter after the step (``params``,
    the first run's) must equal the first run's bit for bit, since no sum
    on the path adds in an order that changes from run to run. Returns
    the second run's ``(params, state)`` and its optimiser."""
    import torch
    from repro_torch.launch.steps import default_optimizer, make_train_step
    t0 = time.perf_counter()
    first = {k: v.detach().clone() for k, v in params.items()}
    with torch.no_grad():
        for k, v in model.paths().items():
            v.copy_(p0[k])
    opt = KeepGrads(default_optimizer(),
                    keep=lambda t: {k: v.detach().clone()
                                    for k, v in t.items()})
    step = make_train_step(model, opt)
    params = model.paths()
    params, state, metrics = step(params, opt.init(params), batch)
    again = float(metrics["loss"])
    apart = {}
    for what, one, two in (("gradient", grads, opt.grads),
                           ("parameter", first, params)):
        for k, v in one.items():
            same, d = same_bits(v.to(two[k].device), two[k])
            if not same:
                apart[f"{what} {k}"] = d
    torch.cuda.synchronize()
    if apart or again != loss:
        raise AssertionError(f"train step 1 run twice: loss {loss!r} vs "
                             f"{again!r}; {len(apart)} leaves differ "
                             f"({dict(list(apart.items())[:4])})")
    log(f"train {MOE_ARCH} step 1 run twice from the same weights and batch: "
        f"loss {again!r}, all {len(grads)} gradient leaves and "
        f"{len(first)} parameter leaves after the step bit-identical "
        f"(held; {time.perf_counter() - t0:.2f} s) [{SMI}]")
    return params, state, opt.opt


def train_olmoe(device, totals):
    """(a) OLMoE-1B-7B at full width, depth cut to ``TRAIN_LAYERS``, remat
    ``block``, ``moe_dcra`` on phase 10's fused packaging at the config's
    queues: ``TRAIN_STEPS`` AdamW steps through ``make_train_step`` and
    ``default_optimizer()`` on ``synth_batch`` tokens ``TRAIN_TOKENS``;
    step 1 held to the same step on the plain sort route from the same
    weights and batch (loss, every gradient leaf, the parameters after)
    where the two runs route alike, every routing difference held to a
    near tie, and step 1 on the kernel path run again from the same
    weights and batch, bit-identical (:func:`train_step_again`); steps
    2-3 timed with nothing patched in (the same state, a train step over
    the plain optimiser)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.dispatch import MeshInfo, dispatch_queues
    from repro_torch.core.fabric import Fabric
    from repro_torch.launch.steps import default_optimizer, make_train_step
    from repro_torch.models.model_zoo import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=TRAIN_LAYERS)
    L, (B, S) = cfg.num_layers, TRAIN_TOKENS
    label, shape, names, kw = MOE_PACKAGINGS[0]
    info = MeshInfo(Fabric.virtual(shape, names, device=device), **kw)
    t0 = time.perf_counter()
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    model = build_model(cfg, mesh_info=info).init(gen)
    batch = {k: torch.as_tensor(v, device=device)
             for k, v in lm_batch(cfg, TRAIN_TOKENS).items()}
    p0 = host_copy(model.paths())
    n_params = sum(v.numel() for v in p0.values())
    log(f"train {MOE_ARCH} (arXiv:2409.02060): {L} of 16 layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads} heads x {cfg.resolved_head_dim}, "
        f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k}, d_expert "
        f"{cfg.moe.d_expert}, vocab {cfg.vocab_size}; {n_params} float32 "
        f"parameters from torch.Generator seed {SEED} in "
        f"{time.perf_counter() - t0:.2f} s (a host copy kept); remat "
        f"{cfg.remat}; MeshInfo {label}, queues at factor "
        f"{cfg.moe.capacity_factor}; tokens synth_batch train_4k cut to "
        f"{TRAIN_TOKENS}")

    # step 1 on the plain sort route, from the same weights and batch
    sort_q = dataclasses.replace(dispatch_queues(cfg.moe), route_impl="sort")
    opt = KeepGrads(default_optimizer())
    step = make_train_step(model, opt)
    t0 = time.perf_counter()
    with RoutingSpy(info, TRAIN_TOKENS, L, sort_q) as spy_s:
        _, state, metrics = step(model.paths(), opt.init(model.paths()),
                                 batch)
    loss_s = float(metrics["loss"])
    ms_s = (time.perf_counter() - t0) * 1e3
    g_s, p1_s = opt.grads, host_copy(model.paths())
    del state, metrics
    with torch.no_grad():
        for k, p in model.paths().items():
            p.copy_(p0[k])

    # the kernel path: step 1 held, steps 2.. timed
    opt = KeepGrads(default_optimizer())
    step = make_train_step(model, opt)
    params = model.paths()
    state = opt.init(params)
    t0 = time.perf_counter()
    with MainPath(f"{MOE_ARCH} train step 1 (moe_dcra)", ("bucket_scatter",),
                  totals, STAGED) as first:
        with RoutingSpy(info, TRAIN_TOKENS, L) as spy_k:
            params, state, metrics = step(params, state, batch)
    losses = [float(metrics["loss"])]
    ms_1 = (time.perf_counter() - t0) * 1e3
    counts, first_diff = routing_differences(
        [(ids, probs) for ids, probs, _ in spy_k.runs],
        [(probs, ids, gap) for ids, probs, gap in spy_s.runs])
    lr1 = float(opt.opt.lr(torch.tensor(1, dtype=torch.int32)))
    held = "held"
    if sum(counts) == 0:
        d_loss = abs(losses[0] - loss_s)
        if not d_loss <= TRAIN_LOSS_REL * abs(loss_s):
            raise AssertionError(f"train step: loss {losses[0]} vs the sort "
                                 f"route's {loss_s}")
        g_share = grads_held(opt.grads, g_s, device)
        p_err, p_firm, firm = params_held(params, p1_s, p0, g_s, lr1,
                                          opt.opt.eps, device)
    else:
        # a near tie moved a token: the routing before it is held (by
        # routing_differences); the step after it is reported
        held = "reported, not held"
        d_loss = abs(losses[0] - loss_s)
        g_share = max(float((opt.grads[k] - w).abs().max())
                      / max(float(w.abs().max()), 1e-30)
                      for k, w in g_s.items())
        p_err, p_firm, firm = (max(float((params[k].detach().cpu() - w)
                                         .abs().max())
                                   for k, w in p1_s.items()), float("nan"),
                               float("nan"))
    del g_s, p1_s
    first_launches = first.launches["bucket_scatter"]
    if (first_launches != 4 * L or first.launches["flash_attention"]
            or spy_k.drops != spy_s.drops):
        raise AssertionError(f"train step 1: launches {first.launches} (want "
                             f"{4 * L} scatter, 0 flash), drops "
                             f"{spy_k.drops} vs the sort route's "
                             f"{spy_s.drops}")
    log(f"train {MOE_ARCH} step 1 vs the sort route ({held}): loss "
        f"{losses[0]:.6f} vs {loss_s:.6f} (|d| {d_loss:.3e}, bound "
        f"{TRAIN_LOSS_REL:.0e} of it); gradients within {g_share:.3e} of "
        f"each leaf's max|g| (bound {TRAIN_GRAD_REL:.0e}); parameters after "
        f"the step within {p_err:.3e} (bound 2 lr = {2 * lr1:.3e}), "
        f"{p_firm:.3e} at the {firm:.4f} of entries with a firm gradient "
        f"(bound 1e-3 lr); tokens routed apart (all at near ties) a layer "
        f"{counts}; drops a layer {spy_k.drops} (capacity factor "
        f"{cfg.moe.capacity_factor}); step 1 {ms_1:.1f} ms, sort route "
        f"{ms_s:.1f} ms (both instrumented) [{SMI}]")
    del state, metrics
    params, state, optimiser = train_step_again(model, params, p0, batch,
                                                losses[0], opt.grads)
    del p0, opt
    step = make_train_step(model, optimiser)    # steps 2..: the optimiser alone

    times = []
    torch.cuda.reset_peak_memory_stats()
    with MainPath(f"{MOE_ARCH} train steps 2-{TRAIN_STEPS}",
                  ("bucket_scatter",), totals, STAGED) as path:
        for _ in range(TRAIN_STEPS - 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, metrics = step(params, state, batch)
            losses.append(float(metrics["loss"]))
            times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    launches = path.launches["bucket_scatter"] / (TRAIN_STEPS - 1)
    if (launches != 4 * L or path.launches["flash_attention"]
            or not all(map(math.isfinite, losses))):
        raise AssertionError(f"train steps: launches {path.launches}, "
                             f"losses {losses}")
    ms = sum(times) / len(times)
    log(f"train {MOE_ARCH} x {TRAIN_TOKENS}: {TRAIN_STEPS} AdamW steps "
        f"(default_optimizer, lr(1) {lr1:.3e}), losses "
        f"{[round(v, 6) for v in losses]}; steps 2-{TRAIN_STEPS} "
        f"{[round(t, 2) for t in times]} ms, mean {ms:.2f} ms a step "
        f"({B * S / ms * 1e3:.4e} tokens/s), peak {peak} B; bucket_scatter "
        f"{launches:.0f} launches a step ({L} layers x 2 buckets x 2: "
        f"forward and remat's recompute), staged only; flash 0 [{SMI}]")
    del model, params, state, metrics


def train_cli(device, totals):
    """(b) ``launch/train.py``'s ``main`` on the card: :data:`TRAIN_CLI`
    (the loss must fall below 0.7 of its first); (c) the same trainer
    under ``run_training`` with a failure at ``RESTART_AT`` and a
    checkpoint every ``RESTART_EVERY`` steps: one restart, step 20, and
    the uninterrupted run's losses."""
    import contextlib
    import io
    import tempfile
    from repro_torch.launch import train
    from repro_torch.runtime.fault_tolerance import (FailurePlan,
                                                     StragglerWatchdog,
                                                     run_training)
    argv = TRAIN_CLI + ["--device", str(device)]
    out = io.StringIO()
    with MainPath("train CLI", (), totals) as path:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            res = train.main(argv)
        wall = time.perf_counter() - t0
    for line in out.getvalue().splitlines():
        log(f"train CLI | {line}")
    losses = [m["loss"] for m in res.metrics_history]
    if (res.final_step != 20 or len(losses) != 20 or any(path.launches.values())
            or not all(map(math.isfinite, losses))
            or not losses[-1] < 0.7 * losses[0]):
        raise AssertionError(f"train CLI: step {res.final_step}, losses "
                             f"{losses}, launches {path.launches}")
    log(f"train CLI {' '.join(argv)}: {wall:.2f} s, loss {losses[0]:.6f} -> "
        f"{losses[-1]:.6f} ({losses[-1] / losses[0]:.4f} of the first, "
        f"below 0.7) [{SMI}]")
    step_fn, init_state, batch_fn = train.trainer(train.parser().parse_args(
        argv))
    plan = FailurePlan({RESTART_AT: "injected"})
    with MainPath("train restart", (), totals) as path:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as ckpt_dir:
            again = run_training(step_fn, init_state, batch_fn, 20, ckpt_dir,
                                 ckpt_every=RESTART_EVERY, failure_plan=plan,
                                 watchdog=StragglerWatchdog())
        wall = time.perf_counter() - t0
    replayed = [m["loss"] for m in again.metrics_history]
    diff = max(abs(a - b) / abs(b) for a, b in zip(replayed, losses))
    if (again.restarts != 1 or again.final_step != 20 or len(replayed) != 20
            or plan.fired != [(RESTART_AT, "injected")]
            or any(path.launches.values()) or not diff <= RESTART_REL):
        raise AssertionError(f"train restart: {again.restarts} restarts, step "
                             f"{again.final_step}, {len(replayed)} losses, "
                             f"{diff} from the uninterrupted run's")
    log(f"train restart: failure at step {RESTART_AT}, checkpoints every "
        f"{RESTART_EVERY}: {again.restarts} restart, final step "
        f"{again.final_step}, steps 5-6 replayed from step 4's checkpoint; "
        f"losses within {diff:.3e} of the uninterrupted run's, relative "
        f"(bound {RESTART_REL:.0e}); {wall:.2f} s [{SMI}]")


def run_train(device, totals):
    """Phase 17: (a) :func:`train_olmoe`, then (b) and (c)
    :func:`train_cli`."""
    import torch
    train_olmoe(device, totals)
    torch.cuda.empty_cache()
    train_cli(device, totals)
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 18: the recurrent, hybrid and encoder-decoder LMs
# ---------------------------------------------------------------------------

REC_TOKENS = (2, 4096)             # TRAIN_4K cut to batch 2
REC_SERVE = (2, 64, 16)            # prompts, prompt length, generated
REC_DECODE = 16                    # seamless: decode steps over the encoder
REC_TRAIN_LAYERS = 12              # zamba2-7b cut from 81 layers
REC_TRAIN_STEPS = 3
#: chunked against scan at layer 0, as a share of max|y|: the reference
#: tests' bounds (tests/test_models.py: 1e-4 RWKV, 1e-3 Mamba)
WKV_SCAN_REL, SSD_SCAN_REL = 1e-4, 1e-3


class FirstCall:
    """Within: ``module.name`` runs as it is and keeps copies of its first
    call's arguments (``self.args``, ``self.kw``): a recurrence's inputs
    at layer 0 on the main path."""

    def __init__(self, module, name):
        self.module, self.name, self.args, self.kw = module, name, None, None

    def __enter__(self):
        import torch
        self.real = getattr(self.module, self.name)

        def keep(*args, **kw):
            if self.args is None:
                self.args = tuple(a.clone() if isinstance(a, torch.Tensor)
                                  else a for a in args)
                self.kw = dict(kw)
            return self.real(*args, **kw)
        setattr(self.module, self.name, keep)
        return self

    def __exit__(self, *_):
        setattr(self.module, self.name, self.real)
        return False


def chunked_vs_scan(tag, first, scan, rel):
    """The chunked recurrence against the scan on the inputs ``first``
    kept (layer 0's): y and the end state within ``rel`` of max|.| of
    the scan's; both timed (one synchronised run each, the chunked form's
    after a warm-up run)."""
    import torch
    chunked = first.real
    chunked(*first.args, **first.kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y_c, s_c = chunked(*first.args, **first.kw)
    torch.cuda.synchronize()
    ms_c = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    y_s, s_s = scan(*first.args)
    torch.cuda.synchronize()
    ms_s = (time.perf_counter() - t0) * 1e3
    errs = []
    for what, got, want in (("y", y_c, y_s), ("state", s_c, s_s)):
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        if not err <= rel * scale:
            raise AssertionError(f"{tag}: chunked {what} {err} from the "
                                 f"scan's, above {rel} of {scale}")
        errs.append(err / scale)
    log(f"lm {tag}: layer 0's chunked recurrence ({first.kw or 'the '
        f'default chunk'}) on its main "
        f"path inputs {tuple(first.args[0].shape)} against the exact scan: "
        f"y within {errs[0]:.3e}, the end state {errs[1]:.3e} of max|.| "
        f"(bound {rel:.0e}); chunked {ms_c:.2f} ms, scan {ms_s:.2f} ms "
        f"[{SMI}]")


def rec_model(arch, device, **replace):
    """The arch's model at its published width (``replace``: the cut)
    with float32 weights from ``torch.Generator`` seed ``SEED`` on the
    card, logged with its dimensions, bytes and seconds."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build_model
    cfg = dataclasses.replace(get_config(arch), **replace)
    t0 = time.perf_counter()
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    model = build_model(cfg, device=device).init(gen)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    heads = (f"{cfg.num_heads}/{cfg.num_kv_heads} heads, hd "
             f"{cfg.resolved_head_dim}" if cfg.num_heads else
             f"{cfg.d_model // cfg.ssm.head_dim} WKV heads of "
             f"{cfg.ssm.head_dim}")
    ssm = (f", ssm state {cfg.ssm.state_dim}, chunk {cfg.ssm.chunk_size}"
           if cfg.family == "hybrid" else "")
    log(f"lm {arch} ({cfg.source}): {cfg.num_layers} layers"
        + (f" + {cfg.encoder_layers} encoder" if cfg.encoder_layers else "")
        + f", d_model {cfg.d_model}, {heads}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}{ssm}; {n} float32 parameters ({4 * n} B) from "
        f"torch.Generator seed {SEED} on the card in "
        f"{time.perf_counter() - t0:.2f} s"
        + (f" (cut: {replace})" if replace else ""))
    return model


def rec_forwards(tag, model, batch, design_f32, design_bf16, totals,
                 masks=None):
    """:func:`lm_forwards` in float32, then in bf16 on a model that shares
    the weights; returns the float32 logits."""
    import torch
    from repro_torch.models.model_zoo import build_model
    with torch.inference_mode():
        got = lm_forwards(f"{tag} float32", model, batch, torch.float32,
                          design_f32, totals, masks)
        bf16 = build_model(model.cfg, dtype=torch.bfloat16,
                           device=model.device)
        bf16.load(model.tree())
        lm_forwards(f"{tag} bf16", bf16, batch, torch.bfloat16, design_bf16,
                    totals, masks, ref=got)
        del bf16
    torch.cuda.empty_cache()
    return got


def rec_zamba(device, totals):
    """(a) zamba2-7b at its width: the forwards (13 flash launches each,
    hd 112), layer 0's chunked SSD against the scan, ``serve``."""
    import torch
    from repro_torch.models import mamba2
    model = rec_model("zamba2-7b", device)
    batch = lm_batch(model.cfg, REC_TOKENS)
    masks = [True] * (model.cfg.num_layers // model.cfg.hybrid_attn_period)
    with FirstCall(mamba2, "ssd_chunked") as first:
        rec_forwards("zamba2-7b", model, batch, "blocked", "wgmma", totals,
                     masks)
    with torch.inference_mode():
        chunked_vs_scan("zamba2-7b", first, mamba2.ssd_scan, SSD_SCAN_REL)
    del first
    torch.cuda.empty_cache()
    lm_serve(model, totals, device, REC_SERVE)
    del model
    torch.cuda.empty_cache()


def rec_rwkv(device, totals):
    """(b) rwkv6-7b at its width: the forwards (no kernel on this path),
    layer 0's chunked WKV against the scan, ``serve``."""
    import torch
    from repro_torch.models import rwkv6
    model = rec_model("rwkv6-7b", device)
    batch = lm_batch(model.cfg, REC_TOKENS)
    with FirstCall(rwkv6, "wkv_chunked") as first:
        rec_forwards("rwkv6-7b", model, batch, None, None, totals)
    with torch.inference_mode():
        chunked_vs_scan("rwkv6-7b", first, rwkv6.wkv_scan, WKV_SCAN_REL)
    del first
    torch.cuda.empty_cache()
    lm_serve(model, totals, device, REC_SERVE)
    del model
    torch.cuda.empty_cache()


def rec_seamless(device, totals):
    """(c) seamless-m4t-large-v2 at its width on ``synth_batch``'s frames
    and tokens (train_4k cut to batch 2: src [2, 2048], tokens [2,
    2048]): the forwards (24 non-causal flash launches in the encoder,
    then 24 causal in the decoder), then ``REC_DECODE`` decode steps over
    ``precompute_cross_kv`` of the encoder's output against the float32
    forward's logits at those positions."""
    import torch
    model = rec_model("seamless-m4t-large-v2", device)
    cfg = model.cfg
    batch = lm_batch(cfg, REC_TOKENS)
    masks = [False] * cfg.encoder_layers + [True] * cfg.num_layers
    logits = rec_forwards("seamless-m4t-large-v2", model, batch, "blocked",
                          "wgmma", totals, masks)
    B, T = batch["tokens"].shape[0], REC_DECODE
    tokens = torch.as_tensor(batch["tokens"], device=device)
    with torch.inference_mode():
        with MainPath("seamless-m4t-large-v2 decode", (), totals) as path:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            enc = model.encode(batch["src_embeds"])
            ks, vs = model.precompute_cross_kv(enc)
            torch.cuda.synchronize()
            ms_enc = (time.perf_counter() - t0) * 1e3
            cache = {**model.init_cache(B, T, torch.float32, cross_len=1),
                     "cross_k": ks, "cross_v": vs}
            outs = []
            t0 = time.perf_counter()
            for t in range(T):
                lg, cache = model.decode_step(cache, tokens[:, t:t + 1], t)
                outs.append(lg)
            torch.cuda.synchronize()
            ms_dec = (time.perf_counter() - t0) * 1e3 / T
    if path.launches["flash_attention"] != cfg.encoder_layers:
        raise AssertionError(f"seamless decode: launches {path.launches}, "
                             f"want {cfg.encoder_layers} flash (the "
                             f"encoder) and none in the decode steps")
    bound = logit_bound(cfg, torch.float32, tokens.shape[1])
    err, share = logits_held("seamless decode vs forward",
                             torch.cat(outs, 1), logits[:, :T], bound)
    log(f"lm seamless-m4t-large-v2 decode over precompute_cross_kv: encode "
        f"+ cross K/V {ms_enc:.2f} ms (flash launches "
        f"{path.launches['flash_attention']}, non-causal), {T} "
        f"teacher-forced steps {ms_dec:.3f} ms a step; logits at positions "
        f"0-{T - 1} vs the kernel-path forward: max |dlogit| {err:.4e} = "
        f"{share:.4e} of max|logit| (bound {bound:.4e}) [{SMI}]")
    del model, logits, cache, ks, vs, enc
    torch.cuda.empty_cache()


class FiniteGrads:
    """An optimiser that hands every call to ``opt`` after checking that
    every gradient leaf is finite."""

    def __init__(self, opt):
        self.opt, self.calls = opt, 0

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params):
        import torch
        bad = [k for k, g in grads.items() if not bool(
            torch.isfinite(g).all())]
        if bad:
            raise AssertionError(f"train step {self.calls + 1}: gradient "
                                 f"leaves not finite: {bad[:8]}")
        self.calls += 1
        return self.opt.update(grads, state, params)


def rec_train(device, totals):
    """(d) zamba2-7b at its width with its depth cut to
    ``REC_TRAIN_LAYERS`` (two applications of the shared block), remat
    ``block``: ``REC_TRAIN_STEPS`` AdamW steps (``make_train_step``,
    ``default_optimizer()``) on ``synth_batch`` tokens ``REC_TOKENS``,
    every gradient leaf and loss finite, no flash launch (the training
    forward takes the torch attention path); ms a step, tokens/s, peak
    bytes."""
    import torch
    from repro_torch.launch.steps import default_optimizer, make_train_step
    model = rec_model("zamba2-7b", device, num_layers=REC_TRAIN_LAYERS)
    cfg = model.cfg
    batch = {k: torch.as_tensor(v, device=device)
             for k, v in lm_batch(cfg, REC_TOKENS).items()}
    opt = FiniteGrads(default_optimizer())
    step = make_train_step(model, opt)
    params = model.paths()
    state = opt.init(params)
    losses, times = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with MainPath(f"zamba2-7b train ({REC_TRAIN_LAYERS} layers)", (),
                  totals) as path:
        for _ in range(REC_TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, metrics = step(params, state, batch)
            losses.append(float(metrics["loss"]))
            times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    if (any(path.launches.values()) or opt.calls != REC_TRAIN_STEPS
            or not all(map(math.isfinite, losses))):
        raise AssertionError(f"zamba2 train: launches {path.launches}, "
                             f"{opt.calls} steps, losses {losses}")
    B, S = REC_TOKENS
    ms = sum(times[1:]) / (len(times) - 1)
    log(f"train zamba2-7b x {REC_TOKENS}: {REC_TRAIN_LAYERS} of 81 layers "
        f"({REC_TRAIN_LAYERS // cfg.hybrid_attn_period} applications of the "
        f"shared block), remat {cfg.remat}; {REC_TRAIN_STEPS} AdamW steps, "
        f"losses {[round(v, 6) for v in losses]}, every gradient leaf "
        f"finite; steps {[round(t, 2) for t in times]} ms, mean of steps "
        f"2-{REC_TRAIN_STEPS} {ms:.2f} ms ({B * S / ms * 1e3:.4e} "
        f"tokens/s), peak {peak} B; launches {path.launches} (flash 0: "
        f"training takes the torch attention path) [{SMI}]")
    del model, params, state, metrics
    torch.cuda.empty_cache()


def run_recurrent(device, totals):
    """Phase 18: (a) zamba2-7b, (b) rwkv6-7b, (c) seamless-m4t-large-v2 at
    their published widths, (d) zamba2-7b training at 12 layers."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    for part in (rec_zamba, rec_rwkv, rec_seamless, rec_train):
        t0 = time.perf_counter()
        part(device, totals)
        log(f"phase 18 {part.__name__}: {time.perf_counter() - t0:.2f} s")


# ---------------------------------------------------------------------------
# phase 19: the LM launch runtime and the analytic dry run
# ---------------------------------------------------------------------------

#: the cells run on the card at their published widths, each cut to its
#: ``dryrun.MEASURE_AT`` entry: (arch, shape, kernels its path must
#: launch, the route designs it may run)
DRY_MEASURED = (
    ("granite-8b", "train_4k", (), None),
    ("granite-8b", "prefill_32k", ("flash_attention",), None),
    ("granite-8b", "decode_32k", (), None),
    ("olmoe-1b-7b", "train_4k", BUCKET_KERNELS, STAGED),
)
#: the example scripts and the small arguments phase 19 runs them at
DRY_EXAMPLES = {
    "train_lm_torch": ["--steps", "8", "--batch", "2", "--seq", "64",
                       "--warmup", "2", "--lr", "3e-3"],
    "serve_lm_torch": ["--batch", "2", "--prompt-len", "8", "--gen", "4"],
    "quickstart_torch": [],
    "serve_graph_torch": ["--requests", "8"],
}
DRY_WAIT = 240                     # seconds phase 19 waits for a subprocess
PSUM_SHAPE, PSUM_AXES = (2, 2), ("data", "model")


def psum_inputs(device):
    """The per-shard gradients and residuals ``[4, 5, 3]`` of phase 19
    (d), from a seeded numpy generator, on ``device``."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED)
    g = rng.standard_normal((4, 5, 3)).astype(np.float32)
    r = (rng.standard_normal((4, 5, 3)) * 0.01).astype(np.float32)
    return (torch.from_numpy(g).to(device), torch.from_numpy(r).to(device))


def psum_worker(coord, pid, out_dir):
    """``--psum-worker COORD PID DIR``: one process of phase 19 (d). Joins
    the gloo group at ``COORD`` as process ``PID`` with a 2 x 2 ``("data",
    "model")`` fabric on the card (``data`` crosses the processes),
    ``compress_psum``s its rows of :func:`psum_inputs` over ``data`` and
    writes the gathered mean and residuals into ``DIR/psum<PID>.npz``."""
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.fabric import Fabric
    from repro_torch.optim import compression as comp
    device = torch.device(*CARD)
    fab = Fabric.distributed(PSUM_SHAPE, PSUM_AXES, coordinator_address=coord,
                             num_processes=2, process_id=int(pid),
                             device=device, timeout=SCALE_OUT_PG_TIMEOUT)
    g, r = (fab.local_rows(t) for t in psum_inputs(device))
    out, ef = comp.compress_psum({"g": g}, comp.EFState({"g": r}), fab,
                                 "data")
    np.savez(Path(out_dir) / f"psum{pid}.npz",
             mean=fab.gather_shards(out["g"]).cpu().numpy(),
             residual=fab.gather_shards(ef.residual["g"]).cpu().numpy(),
             dcn=np.array(fab.dcn_axes()))
    dist.destroy_process_group()
    return 0


def start_subprocesses(out_dir):
    """Phase 19's processes, all started at once: the four example scripts
    on the card at :data:`DRY_EXAMPLES`' arguments and the two
    ``--psum-worker`` processes. -> ``{name: (Popen, log path, host
    clock at its start)}``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    coord = f"127.0.0.1:{free_port()}"
    cmds = {name: [sys.executable, str(ROOT / "examples" / f"{name}.py")]
            + args for name, args in DRY_EXAMPLES.items()}
    for pid in range(2):
        cmds[f"psum worker {pid}"] = [sys.executable,
                                      str(Path(__file__).resolve()),
                                      "--psum-worker", coord, str(pid),
                                      str(out_dir)]
    procs = {}
    for name, cmd in cmds.items():
        path = out_dir / (name.replace(" ", "_") + ".log")
        with open(path, "w") as f:
            procs[name] = (subprocess.Popen(cmd, stdout=f,
                                            stderr=subprocess.STDOUT,
                                            cwd=str(ROOT), env=env), path,
                           time.perf_counter())
    return procs


def kill_subprocesses(procs):
    for p, _, _ in procs.values():
        if p.poll() is None:
            p.kill()
        p.wait()


def finish_subprocesses(procs):
    """Wait for every process (at most :data:`DRY_WAIT` s from now), kill
    what is left, and -> ``{name: (exit code, seconds from its start to
    its end as seen here, log tail)}``."""
    deadline = time.perf_counter() + DRY_WAIT
    done = {}
    try:
        while len(done) < len(procs) and time.perf_counter() < deadline:
            for name, (p, _, t0) in procs.items():
                if name not in done and p.poll() is not None:
                    done[name] = time.perf_counter() - t0
            time.sleep(0.1)
    finally:
        kill_subprocesses(procs)
    return {name: (p.returncode, done.get(name), path.read_text()[-1500:])
            for name, (p, path, _) in procs.items()}


def dry_table(device):
    """Phase 19 (a): every arch x shape x {single, multi} cell laid out on
    meta with its specs on H100 figures; the report's summary, the
    bottleneck counts, and the full table written to
    ``build/dryrun_table.md``."""
    from repro_torch.launch import dryrun, report
    t0 = time.perf_counter()
    results = dryrun.run_sweep(
        dryrun.tasks_for(list(dryrun.ARCH_IDS), list(dryrun.SHAPE_NAMES),
                         [False, True], verbose=False), out=None,
        resume=False, raise_errors=True)
    seconds = time.perf_counter() - t0
    base = [r for r in results if "compute_s" in r]
    skipped = [r for r in results if "skipped" in r]
    if len(base) + len(skipped) != 80 or len(skipped) != 12:
        raise AssertionError(f"dry run: {len(base)} cells, {len(skipped)} "
                             f"skips of 80")
    if any(r["collective_s"] is not None or r["argument_size_in_bytes"] <= 0
           for r in base):
        raise AssertionError("dry run: a cell with a collective term or no "
                             "argument bytes")
    by_arch = {}
    for r in base:
        by_arch.setdefault(r["arch"], {}).setdefault(r["bottleneck"], 0)
        by_arch[r["arch"]][r["bottleneck"]] += 1
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "dryrun_table.md").write_text(
        report.summary(results) + "\n\n" + report.roofline_table(results)
        + "\n")
    DRY_RESULTS.write_text(json.dumps(results))     # phase 21's roofline
    biggest = max(base, key=lambda r: r["argument_size_in_bytes"])
    log(f"dry run (meta device, H100 bf16 989e12 FLOP/s, HBM 3.35e12 B/s): "
        f"{report.summary(results)}; by arch {by_arch}; {seconds:.2f} s; "
        f"largest inputs a shard {biggest['argument_size_in_bytes']} B "
        f"({biggest['arch']} {biggest['shape']} {biggest['mesh']}); the "
        f"table in build/dryrun_table.md")
    return results


class KeepModel:
    """Within: the last model ``launch/dryrun.py`` builds off the meta
    device (a measured cell's) in ``self.model``."""

    def __enter__(self):
        from repro_torch.launch import dryrun
        self.mod, self.real, self.model = dryrun, dryrun.build_model, None

        def keep(*args, **kw):
            model = self.real(*args, **kw)
            if str(kw.get("device")) != "meta":
                self.model = model
            return model
        dryrun.build_model = keep
        return self

    def __exit__(self, *_):
        self.mod.build_model = self.real
        return False


def dry_held(tag, model, shape_name, m, device):
    """The measured model's logits on its step's batch, held to its plain
    path: the prefill's within :func:`logit_bound` of its torch attention
    path's (``kernel=False``); a MoE model's training forward
    (``kernel=False``) on ``moe_dcra``'s kernel route no farther from the
    float32 forward's (same weights, the plain sort route) than the bf16
    forward on the plain sort route, plus :func:`logit_bound` (as
    :func:`lm_forwards` holds a bf16 stack that amplifies a reordered
    sum) and equal bit for bit to a second run of itself, its distance
    to the sort route reported; ``None`` where the step runs no
    kernel."""
    import dataclasses
    import torch
    from repro_torch.core.dispatch import dispatch_queues
    from repro_torch.launch.train import reduced_batch
    from repro_torch.models.model_zoo import build_model
    cfg = model.cfg
    if shape_name != "prefill_32k" and cfg.moe is None:
        return None
    shape = {s.name: s for s in cfg.shape_cells()}[shape_name]
    shape = dataclasses.replace(shape, global_batch=m["batch"],
                                seq_len=m["seq"])
    batch = reduced_batch(cfg, cfg, shape, 0, device)
    bound = logit_bound(cfg, torch.bfloat16, m["seq"])
    t0 = time.perf_counter()
    with torch.no_grad():
        if cfg.moe is None:
            got, _ = model.forward(batch)
            want, _ = model.forward(batch, kernel=False)
            torch.cuda.synchronize()
            err, share = logits_held(f"{tag} vs the torch attention path",
                                     got, want, bound)
            return (f"logits {tuple(got.shape)} {got.dtype} within "
                    f"{err:.4e} = {share:.4e} of max|logit| of the torch "
                    f"attention path's (bound {bound:.4e}; "
                    f"{time.perf_counter() - t0:.2f} s)")
        got, _ = model.forward(batch, kernel=False)
        again, _ = model.forward(batch, kernel=False)
        sort_q = dataclasses.replace(dispatch_queues(cfg.moe),
                                     route_impl="sort")
        with RoutingSpy(model.mesh_info, (m["batch"], m["seq"]), 0, sort_q):
            want, _ = model.forward(batch, kernel=False)
            f32 = build_model(cfg, mesh_info=model.mesh_info,
                              dtype=torch.float32, device=model.device)
            f32.load(model.tree())
            ref, _ = f32.forward(batch, kernel=False)
            del f32
        torch.cuda.synchronize()
    ref = ref.float()
    scale = float(ref.abs().max())
    e_k, e_p = (float((t.float() - ref).abs().max()) / scale
                for t in (got, want))
    apart, rerun = (same_bits(got, t)[1] / scale for t in (want, again))
    if not (e_k <= e_p + bound and bool(torch.isfinite(got).all())):
        raise AssertionError(f"{tag}: the kernel route's logits {e_k:.4e} of "
                             f"max|logit| from the float32 forward's, the "
                             f"sort route's {e_p:.4e}; bound {bound:.4e} "
                             f"more")
    if not same_bits(got, again)[0]:
        raise AssertionError(f"{tag}: the kernel route run twice gives "
                             f"logits {rerun:.4e} of max|logit| apart")
    return (f"logits {tuple(got.shape)} {got.dtype}: from the float32 "
            f"forward's (sort route) kernel route {e_k:.4e}, sort route "
            f"{e_p:.4e} of max|logit| (held: kernel <= sort + {bound:.4e}); "
            f"kernel route run twice {rerun:.4e} (held: bit-identical); "
            f"kernel vs sort route {apart:.4e} "
            f"({'bit-identical' if same_bits(got, want)[0] else 'differs'}"
            f", reported) ({time.perf_counter() - t0:.2f} s)")


def dry_measured(device, totals):
    """Phase 19 (b): :data:`DRY_MEASURED` through ``lower_cell(...,
    measure=True)`` on the card at ``dryrun.MEASURE_AT``'s cuts, each on a
    path of its own; then, off the path, the prefill's flash kernel on
    layer 0's q, k, v against its plain version, and :func:`dry_held`."""
    import torch
    from repro_torch.launch import dryrun
    recs = []
    for arch, shape, need, designs in DRY_MEASURED:
        torch.cuda.empty_cache()
        tag = f"dry run {arch} {shape}"
        with MainPath(tag, need, totals, designs) as path:
            with KeepModel() as kept, FirstFlashInputs() as first:
                rec = dryrun.lower_cell(arch, shape, False, measure=True,
                                        device=device, verbose=False)
        m = rec["measured"]
        if m["timer"] != "cuda events" or not m["step_ms"] > 0:
            raise AssertionError(f"{tag}: not timed on the card ({m})")
        log(f"{tag}: {m['step_ms']:.4f} ms a step (CUDA events), peak "
            f"{m['peak_bytes']} B; cut: {', '.join(m['reduced'])}; the "
            f"reduced cell's analytic terms compute {m['compute_s']:.4e} s, "
            f"memory {m['memory_s']:.4e} s = {m['compute_share']:.4f} / "
            f"{m['memory_share']:.4f} of the measured step; full cell on "
            f"{rec['chips']} chips: compute {rec['compute_s']:.4e} s, memory "
            f"{rec['memory_s']:.4e} s, {rec['bottleneck']}-bound, inputs "
            f"{rec['argument_size_in_bytes']} B a shard; launches in the "
            f"timed step: flash {m['launches']['flash_attention']}, scatter "
            f"{m['launches']['bucket_scatter']}; on the path (warm-up "
            f"included) {path.launches} [{SMI}]")
        model = kept.model
        if first.seen is not None:
            cfg = model.cfg
            long_flash_check(tag, first.seen, (m["batch"] * cfg.num_heads,
                                               m["seq"],
                                               cfg.resolved_head_dim))
        first.seen = first.by_mask = None
        held = dry_held(tag, model, shape, m, device)
        if held:
            log(f"{tag}: the measured model's {held} [{SMI}]")
        del model, kept.model
        recs.append(rec)
    return recs


def dry_subprocesses(procs, device):
    """Phase 19 (c) and (d): the example scripts' exit codes and seconds;
    the two workers' ``compress_psum`` against the one-process virtual
    fabric's, bit for bit."""
    import numpy as np
    from repro_torch.core.fabric import Fabric
    from repro_torch.optim import compression as comp
    res = finish_subprocesses(procs)
    bad = {k: v for k, v in res.items() if v[0] != 0}
    if bad:
        raise AssertionError("phase 19 subprocesses failed: " + "\n".join(
            f"--- {k} (rc {rc}):\n{tail}" for k, (rc, _, tail) in bad.items()))
    for name in DRY_EXAMPLES:
        rc, secs, tail = res[name]
        last = [ln for ln in tail.splitlines() if ln.strip()][-1:]
        log(f"example {name} {' '.join(DRY_EXAMPLES[name])}: exit {rc}, "
            f"done {secs:.2f} s after its start (seen once phase 19 (a) "
            f"ended); last line: "
            f"{last[0][:160] if last else ''}")
    fab = Fabric.virtual(PSUM_SHAPE, PSUM_AXES, device=device)
    g, r = psum_inputs(device)
    out, ef = comp.compress_psum({"g": g}, comp.EFState({"g": r}), fab,
                                 "data")
    want = (out["g"].cpu().numpy(), ef.residual["g"].cpu().numpy())
    out_dir = procs["psum worker 0"][1].parent
    for pid in range(2):
        got = np.load(out_dir / f"psum{pid}.npz")
        if (list(got["dcn"]) != ["data"]
                or not np.array_equal(got["mean"], want[0])
                or not np.array_equal(got["residual"], want[1])):
            raise AssertionError(f"compress_psum across processes: worker "
                                 f"{pid} differs from the virtual fabric")
    log(f"compress_psum over 'data' of a two-process 2x2 Fabric.distributed "
        f"(gloo, the card in both): equal bit for bit to the one-process "
        f"virtual fabric's mean and residuals (max |mean| "
        f"{float(np.abs(want[0]).max()):.4f}) [{SMI}]")


def run_dry(device, totals):
    """Phase 19: the subprocesses (examples, psum workers) started first
    and (a) the dry-run table built on meta while they run; then their
    results (c), (d); then (b) the measured cells, alone on the card."""
    import tempfile
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        procs = start_subprocesses(Path(tmp))
        try:
            dry_table(device)
        except BaseException:
            kill_subprocesses(procs)
            raise
        dry_subprocesses(procs, device)
    dry_measured(device, totals)


# ---------------------------------------------------------------------------
# phase 20: the serving tier and the MoE layer on a distributed fabric
# ---------------------------------------------------------------------------

SERVE_OUT_SHAPE = (2, 32)           # ("portal", "data"): one pod a process
SERVE_OUT_NAMES = ("portal", "data")
SERVE_OUT_REQUESTS = 8              # (a): phase 13's stream, its first
                                    # quarter (a BFS and an SSSP launch):
                                    # 32 took 125 s a pass across the two
                                    # processes (gloo), 16 took 65 s
SERVE_OUT_LOSS = (0, 32, 4)         # (b): the launch of the loss, shards
                                    # kept, requests (one BFS launch: 16
                                    # requests with the loss at launch 2
                                    # took 89 s, re-packing included)
SERVE_OUT_PG_TIMEOUT = 300          # seconds: the gloo group's collectives
SERVE_OUT_WAIT = 900                # seconds the parent waits for a worker
MOE_OUT_PACKAGING = 2               # phase 10's two-stage (pod 2, ...)
MOE_NO_DROP = {"dispatch": 8.0, "portal": 1.0, "expert": 1.0}
MOE_WEIGHTS = ("router", "wg", "wu", "wd")


def serve_out_graph():
    """Phase 13's resident graph and the first ``SERVE_OUT_REQUESTS`` of its
    stream, from the seed."""
    from repro_torch.sparse import datasets
    g = datasets.rmat(SERVE_SCALE, seed=SEED)
    return g, serve_requests(g.n)[:SERVE_OUT_REQUESTS]


def save_serve_graph(out_dir, g, resident):
    """Phase 13's graph and its resident packing onto 64 shards, written
    for the workers (host arrays; ``src_slot`` as int32)."""
    import numpy as np
    for k in ("row_ptr", "col_idx", "values"):
        np.save(out_dir / f"g_{k}.npy", getattr(g, k))
    for (gname, undirected), (n_local, src, dst, w, e_max) in \
            resident.items():
        tag = f"{gname}_{int(undirected)}"
        np.save(out_dir / f"pack_{tag}_src.npy", src.int().cpu().numpy())
        np.save(out_dir / f"pack_{tag}_dst.npy", dst.cpu().numpy())
        np.save(out_dir / f"pack_{tag}_w.npy", w.cpu().numpy())
        (out_dir / f"pack_{tag}.json").write_text(json.dumps(
            [gname, bool(undirected), int(n_local), int(e_max)]))


def load_serve_graph(out_dir, fab):
    """A worker's copy of :func:`save_serve_graph`'s files: the graph and
    the resident packing keyed as ``ProgramServer._resident``, this
    process's rows on its device."""
    import numpy as np
    from repro_torch.sparse.csr import CSR
    from repro_torch.sparse.program import resident_setup
    g = CSR(*(np.load(out_dir / f"g_{k}.npy")
              for k in ("row_ptr", "col_idx", "values")))
    resident = {}
    for meta in sorted(out_dir.glob("pack_*.json")):
        gname, undirected, n_local, e_max = json.loads(meta.read_text())
        tag = meta.name[len("pack_"):-len(".json")]
        arrays = [np.load(out_dir / f"pack_{tag}_{k}.npy")
                  for k in ("src", "dst", "w")]
        resident[(gname, undirected)] = resident_setup(
            (n_local, *arrays, e_max), fab.device, fabric=fab)
    return g, resident


def response_record(resps):
    """What must agree between servers: statuses, reasons, rounds, the
    launch's messages and drops, a response each."""
    return [[r.req_id, r.status, r.reason, r.rounds, r.batch_messages,
             r.batch_drops] for r in resps]


def serve_out_pass(tag, srv, reqs, pid, out_dir, i, warm=True):
    """One pass of ``reqs`` through a worker's distributed server, after its
    pre-warm unless the classes are warm already (``warm=False``): the
    record, the results into ``p<pid>_serve<i>.npy``."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import route
    from repro_torch.sparse import program
    t0 = time.perf_counter()
    if warm:
        srv.prewarm(("bfs", "sssp"))
    warm_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    reset_launches()
    srv.fabric.exchange.reset_stats()
    torch.cuda.reset_peak_memory_stats()
    c0 = program.cache_stats()
    dist.barrier()
    t0 = time.perf_counter()
    resps = srv.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c1 = program.cache_stats()
    srv.stats.verify()
    np.save(out_dir / f"p{pid}_serve{i}.npy", np.stack(
        [np.zeros(0) if r.result is None else r.result.astype(np.float32)
         for r in resps]))
    return {"tag": tag, "warm_s": warm_s, "wall_s": wall,
            "responses": response_record(resps),
            "cache": {k: c1[k] - c0[k] for k in c0},
            "launches": read_launches(), "batches": srv.stats.launches,
            "paths": {k: dict(v) for k, v in route.PATHS.items()},
            "exchange": dict(srv.fabric.exchange.stats),
            "host_losses": srv.stats.host_losses,
            "shape": list(srv.fabric.shape),
            "local_shards": list(srv.fabric.local_shards),
            "peak_bytes": int(torch.cuda.max_memory_allocated())}


def digest(tensors):
    """One hash of the bytes of ``tensors``: equal digests are equal
    tensors, without moving them between processes."""
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def moe_out_grads(params, xs, r, cfg, info, queues):
    """``moe_dcra``'s loss ``sum(out * r) + aux`` on ``info``'s fabric and
    its gradients with respect to the four weights and ``xs``."""
    import torch
    from repro_torch.core.dispatch import moe_dcra
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    x = xs.detach().requires_grad_(True)
    out, aux, stats = moe_dcra(p, x, cfg, info, queues=queues,
                               return_stats=True)
    loss = (out * r).sum() + aux
    grads = torch.autograd.grad(loss, [p[k] for k in MOE_WEIGHTS] + [x])
    return (float(loss), dict(zip(MOE_WEIGHTS + ("x",), grads)),
            stats.total_dropped)


def serve_out_moe(pid, device):
    """Phase 20 (c) and (d) in a worker: one dispatch of OLMoE-1B-7B's MoE
    layer through a ``ProgramServer``'s MoE lane on the two-stage
    packaging, the pods one a process; one gradient of that layer. Rank
    0 holds each against ``moe_dcra`` on the virtual packaging."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core.dispatch import MeshInfo, moe_dcra
    from repro_torch.core.fabric import Fabric
    from repro_torch.core.queues import QueueConfig
    from repro_torch.kernels import route
    from repro_torch.serve import MoEService, ProgramServer, Request
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params, x = moe_setup(device)
    label, shape, names, kw = MOE_PACKAGINGS[MOE_OUT_PACKAGING]
    fab = Fabric.distributed(shape, names, device=device)
    info = MeshInfo(fab, **kw)
    svc = MoEService(cfg, params, info, batch=MOE_TOKENS[0],
                     seq=MOE_TOKENS[1])
    srv = ProgramServer(fab, {}, moe=svc)
    blocks = x.cpu().numpy()
    reqs = [Request(i, f"tenant{i}", "moe", payload=blocks[i])
            for i in range(MOE_TOKENS[0])]
    srv.prewarm(("moe",))
    # the lane's warm callable, asked for the statistics of the very
    # dispatch that is timed and checked (no build: ``traces`` stays)
    lane = {}

    def with_stats(p, xt):
        out, aux, lane["stats"] = moe_dcra(p, xt, cfg, info,
                                           return_stats=True)
        return out, aux
    svc._fn = with_stats
    torch.cuda.synchronize()
    reset_launches()
    fab.exchange.reset_stats()
    dist.barrier()
    t0 = time.perf_counter()
    resps = srv.run(reqs)
    torch.cuda.synchronize()
    rec = {"label": label, "lane_s": time.perf_counter() - t0,
           "d_model": cfg.d_model,
           "statuses": [r.status for r in resps], "traces": svc.traces,
           "launches": read_launches(),
           "paths": {k: dict(v) for k, v in route.PATHS.items()},
           "exchange": dict(fab.exchange.stats),
           "local_shards": list(fab.local_shards),
           "dcn_axes": list(fab.dcn_axes())}
    srv.stats.verify()
    got = torch.from_numpy(np.stack([r.result for r in resps]))
    del resps, blocks
    stats = lane.pop("stats")
    drops = {k: [v.cpu().tolist() for v in c] for k, c in stats.buckets.items()}
    rec["dropped"] = stats.total_dropped
    rec["out_digest"] = digest([got])
    if pid == 0:
        vinfo = MeshInfo(Fabric.virtual(shape, names, device=device), **kw)
        reset_launches()
        want, _, vstats = moe_dcra(params, x, cfg, vinfo, return_stats=True)
        rec["virtual_launches"] = read_launches()
        want = want.cpu()
        rec["scale"] = float(want.abs().max())
        rec["err"] = float((got - want).abs().max())
        rec["drops_equal"] = drops == {
            k: [v.cpu().tolist() for v in c] for k, c in vstats.buckets.items()}
        del want, vstats
    del got, stats
    torch.cuda.empty_cache()

    # (d): the gradient on the smaller x with no drop
    nb, seq = MOE_CHECK_TOKENS
    xs = x[:nb, :seq].contiguous()
    del x
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 2)
    r = torch.randn(xs.shape, generator=gen, device=device)
    queues = QueueConfig(default_iq=None, iq_factors=MOE_NO_DROP)
    torch.cuda.synchronize()
    reset_launches()
    fab.exchange.reset_stats()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    t0 = time.perf_counter()
    loss, grads, dropped = moe_out_grads(params, xs, r, cfg, info, queues)
    torch.cuda.synchronize()
    rec["grad"] = {"s": time.perf_counter() - t0, "loss": loss,
                   "dropped": dropped, "launches": read_launches(),
                   "exchange": dict(fab.exchange.stats),
                   "peak_bytes": int(torch.cuda.max_memory_allocated()),
                   "digest": digest([grads[k] for k in MOE_WEIGHTS])}
    if pid == 0:
        vinfo = MeshInfo(Fabric.virtual(shape, names, device=device), **kw)
        reset_launches()
        vloss, vgrads, _ = moe_out_grads(params, xs, r, cfg, vinfo, queues)
        rec["grad"]["virtual_launches"] = read_launches()
        rec["grad"]["virtual_loss"] = vloss
        rec["grad"]["err"] = {
            k: [float((grads[k] - vgrads[k]).abs().max()),
                float(vgrads[k].abs().max())] for k in grads}
    return rec


def serve_out_worker(coord, pid, out_dir):
    """``--serve-out-worker COORD PID DIR``: one process of phase 20. Joins
    the gloo group at ``COORD`` as process ``PID`` with a
    ``("portal", "data")`` (2, 32) fabric on the card, loads phase 13's
    graph and packing (:func:`load_serve_graph`), serves its stream (a)
    in lockstep and (b) with a host loss (which re-packs onto 32 shards
    here), then runs (c) and (d) (:func:`serve_out_moe`), and
    writes the results (``p<PID>_serve<i>.npy``) and a record
    (``p<PID>.json``) into ``DIR``. It loads the kernels the parent built
    and fails if it had to build one."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.fabric import Fabric
    from repro_torch.kernels import _build
    from repro_torch.serve import (ProgramServer, ServeFailurePlan,
                                   ServeOptions)
    pid, out_dir = int(pid), Path(out_dir)
    built = [k for k, r in _build.build().items() if r["seconds"]]
    if built:
        raise AssertionError(f"worker {pid} built {built}: the parent "
                             f"builds every kernel before it starts")
    device = torch.device(*CARD)
    t0 = time.perf_counter()
    fab = Fabric.distributed(SERVE_OUT_SHAPE, SERVE_OUT_NAMES,
                             coordinator_address=coord, num_processes=2,
                             process_id=pid, device=device,
                             timeout=SERVE_OUT_PG_TIMEOUT)
    join_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    g, resident = load_serve_graph(out_dir, fab)
    reqs = serve_requests(g.n)
    rec = {"join_s": join_s, "setup_s": time.perf_counter() - t0,
           "passes": []}
    name = f"rmat{SERVE_SCALE}"
    at, keep, n_loss = SERVE_OUT_LOSS
    for i, (tag, so, plan, n) in enumerate((
            ("lockstep", ServeOptions(), None, SERVE_OUT_REQUESTS),
            ("host loss", ServeOptions(max_retries=1),
             ServeFailurePlan(at={at: "host_loss"}, keep_devices=keep),
             n_loss))):
        srv = ProgramServer(fab, {name: g}, batch_width=SERVE_WIDTH,
                            serve_options=so, failure_plan=plan)
        # (a) from phase 13's packing, (b) from (a)'s warm classes too
        srv._resident.update(resident)
        rec["passes"].append(serve_out_pass(tag, srv, reqs[:n], pid,
                                            out_dir, i, warm=i == 0))
        resident = srv._resident
        del srv
    del resident
    del g
    torch.cuda.empty_cache()
    rec["moe"] = serve_out_moe(pid, device)
    (out_dir / f"p{pid}.json").write_text(json.dumps(rec))
    dist.destroy_process_group()
    return 0


def run_serve_out(device, totals, base=None):
    """Phase 20: phase 13's server and the MoE layer on a distributed
    fabric, two worker processes (``--serve-out-worker``) sharing the card
    over gloo. Here first: the one-process server on the same (2, 32)
    shape from phase 13's resident packing (``base``: phase 13's
    results, requests/s, graph and packing; when phase 13 has not run,
    its flat-64 lockstep pass makes them). Then the workers' (a)-(d)
    against them: every response bit-identical to phase 13's, rounds,
    messages and drops equal to the one-process server's, no build under
    load and no drop, the scatter ``staged`` and the reduce ``atomic``,
    both workers alike; the host loss served whole; the MoE lane within
    1e-5 of max|out| of the virtual packaging, its own dispatch's drops
    per bucket equal to the virtual packaging's; the gradient within 1e-5 of each leaf's max|g|, the weights'
    gradients identical in both processes. The workers' launches join
    ``totals``."""
    import numpy as np
    import torch
    from repro_torch.core.fabric import Fabric
    from repro_torch.serve import ProgramServer
    name = f"rmat{SERVE_SCALE}"
    if base is None:
        g, reqs = serve_out_graph()
        srv = ProgramServer(Fabric.fake(64, device=device), {name: g},
                            batch_width=SERVE_WIDTH)
        srv.prewarm(("bfs", "sssp"))
        resps, wall = serve_pass("serve-out: phase 13's lockstep pass, flat "
                                 "64", srv, reqs, totals, SERVE_WIDTH)
        base = ([r.result for r in resps], len(reqs) / wall, g, srv._resident)
        del srv, resps
    results13, rate13, g, resident = base
    reqs = serve_requests(g.n)[:SERVE_OUT_REQUESTS]
    n = len(reqs)
    one = ProgramServer(Fabric.virtual(SERVE_OUT_SHAPE, SERVE_OUT_NAMES,
                                       device=device), {name: g},
                        batch_width=SERVE_WIDTH)
    # phase 13's packing: the same graph, shard count and seed
    one._resident.update(resident)
    t0 = time.perf_counter()
    one.prewarm(("bfs", "sssp"))
    log(f"serve-out one process {SERVE_OUT_SHAPE}: pre-warm "
        f"{time.perf_counter() - t0:.2f} s (phase 13's resident packing) "
        f"[{SMI}]")
    resps, wall1 = serve_pass(f"serve-out one process {SERVE_OUT_SHAPE}",
                              one, reqs, totals, SERVE_WIDTH)
    if not all(np.array_equal(r.result, results13[i])
               for i, r in enumerate(resps)):
        raise AssertionError("serve-out: the one-process (2, 32) server's "
                             "responses differ from phase 13's")
    want = response_record(resps)
    del one, resps
    out_dir = ROOT / "build" / "serve_out"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    save_serve_graph(out_dir, g, resident)
    log(f"serve-out: RMAT-{SERVE_SCALE} and phase 13's packing onto 64 "
        f"shards written for the workers in {time.perf_counter() - t0:.2f} s "
        f"[{SMI}]")
    del g, resident, base
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    workers = run_workers(out_dir, "--serve-out-worker", SERVE_OUT_WAIT)
    log(f"serve-out: 2 workers on {device} (gloo over 127.0.0.1, a "
        f"(2, 32) fabric, one pod a process) {time.perf_counter() - t0:.2f} "
        f"s in all; join s {[round(w['join_s'], 2) for w in workers]}, "
        f"RMAT-{SERVE_SCALE} and its packing loaded s "
        f"{[round(w['setup_s'], 2) for w in workers]} [{SMI}]")
    for i in range(2):
        recs = [w["passes"][i] for w in workers]
        n = SERVE_OUT_REQUESTS if i == 0 else SERVE_OUT_LOSS[2]
        got = [np.load(out_dir / f"p{pid}_serve{i}.npy") for pid in (0, 1)]
        if not np.array_equal(got[0], got[1]) or recs[0]["responses"] != \
                recs[1]["responses"]:
            raise AssertionError(f"serve-out pass {i}: the workers' "
                                 f"responses differ")
        same13 = all(np.array_equal(got[0][j], results13[j])
                     for j in range(n))
        statuses = [r[1] for r in recs[0]["responses"]]
        if not same13 or statuses != ["ok"] * n:
            raise AssertionError(f"serve-out {recs[0]['tag']}: statuses "
                                 f"{statuses}, results equal to phase 13's "
                                 f"{same13}")
        for pid, rec in enumerate(recs):
            if i == 0:
                drops = sum(r[5] for r in rec["responses"])
                if (rec["responses"] != want or drops
                        or rec["cache"]["misses"]
                        or rec["cache"]["kernel_traces"]):
                    raise AssertionError(
                        f"serve-out lockstep p{pid}: rounds, messages or "
                        f"drops differ from the one-process server's, or "
                        f"{drops} drops, cache {rec['cache']}")
            elif rec["host_losses"] != 1 or rec["batches"] != 1 or \
                    rec["shape"] != [SERVE_OUT_LOSS[1] // SERVE_OUT_SHAPE[1],
                                     SERVE_OUT_SHAPE[1]]:
                raise AssertionError(f"serve-out host loss p{pid}: "
                                     f"{rec['host_losses']} losses, fabric "
                                     f"{rec['shape']}")
            for k in ROUTE_KERNELS:
                if not rec["launches"][k]:
                    raise AssertionError(f"serve-out {rec['tag']} p{pid}: "
                                         f"{k} never launched")
            for wrapper, design in STAGED_ATOMIC.items():
                ran_only(rec["paths"][wrapper], design,
                         f"serve-out {rec['tag']} p{pid}: {wrapper}")
            for k, v in rec["launches"].items():
                totals[k] += v
            ex = rec["exchange"]
            log(f"serve-out {rec['tag']} p{pid} (shards "
                f"{rec['local_shards']} of {rec['shape']} after): {n} "
                f"requests in {rec['wall_s']:.4f} s, requests/s "
                f"{n / rec['wall_s']:.4e} (phase 13's flat 64 "
                f"{rate13:.4e}, one process on (2, 32) {n / wall1:.4e}); "
                f"pre-warm {rec['warm_s']:.2f} s; {rec['batches']} launches, "
                f"rounds {min(r[3] for r in rec['responses'])}-"
                f"{max(r[3] for r in rec['responses'])}; exchanges "
                f"{ex['calls']}, bytes out {ex['bytes_out']}, gloo s a "
                f"launch {ex['gloo_s'] / max(rec['batches'], 1):.4f} (wait "
                f"{ex['wait_s']:.3f} d2h {ex['d2h_s']:.3f} h2d "
                f"{ex['h2d_s']:.3f} s in all); agreements "
                f"{ex['agree_calls']}, agree s a launch "
                f"{ex['agree_s'] / max(rec['batches'], 1):.4f} "
                f"({ex['agree_s']:.3f} s in all); cache {rec['cache']}; peak "
                f"card memory {rec['peak_bytes']} B; launches "
                f"{rec['launches']} [{SMI}]")
        log(f"serve-out {recs[0]['tag']}: both workers alike, every response "
            f"ok and bit-identical to phase 13's"
            + ("; rounds, messages and drops equal to the one-process "
               "server's, no drop, no build under load" if i == 0 else
               f"; the fabric shrank to {recs[0]['shape']}, "
               f"{recs[0]['local_shards']} a process") + f" [{SMI}]")
    moe = [w["moe"] for w in workers]
    m0 = moe[0]
    if (moe[0]["out_digest"] != moe[1]["out_digest"]
            or moe[0]["grad"]["digest"] != moe[1]["grad"]["digest"]):
        raise AssertionError("serve-out MoE: the workers' outputs or weight "
                             "gradients differ")
    if (m0["statuses"] != ["ok"] * MOE_TOKENS[0] or m0["traces"] != 1
            or not m0["err"] <= 1e-5 * m0["scale"] or not m0["drops_equal"]):
        raise AssertionError(f"serve-out MoE lane: statuses {m0['statuses']}, "
                             f"builds {m0['traces']}, max |err| {m0['err']} "
                             f"vs max|out| {m0['scale']}, drops equal "
                             f"{m0['drops_equal']}")
    gr = m0["grad"]
    bad = {k: v for k, v in gr["err"].items() if not v[0] <= 1e-5 * v[1]}
    if (bad or gr["dropped"] or not abs(gr["loss"] - gr["virtual_loss"])
            <= 1e-5 * abs(gr["virtual_loss"])):
        raise AssertionError(f"serve-out MoE gradient: leaves off {bad}, "
                             f"drops {gr['dropped']}, loss {gr['loss']} vs "
                             f"{gr['virtual_loss']}")
    for pid, rec in enumerate(moe):
        for part in (rec["launches"], rec["grad"]["launches"]):
            if not part["bucket_scatter"]:
                raise AssertionError(f"serve-out MoE p{pid}: no scatter")
            for k, v in part.items():
                totals[k] += v
        ran_only(rec["paths"]["bucket_scatter"], "staged",
                 f"serve-out MoE p{pid}: bucket_scatter")
        ex, gx = rec["exchange"], rec["grad"]["exchange"]
        log(f"serve-out MoE {m0['label']} p{pid} (shards "
            f"{rec['local_shards']}, crossing {rec['dcn_axes']}): the lane's "
            f"dispatch of {MOE_TOKENS[0]} requests x ({MOE_TOKENS[1]}, "
            f"{rec['d_model']}) "
            f"{rec['lane_s']:.2f} s (its statistics gathered across the "
            f"processes inside), scatter launches "
            f"{rec['launches']['bucket_scatter']}, exchanges {ex['calls']} "
            f"(bytes out {ex['bytes_out']}, gloo {ex['gloo_s']:.3f} s), "
            f"{rec['dropped']} tasks dropped; gradient on x "
            f"{MOE_CHECK_TOKENS + (rec['d_model'],)} {rec['grad']['s']:.2f} s"
            f", scatter "
            f"launches {rec['grad']['launches']['bucket_scatter']}, exchanges "
            f"{gx['calls']} (gloo {gx['gloo_s']:.3f} s), peak "
            f"{rec['grad']['peak_bytes']} B [{SMI}]")
    log(f"serve-out MoE: both workers' outputs and weight gradients "
        f"identical; the lane within {m0['err'] / m0['scale']:.3e} of "
        f"max|out| of the virtual packaging (bound 1e-5), drops per bucket "
        f"equal; loss {gr['loss']:.9e} vs {gr['virtual_loss']:.9e}; leaves "
        f"max|dg| / max|g|: "
        + ", ".join(f"{k} {v[0] / v[1]:.3e}" for k, v in gr["err"].items())
        + f" (bound 1e-5) [{SMI}]")
    shutil.rmtree(out_dir, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 21: the paper's figure harness and the graph-analytics example
# ---------------------------------------------------------------------------

FIG_SCALE = 12                      # figures.run --quick: the paper's scale
                                    # 16 takes minutes of host numpy (fig4
                                    # 71.5 s, fig7 60.8 s on a CPU)
NOC_RUNS = ((11, 8, 2),             # (RMAT scale, shards, pods): the
            (18, 64, 8))            # reference's defaults; then the size at
                                    # which SpMV and the histogram route in
                                    # two stages over 64 shards
GA_SCALE = 12                       # examples/graph_analytics_torch.py
#: ``figures.run``'s modules, the reference's twelve in its order; the
#: two timing benches run in phase 22 only
FIG_MODULES = ("fig4_topology", "fig5_sram", "fig6_pus", "fig7_freq",
               "fig8_hbm", "fig10_queues", "fig11_scaling", "moe_dispatch",
               "route_bench", "noc_routing", "serve_bench", "roofline_table")
BENCH_MODULES = ("route_bench", "serve_bench")
DRY_RESULTS = ROOT / "build" / "dryrun_results_torch.json"  # phase 19's


def csv_blocks(text):
    """``{module: rows}`` of ``figures.run``'s output, split at its ``==
    name ==`` lines, each row a list of fields."""
    blocks, name = {}, None
    for line in text.splitlines():
        m = re.fullmatch(r"== (\w+) ==", line)
        if m:
            name = m.group(1)
            blocks[name] = []
        elif name and "," in line and not line.startswith("#"):
            blocks[name].append(line.split(","))
    return blocks


def csv_numbers(row):
    """The numeric fields of a CSV row (``3.441e+09``, ``pu=0.10``,
    ``6.94ms``, ``drops=0``)."""
    out = []
    for field in row:
        v = field.split("=", 1)[-1]
        try:
            out.append(float(v[:-2] if v.endswith("ms") else v))
        except ValueError:
            pass
    return out


def figures_quick(device, totals):
    """(1) ``figures.run`` at ``--quick`` on the card: it lists the
    reference's twelve modules (:data:`FIG_MODULES`); every one but the
    two timing benches (phase 22 times those) ran, a row a module at
    least (the roofline's pointer where no dry run is written), every
    number finite; the route kernels that ``noc_routing`` launched
    counted."""
    import contextlib
    import io
    from repro_torch.figures import run
    out = io.StringIO()
    names = [n for n, _ in run.figures(FIG_SCALE, device, True)]
    if names != list(FIG_MODULES):
        raise AssertionError(f"figures.run lists {names}")
    names = [n for n in names if n not in BENCH_MODULES]
    with MainPath("figures.run --quick", ROUTE_KERNELS, totals,
                  STAGED_PRIVATE) as path:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            _, failures, seconds = run.run_all(FIG_SCALE, device, True,
                                               skip=BENCH_MODULES)
        wall = time.perf_counter() - t0
    blocks = csv_blocks(out.getvalue())
    bad = [(n, r) for n in blocks for r in blocks[n]
           if not all(map(math.isfinite, csv_numbers(r)))]
    if failures or list(blocks) != names or bad or any(
            len(blocks[n]) < (1 if n == "roofline_table" else 2)
            for n in names):
        raise AssertionError(f"figures.run: failed {failures}, modules "
                             f"{list(blocks)}, rows not finite {bad[:3]}")
    for row in blocks["moe_dispatch"]:
        log(f"figures moe_dispatch | {','.join(row)}")
    log(f"figures.run --quick (scale {FIG_SCALE}, cut from the paper's 16: "
        f"the full set takes minutes of host numpy) on {device}: "
        f"{len(names)} of its {len(FIG_MODULES)} modules ran (the benches "
        f"in phase 22), {sum(map(len, blocks.values()))} CSV "
        f"lines, every number finite; {wall:.2f} s, by module "
        + ", ".join(f"{n} {seconds[n]:.2f}" for n in names)
        + f" s; launches {path.launches}, route designs {path.paths} [{SMI}]")


def noc_run(scale, n_dev, n_pods, device, totals):
    """(2) ``noc_routing`` at RMAT-``scale`` over ``n_dev`` shards, flat
    and in ``n_pods`` pods, each mode a path of its own: no drop, BFS and
    the histogram bit-identical to the oracle, SpMV every row within its
    float32 bound (:func:`spmv_bounds`); the hierarchical die crossings
    below the flat ones."""
    import numpy as np
    from repro_torch.figures import noc_routing
    t0 = time.perf_counter()
    g, x, els = noc_routing.workload(scale)
    want = noc_routing.oracles(g, x, els)
    tol, _ = spmv_bounds(g, x)
    setup_s = time.perf_counter() - t0
    for mode, fab in noc_routing.fabrics(n_dev, n_pods, device).items():
        tag = f"noc_routing rmat-{scale} x {n_dev} {mode}"
        with MainPath(tag, ROUTE_KERNELS, totals, STAGED_PRIVATE) as path:
            cases = noc_routing.run_mode(g, x, els, fab, mode, want)
        parts = []
        for c in cases:
            if c.drops:
                raise AssertionError(f"{tag} {c.app}: {c.drops} drops")
            if c.app == "spmv":
                worst = held_to(f"{tag} spmv", c.y, c.oracle, tol)
                held = f"every row within its float32 bound (worst {worst:.3e})"
            elif np.array_equal(c.y.astype(np.float64), c.oracle):
                held = "bit-identical to the oracle"
            else:
                raise AssertionError(f"{tag} {c.app}: max |err| {c.err}")
            parts.append(f"{c.app} {c.ms:.4f} ms a call, {held}")
        log(f"{tag} (nnz {g.nnz}, {fab.shape} {fab.axis_names}): "
            + "; ".join(parts) + f"; no drop; launches {path.launches}, "
            f"route designs {path.paths} [{SMI}]")
    t0 = time.perf_counter()
    cross = noc_routing.crossings(g, n_dev, n_pods)
    if not cross["hier"] < cross["flat"]:
        raise AssertionError(f"noc_routing rmat-{scale}: die crossings "
                             f"{cross}, hierarchical not below flat")
    log(f"noc_routing rmat-{scale} x {n_dev}: die crossings flat "
        f"{cross['flat']}, {n_pods} pods {cross['hier']} "
        f"({cross['hier'] / cross['flat']:.4f} of flat; analytic, "
        f"{time.perf_counter() - t0:.2f} s on the host); inputs and oracles "
        f"{setup_s:.2f} s (numpy)")


def roofline_rows():
    """The dry run's roofline table (``figures.roofline_table``) on the
    records phase 19 wrote: a row a laid-out cell, every number finite,
    the collective term "—"."""
    import contextlib
    import io
    from repro_torch.figures import roofline_table
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rows = roofline_table.main(str(DRY_RESULTS))
    lines = [ln.split(",") for ln in out.getvalue().splitlines()[1:]]
    cells = [r for r in lines if r[3] not in ("SKIP", "ERROR")]
    if (len(rows) != len(cells) or len(cells) != 68
            or any(r[5] != "—" or not all(map(math.isfinite,
                                              csv_numbers(r))) for r in cells)):
        raise AssertionError(f"roofline table: {len(cells)} rows of "
                             f"{len(lines)}, {cells[:2]}")
    log(f"figures roofline_table on phase 19's records: {len(cells)} cells "
        f"and {len(lines) - len(cells)} skips; compute and memory terms "
        f"finite, the collective term — (no XLA HLO in torch)")


def graph_analytics(device, totals):
    """(4) ``examples/graph_analytics_torch.py --distributed --scale
    GA_SCALE`` on the card: every app and the auto-configured BFS with no
    drop, BFS, SSSP, WCC, k-core and the histogram bit-identical to their
    oracles, PageRank within :func:`pagerank_bound` of its oracle, SpMV
    every row within :func:`spmv_bounds`."""
    import contextlib
    import importlib.util
    import io
    spec = importlib.util.spec_from_file_location(
        "graph_analytics_torch", ROOT / "examples" / "graph_analytics_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    argv = ["--scale", str(GA_SCALE), "--distributed", "--device",
            str(device)]
    out = io.StringIO()
    with MainPath("graph_analytics --distributed", ROUTE_KERNELS, totals,
                  STAGED_PRIVATE) as path:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            g, (runs, x, _) = example.main(argv)
        wall = time.perf_counter() - t0
    for line in out.getvalue().splitlines():
        if line.strip():
            log(f"graph_analytics | {line}")
    tol, _ = spmv_bounds(g, x)
    pr_tol = pagerank_bound(g, device, n_dev=example.N_SHARDS)
    held = []
    for name, got, want, stats in runs:
        if stats.total_drops:
            raise AssertionError(f"graph_analytics {name}: "
                                 f"{stats.total_drops} drops")
        if name == "spmv":
            held.append(f"spmv {held_to('graph_analytics spmv', got, want, tol):.3e}")
        elif name == "pagerank":
            held.append(f"pagerank {held_to('graph_analytics pagerank', got, want, pr_tol):.3e}")
        elif not (got.shape == want.shape and (got == want).all()):
            raise AssertionError(f"graph_analytics {name}: differs from "
                                 f"its oracle")
    if [r[0] for r in runs] != ["spmv", "histogram", "bfs", "sssp",
                                "pagerank", "wcc", "kcore", "bfs[auto]"]:
        raise AssertionError(f"graph_analytics: runs {[r[0] for r in runs]}")
    log(f"graph_analytics_torch {' '.join(argv)}: {wall:.2f} s; every app "
        f"no drop, bfs, sssp, wcc, kcore, histogram, bfs[auto] "
        f"bit-identical to their oracles, worst |err| / bound: "
        + ", ".join(held) + f"; launches {path.launches}, route designs "
        f"{path.paths} [{SMI}]")


def run_figures(device, totals):
    """Phase 21: (1) :func:`figures_quick` and the roofline table on phase
    19's records; (2) :func:`noc_run` at each of :data:`NOC_RUNS`; (3)
    ``moe_dispatch``'s rows (its einsum timed on the card, in (1)); (4)
    :func:`graph_analytics`."""
    figures_quick(device, totals)
    roofline_rows()
    for scale, n_dev, n_pods in NOC_RUNS:
        noc_run(scale, n_dev, n_pods, device, totals)
    graph_analytics(device, totals)


# ---------------------------------------------------------------------------
# phase 22: the two timing benches, gated against the committed baselines
# ---------------------------------------------------------------------------

BENCH_OUT = ROOT / "chiprun_out" / "benches"   # this run's artifacts
ROUTE_BASELINE = ROOT / "BENCH_route_torch.json"
SERVE_BASELINE = ROOT / "BENCH_serve_torch.json"
#: timing reps on an H100 (the gates fail a ratio 20 % / 15 % below its
#: baseline, and a gated ratio must not move by half that from pass to
#: pass): route_bench's own (0: about 150 ms of samples, each a block of
#: about 2 ms, at most 100 an op cell and 50 a round cell; no count tried
#: held the kernels' op ratios within 10 % from process to process, so
#: the route gate runs under ``--benches`` only, see :data:`FULL_GATES`);
#: serve_bench's alternations of the two drains, whose ratio moved 3.25 %
#: and 6.55 % over two calls' passes at 101
ROUTE_REPS = 0
SERVE_REPS = 101
#: the gates the whole run's phase 22 runs; ``--benches`` runs both
FULL_GATES = ("serve_compare",)
SERVE_SHARDS = 8
#: the designs of the quick grid: the op cells and the lockstep rounds
#: scatter ``staged``; every round's reduce (n_local 4,096-32,768) is
#: ``private``; the pipelined rounds rank by ``lookback``
ROUTE_DESIGNS = {"bucket_rank": "lookback", "bucket_scatter": "staged",
                 "reduce_received": "private"}
ROUTE_LOWERING = "cuda:lookback+private+staged"


def captured(fn, *args):
    """``(fn(*args), what it printed)``."""
    import contextlib
    import io
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args)
    return result, out.getvalue()


def host_reads(fn):
    """The synchronising calls ``fn()`` makes (each a blocking read of
    the card by the host), counted by torch's sync debug mode."""
    import warnings
    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in seen)


def bench_route(device, totals, out=BENCH_OUT):
    """(1) ``route_bench --quick`` on the card: its own bit-identity
    assertions (op cells: every impl's xb and drops; rounds: the final
    state and drop stream of all six impl x mode pairs), the rank,
    scatter and reduce kernels launched on :data:`ROUTE_DESIGNS` only,
    the artifact's lowering and card; each cell's ms and ratios, and the
    host reads of one round cell by impl and mode."""
    from repro_torch.core.queues import round8
    from repro_torch.figures import route_bench
    fresh = out / ROUTE_BASELINE.name
    argv = ["--quick", "--reps", str(ROUTE_REPS), "--out", str(fresh),
            "--device", str(device)]
    with MainPath("route_bench --quick", ("bucket_rank",) + ROUTE_KERNELS,
                  totals, ROUTE_DESIGNS) as path:
        t0 = time.perf_counter()
        bench, _ = captured(route_bench.main, argv)
        wall = time.perf_counter() - t0
    if (bench["backend"], bench["pallas_lowering"]) != ("cuda",
                                                        ROUTE_LOWERING):
        raise AssertionError(f"route_bench: backend {bench['backend']}, "
                             f"lowering {bench['pallas_lowering']}")
    if f"{bench['device']['name']}, {bench['device']['power_limit']}" != SMI:
        raise AssertionError(f"route_bench: card {bench['device']}")
    for c in bench["cells"]:
        sp = c["speedup_vs_onehot"]
        log(f"route_bench op N={c['n']} S={c['s']} cap={c['cap']}: ms "
            + ", ".join(f"{i} {c['ms'][i]:.4f}" for i in route_bench.IMPLS)
            + f"; speedup_vs_onehot sort {sp['sort']:.4f}, pallas "
            f"{sp['pallas']:.4f} [{SMI}]")
    for c in bench["round_cells"]:
        ms, sp = c["round_ms"], c["round_speedup"]
        log(f"route_bench round N={c['n']} S={c['s']} cap={c['cap']} x "
            f"{c['rounds']}: ms lockstep / pipelined "
            + ", ".join(f"{i} {ms['lockstep'][i]:.4f} / "
                        f"{ms['pipelined'][i]:.4f}"
                        for i in route_bench.IMPLS)
            + "; round_speedup " + ", ".join(
                f"{i} {sp[i]:.4f}" for i in route_bench.IMPLS) + f" [{SMI}]")
    n, s = route_bench.ROUND_QUICK_GRID[0]
    inp = route_bench.round_inputs(n, s, device)
    cap = round8(2 * n // s)
    reads = {f"{i} {m}": host_reads(lambda i=i, m=m: route_bench.run_rounds(
        inp, s, cap, i, m)) for i in route_bench.IMPLS
        for m in route_bench.MODES}
    log(f"route_bench --quick: {len(bench['cells'])} op cells, "
        f"{len(bench['round_cells'])} round cells, every impl bit-identical; "
        f"{wall:.2f} s; lowering {bench['pallas_lowering']}; launches "
        f"{path.launches}, route designs {path.paths}; host reads of "
        f"{route_bench.ROUNDS} rounds at N={n} S={s} by impl and mode "
        f"{reads} [{SMI}]")


def bench_serve(device, totals, out=BENCH_OUT):
    """(2) ``serve_bench`` on :data:`SERVE_SHARDS` shards of the card:
    the smoke leg at depth 3 (its assertions: no build under load, no
    drop, a column equal to a standalone launch, depth 3 equal to depth
    1), the chaos leg (seed 0: a launch fault, a device fault and a host
    loss halving the fabric, retries and the breaker, the responses
    equal to the fault-free run's) and the artifact at depth 3 over
    :data:`SERVE_REPS` alternations of the two drains; each
    leg's ``RESULT`` line, the scatter ``staged`` and the reduce
    ``private``; requests/s and p50/p99."""
    from repro_torch.figures import serve_bench
    fresh = out / SERVE_BASELINE.name
    shards = ["--devices", str(SERVE_SHARDS)]
    legs = ((["--smoke", "--depth", "3"], "RESULT ok"),
            (["--chaos", "0"], "RESULT chaos ok"),
            (["--depth", "3", "--reps", str(SERVE_REPS), "--bench-out"],
             None))
    for leg, want in legs:
        tag = f"serve_bench {' '.join(leg + shards)}"
        argv = leg + ([str(fresh)] if want is None else []) + shards
        with MainPath(tag, ROUTE_KERNELS, totals, STAGED_PRIVATE) as path:
            t0 = time.perf_counter()
            _, text = captured(serve_bench.main,
                               argv + ["--device", str(device)])
            wall = time.perf_counter() - t0
        lines = text.splitlines()
        if want is not None and want not in lines:
            raise AssertionError(f"{tag}: no {want!r} in {lines[-3:]}")
        said = [ln for ln in lines if ln.startswith("#")]
        log(f"{tag}: {wall:.2f} s; " + " | ".join(said)
            + f"; launches {path.launches}, route designs {path.paths} "
            f"[{SMI}]")
    bench = json.loads(fresh.read_text())
    if bench["backend"] != "cuda" or f"{bench['device']['name']}, " \
            f"{bench['device']['power_limit']}" != SMI:
        raise AssertionError(f"serve_bench: {bench['backend']} "
                             f"{bench.get('device')}")
    for r in bench["rows"]:
        log(f"serve_bench {r['mode']} (depth {r['depth']}, "
            f"{bench['config']['requests']} requests, "
            f"{bench['config']['devices']} shards): "
            f"{r['throughput_rps']:.4f} requests/s, latency p50 "
            f"{r['p50_latency_s'] * 1e3:.3f} ms p99 "
            f"{r['p99_latency_s'] * 1e3:.3f} ms, device p50 "
            f"{r['p50_device_s'] * 1e3:.3f} ms, {r['launches']} launches, "
            f"{r['re_traces']} builds under load [{SMI}]")
    log(f"serve_bench overlap_speedup {bench['overlap_speedup']:.4f} "
        f"[{SMI}]")


def gate(name, main, baseline, fresh):
    """``main([baseline, fresh])`` (a ``repro_torch.dse`` gate) must
    return 0; its lines are printed."""
    if not baseline.is_file():
        raise AssertionError(f"{name}: no committed baseline "
                             f"{baseline.name} (this run's: {fresh})")
    rc, text = captured(main, [str(baseline), str(fresh)])
    for line in text.splitlines():
        log(f"{name} | {line}")
    if rc != 0:
        raise AssertionError(f"{name} {baseline.name} {fresh}: exit {rc}")
    log(f"{name} {baseline.name} -> this run's: exit 0 [{SMI}]")


def run_benches(device, totals, out=BENCH_OUT,
                gates=("route_compare", "serve_compare")):
    """Phase 22: (1) :func:`bench_route`, (2) :func:`bench_serve`, then
    the port's gates named in ``gates`` (``route_compare``,
    ``serve_compare``) of this run's artifacts (in ``out``) against the
    committed card baselines (both artifacts are written before either
    gate runs)."""
    from repro_torch.dse import route_compare, serve_compare
    out.mkdir(parents=True, exist_ok=True)
    bench_route(device, totals, out)
    bench_serve(device, totals, out)
    for name, main, baseline in (
            ("route_compare", route_compare.main, ROUTE_BASELINE),
            ("serve_compare", serve_compare.main, SERVE_BASELINE)):
        if name in gates:
            gate(name, main, baseline, out / baseline.name)
        else:
            log(f"{name}: under --benches only (its ratios' spread from "
                f"process to process exceeds half its tolerance, PERF.md "
                f"§5)")


def gated_ratios(route, serve):
    """``{name: ratio}`` of every ratio the two gates read: each op
    cell's ``speedup_vs_onehot`` of sort and the kernels, each round
    cell's ``round_speedup`` per impl, ``overlap_speedup``."""
    out = {}
    for c in route["cells"]:
        for i in ("sort", "pallas"):
            out[f"op {c['n']}x{c['s']} {i}"] = c["speedup_vs_onehot"][i]
    for c in route["round_cells"]:
        for i, v in c["round_speedup"].items():
            out[f"round {c['n']}x{c['s']} {i}"] = v
    out["overlap_speedup"] = serve["overlap_speedup"]
    return out


def median_baselines(routes, serves):
    """The baselines of several passes: the route artifact with each ms
    and ratio the median over the passes (the first pass's other
    fields), and the serve artifact of the pass whose
    ``overlap_speedup`` is the median (the lower one of an even count);
    each records ``passes``."""
    import statistics
    route = json.loads(json.dumps(routes[0]))
    for kind, key in (("cells", "ms"), ("cells", "speedup_vs_onehot"),
                      ("round_cells", "round_speedup")):
        for j, c in enumerate(route[kind]):
            for i in c[key]:
                c[key][i] = statistics.median(r[kind][j][key][i]
                                              for r in routes)
    for j, c in enumerate(route["round_cells"]):
        for m, by in c["round_ms"].items():
            for i in by:
                by[i] = statistics.median(r["round_cells"][j]["round_ms"]
                                          [m][i] for r in routes)
    route["passes"] = len(routes)
    serve = dict(sorted(serves, key=lambda b: b["overlap_speedup"])
                 [(len(serves) - 1) // 2])
    serve["passes"] = len(serves)
    return route, serve


def bench_spread(dirs):
    """``--bench-spread DIR...``: each gated ratio over the passes whose
    artifacts lie in ``DIR...`` (``max / min - 1``, against half the
    gate's tolerance: 10 % route, 7.5 % serve), each pass's lowest ratio
    against the committed baselines, and the median baselines
    (:func:`median_baselines`) written to ``chiprun_out/benches/median``
    and checked by both gates against every pass."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.dse import route_compare, serve_compare
    passes = [(json.loads((Path(d) / ROUTE_BASELINE.name).read_text()),
               json.loads((Path(d) / SERVE_BASELINE.name).read_text()))
              for d in dirs]
    cards = {f"{b['device']['name']}, {b['device']['power_limit']}"
             for p in passes for b in p}
    ratios = [gated_ratios(*p) for p in passes]
    committed = gated_ratios(json.loads(ROUTE_BASELINE.read_text()),
                             json.loads(SERVE_BASELINE.read_text()))
    worst = 0.0
    for name in ratios[0]:
        vals = [r[name] for r in ratios]
        spread = max(vals) / min(vals) - 1
        half = 0.075 if name == "overlap_speedup" else 0.10
        worst = max(worst, spread / half)
        log(f"spread {name}: {spread:.4f} (half its tolerance {half}) over "
            + ", ".join(f"{v:.4f}" for v in vals))
    for k, r in enumerate(ratios):
        low = min(r, key=lambda n: r[n] / committed[n])
        log(f"pass {k} ({dirs[k]}): lowest against the committed baseline "
            f"{low} {r[low] / committed[low]:.4f}")
    route, serve = median_baselines(*zip(*passes))
    med = BENCH_OUT / "median"
    med.mkdir(parents=True, exist_ok=True)
    for name, bench in ((ROUTE_BASELINE.name, route),
                        (SERVE_BASELINE.name, serve)):
        (med / name).write_text(json.dumps(bench, indent=1, sort_keys=True)
                                + "\n")
    for d in dirs:
        for main, name in ((route_compare.main, ROUTE_BASELINE.name),
                           (serve_compare.main, SERVE_BASELINE.name)):
            rc, _ = captured(main, [str(med / name), str(Path(d) / name)])
            log(f"{name} median of {len(dirs)} -> {d}: exit {rc}")
    log(f"{len(dirs)} passes on {sorted(cards)}: the widest spread is "
        f"{worst:.4f} of half its tolerance; median baselines in {med}")
    return 0


def benches_only(out=BENCH_OUT):
    """``--benches [DIR]``: the build and phase 22 alone, its artifacts
    in ``DIR`` (default ``chiprun_out/benches``); its launch counts are
    printed, no kernel table."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    global SMI
    SMI = card_name()
    log(f"card: {SMI} | torch {torch.__version__}")
    t0 = time.perf_counter()
    _build.build()
    t0 = phase("build", t0)
    totals = {k: 0 for k in SOURCES}
    run_benches(torch.device(*CARD), totals, out)
    phase("22 (route_bench, serve_bench, their gates)", t0)
    log(f"launches {totals}")
    return 0


def figures_only():
    """``--figures``: the build, phase 19's dry-run table (for the
    roofline's records) and phase 21 alone; its launch counts are
    printed, no kernel table."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    global SMI
    SMI = card_name()
    log(f"card: {SMI} | torch {torch.__version__}")
    t0 = time.perf_counter()
    _build.build()
    t0 = phase("build", t0)
    device = torch.device(*CARD)
    dry_table(device)
    t0 = phase("19 (a) (the dry run's table on meta)", t0)
    totals = {k: 0 for k in SOURCES}
    run_figures(device, totals)
    phase("21 (figures, noc_routing, graph analytics)", t0)
    log(f"launches {totals}")
    return 0


def serve_out_only():
    """``--serve-out``: the build and phase 20 alone (with phase 13's
    lockstep pass for the baseline); its launch counts are printed, no
    kernel table."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    global SMI
    SMI = card_name()
    log(f"card: {SMI} | torch {torch.__version__}")
    t0 = time.perf_counter()
    _build.build()
    t0 = phase("build", t0)
    totals = {k: 0 for k in SOURCES}
    run_serve_out(torch.device(*CARD), totals)
    phase("20 (the server and the MoE layer across two processes)", t0)
    log(f"launches {totals}")
    return 0


def dry_only():
    """``--dryrun``: the build and phase 19 alone; its launch counts are
    printed, no kernel table."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    global SMI
    SMI = card_name()
    log(f"card: {SMI} | torch {torch.__version__}")
    t0 = time.perf_counter()
    _build.build()
    t0 = phase("build", t0)
    totals = {k: 0 for k in SOURCES}
    run_dry(torch.device(*CARD), totals)
    phase("19 (launch runtime, dry run)", t0)
    log(f"launches {totals}")
    return 0


def scale_out_only():
    """``--scale-out``: the build, RMAT-22 and its packing (phase 2) and
    phase 15 alone; its launch counts are printed, no kernel table."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.sparse import datasets
    from repro_torch.sparse.program import _graph_setup
    global SMI
    SMI = card_name()
    log(f"card: {SMI} | torch {torch.__version__}")
    t0 = time.perf_counter()
    _build.build()
    t0 = phase("build", t0)
    g = datasets.rmat(SCALE, seed=SEED)
    setup = _graph_setup(g, 64)
    t0 = phase(f"rmat-{SCALE} and its packing", t0)
    totals = {k: 0 for k in SOURCES}
    run_scale_out(torch.device(*CARD), totals, g, setup)
    phase("15 (scale-out, two processes)", t0)
    log(f"launches {totals}")
    return 0


def lm_only():
    """``--lm``: the build and phase 16 alone; its launch counts are
    printed, no kernel table."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    global SMI
    SMI = card_name()
    log(f"card: {SMI} | torch {torch.__version__}")
    t0 = time.perf_counter()
    _build.build()
    t0 = phase("build", t0)
    totals = {k: 0 for k in SOURCES}
    run_lm(torch.device(*CARD), totals)
    phase("16 (LM serving)", t0)
    log(f"launches {totals}")
    return 0


def train_only():
    """``--train``: the build and phase 17 alone; its launch counts are
    printed, no kernel table."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    global SMI
    SMI = card_name()
    log(f"card: {SMI} | torch {torch.__version__}")
    t0 = time.perf_counter()
    _build.build()
    t0 = phase("build", t0)
    totals = {k: 0 for k in SOURCES}
    run_train(torch.device(*CARD), totals)
    phase("17 (LM training)", t0)
    log(f"launches {totals}")
    return 0


def repeat_runs(src, det):
    """``--repeat [SRC] [--deterministic]``: does OLMoE-1B-7B repeat bit
    for bit on the card with the ``repro_torch`` under ``SRC`` (default
    this checkout's; another checkout's, to compare two trees)? (a) phase
    19's measured model (4 of 16 layers, bf16 activations over float32
    weights, seed 0, ``moe_measure_fabric``) on train_4k cut to [2,
    4096]: two forwards on the kernel route and one on the sort route,
    their largest logit differences over max|logit|; (b) phase 17's step
    1 (4 layers, float32, seed 1, [2, 4096], the fused packaging) twice
    from the same weights and batch: the loss, and the gradient leaves
    and parameters after the step that differ. ``--deterministic`` runs
    both under ``torch.use_deterministic_algorithms(True,
    warn_only=True)`` and prints each warning once."""
    import contextlib
    import dataclasses
    import warnings
    import torch
    sys.path.insert(0, str(Path(src).resolve()))
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.core.dispatch import MeshInfo, dispatch_queues
    from repro_torch.core.fabric import Fabric
    from repro_torch.kernels import _build
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import mesh_info_for
    from repro_torch.launch.steps import default_optimizer, make_train_step
    from repro_torch.launch.train import reduced_batch
    from repro_torch.models.model_zoo import build_model
    global SMI
    SMI = card_name()
    log(f"repeat: repro_torch from {Path(repro_torch.__file__).parent}, "
        f"deterministic mode {det} [{SMI}]")
    _build.build()
    device = torch.device(*CARD)
    torch.backends.cuda.matmul.allow_tf32 = False
    with contextlib.ExitStack() as stack:
        caught = stack.enter_context(warnings.catch_warnings(record=True))
        warnings.simplefilter("always")
        if det:
            torch.use_deterministic_algorithms(True, warn_only=True)
            stack.callback(torch.use_deterministic_algorithms, False)
        t0 = time.perf_counter()
        cfg = dryrun.with_depth(get_config(MOE_ARCH), 4)
        info = mesh_info_for(cfg, Fabric.virtual(
            *dryrun.moe_measure_fabric(cfg), device=device))
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        model = build_model(cfg, mesh_info=info, dtype=torch.bfloat16,
                            device=device).init(gen)
        shape = dataclasses.replace(
            {s.name: s for s in cfg.shape_cells()}["train_4k"],
            global_batch=2, seq_len=4096)
        batch = reduced_batch(cfg, cfg, shape, 0, device)
        sort_q = dataclasses.replace(dispatch_queues(cfg.moe),
                                     route_impl="sort")
        with torch.no_grad():
            a, _ = model.forward(batch, kernel=False)
            b, _ = model.forward(batch, kernel=False)
            with RoutingSpy(info, (2, 4096), 0, sort_q):
                c, _ = model.forward(batch, kernel=False)
        scale = float(a.float().abs().max())
        (same_ab, d_ab), (same_ac, d_ac) = same_bits(a, b), same_bits(a, c)
        log(f"repeat (a) bf16 forward {tuple(a.shape)}: run twice "
            f"{'bit-identical' if same_ab else 'differs'} ({d_ab / scale:.4e}"
            f" of max|logit| {scale:.4f}); kernel vs sort route "
            f"{'bit-identical' if same_ac else 'differs'} "
            f"({d_ac / scale:.4e}); {time.perf_counter() - t0:.2f} s [{SMI}]")
        del model, a, b, c, batch
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(MOE_ARCH),
                                  num_layers=TRAIN_LAYERS)
        _, fshape, names, kw = MOE_PACKAGINGS[0]
        info = MeshInfo(Fabric.virtual(fshape, names, device=device), **kw)
        gen.manual_seed(SEED)
        model = build_model(cfg, mesh_info=info).init(gen)
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in lm_batch(cfg, TRAIN_TOKENS).items()}
        p0 = host_copy(model.paths())
        runs = []
        for _ in range(2):
            with torch.no_grad():
                for k, p in model.paths().items():
                    p.copy_(p0[k])
            opt = KeepGrads(default_optimizer())
            step = make_train_step(model, opt)
            _, _, metrics = step(model.paths(), opt.init(model.paths()),
                                 batch)
            runs.append((float(metrics["loss"]), opt.grads,
                         host_copy(model.paths())))
            del metrics
        (l1, g1, q1), (l2, g2, q2) = runs
        for what, one, two in (("gradient", g1, g2), ("parameter", q1, q2)):
            diffs = {k: same_bits(one[k], two[k])[1] / max(float(
                one[k].abs().max()), 1e-30) for k in one
                if not same_bits(one[k], two[k])[0]}
            worst = max(diffs, key=diffs.get) if diffs else None
            log(f"repeat (b) train step 1 twice: {what} leaves differing "
                f"{len(diffs)} of {len(one)}"
                + (f", the most {worst} at {diffs[worst]:.4e} of its max"
                   if worst else ""))
        log(f"repeat (b) train step 1 twice: loss {l1!r} vs {l2!r} "
            f"({'equal' if l1 == l2 else 'differs'}); "
            f"{time.perf_counter() - t0:.2f} s [{SMI}]")
    seen = set()
    for w in caught:
        msg = f"{w.category.__name__}: {str(w.message)[:400]}"
        if msg not in seen:
            seen.add(msg)
            log(f"repeat: warned {msg}")
    return 0


def recurrent_only():
    """``--recurrent``: the build and phase 18 alone; its launch counts
    are printed, no kernel table."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    global SMI
    SMI = card_name()
    log(f"card: {SMI} | torch {torch.__version__}")
    t0 = time.perf_counter()
    _build.build()
    t0 = phase("build", t0)
    totals = {k: 0 for k in SOURCES}
    run_recurrent(torch.device(*CARD), totals)
    phase("18 (recurrent, hybrid, encoder-decoder LMs)", t0)
    log(f"launches {totals}")
    return 0


def bfs_rounds(src):
    """``--bfs-rounds [SRC]``: BFS on RMAT-22, flat 64 shards at factor 4,
    with the ``repro_torch`` package found under ``SRC`` (default: this
    checkout's ``src``; another checkout's, to compare two trees on one
    card): one run to build and warm, three timed on the host clock, and
    one profiled, whose device time per round of each route wrapper's
    kernels (:data:`KERNEL_NAMES`, old and new designs) it prints."""
    import numpy as np
    import torch
    sys.path.insert(0, str(Path(src).resolve()))
    import repro_torch
    from repro_torch.core.fabric import Fabric
    from repro_torch.sparse import datasets, ref
    from repro_torch.sparse.options import LaunchOptions
    from repro_torch.sparse.program import _graph_setup
    from repro_torch.sparse.torch_apps import dcra_bfs
    log(f"bfs-rounds: repro_torch from {Path(repro_torch.__file__).parent}")
    g = datasets.rmat(SCALE, seed=SEED)
    setup = _graph_setup(g, 64)
    root = int(np.argmax(g.degrees()))
    want = ref.bfs_ref(g, root)
    fab = Fabric.fake(64, device=torch.device(*CARD))
    opts = LaunchOptions(capacity_factor=4.0)

    def run():
        return dcra_bfs(g, root, fab, options=opts, setup=setup)
    dist, stats = run()
    if not np.array_equal(dist, want) or stats.total_drops:
        raise AssertionError("bfs-rounds: BFS differs from the oracle")
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    per_round, device_ms, wall_ms, top = profile_kernels(run, stats.rounds)
    reached = int(g.degrees()[want >= 0].sum())
    log(f"bfs-rounds flat 64: rounds {stats.rounds}, run_s "
        f"{[round(t, 4) for t in times]}, TEPS {reached / min(times):.4e} "
        f"(best of 3)")
    log_profile("bfs-rounds flat 64", per_round, device_ms, wall_ms, top)
    if per_round is None:
        raise AssertionError("bfs-rounds: the profiler saw no device time")
    route_ms = sum(per_round[k] for k in ("bucket_rank", "bucket_scatter",
                                          "reduce_received"))
    log(f"bfs-rounds flat 64: route kernels {route_ms:.4f} ms a round")
    return 0


def dse_only():
    """``--dse``: the build, RMAT-22 and its packing (phase 2) and phase 14
    alone; its launch counts are printed, no kernel table."""
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.sparse import datasets
    from repro_torch.sparse.program import _graph_setup
    global SMI
    SMI = card_name()
    log(f"card: {SMI} | torch {torch.__version__}")
    t0 = time.perf_counter()
    _build.build()
    t0 = phase("build", t0)
    g = datasets.rmat(SCALE, seed=SEED)
    setup = _graph_setup(g, 64)
    root = int(np.argmax(g.degrees()))
    t0 = phase(f"rmat-{SCALE} and its packing", t0)
    totals = {k: 0 for k in SOURCES}
    run_dse(g, setup, root, torch.device(*CARD), totals)
    phase("14 (DSE, twin, config=auto)", t0)
    log(f"launches {totals}")
    return 0


def stop_children():
    """Kill what :data:`CHILDREN` still runs."""
    for proc in CHILDREN:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def phase(name, t0):
    log(f"phase {name}: {time.perf_counter() - t0:.2f} s")
    return time.perf_counter()


def main() -> int:
    if sys.argv[1:2] == ["--bench-spread"]:        # reads files only
        return bench_spread(sys.argv[2:])
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
    if sys.argv[1:2] == ["--bfs-rounds"]:
        return bfs_rounds(sys.argv[2] if len(sys.argv) > 2 else ROOT / "src")
    if sys.argv[1:2] == ["--rank-grid"]:
        return rank_grid_only(sys.argv[2] if len(sys.argv) > 2
                              else ROOT / "src")
    if sys.argv[1:2] == ["--dse"]:
        return dse_only()
    if sys.argv[1:2] == ["--scale-out"]:
        return scale_out_only()
    if sys.argv[1:2] == ["--lm"]:
        return lm_only()
    if sys.argv[1:2] == ["--train"]:
        return train_only()
    if sys.argv[1:2] == ["--recurrent"]:
        return recurrent_only()
    if sys.argv[1:2] == ["--dryrun"]:
        return dry_only()
    if sys.argv[1:2] == ["--repeat"]:
        args = [a for a in sys.argv[2:] if a != "--deterministic"]
        return repeat_runs(args[0] if args else ROOT / "src",
                           "--deterministic" in sys.argv)
    if sys.argv[1:2] == ["--serve-out"]:
        return serve_out_only()
    if sys.argv[1:2] == ["--figures"]:
        return figures_only()
    if sys.argv[1:2] == ["--benches"]:
        return benches_only(Path(sys.argv[2]) if len(sys.argv) > 2
                            else BENCH_OUT)
    if sys.argv[1:2] == ["--serve-out-worker"]:
        return serve_out_worker(*sys.argv[2:5])
    if sys.argv[1:2] == ["--scale-out-worker"]:
        return scale_out_worker(*sys.argv[2:5])
    if sys.argv[1:2] == ["--psum-worker"]:
        return psum_worker(*sys.argv[2:5])
    if sys.argv[1:2] == ["--host-oracles"]:
        return host_oracles_worker(sys.argv[2])
    atexit.register(stop_children)
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
    global SMI
    smi = SMI = card_name()
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
    oracles = host_oracles_start(g)
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
    route_grid(routing, device, setup[-1], rows)
    rows["bucket_rank"]["grid"] = rank_grid(device, setup[-1], g.nnz)
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
    pagerank = run_pagerank(g, setup, device, totals, oracles)
    t0 = phase("5 (PageRank rmat-22)", t0)
    run_spmv(g, device, totals, oracles)
    t0 = phase("6 (SpMV rmat-22)", t0)
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

    # ---- 12-13: pipelined rounds; the server -------------------------------
    torch.cuda.empty_cache()
    # the rank kernel's row: its path's shape (one shard), the flat BFS
    # round's kept beside it under flat64_*
    rank = rows["bucket_rank"]
    rank.update({f"flat64_{k}": rank[k] for k in ("ms", "plain_ms",
                                                   "bound_ms")})
    rank.update(run_pipelined(g, root, want, setup, device, totals,
                              pagerank, host_setup1(oracles)))
    del want, pagerank
    torch.cuda.empty_cache()
    t0 = phase("12 (pipelined rounds rmat-22)", t0)
    serve13 = run_server(device, totals)
    t0 = phase("13 (server rmat-20, MoE service)", t0)

    # ---- 14: the DSE sweep, the twin at scale, config="auto" ---------------
    torch.cuda.empty_cache()
    run_dse(g, setup, root, device, totals, host_autoconfig(oracles))
    oracles[0].wait()
    shutil.rmtree(oracles[1], ignore_errors=True)
    del oracles
    t0 = phase("14 (DSE, twin rmat-18, config=auto rmat-22)", t0)

    # ---- 15: scale-out, two processes sharing the card ---------------------
    torch.cuda.empty_cache()
    run_scale_out(device, totals, g, setup)
    del g, setup
    t0 = phase("15 (scale-out, two processes)", t0)

    # ---- 16: the decoder LMs' serving path ---------------------------------
    torch.cuda.empty_cache()
    run_lm(device, totals)
    t0 = phase("16 (LM serving)", t0)

    # ---- 17: the decoder LMs' training path --------------------------------
    torch.cuda.empty_cache()
    run_train(device, totals)
    t0 = phase("17 (LM training)", t0)

    # ---- 18: the recurrent, hybrid and encoder-decoder LMs -----------------
    torch.cuda.empty_cache()
    run_recurrent(device, totals)
    t0 = phase("18 (recurrent, hybrid, encoder-decoder LMs)", t0)

    # ---- 19: the LM launch runtime and the analytic dry run ---------------
    torch.cuda.empty_cache()
    run_dry(device, totals)
    t0 = phase("19 (launch runtime, dry run, examples)", t0)

    # ---- 20: the server and the MoE layer across two processes -------------
    torch.cuda.empty_cache()
    run_serve_out(device, totals, serve13)
    del serve13
    t0 = phase("20 (the server and the MoE layer across two processes)", t0)

    # ---- 21: the paper's figure harness, noc_routing, graph analytics ------
    torch.cuda.empty_cache()
    run_figures(device, totals)
    t0 = phase("21 (figures, noc_routing, graph analytics)", t0)

    # ---- 22: the two timing benches and their gates ------------------------
    torch.cuda.empty_cache()
    run_benches(device, totals, gates=FULL_GATES)
    t0 = phase("22 (route_bench, serve_bench, the serve gate)", t0)

    rows = {k: rows[k] for k in SOURCES}           # the table's order
    for k in rows:
        rows[k]["launches"] = totals[k]
    for k in WGMMA_LIBS:
        rows[k]["hgmma"] = hgmma[k]
    # every kernel of the table launched on the paths
    idle = [k for k in rows if not totals[k]]
    if idle:
        raise AssertionError(f"kernels no path launched: {idle} ({totals})")
    log(f"whole run {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": list(rows.values())}))
    # the port drives one card (its shards are virtual)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
