"""The dry run: every (arch x shape x fabric) cell laid out on the contract
fabrics, with its roofline terms on the H100's figures (counterpart of
``repro/launch/dryrun.py:38-269``).

The reference lowers and compiles each cell's train or serve step over a
512-device host mesh. The port has no compiler to ask, so
:func:`lower_cell` is its counterpart of lower-plus-compile: it builds
the step's parameters, AdamW moments, batch and decode cache on the
meta device (shapes and types, no storage, no generator: the
counterpart of ``jax.eval_shape``), applies the spec tables of
:mod:`repro_torch.launch.sharding` to them, and records the reference's
keys: ``compute_s``, ``memory_s`` and ``bottleneck`` from
:mod:`repro_torch.launch.analytic` at the H100's rates,
``analytic_flops``, ``model_flops_ratio``, and
``argument_size_in_bytes``, the bytes one shard holds of the step's
inputs under the specs. What only XLA says (``collective_s``, the
``coll_*`` keys, ``hlo_flops_per_device_scanbody``, the temp, output and
code sizes) is ``None``, with the reason under ``notes``.

``measure=True`` also runs the cell on a device (the card unless
``device`` names another) at the published width, cut in depth, batch
and sequence to the caller's ``measure_at`` or, for the cells
:data:`MEASURE_AT` lists, to what one card was found to hold: the
step's ms (CUDA events on the card, the host clock elsewhere), its peak
bytes (on the card), the kernels it launched, and the analytic terms of
that reduced cell and their share of the measured time; every cut is
listed under ``measured["reduced"]``.

Usage (the default output never overwrites the reference's file):
  PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch ID]
      [--shape NAME] [--mesh single|multi|both] [--out PATH] [--reduced]
      [--measure] [--measure-layers N] [--measure-batch N]
      [--measure-seq N] [--device DEV]
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import time
from typing import Dict, List, Optional, Tuple

import torch

from ..configs import ARCH_IDS, get_config
from ..configs.base import ArchConfig, ShapeConfig
from ..core.fabric import Fabric, resolve_device
from ..dse.driver import SweepTask, run_sweep, summarize
from ..models.common import MetaGenerator
from ..models.model_zoo import build_model
from .analytic import step_cost
from .mesh import make_mesh_for, mesh_info_for
from .roofline import NO_HLO, analyze, model_flops
from .sharding import (batch_struct, cache_shardings, param_shardings,
                       shard_bytes)
from .steps import (check_shape, default_optimizer, make_prefill_step,
                    make_serve_step, make_train_step)

DEFAULT_OUT = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "dryrun_results_torch.json")
SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")

#: the keys of a lowered cell's record
RECORD_KEYS = (
    "arch", "shape", "mesh", "tag", "chips", "compute_s", "memory_s",
    "collective_s", "bottleneck", "analytic_flops", "analytic_hbm_bytes",
    "coll_bytes_per_device", "coll_note", "coll_breakdown",
    "hlo_flops_per_device_scanbody", "model_flops", "model_flops_ratio",
    "build_s", "argument_size_in_bytes", "temp_size_in_bytes",
    "output_size_in_bytes", "generated_code_size_in_bytes", "notes")
#: the keys of a measured cell's ``measured`` entry
MEASURED_KEYS = (
    "device", "device_name", "timer", "reduced", "layers", "batch", "seq",
    "fabric", "step_ms", "peak_bytes", "compute_s", "memory_s",
    "compute_share", "memory_share", "launches")

NO_MEMORY_ANALYSIS = "no XLA memory analysis in torch"
#: the cuts ``measure`` runs a full-size cell at when the caller names
#: none: (arch, shape) -> layers, batch and sequence (or cache) length
#: at the published width, each run on one H100 80GB; any other cell
#: needs its cuts named
MEASURE_AT = {
    ("granite-8b", "train_4k"): {"layers": 8, "batch": 2, "seq": 4096},
    ("granite-8b", "prefill_32k"): {"layers": 8, "batch": 1, "seq": 32768},
    ("granite-8b", "decode_32k"): {"layers": 8, "batch": 8, "seq": 32768},
    ("olmoe-1b-7b", "train_4k"): {"layers": 4, "batch": 2, "seq": 4096},
}
#: the fabric a measured MoE cell dispatches over: chip_smoke.py phase
#: 10's fused packaging (data 2, expert 8, tp 1), one card's share of the
#: contract fabric; the expert axis shrinks to divide a smaller expert
#: count
MOE_MEASURE_FABRIC = ((2, 8, 1), ("data", "expert", "tp"))


def moe_measure_fabric(cfg: ArchConfig) -> Tuple[Tuple[int, ...],
                                                 Tuple[str, ...]]:
    (data, expert, tp), names = MOE_MEASURE_FABRIC
    return (data, math.gcd(expert, cfg.moe.num_experts), tp), names


def variant(cfg: ArchConfig, dispatch_impl=None, remat=None,
            capacity_factor=None) -> ArchConfig:
    """``cfg`` with the hill-climb's knobs applied (each ``None`` keeps
    the config's; the MoE knobs leave a dense arch alone)."""
    if dispatch_impl is not None and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, dispatch_impl=dispatch_impl))
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    if capacity_factor is not None and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe,
                                         capacity_factor=capacity_factor))
    return cfg


def _pairs(tree, specs):
    """``(tensor, spec)`` of every tensor leaf of a cache structure and
    :func:`cache_shardings`' specs of it, walked together."""
    if isinstance(tree, torch.Tensor):
        return [(tree, specs)]
    if isinstance(tree, dict):
        return [x for k in tree for x in _pairs(tree[k], specs[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t, sp in zip(tree, specs) for x in _pairs(t, sp)]
    return []


def _bytes(pairs, fabric: Fabric) -> int:
    return sum(shard_bytes(spec, tuple(t.shape), t.element_size(), fabric)
               for t, spec in pairs)


def _meta_params(model, param_dtype: str) -> Dict[str, torch.Tensor]:
    """The model's parameters as meta tensors; ``bf16``: every float32
    matrix in bf16 (the Adam moments stay float32)."""
    out = {}
    for k, p in model.paths().items():
        if param_dtype == "bf16" and p.dim() >= 2 and p.dtype == torch.float32:
            p = torch.empty(p.shape, dtype=torch.bfloat16, device="meta")
        out[k] = p
    return out


def cell_inputs(cfg: ArchConfig, shape: ShapeConfig, fabric: Fabric,
                fsdp: bool = True, hierarchical: bool = True,
                param_dtype: str = "f32") -> List[Tuple[torch.Tensor, tuple]]:
    """The cell's step inputs on the meta device, each with its spec: the
    parameters, then the AdamW state and batch (train), the batch
    (prefill), or the cache, tokens and position (decode). A train
    cell's shape is checked against the logical rules on ``fabric``
    (:func:`~repro_torch.launch.steps.check_shape`)."""
    info = mesh_info_for(cfg, fabric, hierarchical=hierarchical)
    if info is not None and not fsdp:
        info = dataclasses.replace(info, fsdp=False)
    model = build_model(cfg, mesh_info=info, dtype=torch.bfloat16,
                        device="meta").init(MetaGenerator())
    params = _meta_params(model, param_dtype)
    p_spec = param_shardings(cfg, fabric, params, fsdp=fsdp)
    pairs = [(params[k], p_spec[k]) for k in params]
    if shape.kind == "train":
        check_shape(model, shape, fabric, cfg.accum_steps)
        opt = default_optimizer()
        # the moments are float32 whatever param_dtype, sharded with FSDP
        # as the reference's are
        state = opt.init(model.paths())
        pairs.append((state.step, ()))
        for moments in (state.mu, state.nu):
            spec = param_shardings(cfg, fabric, moments)
            pairs += [(moments[k], spec[k]) for k in moments]
    if shape.kind in ("train", "prefill"):
        pairs += [(s.meta(), s.spec)
                  for s in batch_struct(cfg, shape, fabric).values()]
    else:
        B = shape.global_batch
        cache = model.init_cache(B, shape.seq_len, torch.bfloat16)
        pairs += _pairs(cache, cache_shardings(cfg, shape, fabric, cache))
        pairs += [(torch.empty((B, 1), dtype=torch.int32, device="meta"), ()),
                  (torch.empty((), dtype=torch.int32, device="meta"), ())]
    return pairs


# ---------------------------------------------------------------------------
# measured cells
# ---------------------------------------------------------------------------

def with_depth(cfg: ArchConfig, layers: int) -> ArchConfig:
    """``cfg`` cut to ``layers`` decoder layers (and as many encoder
    layers where it has an encoder)."""
    kw = {"num_layers": layers}
    if cfg.encoder_layers:
        kw["encoder_layers"] = layers
    return dataclasses.replace(cfg, **kw)


def _launch_counts() -> Dict[str, int]:
    from ..kernels import flash_attention, histogram, moe_gmm, route, spmv
    counts: Dict[str, int] = {}
    for mod in (route, histogram, spmv, moe_gmm, flash_attention):
        counts.update(mod.LAUNCHES)
    return counts


def _timed(fn, device: torch.device):
    """``(milliseconds, result)`` of one ``fn()``: CUDA events on the
    card, the host clock elsewhere."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end), out
    t0 = time.perf_counter()
    out = fn()
    return (time.perf_counter() - t0) * 1e3, out


def measure_cell(cfg: ArchConfig, shape: ShapeConfig, device=None,
                 layers: Optional[int] = None, batch: Optional[int] = None,
                 seq: Optional[int] = None, param_dtype: str = "f32",
                 hierarchical: bool = True, fsdp: bool = True
                 ) -> Dict[str, object]:
    """Run the cell's step once to warm up and once timed on ``device``
    (the card unless named) at its published width, cut to ``layers``,
    ``batch`` and ``seq`` (each ``None`` keeps the cell's own);
    weights float32 from a generator seeded 0 (``bf16``: matrices in
    bf16), activations bf16, a MoE arch through its dispatch on
    :func:`moe_measure_fabric`. Returns the ``measured`` entry."""
    from .train import reduced_batch
    dev = resolve_device(device)
    L, B, S = (layers or cfg.num_layers, batch or shape.global_batch,
               seq or shape.seq_len)
    rcfg = with_depth(cfg, L)
    rshape = dataclasses.replace(shape, global_batch=B, seq_len=S)
    reduced = []
    if L != cfg.num_layers:
        reduced.append(f"layers {cfg.num_layers} -> {L}"
                       + (" (and the encoder's)" if cfg.encoder_layers
                          else ""))
    if B != shape.global_batch:
        reduced.append(f"batch {shape.global_batch} -> {B}")
    if S != shape.seq_len:
        reduced.append(f"{'cache' if shape.is_decode else 'sequence'} "
                       f"{shape.seq_len} -> {S}")
    info, fab_desc = None, "one card"
    if cfg.moe is not None:
        fshape, fnames = moe_measure_fabric(cfg)
        full = make_mesh_for(cfg, multi_pod=False)
        info = mesh_info_for(cfg, Fabric.virtual(fshape, fnames, device=dev),
                             hierarchical=hierarchical)
        if not fsdp:
            info = dataclasses.replace(info, fsdp=False)
        fab_desc = "x".join(map(str, fshape)) + " " + ",".join(fnames)
        reduced.append(f"fabric {'x'.join(map(str, full.shape))} -> "
                       f"{'x'.join(map(str, fshape))}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = build_model(rcfg, mesh_info=info, dtype=torch.bfloat16,
                        device=dev).init(gen)
    if param_dtype == "bf16":
        for p in model.parameters():
            if p.dim() >= 2 and p.dtype == torch.float32:
                p.data = p.data.to(torch.bfloat16)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    if rshape.kind == "train":
        opt = default_optimizer()
        step = make_train_step(model, opt, info, rshape,
                               accum_steps=rcfg.accum_steps)
        params = model.paths()
        state = [opt.init(params)]
        data = reduced_batch(rcfg, rcfg, rshape, 0, dev)

        def run():
            _, state[0], m = step(params, state[0], data)
            return m
    elif rshape.kind == "prefill":
        step = make_prefill_step(model)
        data = reduced_batch(rcfg, rcfg, rshape, 0, dev)

        def run():
            return step(data)
    else:
        step = make_serve_step(model)
        cache = [model.init_cache(B, S, torch.bfloat16)]
        tok = torch.zeros((B, 1), dtype=torch.int32, device=dev)

        def run():
            nxt, cache[0] = step(cache[0], tok, S - 1)
            return nxt
    run()                                   # warm-up
    before = _launch_counts()
    ms, out = _timed(run, dev)
    after = _launch_counts()
    if rshape.kind == "train":
        ok = bool(torch.isfinite(out["loss"]))
        bad = None if ok else "a non-finite loss"
    else:
        ok = bool(((out >= 0) & (out < model.embed.shape[0])).all())
        bad = None if ok else "ids outside the vocab"
    if bad:
        raise ValueError(f"{cfg.name} {shape.name}: the measured step gave "
                         f"{bad}")
    on_card = dev.type == "cuda"
    peak = int(torch.cuda.max_memory_allocated(dev)) if on_card else None
    rl = analyze(rcfg, rshape, measured_s=ms / 1e3)
    # a share of the card's time: no share of a host-clock run
    share = rl.share_of_measured() if on_card else None
    return {
        "device": str(dev),
        "device_name": (torch.cuda.get_device_name(dev) if on_card
                        else str(dev)),
        "timer": "cuda events" if on_card else "host clock",
        "reduced": reduced, "layers": L, "batch": B, "seq": S,
        "fabric": fab_desc,
        "step_ms": ms, "peak_bytes": peak,
        "compute_s": rl.compute_s, "memory_s": rl.memory_s,
        "compute_share": share and share["compute"],
        "memory_share": share and share["memory"],
        "launches": {k: after[k] - before[k] for k in after},
    }


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------

def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               dispatch_impl=None, remat=None, verbose: bool = True,
               skip_pair: bool = False, fsdp: bool = True,
               hierarchical: bool = True, capacity_factor=None,
               param_dtype: str = "f32", tag: str = "",
               reduced: bool = False, measure: bool = False, device=None,
               measure_at: Optional[Dict[str, int]] = None):
    """Lay out one cell on meta; returns its record (the reference's
    ``lower_cell`` arguments, ``skip_pair`` accepted and unused: there
    is no collective pair to extrapolate). ``reduced`` takes the arch's
    ``reduced()`` config; ``measure`` adds the ``measured`` entry of
    :func:`measure_cell` on ``device`` at ``measure_at`` (``layers``,
    ``batch``, ``seq``; default the cell's :data:`MEASURE_AT` entry, and
    a cell without one needs ``measure_at``)."""
    del skip_pair
    if measure and not measure_at:
        measure_at = None if reduced else MEASURE_AT.get((arch, shape_name))
        if measure_at is None:
            raise ValueError(f"no measured cut for {arch} {shape_name}"
                             f"{' (reduced)' if reduced else ''}: name its "
                             f"layers, batch or seq (--measure-*)")
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    cfg = variant(cfg, dispatch_impl, remat, capacity_factor)
    shape = {s.name: s for s in cfg.shape_cells()}.get(shape_name)
    mesh = "multi" if multi_pod else "single"
    if shape is None:
        return {"arch": arch, "shape": shape_name, "mesh": mesh,
                "skipped": "shape not applicable (DESIGN.md §5)"}
    fabric = make_mesh_for(cfg, multi_pod=multi_pod)
    chips = fabric.n_devices
    t0 = time.perf_counter()
    n_bytes = _bytes(cell_inputs(cfg, shape, fabric, fsdp=fsdp,
                                 hierarchical=hierarchical,
                                 param_dtype=param_dtype), fabric)
    t1 = time.perf_counter()
    est = step_cost(cfg, shape)
    rl = analyze(cfg, shape, chips)
    compute_s, memory_s, bottleneck = rl.compute_s, rl.memory_s, rl.bottleneck
    mf = model_flops(cfg, shape)
    rec = {
        "arch": arch, "shape": shape.name, "mesh": mesh, "tag": tag,
        "chips": chips,
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": None,
        "bottleneck": bottleneck,
        "analytic_flops": est.flops,
        "analytic_hbm_bytes": est.hbm_bytes,
        "coll_bytes_per_device": None,
        "coll_note": NO_HLO,
        "coll_breakdown": None,
        "hlo_flops_per_device_scanbody": None,
        "model_flops": mf,
        "model_flops_ratio": mf / est.flops if est.flops else 0.0,
        "build_s": t1 - t0,
        "argument_size_in_bytes": n_bytes,
        "temp_size_in_bytes": None,
        "output_size_in_bytes": None,
        "generated_code_size_in_bytes": None,
        "notes": {"collective_s": NO_HLO,
                  "hlo_flops_per_device_scanbody": NO_HLO,
                  "temp_size_in_bytes": NO_MEMORY_ANALYSIS,
                  "output_size_in_bytes": NO_MEMORY_ANALYSIS,
                  "generated_code_size_in_bytes": NO_MEMORY_ANALYSIS,
                  "build_s": "seconds to build the cell on meta"},
    }
    if measure:
        rec["measured"] = measure_cell(
            cfg, shape, device, param_dtype=param_dtype,
            hierarchical=hierarchical, fsdp=fsdp, **measure_at)
    if verbose:
        m = rec.get("measured")
        extra = (f" measured {m['step_ms']:.2f} ms on {m['device_name']} "
                 f"({m['timer']}; {', '.join(m['reduced']) or 'uncut'})"
                 if m else "")
        print(f"[{mesh}|{arch}|{shape.name}|{tag}] chips={chips} "
              f"build={rec['build_s']:.2f}s "
              f"C/M={compute_s:.2e}/{memory_s:.2e}s "
              f"bottleneck={bottleneck} "
              f"6ND/analytic={rec['model_flops_ratio']:.2f} "
              f"args={rec['argument_size_in_bytes'] / 2**30:.2f}GiB/shard"
              + extra, flush=True)
    return rec


def tasks_for(archs: List[str], shapes: List[str], meshes: List[bool],
              **kw) -> List[SweepTask]:
    return [
        SweepTask(
            key=f"{arch}|{shape}|{'multi' if mp else 'single'}",
            run=(lambda arch=arch, shape=shape, mp=mp:
                 lower_cell(arch, shape, mp, **kw)),
            meta={"arch": arch, "shape": shape,
                  "mesh": "multi" if mp else "single"})
        for arch in archs for shape in shapes for mp in meshes]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=("single", "multi", "both"))
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--append", action="store_true")
    ap.add_argument("--retry-errors", action="store_true",
                    help="re-run previously errored cells on resume")
    ap.add_argument("--reduced", action="store_true",
                    help="each arch's reduced() config")
    ap.add_argument("--measure", action="store_true",
                    help="also run each cell on the device, at the "
                         "--measure-* cuts (default MEASURE_AT's)")
    ap.add_argument("--measure-layers", type=int, default=None)
    ap.add_argument("--measure-batch", type=int, default=None)
    ap.add_argument("--measure-seq", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device of --measure (default: the card)")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(SHAPE_NAMES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    at = {k: v for k, v in (("layers", args.measure_layers),
                            ("batch", args.measure_batch),
                            ("seq", args.measure_seq)) if v}
    results = run_sweep(
        tasks_for(archs, shapes, meshes, reduced=args.reduced,
                  measure=args.measure, device=args.device, measure_at=at),
        out=args.out, resume=args.append,
        retry_errors=args.retry_errors,
        key_of=lambda r: f"{r.get('arch')}|{r.get('shape')}|"
                         f"{r.get('mesh')}")
    print(f"dry-run complete: {summarize(results, 'compute_s')} "
          f"-> {args.out}")
    return results


if __name__ == "__main__":
    main()
