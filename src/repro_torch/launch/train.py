"""End-to-end training entry point (counterpart of ``repro/launch/train.py``).

Example (the card; add ``--device cpu`` on a host without one):
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \\
      --reduced --steps 100 --batch 8 --seq 128 --ckpt-dir ckpt

Without ``--ckpt-dir`` the checkpoints go to a temporary directory that
the run deletes, so every run starts from step 0; with one, a run resumes
from its latest checkpoint.
"""
from __future__ import annotations

import argparse
import tempfile
import time
from typing import Callable, Tuple

import numpy as np
import torch

from ..configs import get_config
from ..configs.base import ShapeConfig
from ..core.fabric import resolve_device
from ..data.pipeline import synth_batch
from ..models.model_zoo import build_model
from ..optim.adamw import AdamW, cosine_schedule
from ..runtime.fault_tolerance import StragglerWatchdog, run_training
from .steps import make_train_step


def reduced_batch(full_cfg, cfg, shape: ShapeConfig, step: int, device):
    """``synth_batch`` of the full config at ``step``, its tokens clipped
    to ``cfg``'s vocab and its patch embeddings cut or repeated to
    ``cfg.d_model``, as tensors on ``device``."""
    out = {}
    for k, v in synth_batch(full_cfg, shape, step).items():
        if k in ("tokens", "labels"):
            v = np.minimum(v, cfg.vocab_size - 1)
        if k in ("src_embeds", "patch_embeds") and v.shape[-1] != cfg.d_model:
            v = np.repeat(v, -(-cfg.d_model // v.shape[-1]),
                          axis=-1)[..., :cfg.d_model]
        out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return out


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a temporary one)")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--lr", type=float, default=3e-4,
                    help="peak learning rate of the cosine schedule")
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap


def trainer(args: argparse.Namespace
            ) -> Tuple[Callable, Callable, Callable[[int], dict]]:
    """``(step_fn, init_state, batch_fn)`` for :func:`run_training` from
    the CLI's arguments: the model on ``args.device`` with weights from a
    generator seeded 0, AdamW on the cosine schedule, ``synth_batch``."""
    dev = resolve_device(args.device)
    full_cfg = get_config(args.arch)
    cfg = full_cfg.reduced() if args.reduced else full_cfg
    shape = ShapeConfig("train", args.seq, args.batch, "train")
    model = build_model(cfg, device=dev)
    opt = AdamW(lr=cosine_schedule(peak_lr=args.lr, warmup=args.warmup))

    def init_state():
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = model.init(gen).paths()
        return params, opt.init(params)

    def batch_fn(step):
        return reduced_batch(full_cfg, cfg, shape, step, dev)

    return make_train_step(model, opt, shape=shape), init_state, batch_fn


def main(argv=None):
    """Train and print the loss lines; returns the loop's
    :class:`~repro_torch.runtime.fault_tolerance.TrainLoopResult`."""
    args = parser().parse_args(argv)
    step_fn, init_state, batch_fn = trainer(args)
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        res = run_training(step_fn, init_state, batch_fn, args.steps,
                           args.ckpt_dir or tmp, ckpt_every=args.ckpt_every,
                           watchdog=StragglerWatchdog())
    for i, m in enumerate(res.metrics_history):
        if i % args.log_every == 0 or i == len(res.metrics_history) - 1:
            print(f"step {i}: loss={m['loss']:.4f} ce={m['ce']:.4f}")
    dt = time.time() - t0
    tok = args.steps * args.batch * args.seq
    print(f"done: {args.steps} steps, {tok / dt:.0f} tok/s, "
          f"{res.restarts} restarts, stragglers={res.straggler_steps} "
          f"on {resolve_device(args.device)}")
    return res


if __name__ == "__main__":
    main()
