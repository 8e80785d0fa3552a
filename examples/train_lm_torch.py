"""Train a small decoder LM with checkpoints and the
restartable loop, on the PyTorch port (counterpart of
``examples/train_lm.py``).

  PYTHONPATH=src python examples/train_lm_torch.py [--steps 300]
  PYTHONPATH=src python examples/train_lm_torch.py --device cpu \\
      --steps 8 --batch 2 --seq 32 --warmup 2 --lr 3e-3

granite-8b's family cut to 8 layers x d_model 512 x d_ff 2048, vocab
32000 (64M parameters by ``param_count``; the reference's example calls
it ~100M). Runs on the card unless ``--device`` names another;
the loss on the synthetic Zipf stream must fall. Without ``--ckpt-dir``
the checkpoints go to a temporary directory that the run deletes.
"""
import argparse
import dataclasses
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.fabric import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import reduced_batch
from repro_torch.models.model_zoo import build_model
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.runtime.fault_tolerance import run_training


def granite_100m():
    return dataclasses.replace(
        get_config("granite-8b"),
        name="granite-100m", num_layers=8, d_model=512, num_heads=8,
        num_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=32000)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=6e-4,
                    help="peak learning rate of the cosine schedule")
    ap.add_argument("--warmup", type=int, default=30)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a temporary one)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = granite_100m()
    model = build_model(cfg, device=dev)
    print(f"model: {cfg.param_count() / 1e6:.0f}M params on {dev}")
    opt = AdamW(lr=cosine_schedule(peak_lr=args.lr, warmup=args.warmup,
                                   total=args.steps))
    shape = ShapeConfig("train", args.seq, args.batch, "train")
    step_fn = make_train_step(model, opt, shape=shape)

    def init_state():
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = model.init(gen).paths()
        return params, opt.init(params)

    def batch_fn(step):
        return reduced_batch(cfg, cfg, shape, step, dev)

    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        res = run_training(step_fn, init_state, batch_fn, args.steps,
                           args.ckpt_dir or tmp, ckpt_every=100)
    dt = time.time() - t0
    first = float(res.metrics_history[0]["ce"])
    last = float(np.mean([float(m["ce"])
                          for m in res.metrics_history[-10:]]))
    print(f"CE {first:.3f} -> {last:.3f} over {args.steps} steps "
          f"({args.steps * args.batch * args.seq / dt:.0f} tok/s on {dev})")
    if not last < first:
        raise SystemExit("training must reduce the loss")


if __name__ == "__main__":
    main()
