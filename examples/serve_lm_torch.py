"""Batched serving on the PyTorch port: prefill and greedy decode for a
reduced Mixtral (MoE) and a reduced RWKV6 (attention-free state
serving), through ``repro_torch.launch.serve.serve`` (counterpart of
``examples/serve_lm.py``).

  PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]
"""
import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.fabric import resolve_device
from repro_torch.launch.serve import serve
from repro_torch.models.model_zoo import build_model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    B, P, G = args.batch, args.prompt_len, args.gen
    for arch in ("mixtral-8x22b", "rwkv6-7b"):
        cfg = get_config(arch).reduced()
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        model = build_model(cfg, device=dev).init(gen)
        gen.manual_seed(1)
        prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                                device=dev)
        t0 = time.perf_counter()
        out = serve(cfg, model, prompts, G).cpu()
        dt = time.perf_counter() - t0
        if out.shape != (B, G) or not bool(
                ((out >= 0) & (out < cfg.vocab_size)).all()):
            raise SystemExit(f"{arch}: generated {tuple(out.shape)}, ids "
                             f"outside the vocab")
        print(f"{arch:16s} generated {B}x{G} tokens in {dt:.1f}s "
              f"({B * G / dt:.1f} tok/s on {dev}, cache type: "
              f"{'state' if cfg.attn_free else 'KV ring'})")


if __name__ == "__main__":
    main()
