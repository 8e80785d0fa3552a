"""Batched serving: greedy decode with the KV cache (counterpart
of ``repro/launch/serve.py``), prefilling by teacher-forcing the prompt
through ``decode_step`` as the reference does.

Example (the card; add ``--device cpu --reduced`` on a host without
one):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \\
      --batch 4 --prompt-len 128 --gen 32
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config
from ..core.fabric import resolve_device
from ..models.model_zoo import build_model


@torch.inference_mode()
def serve(cfg, model, prompts: torch.Tensor, gen: int) -> torch.Tensor:
    """prompts [B, P] -> generated [B, gen] int32 (greedy), on the
    model's device."""
    prompts = torch.as_tensor(prompts, device=model.device)
    B, P = prompts.shape
    if gen <= 0:
        # nothing to generate: [B, 0], same type as the generated ids
        return torch.zeros((B, 0), dtype=torch.int32, device=model.device)
    cache = model.init_cache(B, P + gen, torch.float32)
    tok = prompts[:, :1]
    out = []
    for t in range(P + gen - 1):
        logits, cache = model.decode_step(cache, tok, t)
        nxt = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        # the last prompt token's logits (t == P-1) emit the first
        # generated id; with P == 1 that is the very first step
        tok = prompts[:, t + 1:t + 2] if t + 1 < P else nxt
        if t >= P - 1:
            out.append(tok)
    return torch.cat(out, dim=1).to(torch.int32)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    model_gen = torch.Generator(device=dev)
    model_gen.manual_seed(0)
    model = build_model(cfg, device=dev).init(model_gen)
    prompt_gen = torch.Generator(device=dev)
    prompt_gen.manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=prompt_gen, device=dev)
    t0 = time.perf_counter()
    out = serve(cfg, model, prompts, args.gen)
    out = out.cpu()
    dt = time.perf_counter() - t0
    print(f"generated {tuple(out.shape)} on {dev} in {dt:.1f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s)")
    print(out[:, :8])


if __name__ == "__main__":
    main()
