"""DCRA technique on the LM side: flat einsum dispatch vs DCRA owner-routed
dispatch. Compares *collective payload bytes* (the NoC traffic the paper
optimizes) analytically, plus the einsum path's time a call on the device.

einsum (GShard-style) moves dispatch/combine mask tensors [G,T,E,C] plus
padded [E,C,D] buffers; DCRA moves only n_peers*cap*D payload + int meta:
the queue-capacity bound (IQ) from the paper.

  PYTHONPATH=src python -m repro_torch.figures.moe_dispatch [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config
from ..core.dispatch import dispatch_queues
from ..core.fabric import resolve_device
from ..models.moe import GROUP_SIZE, capacity, init_moe, moe_einsum
from .common import emit

ARCHS = ("mixtral-8x22b", "olmoe-1b-7b")
TOKENS = 32768
TIMED_SHAPE = (4, 64)       # x [B, S, d_model] of the reduced config
REPS = 10


def analytic_bytes(arch: str, tokens: int, d_model: int) -> dict:
    cfg = get_config(arch)
    mc = cfg.moe
    g = min(GROUP_SIZE, tokens)
    G = tokens // g
    C = capacity(g, mc)
    E = mc.num_experts
    # einsum path: x_e [G,E,C,D] formed via dispatch mask (bf16 payload moved
    # through the a2a twice: dispatch + combine)
    einsum_bytes = 2 * G * E * C * d_model * 2
    # dcra path: per expert-shard cap buffers, K copies of each token;
    # the bucket capacity the real kernel resolves through QueueConfig
    n_shards = min(E, 8)
    cap = dispatch_queues(mc).channel_cap("dispatch", tokens * mc.top_k,
                                          n_shards)
    dcra_bytes = 2 * n_shards * cap * d_model * 2 + n_shards * cap * 8
    return {"einsum_MB": einsum_bytes / 2**20, "dcra_MB": dcra_bytes / 2**20,
            "ratio": einsum_bytes / dcra_bytes}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def einsum_us(cfg, device, reps: int = REPS) -> float:
    """``moe_einsum`` on the reduced ``cfg`` at :data:`TIMED_SHAPE`, one
    call warm, then the mean of ``reps`` synchronised calls, in µs."""
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = init_moe(gen, cfg)
    gen.manual_seed(1)
    x = torch.randn(TIMED_SHAPE + (cfg.d_model,), generator=gen,
                    device=device)
    with torch.no_grad():
        moe_einsum(params, x, cfg)
        _sync(device)
        t = time.perf_counter()
        for _ in range(reps):
            moe_einsum(params, x, cfg)
            _sync(device)
    return (time.perf_counter() - t) / reps * 1e6


def main(device=None):
    device = resolve_device(device)
    out = []
    for arch in ARCHS:
        full = get_config(arch)
        a = analytic_bytes(arch, tokens=TOKENS, d_model=full.d_model)
        out.append(("moe_dispatch", arch, "einsum_MB", f"{a['einsum_MB']:.1f}"))
        out.append(("moe_dispatch", arch, "dcra_MB", f"{a['dcra_MB']:.1f}"))
        out.append(("moe_dispatch", arch, "einsum/dcra", f"{a['ratio']:.2f}"))
        us = einsum_us(full.reduced(), device)
        out.append(("moe_dispatch", arch, "einsum_us_per_call", f"{us:.0f}"))
    emit(out, "figure,arch,metric,value")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    main(ap.parse_args().device)
