"""Deterministic synthetic token pipeline (host-sharded, restartable);
a numpy copy of ``repro/data/pipeline.py``.

Produces reproducible batches keyed by (seed, step) — restart-safe without
saving data-loader state (the step index in the checkpoint is enough, the
standard trick for elastic training). Per-family extras (VLM patch embeds,
enc-dec source frames) are generated to the same contracts as
launch/sharding.batch_struct.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from ..configs.base import ArchConfig, ShapeConfig

VLM_PATCH_TOKENS = 256


def synth_batch(cfg: ArchConfig, shape: ShapeConfig, step: int,
                seed: int = 0) -> Dict[str, np.ndarray]:
    """One global batch for (cfg, shape) at ``step`` — pure function."""
    rng = np.random.default_rng(np.uint64(seed) * 1_000_003 + step)
    B, S = shape.global_batch, shape.seq_len
    V = cfg.vocab_size

    def tokens(b, s):
        # zipf-ish marginal over the vocab: realistic token frequencies
        z = rng.zipf(1.2, size=(b, s)).astype(np.int64)
        return (z % V).astype(np.int32)

    if cfg.family == "encdec":
        s_src = min(S // 2, 4096)
        s_tgt = S - s_src
        tgt = tokens(B, s_tgt)
        return {"src_embeds": rng.normal(
                    0, 1, (B, s_src, cfg.d_model)).astype(np.float32),
                "tokens": tgt, "labels": tgt}
    if cfg.family == "vlm":
        n_patch = min(VLM_PATCH_TOKENS, S // 2)
        grid = int(n_patch ** 0.5)
        n_patch = grid * grid
        s_txt = S - n_patch
        tok = tokens(B, s_txt)
        # M-RoPE positions: patches get (t=0, h, w); text gets (t, t, t)
        pos = np.zeros((B, 3, S), np.int32)
        hh, ww = np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij")
        pos[:, 1, :n_patch] = hh.reshape(-1)
        pos[:, 2, :n_patch] = ww.reshape(-1)
        t = np.arange(s_txt) + grid
        pos[:, :, n_patch:] = t
        return {"tokens": tok, "labels": tok,
                "patch_embeds": rng.normal(
                    0, 1, (B, n_patch, cfg.d_model)).astype(np.float32),
                "positions": pos}
    tok = tokens(B, S)
    return {"tokens": tok, "labels": tok}


def batches(cfg: ArchConfig, shape: ShapeConfig, start_step: int = 0,
            seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield synth_batch(cfg, shape, step, seed)
        step += 1
