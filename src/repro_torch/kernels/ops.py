"""Public wrappers of the port's leaf kernels (counterpart of
``repro/kernels/ops.py``). Each runs its hand-written CUDA kernel on a
CUDA tensor and its plain PyTorch version on a CPU tensor.
"""
from __future__ import annotations

import torch

from .flash_attention import flash_attention as _flash_attention
from .histogram import histogram
from .moe_gmm import gmm
from .spmv import bsr_spmv, csr_to_bsr, spmv_csr


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q, k, v: [B, H, S, hd] -> [B, H, S, hd]."""
    if q.dim() != 4:
        raise ValueError(f"q must be [B, H, S, hd], got {tuple(q.shape)}")
    B, H, S, hd = q.shape

    def f(a):
        return a.reshape(B * H, S, hd)
    return _flash_attention(f(q), f(k), f(v), causal=causal).reshape(
        B, H, S, hd)


__all__ = ["histogram", "flash_attention", "gmm", "bsr_spmv", "csr_to_bsr",
           "spmv_csr"]
