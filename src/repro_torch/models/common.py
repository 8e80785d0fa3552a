"""Shared model helpers (counterpart of ``repro/models/common.py``, the
parts the MoE layer needs): SwiGLU and the initialisers.

Initialisers draw from an explicit ``torch.Generator``; it gives other
numbers than ``jax.random`` for the same seed, so the tests carry the
reference's parameters across as numpy instead (``moe_params_from_numpy``).
"""
from __future__ import annotations

from typing import Sequence

import torch


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.silu(gate) * up


def dense_init(gen: torch.Generator, in_dim: int, out_shape: Sequence[int],
               scale: float = 1.0, dtype=torch.float32) -> torch.Tensor:
    """``[in_dim, *out_shape]`` normal with std ``scale / sqrt(in_dim)``,
    on the generator's device."""
    shape = (in_dim,) + tuple(out_shape)
    std = scale / (in_dim ** 0.5)
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=gen.device) * std

