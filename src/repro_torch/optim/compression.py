"""Error-feedback int8 gradient compression for the data-parallel
all-reduce (counterpart of ``repro/optim/compression.py:20-62``).

Each gradient is quantized to int8 with one scale a shard before the
sum, and the quantization residual stays on the shard (error feedback),
which keeps SGD's convergence: 4x fewer bytes a step on the data axes.
It is the data-parallel hook of :class:`repro_torch.optim.adamw.AdamW`.

The reference runs :func:`compress_psum` inside ``shard_map``; here a
gradient leaf is the stacked per-shard values ``[S, ...]`` of a
:class:`~repro_torch.core.fabric.Fabric` (``[L, ...]``, this process's
shards, on a distributed one), and the sums over the named axes are the
fabric's :meth:`Fabric.psum`, which on a distributed fabric gathers
every process's shards and sums them as the virtual fabric does: the
same values, bit for bit, over one process or several.
"""
from __future__ import annotations

from typing import Any, Mapping, NamedTuple, Tuple

import torch

from ..core.fabric import Fabric


class EFState(NamedTuple):
    residual: Any          # the gradients' mapping, float32


def init_ef(grads_shape: Mapping[str, Any]) -> EFState:
    """Zero float32 residuals of each leaf's shape and device."""
    return EFState({k: torch.zeros(g.shape, dtype=torch.float32,
                                   device=g.device)
                    for k, g in grads_shape.items()})


def _quantize(x: torch.Tensor, dims) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.amax(torch.abs(x), dim=dims, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (int8 values, the float32 0-d scale max|x| / 127)."""
    q, scale = _quantize(x, tuple(range(x.dim())))
    return q, scale.reshape(())


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_psum(grads: Mapping[str, torch.Tensor], ef: EFState,
                  fabric: Fabric, axis_names) -> Tuple[dict, EFState]:
    """Per leaf: quantize(grad + residual) a shard -> sum (int) over
    ``axis_names`` -> dequantize with the mean scale, divided by the
    participants. Leaves are per-shard ``[S, ...]``; returns the mean
    gradients in each leaf's type and the new residuals."""
    n = fabric.axis_size(axis_names)
    out, res = {}, {}
    for k, g in grads.items():
        g32 = g.to(torch.float32) + ef.residual[k]
        q, scale = _quantize(g32, tuple(range(1, g32.dim())))
        # int8 payloads summed as integers (exact for up to 2^23
        # participants); the scales averaged, as the reference does
        qsum = fabric.psum(q.to(torch.int32), axis_names)
        ssum = fabric.psum(scale, axis_names)
        mean = qsum.to(torch.float32) * (ssum / n) / n
        res[k] = g32 - dequantize(q, scale)
        out[k] = mean.to(g.dtype)
    return out, EFState(res)
