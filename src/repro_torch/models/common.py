"""Shared model helpers (counterpart of ``repro/models/common.py:61-150``):
norms, SwiGLU, cross-entropy, RoPE and M-RoPE, and the initialisers.

The reference's logical-sharding helpers (``shard``,
``logical_axis_rules``) are not ported: on one card every annotation is
the identity.

Numerics follow the reference: the norms reduce in float32 and cast back
before the gamma multiply, RoPE rotates split halves with float32 angles
and casts the result to x's type.

Initialisers draw from an explicit ``torch.Generator``; it gives other
numbers than ``jax.random`` for the same seed, so the tests carry the
reference's parameters across as numpy instead
(``moe_params_from_numpy``, ``model_zoo.params_from_numpy``).
"""
from __future__ import annotations

from typing import Sequence

import torch


# ---------------------------------------------------------------------------
# Numerics
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * gamma


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * gamma + beta


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.silu(gate) * up


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                          ) -> torch.Tensor:
    """Stable CE over the vocab axis: logits [..., V], labels [...] ->
    [...] float32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return lse - ll


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x [..., hd] rotated by angles [..., hd/2] (split halves), in x's
    type."""
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: broadcastable to [..., S]."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # [hd/2]
    angles = positions[..., None].float() * freqs             # [..., S, hd/2]
    return _rotate(x, angles[..., None, :])                   # [..., S, 1, hd/2]


def mrope_sections(head_dim: int, sections: Sequence[int] = (16, 24, 24)
                   ) -> list:
    """The rotary frequencies of each position stream; rescaled when the
    head dim is reduced."""
    half = head_dim // 2
    secs = list(sections)
    if sum(secs) != half:
        base = [max(1, s * half // sum(secs)) for s in secs]
        base[0] += half - sum(base)
        secs = base
    return secs


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Sequence[int] = (16, 24, 24)) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.

    x: [B, S, H, hd]; positions: [B, 3, S] (temporal, height, width
    streams). ``sections`` partitions the hd/2 rotary frequencies among
    the 3 streams.
    """
    hd = x.shape[-1]
    half = hd // 2
    secs = mrope_sections(hd, sections)
    freqs = rope_freqs(hd, theta, x.device)                    # [half]
    ang = positions[..., None].float() * freqs                 # [B, 3, S, half]
    sec_id = torch.repeat_interleave(
        torch.arange(3, device=x.device),
        torch.tensor(secs, device=x.device), output_size=half)  # [half]
    idx = sec_id.expand(ang.shape[0], 1, ang.shape[2], half)
    angles = torch.gather(ang, 1, idx)[:, 0]                   # [B, S, half]
    return _rotate(x, angles[..., None, :])                    # [B, S, 1, half]


# ---------------------------------------------------------------------------
# Init helpers
# ---------------------------------------------------------------------------

class MetaGenerator:
    """Stands in for a ``torch.Generator`` when a model is built on the
    meta device (``model.init(MetaGenerator())``): every initialiser
    gives a tensor of its shape and type with no storage and draws
    nothing, the counterpart of ``jax.eval_shape(model.init, key)``."""
    device = torch.device("meta")


def randn(gen, shape: Sequence[int], dtype=torch.float32) -> torch.Tensor:
    """Standard normal draws of ``shape`` from ``gen`` on its device; on a
    :class:`MetaGenerator`, the meta tensor of that shape."""
    if isinstance(gen, MetaGenerator):
        return torch.empty(tuple(shape), dtype=dtype, device=gen.device)
    return torch.randn(tuple(shape), generator=gen, dtype=dtype,
                       device=gen.device)


def dense_init(gen: torch.Generator, in_dim: int, out_shape: Sequence[int],
               scale: float = 1.0, dtype=torch.float32) -> torch.Tensor:
    """``[in_dim, *out_shape]`` normal with std ``scale / sqrt(in_dim)``,
    on the generator's device."""
    shape = (in_dim,) + tuple(out_shape)
    std = scale / (in_dim ** 0.5)
    return randn(gen, shape, dtype) * std


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               dtype=torch.float32) -> torch.Tensor:
    """``[vocab, dim]`` normal with std 0.02, on the generator's device."""
    return randn(gen, (vocab, dim), dtype) * 0.02
