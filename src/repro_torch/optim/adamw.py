"""AdamW with decoupled weight decay and global-norm clipping
(counterpart of ``repro/optim/adamw.py:11-71``). The data-parallel
gradient reduction hook is :func:`repro_torch.optim.compression.
compress_psum`.

The optimiser works on a mapping of named tensors, the model's parameters
keyed by their tree paths (:meth:`~repro_torch.models.transformer.
ParamTree.paths`): it writes them in place under ``torch.no_grad()``
and replaces its moments leaf by leaf.

Numerics follow the reference's types. JAX promotes two typed arrays to
their common type, 0-d or not, and casts a Python scalar to the array's
type; torch keeps a tensor's type against a 0-d tensor and computes a
Python scalar in the op's math type. So every 0-d operand here is
promoted explicitly (:func:`_promoted`) and every scalar is cast to the
tensor's type (:func:`_weak`): a bf16 gradient times the float32 clip
scale is float32, as are the moments it then updates, and a bf16 moment
times 0.9 multiplies by bf16's 0.9, as in the reference. The step is an
int32 count, raised before the schedule reads it; the bias corrections
and the schedule are float32 tensors.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Mapping, NamedTuple, Tuple

import torch

Tree = Mapping[str, torch.Tensor]


class AdamWState(NamedTuple):
    step: torch.Tensor              # int32, 0-d
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def _weak(x: float, t: torch.Tensor) -> torch.Tensor:
    """A Python scalar as JAX reads it beside ``t``: in ``t``'s type."""
    return torch.tensor(x, dtype=t.dtype, device=t.device)


def _promoted(a: torch.Tensor, b: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``a`` and ``b`` in their common type, as JAX promotes two typed
    arrays whatever their rank."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


@dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params: Tree) -> AdamWState:
        """Zero moments of each parameter's shape and type, step 0."""
        device = next(iter(params.values())).device
        return AdamWState(
            torch.zeros((), dtype=torch.int32, device=device),
            {k: torch.zeros_like(p) for k, p in params.items()},
            {k: torch.zeros_like(p) for k, p in params.items()})

    @torch.no_grad()
    def update(self, grads: Tree, state: AdamWState, params: Tree
               ) -> Tuple[Tree, AdamWState]:
        """One step: ``params`` (the same tensors, written in place) and
        the new state, whose moment mappings are ``state``'s, each entry
        replaced leaf by leaf (so one leaf's old moments at a time outlive
        their update). ``grads`` has ``params``' keys."""
        step = state.step + 1
        scale = None
        if self.clip_norm:
            gnorm = global_norm(grads)
            clip = torch.tensor(self.clip_norm, dtype=gnorm.dtype,
                                device=gnorm.device)
            scale = torch.minimum(_weak(1.0, gnorm), clip / (gnorm + 1e-9))
        s = step.to(torch.float32)
        b1c = 1 - torch.pow(_weak(self.b1, s), s)
        b2c = 1 - torch.pow(_weak(self.b2, s), s)
        lr = self.lr(step)
        mu, nu = state.mu, state.nu
        for k, p in params.items():
            g = grads[k]
            if scale is not None:
                g = torch.mul(*_promoted(g, scale))
            m = torch.add(mu[k] * _weak(self.b1, mu[k]),
                          g * _weak(1 - self.b1, g))
            v = torch.add(nu[k] * _weak(self.b2, nu[k]),
                          g * _weak(1 - self.b2, g) * g)
            mhat = torch.div(*_promoted(m, b1c))
            vhat = torch.div(*_promoted(v, b2c))
            p32 = p.to(torch.float32)
            new = p32 - lr * (mhat / (torch.sqrt(vhat) + self.eps)
                              + self.weight_decay * p32)
            p.copy_(new.to(p.dtype))            # params may live in bf16
            mu[k], nu[k] = m, v
        return params, AdamWState(step, mu, nu)


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree.values()))


def cosine_schedule(peak_lr: float = 3e-4, warmup: int = 100,
                    total: int = 10_000, floor: float = 0.1
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warmup to ``peak_lr``, then a cosine decay to ``floor`` of
    it at ``total``: step (int tensor) -> float32 0-d tensor."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        warm = s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return peak_lr * torch.minimum(warm, cos)
    return lr
