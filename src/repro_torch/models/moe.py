"""Mixture-of-Experts layer (counterpart of ``repro/models/moe.py:28-120``).

Two dispatch implementations, selected by ``MoEConfig.dispatch_impl``:

* ``einsum`` — dense dispatch/combine masks over token groups
  (:func:`moe_einsum`), the flat-NoC baseline and the oracle of the
  owner-routed path;
* ``dcra`` — owner-routed task dispatch with bounded queues over the
  virtual-shard fabric (:func:`repro_torch.core.dispatch.moe_dcra`);
  without a :class:`~repro_torch.core.dispatch.MeshInfo` it falls back to
  ``einsum``, as the reference does.

Expert capacity is the DCRA input-queue size: tasks past it are dropped
and the residual carries their tokens.

Top-k follows ``jax.lax.top_k``: descending, ties to the lower expert id
(a stable descending sort). The order of a token's k tasks decides which
of them a capped bucket admits, so it has to match the reference.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ArchConfig, MoEConfig
from ..core.fabric import resolve_device
from .common import dense_init, randn, swiglu

GROUP_SIZE = 1024  # tokens per dispatch group (DCRA: per-tile task batch)


def init_moe(gen: torch.Generator, cfg: ArchConfig) -> Dict[str, torch.Tensor]:
    """Random MoE parameters on the generator's device: ``router [D, E]``,
    ``wg``/``wu [E, D, F]``, ``wd [E, F, D]`` (float32)."""
    mc = cfg.moe
    if mc is None:
        raise ValueError(f"{cfg.name} has no MoE config")
    d, e, f = cfg.d_model, mc.num_experts, mc.d_expert
    return {
        "router": dense_init(gen, d, (e,), scale=0.1),
        "wg": _expert_init(gen, e, d, f),
        "wu": _expert_init(gen, e, d, f),
        "wd": _expert_init(gen, e, f, d),
    }


def _expert_init(gen, e, din, dout):
    return randn(gen, (e, din, dout)) * (din ** -0.5)


def moe_params_from_numpy(params: Mapping[str, np.ndarray], device=None
                          ) -> Dict[str, torch.Tensor]:
    """The reference's ``init_moe`` parameters (as numpy arrays) as
    tensors on ``device`` (default the card), values and types kept."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(params[k])).to(dev)
            for k in ("router", "wg", "wu", "wd")}


def router_probs(params, x: torch.Tensor, mc: MoEConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., D] -> (probs, logits) [..., E], both float32."""
    logits = torch.matmul(x.float(), params["router"].float())
    return torch.softmax(logits, dim=-1), logits


def topk(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last dimension,
    descending, ties to the lower index -> (values, int64 indices)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _topk_mask(probs: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> gates [..., K] (renormalised), expert one-hot [..., K, E]."""
    vals, idx = topk(probs, k)
    vals = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
    onehot = torch.nn.functional.one_hot(idx, probs.shape[-1]).float()
    return vals, onehot


def capacity(group_tokens: int, mc: MoEConfig) -> int:
    c = int(group_tokens * mc.top_k * mc.capacity_factor / mc.num_experts)
    return max(8, -(-c // 8) * 8)


def moe_einsum(params, x: torch.Tensor, cfg: ArchConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense-mask dispatch. x [B, S, D] -> (out [B, S, D], aux loss [])."""
    mc = cfg.moe
    B, S, D = x.shape
    T = B * S
    g_size = min(GROUP_SIZE, T)
    G = T // g_size
    xg = x.reshape(G, g_size, D)
    K, E = mc.top_k, mc.num_experts

    probs, _ = router_probs(params, xg, mc)                  # [G,T,E]
    gates, onehot = _topk_mask(probs, K)                     # [G,T,K],[G,T,K,E]
    C = capacity(g_size, mc)

    # queue position of each (token, k) task within its expert queue
    flat = onehot.reshape(G, g_size * K, E)
    pos = torch.cumsum(flat, dim=1) * flat - flat            # 0-based
    keep = (pos < C).float() * flat                          # drop = overflow
    pos_k = pos.reshape(G, g_size, K, E).long()
    keep_k = keep.reshape(G, g_size, K, E)
    # one_hot(pos, C) * keep: a position past C has no slot
    slots = torch.arange(C, device=x.device)
    pos_oh = (pos_k[..., None] == slots).float() * keep_k[..., None]
    dispatch = pos_oh.sum(2)                                 # [G,T,E,C]
    combine = (pos_oh * gates[..., None, None]).sum(2)
    del pos_oh

    xe = torch.einsum("gtec,gtd->gecd", dispatch.to(x.dtype), xg)
    h = swiglu(torch.einsum("gecd,edf->gecf", xe, params["wg"].to(x.dtype)),
               torch.einsum("gecd,edf->gecf", xe, params["wu"].to(x.dtype)))
    ye = torch.einsum("gecf,efd->gecd", h, params["wd"].to(x.dtype))
    out = torch.einsum("gecd,gtec->gtd", ye, combine.to(x.dtype))

    aux = load_balance_loss(probs, onehot)
    return out.reshape(B, S, D), aux


def load_balance_loss(probs: torch.Tensor, onehot: torch.Tensor
                      ) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e(frac_tokens_e * mean_prob_e)."""
    E = probs.shape[-1]
    frac = onehot.sum(2).mean(dim=(0, 1))       # [E] routed share (pre-drop)
    mp = probs.mean(dim=(0, 1))                 # [E]
    return E * torch.sum(frac * mp)


def moe_block(params, x: torch.Tensor, cfg: ArchConfig,
              mesh_info: Optional[object] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    mc = cfg.moe
    if mc is None:
        raise ValueError(f"{cfg.name} has no MoE config")
    if mc.dispatch_impl == "dcra" and mesh_info is not None:
        from ..core.dispatch import moe_dcra
        return moe_dcra(params, x, cfg, mesh_info)
    return moe_einsum(params, x, cfg)
