"""The train, serve and prefill steps (counterpart of
``repro/launch/steps.py:18-74``).

The model holds its parameters (:class:`~repro_torch.models.transformer.
ParamTree`), so a step takes the training state as the mapping of its
parameters by tree path (:meth:`ParamTree.paths`) and the optimiser's
state, and writes the parameters in place. The reference's
logical-sharding rules (:mod:`repro_torch.launch.sharding`) are computed
and checked, not applied: on one card every annotation is the identity,
so the train step's ``mesh_info`` and ``shape`` are checked only, and
the serve and prefill steps take the model alone.

A training forward takes the torch attention path (``kernel=False``):
the flash kernel has no backward. Serving and prefill run without a
gradient, with the kernel where its mask is the layer's.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from ..configs.base import ShapeConfig
from ..core.fabric import Fabric
from ..models.model_zoo import BaseModel
from ..optim.adamw import AdamW, AdamWState, cosine_schedule
from .sharding import logical_rules


def default_optimizer() -> AdamW:
    return AdamW(lr=cosine_schedule())


def _micro_batches(batch: Mapping, n: int):
    """``n`` contiguous slices of every array of ``batch`` on its leading
    (batch) dimension, as the reference's ``reshape(n, -1, ...)``."""
    sizes = {len(v) for v in batch.values()}
    if len(sizes) != 1 or next(iter(sizes)) % n:
        raise ValueError(f"batch sizes {sorted(sizes)} do not split into "
                         f"{n} micro-batches")
    m = next(iter(sizes)) // n
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            for i in range(n)]


def loss_and_grads(model: BaseModel, batch, accum_steps: int = 1
                   ) -> Tuple[Dict[str, torch.Tensor],
                              Dict[str, torch.Tensor]]:
    """-> (metrics ``{"loss", "ce", "aux"}`` detached, gradients by tree
    path). With ``accum_steps > 1`` the micro-batches' gradients are
    summed in float32 and divided, and the metrics averaged, as the
    reference's ``scan`` does. Turns the model's parameters trainable
    (a re-init loads new leaves, registered without a gradient)."""
    params = model.requires_grad_(True).paths()
    names, leaves = list(params), list(params.values())
    if accum_steps == 1:
        loss, metrics = model.loss(batch, kernel=False)
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        return ({k: v.detach() for k, v in metrics.items()},
                dict(zip(names, grads)))
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in leaves]
    seen = []
    for mb in _micro_batches(batch, accum_steps):
        loss, metrics = model.loss(mb, kernel=False)
        for a, g in zip(acc, torch.autograd.grad(loss, leaves,
                                                 materialize_grads=True)):
            a.add_(g)
        seen.append({k: v.detach() for k, v in metrics.items()})
    metrics = {k: torch.stack([m[k] for m in seen]).mean() for k in seen[0]}
    return metrics, {k: a / accum_steps for k, a in zip(names, acc)}


def check_shape(model: BaseModel, shape: ShapeConfig, fabric: Fabric,
                accum_steps: int = 1) -> Dict[str, object]:
    """The reference's logical rules of ``shape`` on ``fabric``
    (:func:`~repro_torch.launch.sharding.logical_rules`), once ``shape``
    is checked against them: a training shape whose batch splits into
    ``accum_steps`` micro-batches and over the rules' batch axes, and
    whose sequence splits over their sequence axes."""
    if shape.kind != "train":
        raise ValueError(f"a train step of a {shape.kind!r} shape")
    if shape.global_batch % accum_steps:
        raise ValueError(f"{shape.name}: the batch {shape.global_batch} "
                         f"does not split into {accum_steps} micro-batches")
    rules = logical_rules(model.cfg, fabric, shape)
    for what, size, axes in (
            ("batch", shape.global_batch, rules["act_batch"]),
            ("sequence", shape.seq_len, rules["act_seq"])):
        if size % fabric.axis_size(axes):
            raise ValueError(f"{shape.name}: the {what} {size} does not "
                             f"split over {axes} "
                             f"({fabric.axis_size(axes)} shards)")
    return rules


def make_train_step(model: BaseModel, opt: AdamW, mesh_info=None,
                    shape: Optional[ShapeConfig] = None,
                    accum_steps: int = 1):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``. ``params`` is
    :meth:`ParamTree.paths`' mapping: the model's own tensors, or tensors
    of the same paths (a restored checkpoint), which are copied into the
    model first; the step returns the model's own.

    ``shape`` is checked by :func:`check_shape` against the logical rules
    on the ``mesh_info``'s fabric (else one shard); the step applies
    none (on one card every sharding annotation is the identity)."""
    if mesh_info is not None and mesh_info != model.mesh_info:
        raise ValueError("mesh_info differs from the model's: the model "
                         "routes its MoE layers by its own")
    if shape is not None:
        check_shape(model, shape,
                    mesh_info.mesh if mesh_info is not None else
                    Fabric.virtual((1, 1), ("data", "model"),
                                   device=model.device), accum_steps)

    def train_step(params: Mapping[str, torch.Tensor], opt_state: AdamWState,
                   batch):
        own = model.paths()
        with torch.no_grad():
            for k, v in params.items():
                if v is not own[k]:
                    own[k].copy_(v)
        metrics, grads = loss_and_grads(model, batch, accum_steps)
        own, opt_state = opt.update(grads, opt_state, own)
        return own, opt_state, metrics

    return train_step


def make_serve_step(model: BaseModel):
    """``serve_step(cache, tokens [B, 1], pos) -> (next ids [B, 1] int32,
    cache)``: one greedy decode step."""

    @torch.no_grad()
    def serve_step(cache, tokens, pos: int):
        logits, new_cache = model.decode_step(cache, tokens, pos)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok[:, None], new_cache

    return serve_step


def make_prefill_step(model: BaseModel):
    """``prefill_step(batch) -> ids [B] int32``: the greedy id after the
    last position, from a forward with the flash kernel where its mask is
    the layer's, as serving runs it."""

    @torch.no_grad()
    def prefill_step(batch):
        logits, _ = model.forward(batch)
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)

    return prefill_step
