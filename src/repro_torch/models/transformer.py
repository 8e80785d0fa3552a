"""Decoder blocks, embedding and head, and the layer-stack runners
(counterpart of ``repro/models/transformer.py``, the attention family).

Parameters live in a :class:`ParamTree`, an ``nn.Module`` whose leaves
are registered under the reference's tree paths (``blocks.<i>.attn.wq``,
``blocks.<i>.moe.router``, ...) and read like the reference's dicts
(``params["attn"]``, ``"bq" in params``, ``params.get("lm_head", ...)``).
The reference stacks the blocks on a leading layer axis and may scan
them; here they are one tree a layer and the loop is in Python. The
leaves are registered without a gradient (serving needs none); training
turns them on (``model.requires_grad_(True)``, as
``launch/steps.py::loss_and_grads`` does).

Rematerialisation (:func:`_remat`) wraps each block by ``cfg.remat`` as
the reference's ``jax.checkpoint`` does: ``block``/``full`` keep only the
block's inputs and recompute it in the backward pass, ``dots`` also keeps
the outputs of its matrix products. With no gradient it is the plain
call.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ArchConfig
from .attention import KVCache, attention_block, init_attention
from .common import embed_init, rms_norm
from .mlp import init_mlp, mlp_block
from .moe import init_moe, moe_block


class ParamTree(torch.nn.Module):
    """A nested mapping of tensors as an ``nn.Module``: a mapping becomes
    a submodule, a list a ``ModuleList`` of them, a tensor a parameter
    (registered without a gradient; training turns it on), under the
    mapping's keys. The tensors are registered as they are, not
    copied."""

    def __init__(self, tree: Optional[Mapping[str, Any]] = None):
        super().__init__()
        self.load(tree or {})

    def load(self, tree: Mapping[str, Any]) -> None:
        """Register ``tree``'s leaves, replacing those of the same name."""
        for name, value in tree.items():
            if isinstance(value, Mapping):
                self.add_module(name, ParamTree(value))
            elif isinstance(value, (list, tuple)):
                self.add_module(name, torch.nn.ModuleList(
                    ParamTree(v) for v in value))
            else:
                self.register_parameter(
                    name, torch.nn.Parameter(value, requires_grad=False))

    def __getitem__(self, name: str):
        if name in self._parameters:
            return self._parameters[name]
        if name in self._modules:
            return self._modules[name]
        raise KeyError(name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def get(self, name: str, default=None):
        return self[name] if name in self else default

    def paths(self) -> Dict[str, torch.nn.Parameter]:
        """The parameters keyed by their ``/``-joined tree paths
        (``blocks/3/attn/wq``): the mapping the optimiser and the
        checkpoints take."""
        return {name.replace(".", "/"): p
                for name, p in self.named_parameters()}

    def tree(self) -> Dict[str, Any]:
        """The nested mapping back, the same tensors."""
        out: Dict[str, Any] = {k: p.data for k, p in self._parameters.items()}
        for k, m in self._modules.items():
            out[k] = (m.tree() if isinstance(m, ParamTree)
                      else [b.tree() for b in m])
        return out


# ---------------------------------------------------------------------------
# Attention-family decoder block
# ---------------------------------------------------------------------------

def init_decoder_block(gen: torch.Generator, cfg: ArchConfig,
                       cross: bool = False) -> Dict[str, Any]:
    dev = gen.device
    p: Dict[str, Any] = {
        "ln1": torch.ones(cfg.d_model, device=dev),
        "ln2": torch.ones(cfg.d_model, device=dev),
        "attn": init_attention(gen, cfg),
    }
    if cross:
        p["ln_x"] = torch.ones(cfg.d_model, device=dev)
        p["xattn"] = init_attention(gen, cfg)
    if cfg.moe is not None:
        p["moe"] = init_moe(gen, cfg)
    else:
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff)
    return p


def decoder_block(params, x, cfg: ArchConfig, positions, *,
                  causal: bool = True,
                  cache: Optional[KVCache] = None,
                  cache_pos=None,
                  enc_out: Optional[torch.Tensor] = None,
                  enc_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                  mesh_info=None,
                  index_positions: bool = False,
                  kernel: bool = True):
    """-> (x, new_cache, aux_loss)."""
    h = rms_norm(x, params["ln1"].to(x.dtype), cfg.norm_eps)
    attn_out, new_cache = attention_block(
        params["attn"], h, cfg, positions, causal=causal, cache=cache,
        cache_pos=cache_pos, index_positions=index_positions, kernel=kernel)
    x = x + attn_out
    if enc_out is not None or enc_kv is not None:
        h = rms_norm(x, params["ln_x"].to(x.dtype), cfg.norm_eps)
        xo, _ = attention_block(params["xattn"], h, cfg, positions,
                                causal=False, kv_source=enc_out,
                                kv_precomputed=enc_kv)
        x = x + xo
    h = rms_norm(x, params["ln2"].to(x.dtype), cfg.norm_eps)
    if cfg.moe is not None:
        out, aux = moe_block(params["moe"], h, cfg, mesh_info)
    else:
        out = mlp_block(params["mlp"], h)
        aux = torch.zeros((), device=x.device)
    return x + out, new_cache, aux


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

VOCAB_PAD = 128  # the reference pads the vocab so it shards over any axis


def padded_vocab(vocab_size: int) -> int:
    return -(-vocab_size // VOCAB_PAD) * VOCAB_PAD


def init_embed(gen: torch.Generator, cfg: ArchConfig) -> Dict[str, Any]:
    vp = padded_vocab(cfg.vocab_size)
    p = {"embed": embed_init(gen, vp, cfg.d_model),
         "ln_f": torch.ones(cfg.d_model, device=gen.device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = embed_init(gen, vp, cfg.d_model)
    return p


def embed_tokens(params, tokens, cfg: ArchConfig, dtype=torch.float32):
    """The rows of ``embed`` for ``tokens``. Through ``embedding``, whose
    gradient adds a token's rows in one order on every run; advanced
    indexing's gradient is an accumulating put, whose adds race (on the
    CPU's threads too)."""
    return torch.nn.functional.embedding(tokens.long(),
                                         params["embed"]).to(dtype)


def lm_logits(params, x, cfg: ArchConfig):
    """x [B, S, D] -> logits [B, S, padded vocab] in x's type."""
    head = params.get("lm_head", params["embed"])
    return torch.matmul(x, head.to(x.dtype).t())


# ---------------------------------------------------------------------------
# Layer-stack runners
# ---------------------------------------------------------------------------

#: the matrix products whose outputs ``remat="dots"`` keeps (the aten
#: ops ``torch.matmul`` and ``einsum`` reach), as
#: ``jax.checkpoint_policies.checkpoint_dots`` keeps ``dot_general``'s
DOT_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn: Callable, cfg: ArchConfig) -> Callable:
    """``fn`` rematerialised by ``cfg.remat``: ``none`` the plain call,
    ``block``/``full`` a checkpoint of the whole call, ``dots`` a
    selective one that keeps the matrix products' outputs. Without a
    gradient the plain call."""
    if cfg.remat == "none":
        return fn
    context = (functools.partial(create_selective_checkpoint_contexts,
                                 _save_dots)
               if cfg.remat == "dots" else None)

    def rematerialised(*args, **kwargs):
        if not torch.is_grad_enabled():
            return fn(*args, **kwargs)
        if context is None:
            return checkpoint(fn, *args, use_reentrant=False, **kwargs)
        return checkpoint(fn, *args, use_reentrant=False, context_fn=context,
                          **kwargs)
    return rematerialised


def run_stack(blocks, x, cfg: ArchConfig, positions, *, causal=True,
              enc_out=None, mesh_info=None, index_positions: bool = False,
              kernel: bool = True):
    """Run all layers (train/prefill): ``blocks`` one tree a layer, each
    block rematerialised by ``cfg.remat``."""
    body = _remat(decoder_block, cfg)
    aux_total = torch.zeros((), device=x.device)
    for layer in blocks:
        x, _, aux = body(layer, x, cfg, positions, causal=causal,
                         enc_out=enc_out, mesh_info=mesh_info,
                         index_positions=index_positions, kernel=kernel)
        aux_total = aux_total + aux
    return x, aux_total


def run_stack_decode(blocks, x, cfg: ArchConfig, positions,
                     caches: List[KVCache], cache_pos, *, enc_kv=None,
                     mesh_info=None):
    """One decode step through all layers: ``caches`` one
    :class:`KVCache` a layer; ``enc_kv`` (optional) one precomputed cross
    K/V pair a layer."""
    new_caches = []
    for i, layer in enumerate(blocks):
        x, nc, _ = decoder_block(
            layer, x, cfg, positions, cache=caches[i], cache_pos=cache_pos,
            enc_kv=enc_kv[i] if enc_kv is not None else None,
            mesh_info=mesh_info)
        new_caches.append(nc)
    return x, new_caches
