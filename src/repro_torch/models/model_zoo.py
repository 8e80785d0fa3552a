"""The model interface over the six families (counterpart of
``repro/models/model_zoo.py``: ``BaseModel``, ``DecoderLM`` for the
dense, MoE and VLM families, ``RWKVLM`` (ssm), ``HybridLM`` (hybrid),
``EncDecLM`` (encdec), ``build_model``).

A model is an ``nn.Module`` (:class:`~.transformer.ParamTree`) that owns
its parameters under the reference's tree paths (``embed``, ``ln_f``,
``lm_head``, ``blocks.<i>.attn.wq``, ``blocks.<i>.moe.router``,
``blocks.<i>.w_in``, ``shared_attn.attn.wq``, ``enc_blocks.<i>.mlp.wg``,
...). ``build_model`` makes it empty on its device (the card unless
``device="cpu"``); ``init(gen)`` draws random weights from a
``torch.Generator``, :func:`params_from_numpy` loads the reference's
``init`` tree instead. Parameters are float32, as the reference's;
``dtype`` is the activation type, and every op casts its weights to it.

Contracts (the reference's, with the parameters held by the model):
``forward(batch, kernel=True)`` -> (logits [B, S, padded vocab], aux [])
with ``batch`` ``{"tokens": [B, S]}`` (+ ``"patch_embeds": [B, P, D]``
and ``"positions": [B, 3, P + S]`` for the VLM, + ``"src_embeds": [B,
S_src, D]`` for the encoder-decoder), numpy or tensors; ``kernel=False``
puts every self-attention layer on the torch path (RWKV has none and
ignores it); ``decode_step(cache, tokens [B, 1], pos: int)`` -> (logits
[B, 1, V], cache), ``pos`` the absolute position of the new token.

Caches hold one entry a layer where the reference stacks them on a
layer axis:

* ``DecoderLM``: a list of :class:`~.attention.KVCache`, one a layer;
* ``RWKVLM``: a list of float32 :class:`~.rwkv6.RWKVState`, one a layer;
* ``HybridLM``: ``{"mamba": [MambaState] one a layer (float32), "kv":
  [KVCache] one an application of the shared block, max(n_attn, 1)}``;
* ``EncDecLM``: ``{"kv": [KVCache] one a layer, "cross_k": [k],
  "cross_v": [v]}``, the cross K/V ``[B, cross_len, Hkv, hd]`` one a
  decoder layer, zeros from ``init_cache`` (which ``serve`` attends over,
  as the reference's does) or :meth:`EncDecLM.precompute_cross_kv`'s.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.fabric import resolve_device
from .attention import init_kv_cache, project_cross_kv
from .common import rms_norm, softmax_cross_entropy
from .mamba2 import init_mamba_block, init_mamba_state, mamba_block
from .moe import moe_params_from_numpy
from .rwkv6 import CHUNK, init_rwkv_block, init_rwkv_state, rwkv_block
from .transformer import (ParamTree, _remat, decoder_block, embed_tokens,
                          init_decoder_block, init_embed, lm_logits,
                          run_stack, run_stack_decode)

def _positions(B: int, S: int, offset: int = 0, device=None) -> torch.Tensor:
    return (torch.arange(S, dtype=torch.int32, device=device)
            + offset).expand(B, S)


class BaseModel(ParamTree):
    family: str

    def __init__(self, cfg: ArchConfig, mesh_info=None, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.mesh_info = mesh_info
        self.dtype = dtype
        if device is None and mesh_info is not None:
            device = mesh_info.mesh.device
        self.device = resolve_device(device)

    # -- interface ------------------------------------------------------
    def init(self, gen: torch.Generator) -> "BaseModel":
        raise NotImplementedError

    def forward(self, batch, *, kernel: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def init_cache(self, batch_size: int, cache_len: int,
                   dtype=torch.bfloat16):
        raise NotImplementedError

    def decode_step(self, cache, tokens, pos: int):
        raise NotImplementedError

    def loss(self, batch, *, kernel: bool = True
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The reference's loss: next-token CE over the padded vocab plus
        0.01 of the MoE aux loss. ``kernel`` goes to :meth:`forward`: the
        training step passes ``False``, since the flash kernel has no
        backward."""
        logits, aux = self.forward(batch, kernel=kernel)
        labels = torch.as_tensor(batch["labels"], device=self.device)
        ce = softmax_cross_entropy(logits[:, :-1], labels[:, 1:]).mean()
        total = ce + 0.01 * aux
        return total, {"loss": total, "ce": ce, "aux": aux}

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _own(self, gen: torch.Generator) -> None:
        if resolve_device(gen.device) != self.device:
            raise ValueError(f"the generator is on {gen.device}, the model "
                             f"on {self.device}")

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, self.ln_f.to(x.dtype), self.cfg.norm_eps)
        return lm_logits(self, x, self.cfg)


# ---------------------------------------------------------------------------
# Decoder-only (dense / MoE / VLM)
# ---------------------------------------------------------------------------

class DecoderLM(BaseModel):
    def init(self, gen: torch.Generator) -> "DecoderLM":
        """Random weights by the reference's laws, drawn from ``gen`` on
        the model's device."""
        self._own(gen)
        self.load({**init_embed(gen, self.cfg),
                   "blocks": [init_decoder_block(gen, self.cfg)
                              for _ in range(self.cfg.num_layers)]})
        return self

    def _embed_inputs(self, batch):
        """-> (x, positions, index_positions): whether the positions are
        the indices ``0..S-1`` this model built (not the batch's)."""
        cfg = self.cfg
        tokens = self._tensor(batch["tokens"])
        tok_e = embed_tokens(self, tokens, cfg, self.dtype)
        if cfg.family == "vlm" and "patch_embeds" in batch:
            x = torch.cat([self._tensor(batch["patch_embeds"]).to(self.dtype),
                           tok_e], dim=1)
            return x, self._tensor(batch["positions"]), False   # [B,3,S]
        B, S = tokens.shape
        return tok_e, _positions(B, S, device=self.device), True

    def forward(self, batch, *, kernel: bool = True):
        """``kernel=False`` runs every attention layer on the torch path
        (``attend``) instead of the flash kernel: the training path (the
        kernel has no backward) and the tests' comparisons."""
        cfg = self.cfg
        x, positions, index = self._embed_inputs(batch)
        x, aux = run_stack(self.blocks, x, cfg, positions,
                           mesh_info=self.mesh_info, index_positions=index,
                           kernel=kernel)
        x = rms_norm(x, self.ln_f.to(x.dtype), cfg.norm_eps)
        if cfg.family == "vlm" and "patch_embeds" in batch:
            x = x[:, batch["patch_embeds"].shape[1]:]   # logits over text
        return lm_logits(self, x, cfg), aux

    def init_cache(self, batch_size, cache_len, dtype=torch.bfloat16):
        """One ring :class:`~.attention.KVCache` a layer."""
        return [init_kv_cache(self.cfg, batch_size, cache_len, dtype,
                              self.device)
                for _ in range(self.cfg.num_layers)]

    def decode_step(self, cache, tokens, pos: int):
        cfg = self.cfg
        tokens = self._tensor(tokens)
        B = tokens.shape[0]
        x = embed_tokens(self, tokens, cfg, self.dtype)
        shape = (B, 3, 1) if cfg.mrope else (B, 1)
        positions = torch.full(shape, pos, dtype=torch.int32,
                               device=self.device)
        x, new_cache = run_stack_decode(self.blocks, x, cfg, positions,
                                        cache, pos, mesh_info=self.mesh_info)
        return self._head(x), new_cache


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------

class RWKVLM(BaseModel):
    def init(self, gen: torch.Generator) -> "RWKVLM":
        self._own(gen)
        self.load({**init_embed(gen, self.cfg),
                   "blocks": [init_rwkv_block(gen, self.cfg)
                              for _ in range(self.cfg.num_layers)]})
        return self

    def _run(self, x, states, impl: str):
        body = _remat(rwkv_block, self.cfg)
        new_states = []
        for layer, state in zip(self.blocks, states):
            x, ns = body(layer, x, self.cfg, state, impl=impl)
            new_states.append(ns)
        return x, new_states

    def forward(self, batch, *, kernel: bool = True):
        """``kernel`` is the interface's: RWKV has no attention, so no
        kernel runs either way."""
        tokens = self._tensor(batch["tokens"])
        B, S = tokens.shape
        x = embed_tokens(self, tokens, self.cfg, self.dtype)
        impl = "chunked" if S % CHUNK == 0 and S > CHUNK else "scan"
        x, _ = self._run(x, self.init_cache(B, 0), impl)
        return self._head(x), torch.zeros((), device=self.device)

    def init_cache(self, batch_size, cache_len, dtype=torch.float32):
        """One float32 :class:`~.rwkv6.RWKVState` a layer; the state has
        no length, and is float32 whatever ``dtype``, as the reference's."""
        return [init_rwkv_state(self.cfg, batch_size, torch.float32,
                                self.device)
                for _ in range(self.cfg.num_layers)]

    def decode_step(self, cache, tokens, pos: int):
        x = embed_tokens(self, self._tensor(tokens), self.cfg, self.dtype)
        x, new_states = self._run(x, cache, "scan")
        return self._head(x), new_states


# ---------------------------------------------------------------------------
# Zamba2-style hybrid: Mamba2 stack + one weight-shared attention block
# ---------------------------------------------------------------------------

def _mamba_layer(params, x, cfg: ArchConfig, state, impl: str):
    out, new_state = mamba_block(params, x, cfg, state, impl=impl)
    return x + out, new_state


class HybridLM(BaseModel):
    """Mamba2 layers; after every full segment of ``hybrid_attn_period``
    layers the SHARED attention+MLP block is applied (one set of weights,
    ``shared_attn``; each application has its own KV cache). The shared
    block is rematerialised by a plain checkpoint whenever ``remat`` is
    not ``none`` (the reference's ``jax.checkpoint``, under ``dots``
    too); the Mamba layers by ``remat``."""

    def _segments(self):
        p = self.cfg.hybrid_attn_period
        full, rem = divmod(self.cfg.num_layers, p)
        return [p] * full + ([rem] if rem else []), full

    def init(self, gen: torch.Generator) -> "HybridLM":
        self._own(gen)
        self.load({**init_embed(gen, self.cfg),
                   "blocks": [init_mamba_block(gen, self.cfg)
                              for _ in range(self.cfg.num_layers)],
                   "shared_attn": init_decoder_block(gen, self.cfg)})
        return self

    def forward(self, batch, *, kernel: bool = True):
        cfg = self.cfg
        tokens = self._tensor(batch["tokens"])
        B, S = tokens.shape
        x = embed_tokens(self, tokens, cfg, self.dtype)
        positions = _positions(B, S, device=self.device)
        chunk = cfg.ssm.chunk_size
        impl = "chunked" if S % chunk == 0 and S > chunk else "scan"
        body = _remat(_mamba_layer, cfg)
        attn = _remat(decoder_block, dataclasses.replace(
            cfg, remat="none" if cfg.remat == "none" else "block"))
        segs, _ = self._segments()
        start = 0
        for seg in segs:
            for layer in self.blocks[start:start + seg]:
                state = init_mamba_state(cfg, B, torch.float32, self.device)
                x, _ = body(layer, x, cfg, state, impl)
            if seg == cfg.hybrid_attn_period:
                x, _, _ = attn(self.shared_attn, x, cfg, positions,
                               mesh_info=self.mesh_info,
                               index_positions=True, kernel=kernel)
            start += seg
        return self._head(x), torch.zeros((), device=self.device)

    def init_cache(self, batch_size, cache_len, dtype=torch.bfloat16):
        cfg = self.cfg
        _, n_attn = self._segments()
        return {"mamba": [init_mamba_state(cfg, batch_size, torch.float32,
                                           self.device)
                          for _ in range(cfg.num_layers)],
                "kv": [init_kv_cache(cfg, batch_size, cache_len, dtype,
                                     self.device)
                       for _ in range(max(n_attn, 1))]}

    def decode_step(self, cache, tokens, pos: int):
        cfg = self.cfg
        tokens = self._tensor(tokens)
        x = embed_tokens(self, tokens, cfg, self.dtype)
        positions = torch.full((tokens.shape[0], 1), pos, dtype=torch.int32,
                               device=self.device)
        segs, _ = self._segments()
        start = 0
        new_mamba, new_kv = [], []
        for seg in segs:
            for li in range(start, start + seg):
                out, ns = mamba_block(self.blocks[li], x, cfg,
                                      cache["mamba"][li], impl="scan")
                x = x + out
                new_mamba.append(ns)
            if seg == cfg.hybrid_attn_period:
                x, nkv, _ = decoder_block(
                    self.shared_attn, x, cfg, positions,
                    cache=cache["kv"][len(new_kv)], cache_pos=pos,
                    mesh_info=self.mesh_info)
                new_kv.append(nkv)
            start += seg
        return self._head(x), {"mamba": new_mamba,
                               "kv": new_kv if new_kv else cache["kv"]}


# ---------------------------------------------------------------------------
# Encoder-decoder (seamless backbone)
# ---------------------------------------------------------------------------

class EncDecLM(BaseModel):
    """A non-causal encoder stack over ``src_embeds`` (a stub frontend's
    frames) and a decoder stack with cross-attention over its output.
    Self-attention runs on the flash kernel where its mask is the
    layer's (the encoder's full mask, the decoder's causal one);
    cross-attention on the torch ``attend``."""

    def init(self, gen: torch.Generator) -> "EncDecLM":
        self._own(gen)
        cfg = self.cfg
        self.load({**init_embed(gen, cfg),
                   "enc_blocks": [init_decoder_block(gen, cfg)
                                  for _ in range(cfg.encoder_layers)],
                   "blocks": [init_decoder_block(gen, cfg, cross=True)
                              for _ in range(cfg.num_layers)]})
        return self

    def encode(self, src_embeds, *, kernel: bool = True) -> torch.Tensor:
        src = self._tensor(src_embeds).to(self.dtype)
        B, S = src.shape[:2]
        x, _ = run_stack(self.enc_blocks, src, self.cfg,
                         _positions(B, S, device=self.device), causal=False,
                         mesh_info=self.mesh_info, index_positions=True,
                         kernel=kernel)
        return x

    def forward(self, batch, *, kernel: bool = True):
        cfg = self.cfg
        enc_out = self.encode(batch["src_embeds"], kernel=kernel)
        tokens = self._tensor(batch["tokens"])
        B, S = tokens.shape
        x = embed_tokens(self, tokens, cfg, self.dtype)
        x, aux = run_stack(self.blocks, x, cfg,
                           _positions(B, S, device=self.device),
                           enc_out=enc_out, mesh_info=self.mesh_info,
                           index_positions=True, kernel=kernel)
        return self._head(x), aux

    def precompute_cross_kv(self, enc_out):
        """-> (cross_k, cross_v): each a list of [B, S_src, Hkv, hd], one a
        decoder layer (the cache's ``"cross_k"`` / ``"cross_v"``)."""
        kv = [project_cross_kv(layer["xattn"], enc_out, self.cfg)
              for layer in self.blocks]
        return [k for k, _ in kv], [v for _, v in kv]

    def init_cache(self, batch_size, cache_len, dtype=torch.bfloat16,
                   cross_len: int = 4096):
        """Self-attention caches, and zero cross K/V of ``cross_len``
        positions (one zero tensor, read by every layer, as the reference
        hands one array to both)."""
        cfg = self.cfg
        zeros = torch.zeros((batch_size, cross_len, cfg.num_kv_heads,
                             cfg.resolved_head_dim), dtype=dtype,
                            device=self.device)
        return {"kv": [init_kv_cache(cfg, batch_size, cache_len, dtype,
                                     self.device)
                       for _ in range(cfg.num_layers)],
                "cross_k": [zeros] * cfg.num_layers,
                "cross_v": [zeros] * cfg.num_layers}

    def decode_step(self, cache, tokens, pos: int):
        cfg = self.cfg
        tokens = self._tensor(tokens)
        x = embed_tokens(self, tokens, cfg, self.dtype)
        positions = torch.full((tokens.shape[0], 1), pos, dtype=torch.int32,
                               device=self.device)
        x, new_kv = run_stack_decode(
            self.blocks, x, cfg, positions, cache["kv"], pos,
            enc_kv=list(zip(cache["cross_k"], cache["cross_v"])),
            mesh_info=self.mesh_info)
        return self._head(x), {"kv": new_kv, "cross_k": cache["cross_k"],
                               "cross_v": cache["cross_v"]}


# ---------------------------------------------------------------------------

_FAMILIES = {
    "dense": DecoderLM,
    "moe": DecoderLM,
    "vlm": DecoderLM,
    "ssm": RWKVLM,
    "hybrid": HybridLM,
    "encdec": EncDecLM,
}
#: the subtrees that the reference stacks on a leading layer axis, and
#: the config field that counts their layers
STACKED = {"blocks": "num_layers", "enc_blocks": "encoder_layers"}


def build_model(cfg: ArchConfig, mesh_info=None, dtype=torch.float32,
                device=None) -> BaseModel:
    """The family's model, empty, on ``device`` (default: the MoE
    fabric's device if a ``mesh_info`` is given, else the card); fill it
    with ``init(gen)`` or :func:`params_from_numpy`."""
    if cfg.family not in _FAMILIES:
        raise KeyError(f"unknown family {cfg.family!r} ({cfg.name}); known: "
                       f"{sorted(_FAMILIES)}")
    return _FAMILIES[cfg.family](cfg, mesh_info=mesh_info, dtype=dtype,
                                 device=device)


def params_from_numpy(model: BaseModel, tree: Mapping[str, Any]
                      ) -> BaseModel:
    """Load the reference's ``init`` tree (numpy arrays; ``blocks`` and
    ``enc_blocks`` stacked on a leading layer axis, ``shared_attn`` and
    the embedding not) into ``model`` on its device, values and types
    kept; a ``moe`` subtree goes through
    :func:`~.moe.moe_params_from_numpy`."""
    dev = model.device

    def tensor(a):
        return torch.from_numpy(np.array(a)).to(dev)

    def subtree(sub, i=None):
        """``sub`` as tensors; layer ``i`` of it if it is stacked."""
        def pick(a):
            return a if i is None else a[i]
        out = {}
        for k, v in sub.items():
            if k == "moe":
                out[k] = moe_params_from_numpy(
                    {n: pick(w) for n, w in v.items()}, dev)
            elif isinstance(v, Mapping):
                out[k] = subtree(v, i)
            else:
                out[k] = tensor(pick(v))
        return out

    def layers(name, sub):
        leaf = sub
        while isinstance(leaf, Mapping):
            leaf = next(iter(leaf.values()))
        n, want = len(leaf), getattr(model.cfg, STACKED[name])
        if n != want:
            raise ValueError(f"the tree has {n} layers in {name}, "
                             f"{model.cfg.name} {want}")
        return [subtree(sub, i) for i in range(n)]
    model.load({k: layers(k, v) if k in STACKED
                else subtree(v) if isinstance(v, Mapping) else tensor(v)
                for k, v in tree.items()})
    return model
