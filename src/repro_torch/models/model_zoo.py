"""The model interface over the decoder-LM families (counterpart of
``repro/models/model_zoo.py``: ``BaseModel``, ``DecoderLM``,
``build_model``).

A model is an ``nn.Module`` (:class:`~.transformer.ParamTree`) that owns
its parameters under the reference's tree paths (``embed``, ``ln_f``,
``lm_head``, ``blocks.<i>.attn.wq``, ``blocks.<i>.moe.router``, ...).
``build_model`` makes it empty on its device (the card unless
``device="cpu"``); ``init(gen)`` draws random weights from a
``torch.Generator``, :func:`params_from_numpy` loads the reference's
``DecoderLM.init`` tree instead. Parameters are float32, as the
reference's; ``dtype`` is the activation type, and every op casts its
weights to it.

Contracts (the reference's, with the parameters held by the model):
``forward(batch)`` -> (logits [B, S, padded vocab], aux []) with
``batch`` ``{"tokens": [B, S]}`` (+ ``"patch_embeds": [B, P, D]`` and
``"positions": [B, 3, P + S]`` for the VLM), numpy or tensors;
``decode_step(cache, tokens [B, 1], pos: int)`` -> (logits [B, 1, V],
cache), ``pos`` the absolute position of the new token.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.fabric import resolve_device
from .attention import init_kv_cache
from .common import rms_norm, softmax_cross_entropy
from .moe import moe_params_from_numpy
from .transformer import (ParamTree, embed_tokens, init_decoder_block,
                          init_embed, lm_logits, run_stack, run_stack_decode)

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


# ---------------------------------------------------------------------------
# Decoder-only (dense / MoE / VLM)
# ---------------------------------------------------------------------------

class DecoderLM(BaseModel):
    def init(self, gen: torch.Generator) -> "DecoderLM":
        """Random weights by the reference's laws, drawn from ``gen`` on
        the model's device."""
        if resolve_device(gen.device) != self.device:
            raise ValueError(f"the generator is on {gen.device}, the model "
                             f"on {self.device}")
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
        x = rms_norm(x, self.ln_f.to(x.dtype), cfg.norm_eps)
        return lm_logits(self, x, cfg), new_cache


# ---------------------------------------------------------------------------

_FAMILIES = {
    "dense": DecoderLM,
    "moe": DecoderLM,
    "vlm": DecoderLM,
}


def build_model(cfg: ArchConfig, mesh_info=None, dtype=torch.float32,
                device=None) -> BaseModel:
    """The family's model, empty, on ``device`` (default: the MoE
    fabric's device if a ``mesh_info`` is given, else the card); fill it
    with ``init(gen)`` or :func:`params_from_numpy`."""
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet "
            f"(ROADMAP.md queue 1, item 5b)")
    return _FAMILIES[cfg.family](cfg, mesh_info=mesh_info, dtype=dtype,
                                 device=device)


def params_from_numpy(model: BaseModel, tree: Mapping[str, Any]
                      ) -> BaseModel:
    """Load the reference's ``DecoderLM.init`` tree (numpy arrays,
    ``blocks`` stacked on a leading layer axis) into ``model`` on its
    device, values and types kept; the ``moe`` subtree goes through
    :func:`~.moe.moe_params_from_numpy`."""
    dev = model.device

    def tensor(a):
        return torch.from_numpy(np.array(a)).to(dev)

    def layer(sub, i):
        out = {}
        for k, v in sub.items():
            if k == "moe":
                out[k] = moe_params_from_numpy({n: w[i] for n, w in v.items()},
                                               dev)
            elif isinstance(v, Mapping):
                out[k] = layer(v, i)
            else:
                out[k] = tensor(v[i])
        return out
    blocks = tree["blocks"]
    n = len(blocks["ln1"])
    if n != model.cfg.num_layers:
        raise ValueError(f"the tree has {n} layers, {model.cfg.name} "
                         f"{model.cfg.num_layers}")
    model.load({**{k: tensor(v) for k, v in tree.items() if k != "blocks"},
                "blocks": [layer(blocks, i) for i in range(n)]})
    return model
