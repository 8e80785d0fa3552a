"""Sharding rules: parameters (TP + FSDP + EP), activations (logical
rules), batches and decode caches, per architecture and fabric
(counterpart of ``repro/launch/sharding.py:19-218``).

A spec is a plain tuple with one entry a dimension: ``None``, an axis
name or a tuple of axis names (the reference's ``PartitionSpec``), as
:meth:`~repro_torch.core.fabric.Fabric.shard` takes it. Every entry is
divisibility-checked against the fabric, with replication as the
fallback, so any (arch x shape x fabric) cell gets a layout.

The reference stacks the layers on a leading axis (``blocks/attn/wq [L,
D, H, hd]``, its cache ``[L, B, C, H, hd]``); the port keeps one
subtree a layer (``blocks/3/attn/wq [D, H, hd]``) and one cache entry a
layer (``KVCache.k [B, C, H, hd]``). So the port's spec of a leaf is the
reference's with the leading layer entry dropped: the rules below are
the reference's with every absolute dimension of a stacked leaf moved
down by one. The tensors stay on one card; the tables describe the
layout the contract fabrics would give them (see
:mod:`repro_torch.launch.dryrun`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from ..configs.base import ArchConfig, ShapeConfig
from ..core.fabric import Fabric
from .mesh import batch_axes, model_axes

#: one dimension's entry: no axis, an axis name, or a tuple of names
Spec = Tuple[Any, ...]

VLM_PATCH_TOKENS = 256
ENCDEC_CROSS_LEN = 4096


def best_spec(fabric: Fabric, shape, prefs) -> Spec:
    """Greedy dim->axes assignment honoring divisibility & axis exclusivity.

    prefs: [(dim, axes), ...] in priority order; axes str or tuple.
    """
    spec = [None] * len(shape)
    used = set()
    for dim, axes in prefs:
        if dim >= len(shape) or spec[dim] is not None:
            continue
        ax = (axes,) if isinstance(axes, str) else tuple(axes)
        if any(a not in fabric.axis_names for a in ax):
            continue
        if any(a in used for a in ax):
            continue
        if shape[dim] % fabric.axis_size(ax) == 0 and shape[dim] > 0:
            spec[dim] = axes if isinstance(axes, str) else tuple(axes)
            used.update(ax)
    return tuple(spec)


def _one(axes: tuple):
    """A one-axis group as its name, a larger one as the tuple."""
    return axes[0] if len(axes) == 1 else tuple(axes)


# ---------------------------------------------------------------------------
# Activation logical rules
# ---------------------------------------------------------------------------

def logical_rules(cfg: ArchConfig, fabric: Fabric,
                  shape: Optional[ShapeConfig] = None) -> Dict[str, object]:
    mdl = _one(model_axes(fabric))
    bat = _one(batch_axes(fabric))
    seq_ax = mdl if (shape is None or not shape.is_decode) else None
    if cfg.family in ("ssm", "hybrid"):
        # recurrent time scans are sequential: keep seq local; heads and
        # channels carry the model axes
        seq_ax = None
    if shape is not None and shape.global_batch < fabric.axis_size(
            bat if isinstance(bat, tuple) else (bat,)):
        bat = None  # tiny-batch decode: replicate batch
    return {
        "act_batch": bat,
        "act_seq": seq_ax,           # SP: sequence over the model axes
        "act_seq_inner": None,       # inner tensors shard ff/heads instead
        "act_embed": None,
        "act_ff": mdl,
        "act_heads": mdl,
        "act_kv": None,
        "act_vocab": mdl,   # logits vocab-sharded (seq gathered at the head)
        "act_group": bat,
        "act_expert": "expert" if "expert" in fabric.axis_names else None,
    }


# ---------------------------------------------------------------------------
# Parameter shardings
# ---------------------------------------------------------------------------

def _param_prefs(name: str, shape: Tuple[int, ...], cfg: ArchConfig,
                 fabric: Fabric):
    """Priority list of (dim, axes) for one leaf of one layer (or an
    unstacked leaf). Dims are absolute in the leaf's own shape: the
    reference's for a stacked leaf, less one."""
    mdl = _one(model_axes(fabric))
    nd = len(shape)
    last, prev = nd - 1, nd - 2

    if name in ("wg", "wu", "wd") and nd == 3 and cfg.moe is not None:
        # expert weights [E, D, F] or [E, F, D]
        if name == "wd":
            return [(0, "expert"), (1, "tp"), (2, "data")]
        return [(0, "expert"), (2, "tp"), (1, "data")]
    if name == "router":
        return []
    if name in ("embed", "lm_head"):
        return [(0, mdl), (1, "data")]
    if name == "wq":     # [D, H, hd]
        return [(prev, mdl), (0, "data")]
    if name in ("wk", "wv"):
        prefs = [(prev, mdl)]
        if "expert" in fabric.axis_names:
            prefs.append((prev, "expert"))
        prefs.append((0, "data"))
        return prefs
    if name == "wo":     # [F_in, D]
        return [(prev, mdl), (last, "data")]
    if name in ("wg", "wu", "ck"):   # dense [D, F]
        return [(last, mdl), (prev, "data")]
    if name in ("wd", "cv"):         # dense [F, D]
        return [(prev, mdl), (last, "data")]
    if name in ("wr", "cr", "w_in"):  # [D, X]
        return [(last, mdl), (prev, "data")]
    if name == "w_out":
        return [(prev, mdl), (last, "data")]
    if name == "conv_w":             # [W, C]
        return [(last, mdl)]
    if name == "bq":                 # [H, hd]
        return [(prev, mdl)]
    return []


def param_spec(path: str, shape, cfg: ArchConfig, fabric: Fabric,
               fsdp: bool = True) -> Spec:
    """The spec of the parameter at ``path`` (``blocks/3/attn/wq``).
    ``fsdp=False`` drops the 'data'-axis sharding (weights resident,
    replicated across data: the serving configuration)."""
    prefs = _param_prefs(path.rsplit("/", 1)[-1], tuple(shape), cfg, fabric)
    if not fsdp:
        prefs = [(d, a) for d, a in prefs if a != "data"]
    return best_spec(fabric, tuple(shape), prefs)


def param_shardings(cfg: ArchConfig, fabric: Fabric,
                    params: Mapping[str, torch.Tensor], fsdp: bool = True
                    ) -> Dict[str, Spec]:
    """``params``: the model's parameters by tree path
    (:meth:`~repro_torch.models.transformer.ParamTree.paths`, on any
    device, meta included) -> their specs by the same paths."""
    return {k: param_spec(k, v.shape, cfg, fabric, fsdp)
            for k, v in params.items()}


# ---------------------------------------------------------------------------
# Batch specs per (arch x shape)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Struct:
    """A tensor's shape, type and spec, no storage (the reference's
    sharded ``ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    spec: Spec

    def meta(self) -> torch.Tensor:
        """An empty tensor of this shape and type on the meta device."""
        return torch.empty(self.shape, dtype=self.dtype, device="meta")


def batch_struct(cfg: ArchConfig, shape: ShapeConfig, fabric: Fabric
                 ) -> Dict[str, Struct]:
    """The training / prefill batch's shapes, types and specs."""
    B, S = shape.global_batch, shape.seq_len
    bat = _one(batch_axes(fabric))
    mdl = _one(model_axes(fabric))

    def tok(b, s, extra_dim=None):
        shp = (b, s) if extra_dim is None else (b, extra_dim, s)
        prefs = [(0, bat), (len(shp) - 1, mdl)]
        return Struct(shp, torch.int32, best_spec(fabric, shp, prefs))

    def emb(b, s, d):
        shp = (b, s, d)
        prefs = [(0, bat), (1, mdl)]
        return Struct(shp, torch.float32, best_spec(fabric, shp, prefs))

    if cfg.family == "encdec":
        s_src = min(S // 2, ENCDEC_CROSS_LEN)
        s_tgt = S - s_src
        return {"src_embeds": emb(B, s_src, cfg.d_model),
                "tokens": tok(B, s_tgt), "labels": tok(B, s_tgt)}
    if cfg.family == "vlm":
        s_txt = S - VLM_PATCH_TOKENS
        return {"tokens": tok(B, s_txt), "labels": tok(B, s_txt),
                "patch_embeds": emb(B, VLM_PATCH_TOKENS, cfg.d_model),
                "positions": tok(B, S, extra_dim=3)}
    return {"tokens": tok(B, S), "labels": tok(B, S)}


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------

def _leaf_names(path: Tuple[str, ...]) -> Tuple[str, ...]:
    return tuple(p for p in path if not p.isdigit())


def cache_leaf_spec(names: Tuple[str, ...], shp: Tuple[int, ...],
                    cfg: ArchConfig, shape: ShapeConfig,
                    fabric: Fabric) -> Spec:
    """The spec of one layer's cache leaf of shape ``shp`` reached by the
    field names ``names`` (``("kv", "k")``, ``("h",)``): the reference's
    rule on the stacked leaf, every dimension one lower."""
    bat_t = tuple(batch_axes(fabric))
    mdl = _one(model_axes(fabric))
    batch_ok = shape.global_batch % fabric.axis_size(bat_t) == 0
    nd = len(shp)
    if nd <= 0:
        return ()
    prefs = []
    if batch_ok:
        prefs.append((0, _one(bat_t)))
    if any("k" == n or "v" == n or "cross" in n for n in names) and nd >= 3:
        # [B, C, H, hd]: heads over model/expert; else seq over data
        prefs.append((2, mdl))
        if "expert" in fabric.axis_names:
            prefs.append((2, "expert"))
        prefs.append((1, "data"))
        prefs.append((1, _one(bat_t)))
    elif nd >= 2:
        # recurrent states [B, H, ...] / conv [B, W, C]
        prefs.append((1, mdl))
        prefs.append((nd - 1, mdl))
    return best_spec(fabric, shp, prefs)


def _map_cache(fn, tree, path=()):
    """``tree``'s structure (lists, dicts, named tuples) with every leaf
    ``x`` replaced by ``fn(path, x)``."""
    if isinstance(tree, Mapping):
        return {k: _map_cache(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_cache(fn, getattr(tree, f), path + (f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_cache(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def cache_shardings(cfg: ArchConfig, shape: ShapeConfig, fabric: Fabric,
                    cache):
    """Specs of a decode cache (``model.init_cache``'s structure, on any
    device, meta included), in the same structure. A leaf that is no
    tensor (a ``KVCache``'s written length) replicates: ``()``."""
    def leaf(path, x):
        shp = tuple(x.shape) if isinstance(x, torch.Tensor) else ()
        return cache_leaf_spec(_leaf_names(path), shp, cfg, shape, fabric)
    return _map_cache(leaf, cache)


def shard_bytes(spec: Spec, shp, itemsize: int, fabric: Fabric) -> int:
    """The bytes one shard holds of a tensor of shape ``shp`` under
    ``spec``."""
    n = itemsize
    for d, size in enumerate(shp):
        a = spec[d] if d < len(spec) else None
        n *= size // fabric.axis_size(a)
    return n
