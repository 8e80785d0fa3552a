"""Fabric-agnostic checkpointing with atomic writes and elastic restore
(counterpart of ``repro/checkpoint/checkpoint.py:25-97``), in the
reference's on-disk format:

* ``<dir>/step_XXXXXXXX/`` holds one ``.npy`` file a leaf, named from
  its ``/``-joined tree path (mapping keys in sorted order, sequence
  indices, named-tuple fields), and ``manifest.json`` of ``{"step",
  "keys": [{key, file, dtype, shape}]}``: no pickle, portable;
* writes go to ``step_XXXXXXXX.tmp`` and are published with
  ``os.replace``, so a crash leaves the last checkpoint whole;
* ``keep`` evicts the oldest;
* :func:`restore` loads into the structure of a target tree, each leaf
  on the target leaf's device and in its type, or laid out by a
  :class:`~repro_torch.runtime.elastic.Sharding` (a checkpoint from N
  shards restores onto M).

A bf16 leaf is written byte for byte as the reference writes one
(``ml_dtypes``' bfloat16, which numpy stores as raw ``<V2`` records)
under the manifest dtype ``"bfloat16"``, with no ``ml_dtypes`` here:
the header by hand, then the 16-bit words. So either package restores
the other's.

A model's tree (``model.tree()``, or its parameters by
:meth:`~repro_torch.models.transformer.ParamTree.paths`) has one subtree
a layer (``blocks/3/attn/wq``) where the reference's stacks the layers
(``blocks/attn/wq [L, ...]``).
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from ..runtime.elastic import ShardedArray, Sharding, place

#: the ``.npy`` type of a bf16 array as numpy writes ``ml_dtypes``'
#: bfloat16: a raw 2-byte record
BF16_DESCR = "<V2"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _map(fn: Callable[[str, Any], Any], tree: Any, prefix: str = ""):
    """``fn(path, leaf)`` over the leaves of ``tree`` (mappings, lists,
    tuples, named tuples; ``None`` is an empty subtree), in the
    reference's flattening order; the same structure back."""
    def sub(key):
        return f"{prefix}/{key}" if prefix else str(key)
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {k: _map(fn, tree[k], sub(k)) for k in sorted(tree.keys())}
    if _is_namedtuple(tree):
        return type(tree)(*(_map(fn, getattr(tree, f), sub(f))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, sub(i)) for i, v in enumerate(tree))
    return fn(prefix, tree)


def _flatten(tree: Any) -> Dict[str, Any]:
    flat: Dict[str, Any] = {}
    _map(lambda key, leaf: flat.__setitem__(key, leaf), tree)
    return flat


def _write_leaf(path: str, leaf) -> Dict[str, Any]:
    """Write one leaf (a tensor, or a :class:`ShardedArray`'s global
    array); -> its dtype name and shape."""
    if isinstance(leaf, ShardedArray):
        leaf = leaf.global_array()
    t = leaf.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(f, {
                "descr": BF16_DESCR, "fortran_order": False,
                "shape": tuple(t.shape)})
            f.write(t.view(torch.int16).numpy().tobytes())
    else:
        np.save(path, t.numpy())
    return {"dtype": str(t.dtype).removeprefix("torch."),
            "shape": list(t.shape)}


def save(ckpt_dir: str, step: int, tree: Any, keep: int = 3) -> str:
    """Save ``tree``; returns the published directory."""
    dest = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = dest + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "keys": []}
    for key, leaf in _flatten(tree).items():
        fname = re.sub(r"[^A-Za-z0-9_.-]", "_", key) + ".npy"
        manifest["keys"].append({"key": key, "file": fname,
                                 **_write_leaf(os.path.join(tmp, fname),
                                               leaf)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(dest):
        shutil.rmtree(dest)
    os.replace(tmp, dest)      # atomic publish
    _evict(ckpt_dir, keep)
    return dest


def _evict(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(ckpt_dir, d))


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _load(path: str, dtype_name: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr)


def restore(ckpt_dir: str, step: int, target: Any,
            shardings: Optional[Any] = None) -> Any:
    """Restore into the structure of ``target``, a tree of tensors whose
    leaves give each leaf's shape, type and device. ``shardings``: an
    optional tree of the same structure whose :class:`Sharding` leaves
    lay their leaf out on the current fabric (``None`` leaves: the
    target's device)."""
    src = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(src, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {e["key"]: e for e in manifest["keys"]}
    flat_s = _flatten(shardings) if shardings is not None else {}

    def one(key, leaf):
        e = by_key[key]
        t = _load(os.path.join(src, e["file"]), e["dtype"])
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(t.shape)} != "
                             f"target {tuple(leaf.shape)}")
        sh = flat_s.get(key)
        if isinstance(sh, Sharding):
            return place(t.to(leaf.dtype), sh)
        return t.to(device=leaf.device, dtype=leaf.dtype)
    return _map(one, target)
