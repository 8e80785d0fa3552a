"""Elastic rescale: move a tree of sharded arrays from one fabric to
another (counterpart of ``repro/runtime/elastic.py:1-49``).

A :class:`ShardedArray` is the stacked per-shard blocks of one global
array (:meth:`Fabric.shard`) together with its :class:`Sharding`, the
fabric and partition spec that laid it out: the port's counterpart of a
``jax.Array`` and its ``NamedSharding``. :func:`reshard` moves each leaf
to its target sharding through the global array (:meth:`Fabric.unshard`,
then :meth:`Fabric.shard`); a leaf already laid out for its target comes
back as the same object, with no copy. :func:`rescale` binds one spec a
leaf to a fabric, typically a :meth:`Fabric.resize` result, so a changed
shard count degrades capacity instead of ending the run. On a
distributed fabric a leaf holds this process's blocks only: a move
gathers the blocks across processes and keeps the target's local rows.
:func:`rescale_from_checkpoint` restores a checkpoint written on any
fabric onto target shardings.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch

from ..core.fabric import Axes, Fabric


@dataclass(frozen=True)
class Sharding:
    """Where a global array lives: ``fabric`` and the partition ``spec``
    (a tuple, one entry per dimension: an axis name, a tuple of names, or
    ``None``) that cuts it into per-shard blocks."""
    fabric: Fabric
    spec: Tuple[Axes, ...]


@dataclass(frozen=True, eq=False)
class ShardedArray:
    """``blocks [L, *block]``: this process's per-shard blocks of a
    global array under ``sharding`` (all ``S`` of them on a virtual
    fabric)."""
    blocks: torch.Tensor
    sharding: Sharding

    def global_array(self) -> torch.Tensor:
        """The global array (a collective on a distributed fabric)."""
        fab = self.sharding.fabric
        return fab.unshard(self.blocks, self.sharding.spec)


def place(x: torch.Tensor, sharding: Sharding) -> ShardedArray:
    """Lay the global array ``x`` out under ``sharding``, on its fabric's
    device (``jax.device_put`` with a sharding)."""
    fab = sharding.fabric
    blocks = fab.shard(x.to(fab.device), sharding.spec)
    return ShardedArray(blocks, sharding)


def _tree_map(fn, tree, targets):
    """``fn(leaf, target)`` over the leaves of ``tree`` (dicts, lists and
    tuples of leaves), ``targets`` a tree of the same structure."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, targets[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, t) for v, t in zip(tree, targets))
    return fn(tree, targets)


def reshard(tree: Any, shardings: Any) -> Any:
    """Move every leaf of ``tree`` (a :class:`ShardedArray`, or a global
    tensor) to its :class:`Sharding` in ``shardings``. A leaf whose
    sharding already equals its target is returned as it is."""
    def one(x, sh):
        if isinstance(x, ShardedArray):
            if x.sharding == sh:
                return x
            x = x.global_array()
        return place(x, sh)
    return _tree_map(one, tree, shardings)


def rescale(tree: Any, fabric: Fabric, specs: Any) -> Any:
    """Move ``tree`` onto ``fabric``: each leaf's partition spec in
    ``specs`` (a tree of specs of ``tree``'s structure) bound to it, then
    :func:`reshard`."""
    return reshard(tree, _tree_map(lambda _, s: Sharding(fabric, s),
                                   tree, specs))


def rescale_from_checkpoint(ckpt_dir: str, step: int, target_state: Any,
                            target_shardings: Optional[Any]) -> Any:
    """:func:`repro_torch.checkpoint.checkpoint.restore` of ``step`` into
    ``target_state``'s structure, each leaf placed by its
    :class:`Sharding` in ``target_shardings`` (``None``: on the target
    leaf's device)."""
    from ..checkpoint import checkpoint as ckpt   # it imports this module
    return ckpt.restore(ckpt_dir, step, target_state, target_shardings)
