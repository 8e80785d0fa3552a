"""The virtual-shard fabric: S shards stacked on the leading dimension of
one device (counterpart of ``repro/core/fabric.py:67-212``).

A :class:`Fabric` names its axes and their sizes, like a device mesh,
but every shard lives on ``device``: a shard's arrays are row ``g`` of
``[S, ...]`` tensors, with ``g`` the row-major index over the axes
(``g = pod * n_intra + intra`` for a ``("pod", "data")`` fabric). The
NoC ``all_to_all`` over an axis becomes a transpose
(:func:`repro_torch.core.routing.noc_all_to_all`) and ``psum`` a sum
over the shard dimension.

The MoE dispatch runs its ``shard_map`` body on such a fabric (axes
``("data", "expert", "tp")`` or ``("pod", "data", "expert", "tp")``):
:meth:`Fabric.shard` / :meth:`Fabric.unshard` cut a global array into
its per-shard blocks by a partition spec and put them back, and
:meth:`Fabric.all_gather`, :meth:`Fabric.psum`, :meth:`Fabric.axis_index`
and :meth:`Fabric.shard_slice` are the
collectives and index helpers of a ``shard_map`` body, over one axis or
a tuple of axes (linear index row-major in the tuple's order, as
``jax.lax.axis_index`` of a tuple).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from functools import cached_property
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .topology import TileGrid

#: one axis name, a tuple of names, or None (no axis)
Axes = Union[None, str, Sequence[str]]

#: conventional names of the axis that crosses pods
PORTAL_AXIS_NAMES = ("pod", "portal")


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card, and
    raises when there is none (the port never falls back to the CPU
    unless asked). A card named without an index is the current one, so
    the fabric's device equals its tensors' (``cuda:0``, not ``cuda``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run "
                               "on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if (device.type == "cuda" and device.index is None
            and torch.cuda.is_available()):
        return torch.device("cuda", torch.cuda.current_device())
    return device


@dataclass(frozen=True)
class Fabric:
    """Frozen topology of one launch: axis names, axis sizes, device.
    ``portal_axis`` names the axis that crosses pods (``None`` = flat)."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    device: torch.device
    portal_axis: Optional[str] = None

    @classmethod
    def virtual(cls, axis_shapes: Sequence[int], axis_names: Sequence[str],
                device=None, portal_axis: Optional[str] = None) -> "Fabric":
        """``prod(axis_shapes)`` virtual shards on ``device`` (default the
        card). The portal axis is detected from :data:`PORTAL_AXIS_NAMES`
        unless named."""
        names = tuple(axis_names)
        shape = tuple(int(s) for s in axis_shapes)
        if len(names) != len(shape) or len(set(names)) != len(names):
            raise ValueError(f"axis names {names} do not match shape {shape}")
        if any(s < 1 for s in shape):
            raise ValueError(f"axis sizes must be >= 1, got {shape}")
        if portal_axis is None:
            portal_axis = next((a for a in PORTAL_AXIS_NAMES if a in names),
                               None)
        return cls(names, shape, resolve_device(device), portal_axis)

    @classmethod
    def fake(cls, n_dev: int, axis: str = "data", device=None) -> "Fabric":
        """A flat ``n_dev``-shard fabric."""
        return cls.virtual((int(n_dev),), (axis,), device=device)

    @cached_property
    def axis_sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    @property
    def n_devices(self) -> int:
        return math.prod(self.shape)

    @cached_property
    def pod_axis(self) -> Optional[str]:
        """The portal axis when it routes across pods (size > 1)."""
        if self.portal_axis is None:
            return None
        if self.axis_sizes.get(self.portal_axis, 1) <= 1:
            return None
        return self.portal_axis

    def fabric_key(self) -> tuple:
        """Stable identity for the round-function cache."""
        return (self.axis_names, self.shape, str(self.device))

    # ---- analytic-model hooks ------------------------------------------

    def tile_grid(self) -> TileGrid:
        """The analytic twin's grid at this fabric's parallelism: one tile
        per shard (``TileGrid(1, n_devices)``), the channel structure the
        shardcheck revalidation relies on."""
        return TileGrid(1, self.n_devices)

    def device_coords(self) -> Tuple[Tuple[int, Tuple[int, ...]], ...]:
        """``((shard index, coordinates), ...)`` in row-major shard order.
        The shards are virtual, so a shard's index stands where the
        reference gives a device id."""
        return tuple((g, tuple(int(c) for c in row))
                     for g, row in enumerate(self.coords))

    # ---- elasticity ----------------------------------------------------

    def resize(self, n_shards: int) -> "Fabric":
        """A fabric of ``n_shards`` shards on the same device
        (``repro/core/fabric.py:285-310``): the leading axis absorbs the
        change and the trailing axes keep their sizes; where the count
        does not keep that structure, the fabric goes flat over the last
        axis name. The new shape gives a new :meth:`fabric_key`, so its
        launches build their own round functions."""
        n_shards = int(n_shards)
        if n_shards < 1:
            raise ValueError("cannot resize to an empty fabric")
        inner = math.prod(self.shape[1:]) if len(self.shape) > 1 else 1
        lead, rem = divmod(n_shards, inner)
        if len(self.shape) > 1 and rem == 0 and lead >= 1:
            shape, names = (lead,) + self.shape[1:], self.axis_names
        else:
            shape, names = (n_shards,), self.axis_names[-1:]
        portal = self.portal_axis if self.portal_axis in names else None
        # a new instance: the cached axis bookkeeping starts afresh
        return replace(self, axis_names=names, shape=shape,
                       portal_axis=portal)

    def shrink(self, keep: int) -> "Fabric":
        """:meth:`resize` onto the first ``keep`` shards: the host-loss
        degrade of the serving tier (``repro/core/fabric.py:312-328``)."""
        keep = int(keep)
        if not 1 <= keep <= self.n_devices:
            raise ValueError(f"shrink keeps {keep} of {self.n_devices} "
                             f"devices — need 1 <= keep <= n_devices")
        return self.resize(keep)

    # ---- axes and the stacked-shard index helpers --------------------

    def _axis_tuple(self, axes: Axes) -> Tuple[str, ...]:
        """``axes`` as a tuple of names (``None`` -> ``()``)."""
        if axes is None:
            return ()
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in names:
            if a not in self.axis_sizes:
                raise ValueError(f"no axis {a!r} in {self.axis_names}")
        return names

    def axis_size(self, axes: Axes) -> int:
        """Product size of ``axes`` (``None`` -> 1; a name; a tuple)."""
        return math.prod(self.axis_sizes[a] for a in self._axis_tuple(axes))

    def axis_dims(self, axes: Axes) -> Tuple[int, ...]:
        """Positions of ``axes`` in the fabric shape, in the given order."""
        return tuple(self.axis_names.index(a)
                     for a in self._axis_tuple(axes))

    @cached_property
    def coords(self) -> np.ndarray:
        """``[S, n_axes]`` coordinates of each shard (row-major ids)."""
        grid = np.indices(self.shape).reshape(len(self.shape), -1)
        return np.ascontiguousarray(grid.T)

    def axis_index(self, axes: Axes) -> np.ndarray:
        """``[S]`` linear index of each shard over ``axes``, row-major in
        the given order (zeros for ``None``)."""
        idx = np.zeros(self.n_devices, np.int64)
        for d in self.axis_dims(axes):
            idx = idx * self.shape[d] + self.coords[:, d]
        return idx

    def _index(self, axes: Axes, device) -> torch.Tensor:
        return torch.from_numpy(self.axis_index(axes)).to(device)

    # ---- the shard_map boundary ---------------------------------------

    def shard(self, x: torch.Tensor, spec: Sequence[Axes]) -> torch.Tensor:
        """Per-shard blocks of the global ``x`` under the partition spec
        ``spec`` (one entry per dimension): ``[S, *block]``, a copy.
        Shards not named on a dimension hold the same block."""
        spec = tuple(spec) + (None,) * (x.dim() - len(spec))
        nb = [self.axis_size(a) for a in spec]
        for n, size, a in zip(nb, x.shape, spec):
            if size % n:
                raise ValueError(f"dimension {size} does not split over "
                                 f"{a!r} ({n} shards)")
        blk = [size // n for n, size in zip(nb, x.shape)]
        view = x.reshape([v for pair in zip(nb, blk) for v in pair])
        nd = x.dim()
        view = view.permute([2 * i for i in range(nd)]
                            + [2 * i + 1 for i in range(nd)])
        return view[tuple(self._index(a, x.device) for a in spec)]

    def unshard(self, xs: torch.Tensor, spec: Sequence[Axes]) -> torch.Tensor:
        """Inverse of :meth:`shard`: the global array from per-shard blocks
        ``[S, *block]``; over axes the spec does not name, the shard at
        coordinate 0 gives the block."""
        spec = tuple(spec) + (None,) * (xs.dim() - 1 - len(spec))
        named = {d for a in spec for d in self.axis_dims(a)}
        rep = np.flatnonzero((self.coords[:, [d for d in range(len(self.shape))
                                               if d not in named]] == 0)
                             .all(axis=1))
        nb = [self.axis_size(a) for a in spec]
        blk = list(xs.shape[1:])
        out = xs.new_empty(nb + blk)
        rep_t = torch.from_numpy(rep).to(xs.device)
        out[tuple(self._index(a, xs.device)[rep_t] for a in spec)] = xs[rep_t]
        nd = len(blk)
        out = out.permute([v for i in range(nd) for v in (i, nd + i)])
        return out.reshape([n * b for n, b in zip(nb, blk)])

    # ---- collectives of a shard_map body --------------------------------

    def all_gather(self, x: torch.Tensor, axes: Axes, dim: int
                   ) -> torch.Tensor:
        """Tiled ``all_gather`` over ``axes`` along per-shard dimension
        ``dim`` of ``x [S, ...]``: every shard gets its peers' blocks
        concatenated in their linear order over ``axes``."""
        dims = self.axis_dims(axes)
        if not dims:
            return x
        n, rest = len(self.shape), list(x.shape[1:])
        y = x.reshape(*self.shape, *rest)
        others = [d for d in range(n) if d not in dims]
        perm = (others + [n + i for i in range(dim)] + list(dims)
                + [n + i for i in range(dim, len(rest))])
        gathered = rest[:dim] + [self.axis_size(axes) * rest[dim]] + rest[dim + 1:]
        g = y.permute(perm).reshape([self.shape[d] for d in others]
                                    + gathered)
        for d in sorted(dims):              # the same on every peer
            g = g.unsqueeze(d)
        return g.expand(*self.shape, *gathered).reshape(x.shape[0],
                                                        *gathered)

    def psum(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        """Sum of ``x [S, ...]`` over the peers along ``axes``, on each."""
        dims = self.axis_dims(axes)
        if not dims:
            return x
        y = x.reshape(*self.shape, *x.shape[1:])
        return y.sum(dim=dims, keepdim=True).expand_as(y).reshape(x.shape)

    def shard_slice(self, x: torch.Tensor, axes: Axes, dim: int
                    ) -> torch.Tensor:
        """Each shard's block ``axis_index(axes)`` of ``axis_size(axes)``
        equal blocks along per-shard dimension ``dim`` (the inverse of
        :meth:`all_gather`; ``dynamic_slice_in_dim`` at the shard's
        index)."""
        n = self.axis_size(axes)
        if n == 1:
            return x
        size = x.shape[1 + dim]
        if size % n:
            raise ValueError(f"dimension {size} does not split in {n}")
        v = x.reshape(*x.shape[:1 + dim], n, size // n, *x.shape[2 + dim:])
        v = v.movedim(1 + dim, 1)
        rows = torch.arange(x.shape[0], device=x.device)
        return v[rows, self._index(axes, x.device)]
