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

:meth:`Fabric.distributed` spreads the shards over processes joined by
``torch.distributed`` (gloo), process-major as ``jax.devices()`` orders
devices: process ``p`` holds the contiguous shards ``[p*L, (p+1)*L)``,
``L = n_devices / n_processes``, stacked on the leading dimension of its
own device, so the leading axis is the one that crosses processes. Its
round loop exchanges through :attr:`Fabric.exchange`
(:class:`repro_torch.core.scaleout.ProcessExchange`), sums with
:meth:`Fabric.gsum` and tests convergence with :meth:`Fabric.global_any`;
on a virtual fabric those are the local transpose, the local sum and the
local test, unchanged.

On a distributed fabric the ``shard_map`` helpers take and give this
process's rows ``[L, ...]``: :meth:`Fabric.shard` cuts this process's
blocks out of a global tensor every process holds, :meth:`Fabric.unshard`
gives the global tensor back on every process, and the collectives
gather over gloo only where their axes cross processes. Each of them is
differentiable, and its gradient is the virtual fabric's: a crossing
collective runs the virtual fabric's own operation on the gathered
global tensor (:class:`_ViaGlobal`), so the backward is that operation's
vector-Jacobian product on the gathered global gradient. A tensor every
process holds whole (the global input of :meth:`Fabric.shard`, the
output of :meth:`Fabric.unshard`) carries the same gradient on every
process, that of the one global loss.
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


def balanced_slice(total: int, rank: int, world: int) -> Tuple[int, int]:
    """Rank ``rank``'s contiguous ``[lo, hi)`` share of ``total`` items
    split near-evenly over ``world`` (the first ``total % world`` ranks
    take one more)."""
    base, rem = divmod(int(total), int(world))
    lo = rank * base + min(rank, rem)
    return lo, lo + base + (1 if rank < rem else 0)


def _all_gather_grid(x: torch.Tensor, shape: Sequence[int],
                     dims: Sequence[int], dim: int) -> torch.Tensor:
    """Tiled ``all_gather`` of ``x [prod(shape), ...]`` over the grid
    dims ``dims`` of ``shape`` along per-shard dimension ``dim``: every
    shard gets its peers' blocks concatenated in their linear order over
    ``dims``."""
    n, rest = len(shape), list(x.shape[1:])
    y = x.reshape(*shape, *rest)
    others = [d for d in range(n) if d not in dims]
    perm = (others + [n + i for i in range(dim)] + list(dims)
            + [n + i for i in range(dim, len(rest))])
    peers = math.prod(shape[d] for d in dims)
    gathered = rest[:dim] + [peers * rest[dim]] + rest[dim + 1:]
    g = y.permute(perm).reshape([shape[d] for d in others] + gathered)
    for d in sorted(dims):              # the same on every peer
        g = g.unsqueeze(d)
    return g.expand(*shape, *gathered).reshape(x.shape[0], *gathered)


def _process_rows(fab: "Fabric", t: torch.Tensor) -> torch.Tensor:
    """This process's equal share of ``t``'s leading dimension, which
    holds every process's rows in process order."""
    per = t.shape[0] // fab.n_processes
    return t[fab.process_index * per:(fab.process_index + 1) * per]


class _Take(torch.autograd.Function):
    """``x[index]`` for an index that reads no element twice; the gradient
    is put back by a copy, where advanced indexing's own gradient adds by
    index (atomics on the card, in an order that changes from run to
    run)."""

    @staticmethod
    def forward(ctx, x, *index):
        ctx.shape, ctx.index = x.shape, index
        return x[index]

    @staticmethod
    def backward(ctx, g):
        gx = g.new_zeros(ctx.shape).index_put_(ctx.index, g)
        return (gx,) + (None,) * len(ctx.index)


class _ViaGlobal(torch.autograd.Function):
    """``fn`` of a distributed fabric's global tensor, differentiable.

    ``local_in``: ``x`` is this process's rows, gathered over gloo into
    the global tensor ``fn`` takes; else ``x`` is global, held whole by
    every process. ``local_out``: the result is this process's rows of
    ``fn``'s; else the global result, on every process. ``fast``, when
    given, computes the same result from ``x`` without the gather.

    The backward is ``fn``'s vector-Jacobian product on the global
    gradient (gathered from every process when the result is local rows)
    and, for a local input, this process's rows of it: the virtual
    fabric's gradient, computed by the same operation. ``fn`` must be
    linear, as every layout operation is: its product is taken at zero,
    so nothing of the forward is kept."""

    @staticmethod
    def forward(ctx, x, fab, fn, local_in, local_out, fast):
        ctx.fab, ctx.fn = fab, fn
        ctx.local_in, ctx.local_out = local_in, local_out
        rows = x.shape[0] * (fab.n_processes if local_in else 1)
        ctx.in_shape, ctx.dtype = (rows, *x.shape[1:]), x.dtype
        if fast is not None:
            return fast(x)
        y = fn(fab.exchange.all_gather(x) if local_in else x)
        return _process_rows(fab, y) if local_out else y

    @staticmethod
    def backward(ctx, g):
        fab = ctx.fab
        if ctx.local_out:
            g = fab.exchange.all_gather(g.contiguous())
        with torch.enable_grad():
            z = torch.zeros(ctx.in_shape, dtype=ctx.dtype, device=g.device,
                            requires_grad=True)
            (gx,) = torch.autograd.grad(ctx.fn(z), z, g)
        if ctx.local_in:
            gx = _process_rows(fab, gx)
        return gx, None, None, None, None, None


@dataclass(frozen=True)
class Fabric:
    """Frozen topology of one launch: axis names, axis sizes, device.
    ``portal_axis`` names the axis that crosses pods (``None`` = flat).
    ``process_index`` / ``n_processes`` place it over processes
    (:meth:`distributed`); a virtual fabric is process 0 of 1."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    device: torch.device
    portal_axis: Optional[str] = None
    process_index: int = 0
    n_processes: int = 1

    def __post_init__(self):
        if self.n_devices % self.n_processes:
            raise ValueError(f"{self.n_devices} shards {self.shape} do not "
                             f"split over {self.n_processes} processes")
        if not 0 <= self.process_index < self.n_processes:
            raise ValueError(f"process {self.process_index} outside "
                             f"{self.n_processes}")

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

    @classmethod
    def distributed(cls, axis_shapes: Optional[Sequence[int]] = None,
                    axis_names: Optional[Sequence[str]] = None, *,
                    coordinator_address: Optional[str] = None,
                    num_processes: Optional[int] = None,
                    process_id: Optional[int] = None,
                    portal_axis: Optional[str] = None, device=None,
                    timeout: float = 300.0) -> "Fabric":
        """A fabric over ``num_processes`` processes joined by
        ``torch.distributed`` with gloo (``repro/core/fabric.py:134-166``).

        Joins the process group at ``tcp://coordinator_address`` (a
        group already initialised is reused), with a collective timeout
        of ``timeout`` seconds. The shards are process-major: process
        ``p`` holds the contiguous shards ``[p*L, (p+1)*L)`` on its own
        ``device`` (default the card), so declare the portal axis first
        (``(n_proc, local)``, ``("portal", "data")``) and only the portal
        stage crosses processes. With no shape, the fabric is flat: one
        ``data`` axis, one shard a process. A shape whose shard count
        does not split over the processes raises ``ValueError``."""
        from .scaleout import join_process_group
        if axis_shapes is not None and axis_names is None:
            raise ValueError("axis_names is required with axis_shapes")
        dev = resolve_device(device)
        world, rank = join_process_group(coordinator_address, num_processes,
                                         process_id, timeout,
                                         axis_shapes=axis_shapes)
        if axis_shapes is None:
            axis_shapes, axis_names = (world,), ("data",)
        fab = cls.virtual(axis_shapes, axis_names, device=dev,
                          portal_axis=portal_axis)
        return replace(fab, process_index=rank, n_processes=world)

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
        """Stable identity for the round-function cache: a distributed
        fabric holds fewer shards a process than the virtual one of its
        shape, so the process placement is part of it."""
        return (self.axis_names, self.shape, str(self.device),
                (self.process_index, self.n_processes))

    # ---- multi-process topology -----------------------------------------

    @property
    def process_indices(self) -> Tuple[int, ...]:
        """The processes that hold this fabric's shards (``(0,)`` on a
        virtual fabric)."""
        return tuple(range(self.n_processes))

    @property
    def is_multiprocess(self) -> bool:
        return self.n_processes > 1

    @property
    def n_local_shards(self) -> int:
        """Shards this process holds: the leading dimension of its
        tensors."""
        return self.n_devices // self.n_processes

    @property
    def local_shards(self) -> Tuple[int, int]:
        """The ``[lo, hi)`` global shard rows this process holds (all of
        them on a virtual fabric)."""
        lo = self.process_index * self.n_local_shards
        return lo, lo + self.n_local_shards

    def dcn_axes(self) -> Tuple[str, ...]:
        """Axes along which neighbouring shards live in different
        processes: the axes whose exchanges cross processes. Empty on a
        virtual fabric."""
        if not self.is_multiprocess:
            return ()
        procs = (np.arange(self.n_devices) // self.n_local_shards
                 ).reshape(self.shape)
        return tuple(name for i, name in enumerate(self.axis_names)
                     if self.shape[i] > 1
                     and bool((np.diff(procs, axis=i) != 0).any()))

    def host_slice(self, total: int, *, rank: Optional[int] = None,
                   world: Optional[int] = None) -> Tuple[int, int]:
        """This process's contiguous ``[lo, hi)`` share of ``total`` ingest
        items (edge chunks, rows), balanced over the fabric's processes;
        ``rank`` / ``world`` stand in for the fabric's own."""
        world = self.n_processes if world is None else int(world)
        rank = self.process_index if rank is None else int(rank)
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} outside world {world}")
        return balanced_slice(total, rank, world)

    def local_rows(self, x):
        """This process's rows ``[lo, hi)`` of a global ``[S, ...]`` array
        (numpy or tensor; the array itself on a virtual fabric)."""
        if not self.is_multiprocess:
            return x
        lo, hi = self.local_shards
        return x[lo:hi]

    @cached_property
    def exchange(self):
        """The all_to_all across processes
        (:class:`repro_torch.core.scaleout.ProcessExchange`), ``None`` on
        a virtual fabric, whose exchange is the local transpose."""
        if not self.is_multiprocess:
            return None
        from .scaleout import ProcessExchange
        return ProcessExchange(self)

    def gsum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of per-shard values ``x [L, ...]`` over every shard of the
        fabric, handed back to each (the reference's ``psum`` over all
        axes): the local sum, then, across processes, a gloo
        ``all_reduce``."""
        total = x.sum(0, keepdim=True)
        if self.is_multiprocess:
            total = self.exchange.all_reduce(total, "sum")
        return total.expand_as(x)

    def global_any(self, flag: torch.Tensor) -> bool:
        """Whether ``flag`` (any shape, bool) holds anywhere on the
        fabric: one blocking host read, and across processes an
        ``all_reduce(MAX)`` of it."""
        local = flag.any()
        if self.is_multiprocess:
            local = self.exchange.all_reduce(local.to(torch.int32), "max")
        return bool(local)

    def gather_shards(self, x: torch.Tensor) -> torch.Tensor:
        """The global ``[S, ...]`` from every process's rows ``[L, ...]``
        (gloo ``all_gather``), on ``x``'s device; ``x`` itself on a
        virtual fabric."""
        if not self.is_multiprocess:
            return x
        return self.exchange.all_gather(x)

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
        degrade of the serving tier (``repro/core/fabric.py:312-328``).
        A distributed fabric keeps every process, each with ``keep /
        n_processes`` shards; a ``keep`` that does not split over the
        processes raises ``ValueError``."""
        keep = int(keep)
        if not 1 <= keep <= self.n_devices:
            raise ValueError(f"shrink keeps {keep} of {self.n_devices} "
                             f"devices — need 1 <= keep <= n_devices")
        if keep % self.n_processes:
            raise ValueError(f"shrink keeps {keep} of {self.n_devices} "
                             f"shards, which do not split over "
                             f"{self.n_processes} processes: a distributed "
                             f"fabric keeps every process")
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

    def _local_index(self, axes: Axes, device) -> torch.Tensor:
        """:meth:`axis_index` of this process's shards ``[L]``."""
        lo, hi = self.local_shards
        return torch.from_numpy(self.axis_index(axes)[lo:hi]).to(device)

    def _local_grid(self) -> Tuple[int, int]:
        """``(t, lead)``: this process's rows are ``[lead, *shape[t:]]``,
        whole trailing axes ``t..`` under ``lead`` consecutive indices of
        the leading ones (row-major over ``shape[:t]``)."""
        t = next(i for i in range(len(self.shape) + 1)
                 if self.n_local_shards % math.prod(self.shape[i:]) == 0)
        return t, self.n_local_shards // math.prod(self.shape[t:])

    # ---- the shard_map boundary ---------------------------------------

    def _shard_on(self, x: torch.Tensor, spec, rows=None) -> torch.Tensor:
        """The blocks of global ``x`` under ``spec`` of the shards
        ``rows`` (every shard when ``None``). Each dimension splits into
        its axes' sizes (row-major in the tuple's order) and its block,
        the axes move to their fabric positions and the blocks broadcast
        over the axes ``spec`` does not name: no index, so the gradient
        is a sum over those replicas, in a fixed order."""
        nb = [self.axis_size(a) for a in spec]
        for n, size, a in zip(nb, x.shape, spec):
            if size % n:
                raise ValueError(f"dimension {size} does not split over "
                                 f"{a!r} ({n} shards)")
        split, fabric_dim = [], []
        for a, n, size in zip(spec, nb, x.shape):
            dims = self.axis_dims(a)
            split += [self.shape[d] for d in dims] + [size // n]
            fabric_dim += list(dims) + [None]
        at = {d: i for i, d in enumerate(fabric_dim) if d is not None}
        blocks = [i for i, d in enumerate(fabric_dim) if d is None]
        grid = x.reshape(split).permute([at[d] for d in sorted(at)] + blocks)
        for d in range(len(self.shape)):
            if d not in at:
                grid = grid.unsqueeze(d)
        blk = grid.shape[len(self.shape):]
        grid = grid.expand(*self.shape, *blk)
        if rows is None:
            return grid.clone(memory_format=torch.contiguous_format).view(
                self.n_devices, *blk)
        at_rows = torch.from_numpy(self.coords[rows].T.copy()).to(x.device)
        return grid[tuple(at_rows)]

    def shard(self, x: torch.Tensor, spec: Sequence[Axes]) -> torch.Tensor:
        """Per-shard blocks of the global ``x`` under the partition spec
        ``spec`` (one entry per dimension): ``[S, *block]``, a copy.
        Shards not named on a dimension hold the same block. On a
        distributed fabric every process holds ``x`` whole and gets its
        own rows ``[L, *block]``; the gradient of ``x`` is the global
        one on every process (its rows' gradients gathered, then added
        as the virtual fabric adds them)."""
        spec = tuple(spec) + (None,) * (x.dim() - len(spec))
        if not self.is_multiprocess:
            return self._shard_on(x, spec)
        lo, hi = self.local_shards
        return _ViaGlobal.apply(x, self, lambda t: self._shard_on(t, spec),
                                False, True,
                                lambda t: self._shard_on(t, spec, slice(lo, hi)))

    def _unshard_on(self, xs: torch.Tensor, spec, rows: np.ndarray,
                    at: np.ndarray) -> torch.Tensor:
        """The global array from the blocks of rows ``rows`` of ``xs``,
        which are the global shards ``at``: one a block."""
        nb = [self.axis_size(a) for a in spec]
        blk = list(xs.shape[1:])
        out = xs.new_empty(nb + blk)
        at_t = torch.from_numpy(at).to(xs.device)
        out[tuple(self._index(a, xs.device)[at_t] for a in spec)] = \
            _Take.apply(xs, torch.from_numpy(rows).to(xs.device))
        nd = len(blk)
        out = out.permute([v for i in range(nd) for v in (i, nd + i)])
        return out.reshape([n * b for n, b in zip(nb, blk)])

    def _replica_rows(self, spec) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """The shards whose blocks :meth:`unshard` reads: ``(rep, mine)``.
        ``rep`` are the global ones, at coordinate 0 over the axes the
        spec does not name. ``mine`` are this process's local rows that
        hold every block once (the first of each), ``None`` unless every
        process holds every block, which is when no named axis crosses
        processes."""
        named = sorted({d for a in spec for d in self.axis_dims(a)})
        free = [d for d in range(len(self.shape)) if d not in named]
        rep = np.flatnonzero((self.coords[:, free] == 0).all(axis=1))
        if not self.is_multiprocess:
            return rep, rep
        sizes = [self.shape[d] for d in named]
        key = (np.ravel_multi_index(self.coords[:, named].T, sizes)
               if named else np.zeros(self.n_devices, np.int64))
        per = key.reshape(self.n_processes, self.n_local_shards)
        n_blocks = math.prod(sizes)
        if any(len(np.unique(k)) != n_blocks for k in per):
            return rep, None
        mine = per[self.process_index]
        _, first = np.unique(mine, return_index=True)
        return rep, np.sort(first)

    def unshard(self, xs: torch.Tensor, spec: Sequence[Axes]) -> torch.Tensor:
        """Inverse of :meth:`shard`: the global array from per-shard blocks
        ``[S, *block]``; over axes the spec does not name, the shard at
        coordinate 0 gives the block. On a distributed fabric ``xs`` is
        this process's rows and every process gets the global array:
        gathered over gloo where a named axis crosses processes; where
        none does, every process holds every block and assembles it from
        its own shards (their replicas over the unnamed axes hold the
        same values). The gradient goes to the coordinate-0 shards, as
        on the virtual fabric."""
        spec = tuple(spec) + (None,) * (xs.dim() - 1 - len(spec))
        rep, mine = self._replica_rows(spec)
        if not self.is_multiprocess:
            return self._unshard_on(xs, spec, rep, rep)

        def whole(t):
            return self._unshard_on(t, spec, rep, rep)
        fast = None
        if mine is not None:
            lo = self.local_shards[0]

            def fast(t):
                return self._unshard_on(t, spec, mine, mine + lo)
        return _ViaGlobal.apply(xs, self, whole, True, False, fast)

    # ---- collectives of a shard_map body --------------------------------

    def all_gather(self, x: torch.Tensor, axes: Axes, dim: int
                   ) -> torch.Tensor:
        """Tiled ``all_gather`` over ``axes`` along per-shard dimension
        ``dim`` of ``x [S, ...]``: every shard gets its peers' blocks
        concatenated in their linear order over ``axes``. On a
        distributed fabric ``x`` is this process's rows: over axes it
        holds whole the gather is local, and only where an axis crosses
        processes does it go over gloo."""
        dims = [d for d in self.axis_dims(axes) if self.shape[d] > 1]
        if not dims:
            return x
        if not self.is_multiprocess:
            return _all_gather_grid(x, self.shape, dims, dim)
        t, lead = self._local_grid()
        if all(d >= t for d in dims):
            grid = (lead,) + self.shape[t:]
            return _all_gather_grid(x, grid, [d - t + 1 for d in dims], dim)

        def whole(full):
            return _all_gather_grid(full, self.shape, dims, dim)
        return _ViaGlobal.apply(x, self, whole, True, True, None)

    def psum(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        """Sum of ``x [S, ...]`` over the peers along ``axes``, on each.
        On a distributed fabric ``x`` is this process's rows ``[L, ...]``:
        over every axis it is :meth:`gsum`; otherwise the axes this
        process holds whole are summed here, and only where ``axes``
        also cross processes are the partial sums gathered (one gloo
        ``all_gather``) and summed over the rest. Over the axes of one
        kind the values are the virtual fabric's bit for bit; over both
        the local sums come first."""
        dims = self.axis_dims(axes)
        if not dims:
            return x
        if not self.is_multiprocess:
            y = x.reshape(*self.shape, *x.shape[1:])
            return y.sum(dim=dims, keepdim=True).expand_as(y).reshape(x.shape)
        if len(dims) == len(self.shape):
            return self.gsum(x)
        t, lead = self._local_grid()
        inner, rest = self.shape[t:], x.shape[1:]
        y = x.reshape(-1, *inner, *rest)
        local = tuple(1 + d - t for d in dims if d >= t)
        if local:
            y = y.sum(dim=local, keepdim=True)
        cross = tuple(d for d in dims if d < t)
        if cross:
            lead_shape = self.shape[:t]

            def whole(full):
                f = full.reshape(*lead_shape, *full.shape[1:])
                f = f.sum(dim=cross, keepdim=True).expand_as(f)
                return f.reshape(-1, *f.shape[t:])
            y = _ViaGlobal.apply(y, self, whole, True, True, None)
        return y.expand(-1, *inner, *rest).reshape(x.shape)

    def shard_slice(self, x: torch.Tensor, axes: Axes, dim: int
                    ) -> torch.Tensor:
        """Each shard's block ``axis_index(axes)`` of ``axis_size(axes)``
        equal blocks along per-shard dimension ``dim`` (the inverse of
        :meth:`all_gather`; ``dynamic_slice_in_dim`` at the shard's
        index). On a distributed fabric, of this process's rows."""
        n = self.axis_size(axes)
        if n == 1:
            return x
        size = x.shape[1 + dim]
        if size % n:
            raise ValueError(f"dimension {size} does not split in {n}")
        v = x.reshape(*x.shape[:1 + dim], n, size // n, *x.shape[2 + dim:])
        v = v.movedim(1 + dim, 1)
        rows = torch.arange(x.shape[0], device=x.device)
        return _Take.apply(v, rows, self._local_index(axes, x.device))
