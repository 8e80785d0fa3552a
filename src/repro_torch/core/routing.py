"""Owner-routed NoC rounds on virtual shards (counterpart of
``repro/core/routing.py:51-330, 459-492``).

The reference functions run per shard inside ``shard_map``; these take
every shard at once, stacked on the leading dimension (``dest [S, N]``
holds the N tasks of each of the S shards). A round is:

  1. *bucket*: each shard groups its tasks by destination into
     capacity-bounded buckets (the paper's input queue); the first
     ``cap`` tasks per channel in array order are kept, the rest dropped
     and counted;
  2. *deliver*: value and int32 metadata columns are packed into one f32
     wire array (ints bitcast, never converted) and exchanged by
     :func:`noc_all_to_all`, a transpose of ``[S_src, S_dst, cap, C]``;
  3. on the pod/portal path, stage 1 routes over the intra-pod axis to
     the destination's portal and stage 2 hops once over the pod axis.

Shard id on the pod/portal path: ``g = pod * n_intra + intra``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..kernels import route as kroute
from ..kernels.route import resolve_route_impl


# ---------------------------------------------------------------------------
# per-round capacity resolution
# ---------------------------------------------------------------------------

def resolve_flat_cap(queues, task: str, e_local: int, n_shards: int,
                     clamp: bool = False) -> int:
    """One flat round's per-channel capacity. ``None`` (unbounded)
    resolves to ``e_local``; ``clamp=True`` trims an explicit capacity
    at ``e_local`` (a shard never sends more than its slice to one
    owner, so drops are unchanged)."""
    cap = queues.channel_cap(task, e_local, n_shards)
    if cap is None:
        cap = max(1, e_local)
    elif clamp:
        cap = min(int(cap), max(1, e_local))
    return max(1, int(cap))


def resolve_hier_caps(queues, task: str, e_local: int, n_intra: int,
                      n_pods: int) -> Tuple[int, int]:
    """Stage-1 / stage-2 capacities of the pod/portal path; stage 2 sizes
    from stage 1's worst-case egress (``n_intra * cap1``)."""
    cap1 = queues.channel_cap(task, e_local, n_intra)
    cap1 = max(1, e_local) if cap1 is None else int(cap1)
    cap2 = queues.channel_cap(task, n_intra * cap1, n_pods)
    cap2 = max(1, n_intra * cap1) if cap2 is None else int(cap2)
    return cap1, cap2


def resolve_caps(fabric, queues, task: str, e_local: int, axis: str,
                 pod_axis: Optional[str], *, clamp: bool = False
                 ) -> Tuple[Tuple[int, ...], Optional[Tuple[int, int]]]:
    """One launch's capacities against a fabric: ``(caps, pods)`` with
    ``pods = (n_intra, n_pods)`` on the pod/portal path, else ``None``."""
    if queues.iq_sizes.get(task) is not None and pod_axis is not None:
        raise ValueError("explicit cap is only defined for the flat path")
    if pod_axis is None:
        return ((resolve_flat_cap(queues, task, e_local, fabric.n_devices,
                                  clamp=clamp),), None)
    sizes = fabric.axis_sizes
    pods = (sizes[axis], sizes[pod_axis])
    return resolve_hier_caps(queues, task, e_local, *pods), pods


# ---------------------------------------------------------------------------
# bucketing (the bounded IQ)
# ---------------------------------------------------------------------------

def positions_by_dest(dest, valid, n_buckets, impl=None):
    """Stable position of each valid task within its (shard, destination)
    bucket: ``"pallas"`` the rank kernel (its plain version on the CPU),
    ``"sort"`` the argsort rank, ``"onehot"`` the one-hot cumsum. Entries
    of invalid tasks are unspecified."""
    impl = resolve_route_impl(impl)
    if impl == "pallas":
        return kroute.bucket_rank(dest, valid, n_buckets)
    if impl == "sort":
        return kroute.plain_bucket_rank(dest, valid, n_buckets)
    return kroute.onehot_rank(dest, valid, n_buckets)


def bucket(x_tasks, dest, valid, aux_ints, n_buckets, cap, impl=None):
    """Capacity-bounded bucketing: ``(xb, ints, task_slot, n_drop)``.

    ``x_tasks`` is ``[S, N, D]`` (or ``[S, N]``), ``dest``/``valid`` and
    every aux column ``[S, N]``. ``xb`` is ``[S, n_buckets*cap, D]``,
    ``ints`` the aux columns in slot order (-1 = empty), ``task_slot``
    each task's slot (-1 if dropped), ``n_drop`` ``[S]``. Admission is
    the same for every impl: the first ``cap`` tasks per channel.
    """
    impl = resolve_route_impl(impl)
    squeeze = x_tasks.dim() == 2
    x3 = (x_tasks[..., None] if squeeze else x_tasks).contiguous()
    if impl == "pallas":
        out = kroute.bucket_scatter(x3, dest, valid, aux_ints, n_buckets, cap)
    elif impl == "sort":
        out = kroute.bucket_sort_gather(x3, dest, valid, aux_ints, n_buckets,
                                        cap)
    else:
        out = kroute.plain_bucket_scatter(
            x3, dest, valid, aux_ints, n_buckets, cap,
            rank=kroute.onehot_rank(dest, valid, n_buckets))
    xb, ints, task_slot, n_drop = out
    return (xb[..., 0] if squeeze else xb), ints, task_slot, n_drop


# ---------------------------------------------------------------------------
# the NoC round: one fused all_to_all
# ---------------------------------------------------------------------------

def noc_all_to_all(x, shape: Sequence[int], dim: int):
    """The tiled ``all_to_all`` over fabric axis ``dim`` of ``shape``:
    ``x [S, B*rows, C]`` holds, per shard, one block of ``rows`` for each
    of the ``B = shape[dim]`` peers along that axis. Shard ``d`` receives
    block ``d`` of every peer, in peer order, as
    ``lax.all_to_all(x, axis, 0, 0, tiled=True)`` delivers it."""
    s, total, c = x.shape
    b = shape[dim]
    y = x.reshape(*shape, b, total // b, c)
    return y.transpose(dim, len(shape)).reshape(s, total, c)


def pack_wire(vals: Optional[torch.Tensor], int_cols: Sequence[torch.Tensor]
              ) -> Tuple[torch.Tensor, tuple]:
    """Pack float32 value columns + int32 metadata columns into one f32
    wire array ``[S, R, C]``. Ints are bitcast (``Tensor.view``), never
    converted, so -1 travels as a NaN pattern untouched. Returns
    ``(packed, meta)`` for :func:`unpack_wire`. (The reference also packs
    half-width payloads two per lane; no app of this slice sends one.)"""
    if vals is None and not int_cols:
        raise ValueError("nothing to route")
    cols = []
    squeeze = False
    if vals is not None:
        if vals.dtype != torch.float32:
            raise TypeError(f"wire payloads are float32, got {vals.dtype}")
        if vals.dim() == 2:
            vals, squeeze = vals[..., None], True
        cols.append(vals)
    for c in int_cols:
        cols.append(c.to(torch.int32).view(torch.float32)[..., None])
    packed = cols[0] if len(cols) == 1 else torch.cat(cols, dim=-1)
    return packed, (vals is not None, squeeze, len(int_cols))


def unpack_wire(recv: torch.Tensor, meta: tuple
                ) -> Tuple[Optional[torch.Tensor], List[torch.Tensor]]:
    """Exact inverse of :func:`pack_wire` (bitcast round trip)."""
    has_vals, squeeze, n_int = meta
    c = recv.shape[-1]
    ints = [recv[..., c - n_int + i].contiguous().view(torch.int32)
            for i in range(n_int)]
    if not has_vals:
        return None, ints
    v_out = recv[..., :c - n_int]
    if squeeze:
        v_out = v_out[..., 0]
    return v_out.contiguous(), ints


def fused_all_to_all(vals, int_cols, shape: Sequence[int], dim: int):
    """Deliver value + int32 columns in ONE exchange over fabric axis
    ``dim`` (see :func:`pack_wire` and :func:`noc_all_to_all`)."""
    packed, meta = pack_wire(vals, int_cols)
    return unpack_wire(noc_all_to_all(packed, shape, dim), meta)


# ---------------------------------------------------------------------------
# owner-routed rounds (bucket + fused a2a), flat and hierarchical
# ---------------------------------------------------------------------------

def owner_route(vals, slot_ids, owner, valid, n_shards, cap, impl=None):
    """One flat round: route ``(slot_ids, vals)`` tasks ``[S, N]`` to
    shard ``owner``. Returns ``(recv_slot [S, S*cap], recv_val,
    n_drop [S])``; ``recv_slot`` is -1 for an empty queue entry."""
    xb, (slot_b,), _, n_drop = bucket(vals[..., None], owner, valid,
                                      [slot_ids], n_shards, cap, impl=impl)
    recv_vals, (recv_slot,) = fused_all_to_all(xb, [slot_b], (n_shards,), 0)
    return recv_slot, recv_vals[..., 0].contiguous(), n_drop


def owner_route_hier(vals, slot_ids, owner, valid, n_intra, n_pods, cap1,
                     cap2, impl=None):
    """Two-stage pod/portal round (paper §III-A): stage 1 to the portal in
    the sender's pod with the owner's intra-pod coordinate, stage 2 over
    the pod axis. Returns ``(recv_slot [S, n_pods*cap2], recv_val,
    n_drop [S])``."""
    shape = (n_pods, n_intra)
    e_coord = owner % n_intra
    p_coord = owner // n_intra
    xb, (pc_b, slot_b), _, drop1 = bucket(vals[..., None], e_coord, valid,
                                          [p_coord, slot_ids], n_intra, cap1,
                                          impl=impl)
    v1, (pc1, slot1) = fused_all_to_all(xb, [pc_b, slot_b], shape, 1)
    xb2, (slot2_b,), _, drop2 = bucket(v1, pc1.clamp(min=0), pc1 >= 0,
                                       [slot1], n_pods, cap2, impl=impl)
    v2, (recv_slot,) = fused_all_to_all(xb2, [slot2_b], shape, 0)
    return recv_slot, v2[..., 0].contiguous(), drop1 + drop2


def reduce_received(recv_slot, recv_val, n_local, op, impl=None):
    """Apply received tasks at the owner: ``[S, M]`` -> ``[S, n_local]``
    by add / min / store (the largest value wins; empty slots read 0).
    ``"pallas"`` is the reduce kernel (its plain version on the CPU);
    the other impls use the plain version everywhere."""
    if resolve_route_impl(impl) == "pallas":
        return kroute.reduce_received(recv_slot, recv_val, n_local, op)
    return kroute.plain_reduce_received(recv_slot, recv_val, n_local, op)
