"""Owner-routed NoC rounds on virtual shards (counterpart of
``repro/core/routing.py:51-492``).

The reference functions run per shard inside ``shard_map``; these take
every shard at once, stacked on the leading dimension (``dest [S, N]``
holds the N tasks of each of the S shards). A round is:

  1. *bucket*: each shard groups its tasks by destination into
     capacity-bounded buckets (the paper's input queue); the first
     ``cap`` tasks per channel in array order are kept, the rest dropped
     and counted;
  2. *deliver*: value and int32 metadata columns are packed into one f32
     wire array (ints bitcast, never converted) and exchanged by
     :func:`noc_all_to_all`, a transpose of ``[S_src, S_dst, cap, C]``
     (on a distributed fabric, its ``exchange``: the blocks that stay in
     the process permuted locally, the rest staged across over gloo);
  3. on the pod/portal path, stage 1 routes over the intra-pod axis to
     the destination's portal and stage 2 hops once over the pod axis.

The pipelined round splits a round into a produce half
(:func:`owner_route_start`, :func:`owner_route_hier_start`: bucket, pack
and exchange, with an int32 signal riding the exchange) and a consume
half (:func:`owner_route_finish`); :func:`local_route_reduce` is a whole
round whose producer and consumer are one shard.

Shard id on the pod/portal path: ``g = pod * n_intra + intra``.

Every function that exchanges takes ``exchange``: ``None`` (a virtual
fabric) runs the local transpose; a distributed fabric passes its
:attr:`~repro_torch.core.fabric.Fabric.exchange`, and then the leading
dimension holds this process's shards only, while shard counts, owners
and the fabric ``shape`` stay global.
"""
from __future__ import annotations

import math
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


def _gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    s, m, d = table.shape
    flat = (ids.long().clamp(min=0)
            + torch.arange(s, device=ids.device)[:, None] * m).reshape(-1)
    rows = table.reshape(s * m, d).index_select(0, flat).view(*ids.shape, d)
    return rows.mul_((ids >= 0)[..., None].to(rows.dtype))


class _SumK(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        ctx.shape = t.shape
        out = t.new_zeros(t.shape[0], t.shape[1], t.shape[3])
        for j in range(t.shape[2]):
            out.add_(t[:, :, j])
        return out

    @staticmethod
    def backward(ctx, g):
        return g.unsqueeze(2).expand(ctx.shape)


def sum_k(t: torch.Tensor) -> torch.Tensor:
    """``t [S, M, K, D]`` summed over K in order, from zeros: ``((0 + t_0)
    + t_1) + ...``, the order of the reference's ``segment_sum`` over
    consecutive segment ids on the CPU. -> ``[S, M, D]``; its gradient
    is a broadcast view, no copy of ``t``."""
    return _SumK.apply(t)


class _GatherRows(torch.autograd.Function):
    """:func:`gather_rows` with ``inverse``: the gradient of table row
    ``m`` is the sum, in order from zeros, of the gradients of the rows
    ``inverse[:, m*k : (m+1)*k]`` name (-1: none), gathered back. No
    accumulate-by-index op, so the sum is the same on every run."""

    @staticmethod
    def forward(ctx, table, ids, inverse, k):
        ctx.save_for_backward(inverse)
        ctx.k = k
        return _gather(table, ids)

    @staticmethod
    def backward(ctx, g):
        (inverse,) = ctx.saved_tensors
        s, n = inverse.shape
        by_k = inverse.view(s, n // ctx.k, ctx.k)
        out = g.new_zeros(s, n // ctx.k, g.shape[2])
        for j in range(ctx.k):                  # one [S, M, D] at a time
            out.add_(_gather(g, by_k[:, :, j]))
        return out, None, None, None


def gather_rows(table: torch.Tensor, ids: torch.Tensor,
                inverse: Optional[torch.Tensor] = None, k: int = 1
                ) -> torch.Tensor:
    """``rows[s, r] = table[s, ids[s, r]]``, a zero row where the id is -1
    (``repro/core/routing.py:194``): ``table [S, M, D]``, ``ids [S, R]``
    -> ``[S, R, D]``.

    ``inverse [S, M * k]``, when given, lists for each table row the
    ``k`` rows of ``ids`` that read it (-1: none; :func:`inverse_map`
    builds it where a row is read at most once): the gradient into
    ``table`` is then gathered back through it and summed over the
    ``k`` in order, where ``index_select``'s own gradient adds by index
    (atomics on the card, in an order that changes from run to run)."""
    if inverse is None:
        return _gather(table, ids)
    return _GatherRows.apply(table, ids, inverse, k)


def inverse_map(ids: torch.Tensor, m: int) -> torch.Tensor:
    """``[S, m]`` int32: for each of ``m`` table rows the position in
    ``ids [S, R]`` that reads it, -1 where none; ``ids`` (-1: none)
    reads each row at most once."""
    s, r = ids.shape
    seg = torch.where(ids >= 0, ids.long(), m)
    inv = torch.full((s, m + 1), -1, dtype=torch.int32, device=ids.device)
    inv.scatter_(1, seg, torch.arange(r, dtype=torch.int32, device=ids.device
                                      ).expand(s, r))
    return inv[:, :m]


def slot_scatter(data: torch.Tensor, slot: torch.Tensor, valid: torch.Tensor,
                 num_slots: int) -> torch.Tensor:
    """Scatter the valid rows of ``data [S, N, D]`` into ``num_slots``
    slots of each shard (``repro/core/routing.py:145``): slot
    ``slot[s, i]``, at most one valid row a slot; slots that get none
    hold 0. -> ``[S, num_slots, D]``. A copy, not a sum: with one writer
    a slot the two agree (but for the sign of a zero), and a copy sends
    the invalid rows to one spare slot a shard without contention."""
    s, n, d = data.shape
    seg = torch.where(valid, slot.long(), num_slots)
    flat = (seg + torch.arange(s, device=seg.device)[:, None]
            * (num_slots + 1)).reshape(-1)
    out = data.new_zeros(s * (num_slots + 1), d)
    out.index_copy_(0, flat, data.reshape(s * n, d))
    return out.view(s, num_slots + 1, d)[:, :num_slots]


# ---------------------------------------------------------------------------
# the NoC round: one fused all_to_all
# ---------------------------------------------------------------------------

def noc_all_to_all(x, shape: Sequence[int], dim, exchange=None):
    """The tiled ``all_to_all`` over fabric axis ``dim`` of ``shape`` (or
    over a tuple of axes, the peers in their linear order over the tuple,
    as ``lax.all_to_all`` over a tuple of axis names): ``x [S, B*rows,
    C]`` holds, per shard, one block of ``rows`` for each of the ``B``
    peers. Shard ``d`` receives block ``d`` of every peer, in peer
    order. ``exchange`` (a distributed fabric's) runs it across
    processes on this process's shards."""
    dims = (dim,) if isinstance(dim, int) else tuple(dim)
    if exchange is not None:
        return exchange(x, shape, dims)
    s, total, c = x.shape
    n = len(shape)
    peers = [shape[d] for d in dims]
    y = x.reshape(*shape, *peers, total // math.prod(peers), c)
    perm = list(range(n + len(dims) + 2))
    for j, d in enumerate(dims):            # swap fabric dim d with block j
        perm[d], perm[n + j] = perm[n + j], perm[d]
    return y.permute(perm).reshape(s, total, c)


HALF_TYPES = (torch.bfloat16, torch.float16)


def _wire_columns(vals: Optional[torch.Tensor],
                  int_cols: Sequence[torch.Tensor]) -> Tuple[list, tuple]:
    """The f32 column blocks of a wire and its ``meta`` (see
    :func:`pack_wire`)."""
    if vals is None and not int_cols:
        raise ValueError("nothing to route")
    cols = []
    squeeze = False
    dtype, d_vals, half = None, 0, False
    if vals is not None:
        dtype = vals.dtype
        if dtype != torch.float32 and dtype not in HALF_TYPES:
            raise TypeError(f"wire payloads are float32, bfloat16 or "
                            f"float16, got {dtype}")
        if vals.dim() == 2:
            vals, squeeze = vals[..., None], True
        d_vals = vals.shape[-1]
        half = dtype in HALF_TYPES
        if half:
            if d_vals % 2:
                vals = torch.cat([vals, vals.new_zeros(*vals.shape[:-1], 1)],
                                 dim=-1)
            vals = vals.contiguous().view(torch.float32)
        cols.append(vals)
    for c in int_cols:
        cols.append(c.to(torch.int32).view(torch.float32)[..., None])
    return cols, (dtype, d_vals, half, squeeze, len(int_cols))


def pack_wire(vals: Optional[torch.Tensor], int_cols: Sequence[torch.Tensor]
              ) -> Tuple[torch.Tensor, tuple]:
    """Pack value columns + int32 metadata columns into one f32 wire array
    ``[S, R, C]``. Ints are bitcast (``Tensor.view``), never converted,
    so -1 travels as a NaN pattern untouched. Half-width payloads (bf16,
    f16) are bitcast two to a float32 lane, an odd width padded with a
    zero column, so the wire has ``ceil(D/2) + len(int_cols)`` columns
    (``repro/core/routing.py:210-249``). Returns ``(packed, meta)`` for
    :func:`unpack_wire`."""
    cols, meta = _wire_columns(vals, int_cols)
    packed = cols[0] if len(cols) == 1 else torch.cat(cols, dim=-1)
    return packed, meta


def unpack_wire(recv: torch.Tensor, meta: tuple
                ) -> Tuple[Optional[torch.Tensor], List[torch.Tensor]]:
    """Exact inverse of :func:`pack_wire` (bitcast round trip)."""
    dtype, d_vals, half, squeeze, n_int = meta
    c = recv.shape[-1]
    ints = [recv[..., c - n_int + i].contiguous().view(torch.int32)
            for i in range(n_int)]
    if dtype is None:
        return None, ints
    v_out = recv[..., :c - n_int].contiguous()
    if half:
        v_out = v_out.view(dtype)[..., :d_vals].contiguous()
    if squeeze:
        v_out = v_out[..., 0].contiguous()
    return v_out, ints


def fused_all_to_all(vals, int_cols, shape: Sequence[int], dim,
                     exchange=None):
    """Deliver value + int32 columns in ONE exchange over fabric axis
    ``dim`` or a tuple of axes (see :func:`pack_wire` and
    :func:`noc_all_to_all`)."""
    packed, meta = pack_wire(vals, int_cols)
    return unpack_wire(noc_all_to_all(packed, shape, dim, exchange), meta)


# ---------------------------------------------------------------------------
# owner-routed rounds (bucket + fused a2a), flat and hierarchical
# ---------------------------------------------------------------------------

def owner_route(vals, slot_ids, owner, valid, n_shards, cap, impl=None,
                exchange=None):
    """One flat round: route ``(slot_ids, vals)`` tasks ``[S, N]`` to
    shard ``owner``. Returns ``(recv_slot [S, S*cap], recv_val,
    n_drop [S])``; ``recv_slot`` is -1 for an empty queue entry."""
    xb, (slot_b,), _, n_drop = bucket(vals[..., None], owner, valid,
                                      [slot_ids], n_shards, cap, impl=impl)
    recv_vals, (recv_slot,) = fused_all_to_all(xb, [slot_b], (n_shards,), 0,
                                               exchange)
    return recv_slot, recv_vals[..., 0].contiguous(), n_drop


def owner_route_hier(vals, slot_ids, owner, valid, n_intra, n_pods, cap1,
                     cap2, impl=None, exchange=None):
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
    v1, (pc1, slot1) = fused_all_to_all(xb, [pc_b, slot_b], shape, 1,
                                        exchange)
    xb2, (slot2_b,), _, drop2 = bucket(v1, pc1.clamp(min=0), pc1 >= 0,
                                       [slot1], n_pods, cap2, impl=impl)
    v2, (recv_slot,) = fused_all_to_all(xb2, [slot2_b], shape, 0, exchange)
    return recv_slot, v2[..., 0].contiguous(), drop1 + drop2


# ---------------------------------------------------------------------------
# split-phase rounds (the pipelined round's communication edge)
# ---------------------------------------------------------------------------

def _a2a_with_signal(vals, int_cols, shape: Sequence[int], dim: int,
                     signal: torch.Tensor, exchange=None):
    """Pack ``vals`` and ``int_cols`` (see :func:`pack_wire`; ``[S,
    B*rows]`` tasks, B the peers over fabric axis ``dim``) with one signal
    row appended to each destination block, the int32 ``signal [S]``
    bitcast into its column 0, and exchange them over ``dim``
    (``repro/core/routing.py:347-371``). The blocks are written straight
    into one ``[S, B, rows + 1, C]`` wire, so the row costs no extra copy
    of the tasks. Returns ``(recv [S, B, rows + 1, C], meta, gsignal
    [S])``: ``gsignal`` is the sum of the signals of the peers a shard
    received from; :func:`_strip` gives the task rows, value-identical
    to :func:`fused_all_to_all`'s."""
    cols, meta = _wire_columns(vals, int_cols)
    s, total = cols[0].shape[:2]
    n_blocks = shape[dim]
    rows = total // n_blocks
    c = sum(col.shape[-1] for col in cols)
    wire = cols[0].new_empty(s, n_blocks, rows + 1, c)
    j = 0
    for col in cols:
        w = col.shape[-1]
        wire[:, :, :rows, j:j + w] = col.view(s, n_blocks, rows, w)
        j += w
    wire[:, :, rows] = 0.0
    wire[:, :, rows, 0] = signal.to(torch.int32).view(torch.float32)[:, None]
    recv = noc_all_to_all(wire.view(s, n_blocks * (rows + 1), c), shape,
                          dim, exchange).view(s, n_blocks, rows + 1, c)
    gsignal = recv[:, :, rows, 0].contiguous().view(torch.int32).sum(
        1, dtype=torch.int32)
    return recv, meta, gsignal


def _unpack_signalled(recv: torch.Tensor, meta: tuple):
    """:func:`unpack_wire` of a signalled wire's task rows (``[S, B, rows
    + 1, C]`` -> values and ints ``[S, B*rows, ...]``), each column read
    once, with no copy of the whole wire."""
    s, b, rows1, _ = recv.shape
    v, ints = unpack_wire(recv[:, :, :rows1 - 1], meta)
    m = b * (rows1 - 1)
    ints = [a.reshape(s, m) for a in ints]
    return (None if v is None else v.reshape(s, m, *v.shape[3:])), ints


def owner_route_start(vals, slot_ids, owner, valid, n_shards, cap, signal,
                      impl=None, exchange=None):
    """Produce half of one flat round: bucket, pack and exchange, the
    int32 ``signal [S]`` riding along (:func:`_a2a_with_signal`).
    Returns ``(recv, meta, n_drop [S], gsignal [S])``; hand ``(recv,
    meta)`` to :func:`owner_route_finish`, across a loop iteration if need
    be, for :func:`owner_route`'s receive values."""
    xb, (slot_b,), _, n_drop = bucket(vals[..., None], owner, valid,
                                      [slot_ids], n_shards, cap, impl=impl)
    recv, meta, gsignal = _a2a_with_signal(xb, [slot_b], (n_shards,), 0,
                                           signal, exchange)
    return recv, meta, n_drop, gsignal


def owner_route_finish(recv, meta):
    """Consume half: ``(recv_slot, recv_val)`` from a carried wire, equal
    to :func:`owner_route`'s (feed them to :func:`reduce_received`)."""
    recv_vals, (recv_slot,) = _unpack_signalled(recv, meta)
    return recv_slot, recv_vals[..., 0].contiguous()


def owner_route_hier_start(vals, slot_ids, owner, valid, n_intra, n_pods,
                           cap1, cap2, signal, impl=None, exchange=None):
    """Produce half of one pod/portal round: both stages run here (stage
    2's bucketing needs stage 1's receive), so the pod-crossing exchange
    is the one carried. The signal crosses both stages: stage 1 sums it
    within each pod, stage 2 over the pods, so ``gsignal`` is the global
    sum, as on the flat path. Returns ``(recv2, meta2, n_drop [S],
    gsignal [S])``."""
    shape = (n_pods, n_intra)
    e_coord = owner % n_intra
    p_coord = owner // n_intra
    xb, (pc_b, slot_b), _, drop1 = bucket(vals[..., None], e_coord, valid,
                                          [p_coord, slot_ids], n_intra, cap1,
                                          impl=impl)
    recv1, meta1, sig1 = _a2a_with_signal(xb, [pc_b, slot_b], shape, 1,
                                          signal, exchange)
    v1, (pc1, slot1) = _unpack_signalled(recv1, meta1)
    xb2, (slot2_b,), _, drop2 = bucket(v1, pc1.clamp(min=0), pc1 >= 0,
                                       [slot1], n_pods, cap2, impl=impl)
    recv2, meta2, gsignal = _a2a_with_signal(xb2, [slot2_b], shape, 0, sig1,
                                             exchange)
    return recv2, meta2, drop1 + drop2, gsignal


def local_route_reduce(vals, slot_ids, dest, valid, n_buckets, cap, n_local,
                       op, impl=None):
    """One whole round whose producer and consumer are one shard
    (``repro/core/routing.py:420-456``): rank each task within its
    destination bucket (:func:`positions_by_dest`: the rank kernel on
    ``"pallas"``), keep the first ``cap`` a bucket, and fold the kept
    tasks straight into ``[S, n_local]`` with :func:`reduce_received`,
    dropped tasks' slots at -1: no bucket array, no wire. Only for
    ``min`` and ``store``, which do not depend on order, so the result
    and the drop count are bit-identical to :func:`bucket` +
    :func:`reduce_received`. Returns ``(y [S, n_local], n_drop [S])``."""
    if op not in ("min", "store"):
        raise ValueError(f"local_route_reduce needs an order-insensitive "
                         f"reduce, got {op!r}")
    valid = valid & (dest >= 0) & (dest < n_buckets)   # as bucket() admits
    pos = positions_by_dest(dest, valid, n_buckets, impl=impl)
    keep = valid & (pos < cap)
    n_drop = (valid & ~keep).sum(1, dtype=torch.int32)
    seg = torch.where(keep, slot_ids.to(torch.int32), -1)
    y = reduce_received(seg, vals.to(torch.float32), n_local, op, impl=impl)
    return y, n_drop


def reduce_received(recv_slot, recv_val, n_local, op, impl=None):
    """Apply received tasks at the owner: ``[S, M]`` -> ``[S, n_local]``
    by add / min / store (the largest value wins; empty slots read 0).
    ``"pallas"`` is the reduce kernel (its plain version on the CPU);
    the other impls use the plain version everywhere."""
    if resolve_route_impl(impl) == "pallas":
        return kroute.reduce_received(recv_slot, recv_val, n_local, op)
    return kroute.plain_reduce_received(recv_slot, recv_val, n_local, op)
