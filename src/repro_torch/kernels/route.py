"""The routing kernels of the owner-routed round, on S virtual shards.

Counterpart of ``repro/kernels/route.py``. Every array carries the shard
on its leading dimension: ``dest [S, N]`` holds the N tasks of each of
the S shards, and one launch covers all of them.

* :func:`bucket_rank` — stable rank of each task within its destination
  bucket (``bucket_rank_pallas``);
* :func:`bucket_scatter` — rank, capacity test and slot scatter
  (``bucket_scatter_pallas``): ``(xb, ints, task_slot, n_drop)``;
* :func:`reduce_received` — the owner-side add/min/store fold
  (``reduce_received_pallas``).

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/route.cu``) and adds one to its entry of :data:`LAUNCHES`; on a
CPU tensor it runs its plain PyTorch version (``plain_*``) instead.
Any other device raises. The plain versions are also what the tests
hold against the JAX package and what ``chip_smoke.py`` holds the
kernels against on the card.
"""
from __future__ import annotations

import torch

ROUTE_IMPLS = ("pallas", "sort", "onehot")
REDUCE_OPS = ("add", "min", "store")
MAX_BUCKETS = 1024        # rank kernel keeps [32 warps, n_buckets] in smem

#: kernel launches per wrapper since the last reset (chip_smoke reads these)
LAUNCHES = {"bucket_rank": 0, "bucket_scatter": 0, "reduce_received": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def gamma(k):
    """``gamma_k = k u / (1 - k u)``, u = 2^-24: a float32 sum of ``k + 1``
    terms, in any order or tree, is within ``gamma_k`` times the sum of
    their magnitudes of the exact sum (Higham, Accuracy and Stability of
    Numerical Algorithms, 2nd ed., section 4.2). Works on arrays."""
    u = 2.0 ** -24
    return k * u / (1 - k * u)


def resolve_route_impl(impl=None) -> str:
    """``None``/``"auto"`` -> ``"pallas"``, the kernel tier."""
    if impl in (None, "auto"):
        return "pallas"
    if impl not in ROUTE_IMPLS:
        raise ValueError(f"route_impl {impl!r} not in {ROUTE_IMPLS}")
    return impl


def _admitted(dest, valid, n_buckets):
    """A task takes part only when valid with a destination in range (the
    kernels never index outside their buckets)."""
    return valid & (dest >= 0) & (dest < n_buckets)


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"the kernels run on cuda or cpu, not {t.device}")
    return True


def _check(t, name, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got "
                         f"{t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def onehot_rank(dest, valid, n_buckets):
    """The one-hot cumsum rank (``repro/kernels/route.py:73-81``):
    O(N*S) memory; entries of invalid tasks are unspecified."""
    onehot = torch.nn.functional.one_hot(dest.long().clamp(0, n_buckets - 1),
                                         n_buckets).to(torch.int32)
    onehot = onehot * _admitted(dest, valid, n_buckets)[..., None]
    pos = torch.cumsum(onehot, dim=1, dtype=torch.int32) - 1
    return torch.gather(pos, 2, dest.long().clamp(0, n_buckets - 1)[..., None]
                        )[..., 0]


def _sorted_runs(dest, valid, n_buckets):
    """Stable argsort by destination, invalid tasks to the sentinel bucket
    ``n_buckets``: ``(key, order, sorted key, rank of each sorted task)``."""
    key = torch.where(_admitted(dest, valid, n_buckets), dest, n_buckets)
    order = torch.argsort(key, dim=1, stable=True)
    ks = torch.gather(key, 1, order).contiguous()
    start = torch.searchsorted(ks, ks, side="left")
    pos_sorted = torch.arange(key.shape[1], device=key.device) - start
    return key, order, ks, pos_sorted


def plain_bucket_rank(dest, valid, n_buckets):
    """Stable rank by argsort (``repro/core/routing.py:131-142``), 0 for
    an invalid task, as the kernel gives: [S, N] int32."""
    if dest.shape[1] == 0:
        return torch.zeros_like(dest, dtype=torch.int32)
    key, order, _, pos_sorted = _sorted_runs(dest, valid, n_buckets)
    pos = torch.empty_like(pos_sorted).scatter_(1, order, pos_sorted)
    return torch.where(key < n_buckets, pos, 0).to(torch.int32)


def plain_bucket_scatter(x, dest, valid, aux_ints, n_buckets, cap,
                         rank=None):
    """Rank (``plain_bucket_rank`` unless given), keep the first ``cap``
    per (shard, destination), and put the kept rows into fresh zero / -1
    buffers: ``(xb [S, B*cap, D], ints k*[S, B*cap], task_slot [S, N],
    n_drop [S])``."""
    s, n, d = x.shape
    total = n_buckets * cap
    valid = _admitted(dest, valid, n_buckets)
    pos = plain_bucket_rank(dest, valid, n_buckets) if rank is None else rank
    keep = valid & (pos < cap)
    slot = dest.long() * cap + pos.long()
    flat = (torch.arange(s, device=x.device)[:, None] * total + slot)[keep]
    xb = torch.zeros(s * total, d, dtype=x.dtype, device=x.device)
    xb[flat] = x[keep]
    ints = []
    for a in aux_ints:
        col = torch.full((s * total,), -1, dtype=torch.int32, device=x.device)
        col[flat] = a.to(torch.int32)[keep]
        ints.append(col.view(s, total))
    task_slot = torch.where(keep, slot, -1).to(torch.int32)
    n_drop = (valid & ~keep).sum(1, dtype=torch.int32)
    return xb.view(s, total, d), ints, task_slot, n_drop


def bucket_sort_gather(x, dest, valid, aux_ints, n_buckets, cap):
    """The ``route_impl="sort"`` bucketing (``bucket_sort_gather`` of the
    reference): one stable argsort per shard, then slot ``(b, p)``
    gathers the task at sorted position ``start[b] + p``. Same outputs as
    :func:`plain_bucket_scatter`."""
    s, n, d = x.shape
    total = n_buckets * cap
    dev = x.device
    if n == 0:
        return (torch.zeros(s, total, d, dtype=x.dtype, device=dev),
                [torch.full((s, total), -1, dtype=torch.int32, device=dev)
                 for _ in aux_ints],
                torch.zeros(s, 0, dtype=torch.int32, device=dev),
                torch.zeros(s, dtype=torch.int32, device=dev))
    key, order, ks, pos_sorted = _sorted_runs(dest, valid, n_buckets)
    pos = torch.empty_like(pos_sorted).scatter_(1, order, pos_sorted)
    bins = torch.arange(n_buckets, dtype=ks.dtype, device=dev).expand(
        s, n_buckets).contiguous()
    b_start = torch.searchsorted(ks, bins, side="left")
    b_end = torch.searchsorted(ks, bins, side="right")
    slot_b = torch.arange(n_buckets, device=dev).repeat_interleave(cap)
    slot_p = torch.arange(cap, device=dev).repeat(n_buckets)
    src_sorted = b_start[:, slot_b] + slot_p
    filled = src_sorted < b_end[:, slot_b]
    src = torch.gather(order, 1, src_sorted.clamp(max=n - 1))
    rows = torch.gather(x, 1, src[..., None].expand(s, total, d))
    xb = torch.where(filled[..., None], rows, torch.zeros((), dtype=x.dtype,
                                                          device=dev))
    ints = [torch.where(filled, torch.gather(a.to(torch.int32), 1, src), -1)
            for a in aux_ints]
    admitted = key < n_buckets
    keep = admitted & (pos < cap)
    task_slot = torch.where(keep, dest.long() * cap + pos, -1).to(torch.int32)
    n_drop = (admitted & ~keep).sum(1, dtype=torch.int32)
    return xb, ints, task_slot, n_drop


_REDUCE_INIT = {"add": 0.0, "min": float("inf"), "store": float("-inf")}
_REDUCE_NAME = {"add": "sum", "min": "amin", "store": "amax"}


def plain_reduce_received(recv_slot, recv_val, n_local, op):
    """``scatter_reduce_`` into one spare column per shard for empty or
    out-of-range slots, then the finalisation of
    ``repro/kernels/route.py:386-390``: [S, n_local] float32."""
    if op not in REDUCE_OPS:
        raise ValueError(op)
    s = recv_slot.shape[0]
    init = _REDUCE_INIT[op]
    ok = (recv_slot >= 0) & (recv_slot < n_local)
    seg = torch.where(ok, recv_slot.long(), n_local)
    idx = (torch.arange(s, device=seg.device)[:, None] * (n_local + 1)
           + seg).reshape(-1)
    vals = torch.where(ok, recv_val.to(torch.float32), init).reshape(-1)
    y = torch.full((s * (n_local + 1),), init, dtype=torch.float32,
                   device=seg.device)
    y.scatter_reduce_(0, idx, vals, _REDUCE_NAME[op], include_self=True)
    y = y.view(s, n_local + 1)[:, :n_local]
    if op == "min":
        y = torch.where(torch.isfinite(y), y, float("inf"))
    elif op == "store":
        y = torch.where(torch.isfinite(y), y, 0.0)
    return y.contiguous()


# ---------------------------------------------------------------------------
# the kernel wrappers
# ---------------------------------------------------------------------------

def _launch_rank(dest, valid_u8, n_buckets):
    from ._build import library
    lib = library("route")
    s, n = dest.shape
    tiles = -(-n // lib.dcra_rank_tile())
    scratch = torch.empty(s * n_buckets * max(tiles, 1), dtype=torch.int32,
                          device=dest.device)
    pos = torch.empty(s, n, dtype=torch.int32, device=dest.device)
    if n == 0:
        return pos
    _raise_on(lib.dcra_bucket_rank(
        dest.data_ptr(), valid_u8.data_ptr(), s, n, n_buckets,
        scratch.data_ptr(), pos.data_ptr(), _stream(dest.device)),
        "bucket_rank")
    LAUNCHES["bucket_rank"] += 1
    return pos


def _check_tasks(dest, valid, n_buckets):
    _check(dest, "dest", torch.int32, dest.shape, dest.device)
    _check(valid, "valid", torch.bool, dest.shape, dest.device)
    if dest.dim() != 2:
        raise ValueError(f"dest must be [S, N], got {tuple(dest.shape)}")
    if not 1 <= n_buckets <= MAX_BUCKETS:
        raise ValueError(f"n_buckets {n_buckets} outside [1, {MAX_BUCKETS}]")


def bucket_rank(dest, valid, n_buckets):
    """Stable rank of each valid task within its (shard, destination)
    bucket; 0 for an invalid task. dest [S, N] int32, valid [S, N] bool
    -> [S, N] int32."""
    if not _on_cuda(dest):
        return plain_bucket_rank(dest, valid, n_buckets)
    _check_tasks(dest, valid, n_buckets)
    return _launch_rank(dest, valid.view(torch.uint8), n_buckets)


def bucket_scatter(x, dest, valid, aux_ints, n_buckets, cap):
    """Capacity-bounded bucketing of ``x [S, N, D]`` float32 with int32
    aux columns ``k*[S, N]``: ``(xb [S, B*cap, D], ints k*[S, B*cap],
    task_slot [S, N], n_drop [S])``. The first ``cap`` valid tasks per
    (shard, destination) in array order are kept; empty slots hold 0 in
    ``xb`` and -1 in ``ints``; ``task_slot`` is -1 for a dropped task."""
    if not _on_cuda(x):
        return plain_bucket_scatter(x, dest, valid, aux_ints, n_buckets, cap)
    _check_tasks(dest, valid, n_buckets)
    if dest.device != x.device:
        raise ValueError(f"dest: expected a tensor on {x.device}, got "
                         f"{dest.device}")
    s, n = dest.shape
    if x.dim() != 3:
        raise ValueError(f"x must be [S, N, D], got {tuple(x.shape)}")
    _check(x, "x", torch.float32, (s, n, x.shape[2]), x.device)
    if cap < 1:
        raise ValueError(f"cap must be >= 1, got {cap}")
    for j, a in enumerate(aux_ints):
        _check(a, f"aux_ints[{j}]", torch.int32, (s, n), x.device)
    from ._build import library
    lib = library("route")
    k, d = len(aux_ints), x.shape[2]
    total = n_buckets * cap
    dev = x.device
    valid_u8 = valid.view(torch.uint8)
    rank = _launch_rank(dest, valid_u8, n_buckets)
    aux = (aux_ints[0][None] if k == 1 else torch.stack(aux_ints)) if k else None
    xb = torch.empty(s, total, d, dtype=torch.float32, device=dev)
    ints = torch.empty(k, s, total, dtype=torch.int32, device=dev)
    task_slot = torch.empty(s, n, dtype=torch.int32, device=dev)
    n_drop = torch.empty(s, dtype=torch.int32, device=dev)
    _raise_on(lib.dcra_bucket_scatter(
        x.data_ptr(), dest.data_ptr(), valid_u8.data_ptr(),
        aux.data_ptr() if k else None, rank.data_ptr(), s, n, d, k,
        n_buckets, cap, xb.data_ptr(), ints.data_ptr() if k else None,
        task_slot.data_ptr(), n_drop.data_ptr(), _stream(dev)),
        "bucket_scatter")
    LAUNCHES["bucket_scatter"] += 1
    return xb, list(ints.unbind(0)), task_slot, n_drop


def reduce_received(recv_slot, recv_val, n_local, op):
    """Fold received ``(slot, value)`` pairs ``[S, M]`` into ``[S,
    n_local]`` float32 by ``add`` (empty 0), ``min`` (empty +inf) or
    ``store`` (the largest value wins, empty 0). Slots outside
    ``[0, n_local)`` are ignored."""
    if op not in REDUCE_OPS:
        raise ValueError(op)
    if not _on_cuda(recv_slot):
        return plain_reduce_received(recv_slot, recv_val, n_local, op)
    if recv_slot.dim() != 2:
        raise ValueError(f"recv_slot must be [S, M], got "
                         f"{tuple(recv_slot.shape)}")
    _check(recv_slot, "recv_slot", torch.int32, recv_slot.shape,
           recv_slot.device)
    _check(recv_val, "recv_val", torch.float32, recv_slot.shape,
           recv_slot.device)
    from ._build import library
    s, m = recv_slot.shape
    y = torch.empty(s, n_local, dtype=torch.float32, device=recv_slot.device)
    _raise_on(library("route").dcra_reduce_received(
        recv_slot.data_ptr(), recv_val.data_ptr(), s, m, n_local,
        REDUCE_OPS.index(op), y.data_ptr(), _stream(recv_slot.device)),
        "reduce_received")
    LAUNCHES["reduce_received"] += 1
    return y
