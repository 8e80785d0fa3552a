"""The routing kernels of the owner-routed round, on S virtual shards.

Counterpart of ``repro/kernels/route.py``. Every array carries the shard
on its leading dimension: ``dest [S, N]`` holds the N tasks of each of
the S shards, and one launch covers all of them.

* :func:`bucket_rank` — stable rank of each task within its destination
  bucket (``bucket_rank_pallas``), one pass with decoupled look-back
  (:func:`bucket_rank_plan`);
* :func:`bucket_scatter` — rank, capacity test and slot scatter
  (``bucket_scatter_pallas``): ``(xb, ints, task_slot, n_drop)``;
* :func:`reduce_received` — the owner-side add/min/store fold
  (``reduce_received_pallas``).

On a CUDA tensor each wrapper launches its hand-written kernels
(``csrc/route.cu``) and adds one to its entry of :data:`LAUNCHES`; on a
CPU tensor it runs its plain PyTorch version (``plain_*``) instead.
Any other device raises. The plain versions are also what the tests
hold against the JAX package and what ``chip_smoke.py`` holds the
kernels against on the card.

``bucket_rank`` has one design, ``lookback``, launched as
:func:`bucket_rank_plan` says and counted in :data:`PATHS` like the
others. ``bucket_scatter`` and ``reduce_received`` each have two
designs, picked by :func:`bucket_scatter_plan` (from shapes alone) and
:func:`reduce_received_plan` (from shapes and 16-byte alignment), and
counted by design in :data:`PATHS`: ``staged`` (rank, capacity test and
scatter fused, every slot written once) or ``ranked`` (the rank kernel,
a fill of every slot, one store a kept task: for payloads too wide to
stage); ``private`` (per-block copies of the outputs in shared memory,
for ``n_local`` up to :data:`PRIVATE_MAX_LOCAL`) or ``atomic`` (one
global atomic an entry).
"""
from __future__ import annotations

import torch

from ._launch import LaunchPlan, aligned as _aligned, as_c

ROUTE_IMPLS = ("pallas", "sort", "onehot")
REDUCE_OPS = ("add", "min", "store")
MAX_BUCKETS = 1024        # staged and rank kernels keep [8 warps, B] in smem
THREADS = 256             # ranked scatter, atomic reduce: one task a thread
SMEM_LIMIT = 232_448      # shared memory one block may take on an H100
#: a block's least count on the card: 8 on each of the H100's 132 SMs
TARGET_BLOCKS = 8 * 132
#: staged: tasks a block (256 threads of 8)
STAGE_TILE = 2048
#: lookback rank: tasks a tile, one block each (256 threads of 16), and
#: the most tasks a shard (its row indices are int32)
RANK_TILE = 4096
RANK_MAX_TASKS = 2 ** 31 - 2 * RANK_TILE
#: private: least entries a block, and the shared memory of one copy a
#: warp (8 copies) above which a block keeps one copy
PRIVATE_MIN_CHUNK = 4096
WARP_COPY_BYTES = 48 * 1024
#: private: the largest n_local it takes, the most whose one copy fits a
#: block. ``chip_smoke.py``'s reduce grid (64 shards of 2^23 entries, n_local
#: 64 to 58,112) timed it faster than atomic at every point by add and by
#: min on an H100, 1.28x at 58,112 by add: no crossover below this edge
PRIVATE_MAX_LOCAL = SMEM_LIMIT // 4
#: the designs of each wrapper, as the C entry points number them
PATH_CODES = {"bucket_rank": {"lookback": 0},
              "bucket_scatter": {"ranked": 0, "staged": 1},
              "reduce_received": {"atomic": 0, "private": 1}}

#: kernel launches per wrapper since the last reset, in all and by design
#: (chip_smoke reads these)
LAUNCHES = {"bucket_rank": 0, "bucket_scatter": 0, "reduce_received": 0}
PATHS = {name: {path: 0 for path in codes}
         for name, codes in PATH_CODES.items()}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for paths in PATHS.values():
        for path in paths:
            paths[path] = 0


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
    O(N*S) memory; entries of invalid tasks are unspecified. The one-hot
    is laid out ``[S, B, N]`` so the cumsum runs along the innermost
    axis: along N of ``[S, N, B]`` it took 48 ms at N 131,072, B 128 on
    an H100 (``route_bench``), linear in N."""
    d = dest.long().clamp(0, n_buckets - 1)
    buckets = torch.arange(n_buckets, device=dest.device)
    onehot = ((d[:, None, :] == buckets[None, :, None])
              & _admitted(dest, valid, n_buckets)[:, None, :])
    pos = torch.cumsum(onehot, dim=2, dtype=torch.int32) - 1
    return torch.gather(pos, 1, d[:, None, :])[:, 0]


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
# launch plans
# ---------------------------------------------------------------------------

def rank_smem(n_buckets: int) -> int:
    """Shared memory of a lookback rank block: the tile's keys, then
    ranks, ``[T]``, per-warp counts ``[8, B]``, the tile's aggregate and
    exclusive prefix ``2 * [B]``, above one bucket the look-back's partial
    sums ``[8 * 256]``, and 4 ints (tile id, the nearest inclusive
    tile)."""
    parts = 8 * 256 if n_buckets > 1 else 0
    return 4 * (RANK_TILE + (8 + 2) * n_buckets + parts + 4)


def bucket_rank_plan(s: int, n: int, n_buckets: int) -> LaunchPlan:
    """The launch of ``bucket_rank`` on ``dest [s, n]`` into
    ``n_buckets``: one design, ``lookback``. Each shard's row is cut into
    ``ceil((n + 3) / RANK_TILE)`` tiles (the first shortened by up to 3
    tasks so that tiles start on a 16-byte boundary of dest), one
    256-thread block a tile, grid ``(s * tiles,)``: a block takes its tile
    from an atomic counter, in order (tile t of shard i is the (t * s +
    i)-th), and the tiles of a shard chain their per-bucket prefixes by
    decoupled look-back. ``tiles`` is (tasks a tile, n_buckets, tiles a
    shard); the status scratch is :func:`rank_scratch_ints`. ``csrc/route.cu`` launches this plan as it
    is and refuses one that differs from its own geometry. Negative sizes,
    ``n`` past :data:`RANK_MAX_TASKS` and ``n_buckets`` outside ``[1,
    MAX_BUCKETS]`` raise."""
    if min(s, n) < 0 or n > RANK_MAX_TASKS:
        raise ValueError(f"sizes must be in [0, {RANK_MAX_TASKS}], got "
                         f"s={s} n={n}")
    if not 1 <= n_buckets <= MAX_BUCKETS:
        raise ValueError(f"n_buckets {n_buckets} outside [1, {MAX_BUCKETS}]")
    tiles = -(-(n + 3) // RANK_TILE) if n else 0
    return LaunchPlan("lookback", (RANK_TILE, n_buckets, tiles),
                      (s * tiles, 1, 1), 256, 1, rank_smem(n_buckets))


def rank_scratch_ints(plan: LaunchPlan) -> int:
    """int32 of the lookback rank's status scratch: the tile counter and a
    pad, a 64-bit status word a tile (its flag, and at one bucket its
    count), and above one bucket each tile's inclusive prefix (int32) and
    aggregate (uint16: at most a tile; rows padded to 8 buckets, read 8 a
    16-byte load) a bucket. Only the counter and the words are zeroed a
    launch."""
    n_tiles, n_buckets = plan.grid[0], plan.tiles[1]
    if n_buckets == 1:
        return 2 + 2 * n_tiles
    prefixes = 2 + 2 * n_tiles + n_tiles * n_buckets
    # the aggregates: from a 16-byte boundary, rows of B padded to 8
    return -(-prefixes // 4) * 4 + n_tiles * (-(-n_buckets // 8) * 4)


def staged_smem(n_buckets: int, d: int, k: int) -> int:
    """Shared memory of a staged block: per-warp counts ``[8, B]``, the
    bucket offsets and tile bases ``2 * [B]``, 16 scan ints, and the
    staged rows of a tile: slots ``[T]``, x ``[T, D]``, aux ``[k, T]``."""
    return 4 * ((8 + 2) * n_buckets + 16 + STAGE_TILE * (1 + d + k))


def bucket_scatter_plan(s: int, n: int, d: int, k: int, n_buckets: int,
                        cap: int) -> LaunchPlan:
    """The design and launch of ``bucket_scatter`` on ``x [s, n, d]`` with
    ``k`` aux columns into ``n_buckets * cap`` slots a shard:

    * ``staged`` where the tile staging fits a block (:func:`staged_smem`
      within :data:`SMEM_LIMIT`: at ``d = 1`` any ``k <= 2`` and
      ``n_buckets <= MAX_BUCKETS``; ``d + k`` up to 22 at 1024 buckets,
      27 at one) and slot numbers stay within int32: grid (tiles of
      :data:`STAGE_TILE` tasks, s), 256 threads, that shared memory; the
      count, scan and fill launches around it follow from the same
      shapes. Its kernels read the inputs with 4- and 1-byte loads, so a
      view at any offset takes it;
    * ``ranked`` otherwise (wide ``d``, ``n_buckets * cap >= 2^31``): the
      rank kernel, then one thread a task, grid (ceil(n / 256), s).

    ``tiles`` is (tasks a block, n_buckets, d). ``csrc/route.cu``
    launches this plan as it is and refuses one that differs from its own
    geometry. Negative sizes, ``n_buckets`` outside ``[1, MAX_BUCKETS]``
    and ``cap < 1`` raise."""
    if min(s, n, d, k) < 0:
        raise ValueError(f"sizes must be >= 0, got s={s} n={n} d={d} k={k}")
    if not 1 <= n_buckets <= MAX_BUCKETS:
        raise ValueError(f"n_buckets {n_buckets} outside [1, {MAX_BUCKETS}]")
    if cap < 1:
        raise ValueError(f"cap must be >= 1, got {cap}")
    smem = staged_smem(n_buckets, d, k)
    if smem <= SMEM_LIMIT and n_buckets * cap < 2 ** 31:
        return LaunchPlan("staged", (STAGE_TILE, n_buckets, d),
                          (-(-n // STAGE_TILE), s, 1), 256, 1, smem)
    return LaunchPlan("ranked", (THREADS, n_buckets, d),
                      (-(-n // THREADS), s, 1), THREADS, 1, 0)


def private_plan(s: int, m: int, n_local: int) -> LaunchPlan:
    """The ``private`` design's launch on ``[s, m]`` entries into ``[s,
    n_local]``: grid (chunks, s), chunks enough for :data:`TARGET_BLOCKS`
    blocks but no more than ceil(m / :data:`PRIVATE_MIN_CHUNK`), each
    block a run of ``chunk`` entries (a multiple of 4), 256 threads,
    shared memory for 8 copies of the outputs (one a warp) while they fit
    in :data:`WARP_COPY_BYTES`, else one. ``tiles`` is (entries a block,
    n_local, copies). It fits a block up to n_local
    :data:`PRIVATE_MAX_LOCAL`; what picks it is
    :func:`reduce_received_plan`."""
    most = -(-TARGET_BLOCKS // max(s, 1))
    chunks = max(1, min(-(-m // PRIVATE_MIN_CHUNK), most))
    each = -(-m // chunks)
    chunk = -(-each // 4) * 4 if each > 1 else 4
    copies = 8 if 8 * n_local * 4 <= WARP_COPY_BYTES else 1
    return LaunchPlan("private", (chunk, n_local, copies), (chunks, s, 1),
                      256, 1, 4 * copies * n_local)


def reduce_received_plan(s: int, m: int, n_local: int, aligned: bool = True
                         ) -> LaunchPlan:
    """The design and launch of ``reduce_received`` on ``[s, m]`` entries
    into ``[s, n_local]``: :func:`private_plan` for ``1 <= n_local <=
    PRIVATE_MAX_LOCAL`` on 16-byte aligned inputs, else ``atomic``: one
    thread an entry, grid (ceil(m / 256), s), ``tiles`` (256, n_local,
    1). Negative sizes raise."""
    if min(s, m, n_local) < 0:
        raise ValueError(f"sizes must be >= 0, got s={s} m={m} "
                         f"n_local={n_local}")
    if aligned and 1 <= n_local <= PRIVATE_MAX_LOCAL:
        return private_plan(s, m, n_local)
    return LaunchPlan("atomic", (THREADS, n_local, 1),
                      (-(-m // THREADS), s, 1), THREADS, 1, 0)


# ---------------------------------------------------------------------------
# the kernel wrappers
# ---------------------------------------------------------------------------

def _launch_rank(dest, valid_u8, n_buckets):
    from ._build import library
    s, n = dest.shape
    pos = torch.empty(s, n, dtype=torch.int32, device=dest.device)
    if s == 0 or n == 0:
        return pos
    plan = bucket_rank_plan(s, n, n_buckets)
    status = torch.empty(rank_scratch_ints(plan), dtype=torch.int32,
                         device=dest.device)
    _raise_on(library("route").dcra_bucket_rank(
        dest.data_ptr(), valid_u8.data_ptr(), s, n, n_buckets,
        status.data_ptr(), pos.data_ptr(),
        as_c(plan, PATH_CODES["bucket_rank"][plan.path]),
        _stream(dest.device)), "bucket_rank")
    LAUNCHES["bucket_rank"] += 1
    PATHS["bucket_rank"][plan.path] += 1
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
    ``xb`` and -1 in ``ints``; ``task_slot`` is -1 for a dropped task.
    The design follows :func:`bucket_scatter_plan`; both give the same
    bits."""
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
    plan = bucket_scatter_plan(s, n, d, k, n_buckets, cap)
    rank = scratch = None
    if plan.path == "staged":
        scratch = torch.empty(s * (plan.grid[0] + 1) * n_buckets,
                              dtype=torch.int32, device=dev)
    else:
        rank = _launch_rank(dest, valid_u8, n_buckets)
    aux = (aux_ints[0][None] if k == 1 else torch.stack(aux_ints)) if k else None
    xb = torch.empty(s, total, d, dtype=torch.float32, device=dev)
    ints = torch.empty(k, s, total, dtype=torch.int32, device=dev)
    task_slot = torch.empty(s, n, dtype=torch.int32, device=dev)
    n_drop = torch.empty(s, dtype=torch.int32, device=dev)
    _raise_on(lib.dcra_bucket_scatter(
        x.data_ptr(), dest.data_ptr(), valid_u8.data_ptr(),
        aux.data_ptr() if k else None,
        None if rank is None else rank.data_ptr(), s, n, d, k, n_buckets,
        cap, xb.data_ptr(), ints.data_ptr() if k else None,
        task_slot.data_ptr(), n_drop.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        as_c(plan, PATH_CODES["bucket_scatter"][plan.path]), _stream(dev)),
        "bucket_scatter")
    LAUNCHES["bucket_scatter"] += 1
    PATHS["bucket_scatter"][plan.path] += 1
    return xb, list(ints.unbind(0)), task_slot, n_drop


def reduce_received(recv_slot, recv_val, n_local, op):
    """Fold received ``(slot, value)`` pairs ``[S, M]`` into ``[S,
    n_local]`` float32 by ``add`` (empty 0), ``min`` (empty +inf) or
    ``store`` (the largest value wins, empty 0). Slots outside
    ``[0, n_local)`` are ignored; a slot that received a NaN reads +inf
    under min and 0 under store, NaN under add. The design follows
    :func:`reduce_received_plan`."""
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
    plan = reduce_received_plan(s, m, n_local,
                                _aligned(recv_slot, recv_val))
    y = torch.empty(s, n_local, dtype=torch.float32, device=recv_slot.device)
    _raise_on(library("route").dcra_reduce_received(
        recv_slot.data_ptr(), recv_val.data_ptr(), s, m, n_local,
        REDUCE_OPS.index(op), y.data_ptr(),
        as_c(plan, PATH_CODES["reduce_received"][plan.path]),
        _stream(recv_slot.device)), "reduce_received")
    LAUNCHES["reduce_received"] += 1
    PATHS["reduce_received"][plan.path] += 1
    return y
