"""The routing kernels' share of their bytes-bound time, in percent: the
least time the HBM needs for the bytes the window's rounds must move
through the rank, scatter and reduce kernels (each input byte read once,
each output byte written once, at 3.35e12 B/s), over those kernels'
device time in the trace.

A flat owner-routed round on ``S`` shards buckets ``N = E_max`` tasks a
shard (``valid``, ``task_slot``: every task; ``dest``, the float32
payload, the slot column: the round's active tasks) into ``S`` buckets of
``cap`` slots (every slot's payload and slot column written once), and
folds the ``S * S * cap`` received entries (every entry's slot read, the
value of each kept one) into ``n_local`` outputs a shard."""
import math

from dcra_bench.trace import is_port_kernel

HBM_BYTES_PER_S = 3.35e12           # H100 SXM, NVIDIA's data sheet, 700 W
ROUTE_KERNELS = ("rank_lookback_kernel", "fill_kernel", "scatter_kernel",
                 "staged_count_kernel", "staged_scan_kernel",
                 "staged_fill_kernel", "staged_place_kernel",
                 "reduce_init_kernel", "reduce_kernel",
                 "reduce_private_kernel", "reduce_finish_kernel")


def round8(x: int) -> int:
    return max(8, -(-x // 8) * 8)


def flat_cap(e_max: int, shards: int, factor: float) -> int:
    """The port's bucket capacity of a flat round (``QueueConfig``'s
    factor rule, clamped at a shard's tasks)."""
    return min(round8(int(e_max * factor / shards)), max(1, e_max))


def scatter_bytes(s, n, buckets, cap, d, k, valid) -> int:
    return (s * n * (1 + 4) + valid * (4 + 4 * d + 4 * k)
            + s * buckets * cap * (4 * d + 4 * k) + 4 * s)


def reduce_bytes(entries, kept, outputs) -> int:
    return entries * 4 + kept * 4 + outputs * 4


def round_bytes(w, active, dropped) -> int:
    s, e_max = w["shards"], w["e_max"]
    cap = flat_cap(e_max, s, w["capacity_factor"])
    n_local = -(-w["n"] // s)
    return (scatter_bytes(s, e_max, s, cap, 1, 1, active)
            + reduce_bytes(s * s * cap, active - dropped, s * n_local))


def is_route_kernel(name: str) -> bool:
    return any(is_port_kernel(name, k) for k in ROUTE_KERNELS)


def read(run):
    if run.trace is None or "messages" not in run.work:
        return None
    w = run.work
    total = sum(round_bytes(w, int(m), int(d))
                for ms, ds in zip(w["messages"], w["drops"])
                for m, d in zip(ms, ds))
    seconds = run.trace.device_seconds(is_route_kernel)
    if not seconds or not math.isfinite(seconds):
        return None
    return 100.0 * total / HBM_BYTES_PER_S / seconds
