"""The ``bucket_scatter`` kernels' share of their bytes-bound time in the
MoE layers, in percent: the least time the HBM needs for the bytes the
window's steps must move through them in every layer (at 3.35e12 B/s,
H100 SXM, NVIDIA's data sheet, 700 W) over their device time in the
trace.

The layer buckets two task streams a step, each with a one-column
float32 payload (the rows themselves move through ``gather_rows``, not
this kernel). On the fused packaging (no pod axis: ``S`` shards, a
dispatch group of ``G`` shards, ``T_l`` tokens a shard):

* dispatch: ``T_l K`` tasks a shard, all valid, into ``G`` buckets, with
  two int columns (local expert, source token);
* expert: the ``G cap_1`` received slots a shard, valid where a task
  arrived (``T K`` in all, dropless), into ``E / G`` buckets, one int
  column (the received slot).

Bytes of a stream: ``valid`` and ``task_slot`` of every task; ``dest``,
the payload and the int columns of each valid one; every slot's payload
and int columns written once; ``n_drop``."""
import math

from dcra_bench.trace import is_port_kernel

HBM_BYTES_PER_S = 3.35e12
SCATTER_KERNELS = ("fill_kernel", "scatter_kernel", "staged_count_kernel",
                   "staged_scan_kernel", "staged_fill_kernel",
                   "staged_place_kernel", "rank_lookback_kernel")


def round8(x: int) -> int:
    return max(8, -(-x // 8) * 8)


def scatter_bytes(s, n, buckets, cap, d, k, valid) -> int:
    return (s * n * (1 + 4) + valid * (4 + 4 * d + 4 * k)
            + s * buckets * cap * (4 * d + 4 * k) + 4 * s)


def step_bytes(cfg, traffic) -> int:
    """Both streams of one layer of a step on the fused packaging."""
    shape = dict(zip(cfg["packaging"]["axes"], cfg["packaging"]["shape"]))
    s = math.prod(shape.values())
    group = shape["expert"] * shape.get("tp", 1)
    k, e = cfg["num_experts_per_tok"], cfg["num_experts"]
    tokens = traffic["batch"] * traffic["seq_len"]
    t_l = tokens // s
    q = cfg["queue_factors"]
    n1 = t_l * k
    cap1 = round8(int(n1 * q["dispatch"] / group))
    n2 = group * cap1
    e_local = e // group
    cap2 = round8(int(n2 * q["expert"] / e_local))
    return (scatter_bytes(s, n1, group, cap1, 1, 2, s * n1)
            + scatter_bytes(s, n2, e_local, cap2, 1, 1, tokens * k))


def is_scatter_kernel(name: str) -> bool:
    return any(is_port_kernel(name, k) for k in SCATTER_KERNELS)


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.device_seconds(is_scatter_kernel)
    if not seconds or not run.work.get("steps"):
        return None
    total = (run.work["steps"] * run.work["layers"]
             * step_bytes(run.config, run.traffic))
    return 100.0 * total / HBM_BYTES_PER_S / seconds
