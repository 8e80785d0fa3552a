"""Collectives across processes for a distributed :class:`Fabric`
(counterpart of the ``jax.distributed`` layer under
``repro/core/fabric.py:134-166`` and ``repro/sparse/program.py:311-337``).

The processes join one ``torch.distributed`` group over gloo. Every
collective here runs on CPU tensors: a value on the card is staged
through pinned host memory with one device-to-host copy, exchanged over
gloo, and copied back with one host-to-device copy. Staging keeps the
behaviour independent of whether a gloo build can exchange CUDA tensors,
and it is what lets two processes share one card, where NCCL refuses two
ranks on one device.

:class:`ProcessExchange` is the fabric's all_to_all: the tiled exchange
of :func:`repro_torch.core.routing.noc_all_to_all` over shards spread
over processes. The blocks whose destination shard lives in this process
are permuted locally; only the others cross, in one ``all_to_all_single``
a call. Every process must issue the same collectives in the same order.
The exchange is differentiable: the tiled all_to_all is its own inverse
(block ``b`` of shard ``g`` lands in shard ``b``'s block ``g``), so its
backward is the same exchange of the gradient. :meth:`ProcessExchange.agree`
settles a decision every process must make alike (one that reads a clock
or the card): rank 0's value, broadcast.
"""
from __future__ import annotations

import math
import time
from datetime import timedelta
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


def join_process_group(coordinator_address: Optional[str],
                       num_processes: Optional[int],
                       process_id: Optional[int], timeout: float,
                       axis_shapes: Optional[Sequence[int]] = None
                       ) -> Tuple[int, int]:
    """``(world size, rank)`` of the gloo group, joined at
    ``tcp://coordinator_address`` unless one is already initialised (then
    reused; it must be gloo, of ``num_processes`` if given). A shard
    count ``prod(axis_shapes)`` that does not split over the world raises
    ``ValueError`` before anything is joined."""
    import torch.distributed as dist
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        if dist.get_backend() != "gloo":
            raise ValueError(f"the initialised process group runs "
                             f"{dist.get_backend()}, not gloo")
        if num_processes is not None and int(num_processes) != world:
            raise ValueError(f"num_processes={num_processes}, but the "
                             f"initialised group has {world}")
    else:
        if coordinator_address is None or num_processes is None \
                or process_id is None:
            raise ValueError("coordinator_address, num_processes and "
                             "process_id are needed to join a group")
        world, rank = int(num_processes), int(process_id)
    if axis_shapes is not None and math.prod(axis_shapes) % world:
        raise ValueError(f"{math.prod(axis_shapes)} shards {tuple(axis_shapes)}"
                         f" do not split over {world} processes")
    if not dist.is_initialized():
        dist.init_process_group("gloo",
                                init_method=f"tcp://{coordinator_address}",
                                world_size=world, rank=rank,
                                timeout=timedelta(seconds=float(timeout)))
    return world, rank


def exchange_plan(shape: Tuple[int, ...], dims: Tuple[int, ...],
                  n_processes: int, process_index: int) -> dict:
    """Where every block of this process's wire goes in the tiled
    all_to_all over fabric dims ``dims`` of ``shape``, with the shards
    process-major (``L = prod(shape) / n_processes`` a process).

    Shard ``g`` sends its block ``b`` (peer coordinates along ``dims``) to
    the shard ``h`` whose coordinates are ``g``'s with ``dims`` set to
    ``b``; it lands in ``h``'s block at ``g``'s coordinates along
    ``dims``. Blocks are numbered ``shard * B + block`` (``B`` peers).
    Returns numpy arrays, local numbering (``lo * B`` subtracted):
    ``local_src``/``local_dst`` (blocks that stay), ``send`` (the blocks
    that leave, ordered by destination process, then destination block)
    with ``send_splits``, and ``recv_dst`` (where arriving blocks go, in
    arrival order) with ``recv_splits``."""
    n_shards = math.prod(shape)
    per = n_shards // n_processes
    peers = [shape[d] for d in dims]
    n_blocks = math.prod(peers)
    lo = process_index * per
    coords = np.indices(shape).reshape(len(shape), -1).T
    g = np.repeat(np.arange(n_shards), n_blocks)
    b = np.tile(np.arange(n_blocks), n_shards)
    hc = coords[g]
    hc[:, list(dims)] = np.stack(np.unravel_index(b, peers), 1)
    h = np.ravel_multi_index(hc.T, shape)
    pos = np.ravel_multi_index(coords[g][:, list(dims)].T, peers)
    dst = h * n_blocks + pos
    src_proc, dst_proc = g // per, h // per
    mine = src_proc == process_index
    stay = mine & (dst_proc == process_index)
    leave = np.flatnonzero(mine & ~stay)
    leave = leave[np.lexsort((dst[leave], dst_proc[leave]))]
    arrive = np.flatnonzero(~mine & (dst_proc == process_index))
    arrive = arrive[np.lexsort((dst[arrive], src_proc[arrive]))]
    off = lo * n_blocks
    src = g * n_blocks + b
    return {
        "blocks": n_blocks,
        "local_src": src[stay] - off, "local_dst": dst[stay] - off,
        "send": src[leave] - off,
        "send_splits": np.bincount(dst_proc[leave],
                                   minlength=n_processes).tolist(),
        "recv_dst": dst[arrive] - off,
        "recv_splits": np.bincount(src_proc[arrive],
                                   minlength=n_processes).tolist(),
    }


class ProcessExchange:
    """A distributed fabric's collectives over gloo (see the module
    docstring). ``stats`` adds up, over the all_to_all calls since the
    last :meth:`reset_stats`: ``calls``, ``bytes_out`` (what this process
    sent across the boundary), and the host seconds of ``wait_s`` (the
    card finishing the work queued before the exchange), ``d2h_s``,
    ``gloo_s`` and ``h2d_s``; and over the :meth:`agree` calls,
    ``agree_calls`` and their host seconds ``agree_s``."""

    def __init__(self, fabric):
        self.fabric = fabric
        self.device = fabric.device
        self._cuda = fabric.device.type == "cuda"
        self._index: Dict[tuple, dict] = {}
        self.stats: Dict[str, float] = {}
        self.reset_stats()

    def reset_stats(self) -> None:
        self.stats = {"calls": 0, "bytes_out": 0, "wait_s": 0.0,
                      "d2h_s": 0.0, "gloo_s": 0.0, "h2d_s": 0.0,
                      "agree_calls": 0, "agree_s": 0.0}

    def _plan(self, shape, dims) -> dict:
        key = (shape, dims)
        plan = self._index.get(key)
        if plan is None:
            np_plan = exchange_plan(shape, dims, self.fabric.n_processes,
                                    self.fabric.process_index)
            plan = dict(np_plan)
            for k in ("local_src", "local_dst", "send", "recv_dst"):
                plan[k] = torch.from_numpy(np_plan[k]).to(self.device)
            self._index[key] = plan
        return plan

    def __call__(self, x: torch.Tensor, shape: Sequence[int],
                 dims: Sequence[int]) -> torch.Tensor:
        """The tiled all_to_all of ``x [L, B*rows, C]`` (this process's
        shards; ``shape`` the global fabric shape of the round, ``dims``
        the axes exchanged over): shard ``d`` receives block ``d`` of
        every peer, in peer order, as the local transpose does on one
        process. Differentiable: the gradient takes the same exchange."""
        shape = tuple(int(s) for s in shape)
        dims = tuple(int(d) for d in dims)
        if torch.is_grad_enabled() and x.requires_grad:
            return _Exchange.apply(x, self, shape, dims)
        return self._exchange(x, shape, dims)

    def _exchange(self, x: torch.Tensor, shape: Tuple[int, ...],
                  dims: Tuple[int, ...]) -> torch.Tensor:
        import torch.distributed as dist
        plan = self._plan(shape, dims)
        n_loc, total, c = x.shape
        nb = plan["blocks"]
        xb = x.reshape(n_loc * nb, (total // nb) * c)
        out = torch.empty_like(xb)
        out.index_copy_(0, plan["local_dst"],
                        xb.index_select(0, plan["local_src"]))
        if len(plan["send"]) == 0 and len(plan["recv_dst"]) == 0:
            return out.view(n_loc, total, c)
        st = self.stats
        send = xb.index_select(0, plan["send"])
        t0 = time.perf_counter()
        host_send = send
        if self._cuda:
            torch.cuda.current_stream(self.device).synchronize()
        t1 = time.perf_counter()
        if self._cuda:
            host_send = torch.empty(send.shape, dtype=send.dtype,
                                    pin_memory=True).copy_(send)
        t2 = time.perf_counter()
        host_recv = torch.empty((len(plan["recv_dst"]), xb.shape[1]),
                                dtype=xb.dtype, pin_memory=self._cuda)
        dist.all_to_all_single(host_recv, host_send,
                               output_split_sizes=plan["recv_splits"],
                               input_split_sizes=plan["send_splits"])
        t3 = time.perf_counter()
        recv = host_recv.to(self.device)
        t4 = time.perf_counter()
        out.index_copy_(0, plan["recv_dst"], recv)
        st["calls"] += 1
        st["bytes_out"] += send.numel() * send.element_size()
        st["wait_s"] += t1 - t0
        st["d2h_s"] += t2 - t1
        st["gloo_s"] += t3 - t2
        st["h2d_s"] += t4 - t3
        return out.view(n_loc, total, c)

    def agree(self, value, pick=None):
        """One decision, the same on every process: rank 0's ``value``
        (a picklable object), broadcast over gloo. With ``pick``, every
        process's value is gathered and ``pick(values)``, a function of
        the list in rank order, decides on each. Every process calls it
        at the same point of its program."""
        import torch.distributed as dist
        t0 = time.perf_counter()
        if pick is None:
            box = [value]
            dist.broadcast_object_list(box, src=0)
            got = box[0]
        else:
            values = [None] * self.fabric.n_processes
            dist.all_gather_object(values, value)
            got = pick(values)
        self.stats["agree_calls"] += 1
        self.stats["agree_s"] += time.perf_counter() - t0
        return got

    def all_reduce(self, x: torch.Tensor, op: str) -> torch.Tensor:
        """``x`` reduced over the processes by ``op`` (``"sum"`` or
        ``"max"``), on ``x``'s device; gloo reduces in one order for
        every rank, so every process gets the same value."""
        import torch.distributed as dist
        host = x.detach().to("cpu", copy=True)
        dist.all_reduce(host, op={"sum": dist.ReduceOp.SUM,
                                  "max": dist.ReduceOp.MAX}[op])
        return host.to(x.device)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every process's ``x [L, ...]`` concatenated in process order:
        ``[n_processes * L, ...]`` on ``x``'s device. Not differentiable:
        the fabric's collectives carry the gradient around it."""
        import torch.distributed as dist
        host = x.detach().to("cpu").contiguous()
        parts = [torch.empty_like(host)
                 for _ in range(self.fabric.n_processes)]
        dist.all_gather(parts, host)
        return torch.cat(parts).to(x.device)


class _Exchange(torch.autograd.Function):
    """:meth:`ProcessExchange.__call__` under autograd: the exchange of
    the gradient with the same plan is the backward (the all_to_all is an
    involution)."""

    @staticmethod
    def forward(ctx, x, xchg, shape, dims):
        ctx.xchg, ctx.shape, ctx.dims = xchg, shape, dims
        return xchg._exchange(x, shape, dims)

    @staticmethod
    def backward(ctx, g):
        return (ctx.xchg._exchange(g.contiguous(), ctx.shape, ctx.dims),
                None, None, None)
