"""DCRA task-routed MoE dispatch on virtual shards (counterpart of
``repro/core/dispatch.py:39-297``).

Tokens are task invocations, experts the tiles that own data, top-k
routing is task spawning and expert capacity the input-queue size:
tasks past a bucket's capacity are dropped and the residual carries
their tokens. The dispatch all_to_all is the NoC; when the experts span
pods it runs in two stages, over the intra-pod group (tile-NoC) to the
per-pod portal and then once over the pod axis (die-NoC).

The reference runs its body under ``shard_map``; here every shard's
tensors are stacked on the leading dimension of one device, as
``sparse/program.py`` does: :meth:`Fabric.shard` cuts the inputs by
the reference's partition specs, the collectives are
:meth:`Fabric.all_gather` / :meth:`Fabric.psum` and the transpose
:func:`~repro_torch.core.routing.noc_all_to_all`, and
:meth:`Fabric.unshard` puts the output back together. On a distributed
fabric every process is handed the same global ``x`` and holds its own
shards' rows: it routes, dispatches and computes them, the exchanges go
through the fabric's :attr:`~Fabric.exchange`, and ``out`` and ``aux``
come back global on every process, with the one-process gradient.

The buckets go through :func:`~repro_torch.core.routing.bucket`, whose
``"pallas"`` impl launches the ``bucket_scatter`` kernels on the card
(their staged design ranks the tasks in its own launches). The expert FFN is a batched ``torch.matmul``, as the reference
computes it with einsums outside any Pallas kernel.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch

from ..models.common import swiglu
from ..models.moe import topk
from . import trace
from .fabric import Fabric
from .queues import QueueConfig
from .routing import (bucket, fused_all_to_all, gather_rows, inverse_map,
                      noc_all_to_all, resolve_route_impl, slot_scatter, sum_k)


def dispatch_queues(moe_cfg) -> QueueConfig:
    """The MoE dispatch IQ sizing: the three bounded buckets ("dispatch",
    "portal", "expert") at the config's capacity factor."""
    return QueueConfig.for_moe_dispatch(moe_cfg.capacity_factor)


@dataclass(frozen=True)
class MeshInfo:
    """How the MoE layer maps onto a virtual-shard :class:`Fabric` (the
    reference's ``MeshInfo`` over a device mesh)."""
    mesh: Fabric
    data_axis: str = "data"
    expert_axis: str = "expert"
    tp_axis: str = "tp"
    pod_axis: Optional[str] = None       # set on the multi-pod fabric
    hierarchical: bool = True            # 2-stage a2a when experts span pods
    fsdp: bool = True                    # expert weights sharded over data
    fuse_tp: bool = True                 # fold tp into the expert group

    def __post_init__(self):
        if not isinstance(self.mesh, Fabric):
            raise TypeError(f"MeshInfo takes a repro_torch Fabric, got "
                            f"{type(self.mesh).__name__}")

    def axis_size(self, name) -> int:
        if isinstance(name, list):
            name = tuple(name)
        return self.mesh.axis_size(name)

    def all_axes(self) -> Tuple[str, ...]:
        return tuple(self.mesh.axis_names)

    def dispatch_plan(self, num_experts: int):
        """``(group_axes_in_pod, spans_pods, tp_shards_ffn)``: the axes
        whose shards each own ``E / n`` experts (the stage-1 group),
        whether stage 2 over the pod axis is needed, and whether the
        expert FFN is tp-sharded (tp not in the group)."""
        n_pod = self.axis_size(self.pod_axis)
        has_pod = self.pod_axis is not None and n_pod > 1
        cands = []
        if self.fuse_tp:
            if has_pod and self.hierarchical:
                cands.append(((self.expert_axis, self.tp_axis), True))
            cands.append(((self.expert_axis, self.tp_axis), False))
        if has_pod and self.hierarchical:
            cands.append(((self.expert_axis,), True))
        cands.append(((self.expert_axis,), False))
        for group, spans in cands:
            total = self.axis_size(group) * (n_pod if spans else 1)
            if num_experts % total == 0:
                return group, spans, self.tp_axis not in group
        return (self.expert_axis,), False, True


@dataclass
class DispatchStats:
    """What one :func:`moe_dcra` call routed, per shard (``S`` leading).

    ``topk_ids [S, T_l, K]`` are the global expert ids in the order the
    tasks were spawned; ``buckets[stage] = (admitted, dropped)``, each
    ``[S, n_buckets]`` int64, for the stages "dispatch", "portal" (pod
    path) and "expert" (when a shard owns more than one expert);
    ``caps[stage]`` the capacity of each. ``expert_rows [S, E_local *
    cap_e, D]`` are the expert-bucketed, capacity-padded rows the expert
    FFN takes (``None`` when ``E_local == 1``); local expert ``j`` of
    shard ``s`` is global expert ``expert_base[s] + j``."""
    topk_ids: torch.Tensor
    buckets: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = field(
        default_factory=dict)
    caps: Dict[str, int] = field(default_factory=dict)
    e_local: int = 1
    expert_base: Optional[torch.Tensor] = None
    expert_rows: Optional[torch.Tensor] = None

    @property
    def total_dropped(self) -> int:
        return int(sum(int(d.sum()) for _, d in self.buckets.values()))


def _bucket_counts(dest, valid, task_slot, n_buckets):
    """``(admitted, dropped)`` per (shard, bucket): ``[S, n_buckets]``."""
    s = dest.shape[0]
    idx = (dest.long().clamp(0, n_buckets - 1)
           + torch.arange(s, device=dest.device)[:, None] * n_buckets)
    kept = valid & (task_slot >= 0)

    def count(mask):
        return torch.bincount(idx[mask], minlength=s * n_buckets).view(
            s, n_buckets)
    return count(kept), count(valid & ~kept)


def _expert_ffn(xe, wg, wu, wd, fab: Fabric, tp_axis, n_tp):
    """xe [S, E_l, C, D]; wg/wu [S, E_l, D, F_l]; wd [S, E_l, F_l, D] ->
    [S, E_l, C, D]; with a tp-sharded F the partial sums add over tp.
    Traced as ``moe.ffn``."""
    with trace.span("moe.ffn"):
        dt = xe.dtype
        h = swiglu(torch.matmul(xe, wg.to(dt)), torch.matmul(xe, wu.to(dt)))
        y = torch.matmul(h, wd.to(dt))
        if n_tp > 1:
            y = fab.psum(y, tp_axis)
        return y


def combine(yb1: torch.Tensor, slot_of_task: torch.Tensor,
            gates_f: torch.Tensor, k: int) -> torch.Tensor:
    """The combine at the source (``repro/core/dispatch.py:272-275``):
    each task's returned row (its slot in ``yb1``; -1, dropped: a zero
    row) weighted by its gate, and token t's tasks ``t*k .. t*k+k-1``
    added in k order from zeros, as the reference's ``segment_sum`` adds
    them on the CPU. ``yb1 [S, N, D]``, ``slot_of_task`` and ``gates_f
    [S, T*k]`` -> float32 ``[S, T, D]``. No accumulate-by-index op runs,
    forward or backward, so the sums repeat bit for bit on the card."""
    s, n, d = yb1.shape
    rows = gather_rows(yb1, slot_of_task, inverse_map(slot_of_task, n))
    task_y = torch.where((slot_of_task >= 0)[..., None], rows, 0.0).float()
    return sum_k((task_y * gates_f[..., None]).view(s, -1, k, d))


def moe_dcra(params, x: torch.Tensor, cfg, info: MeshInfo,
             queues: Optional[QueueConfig] = None,
             return_stats: bool = False):
    """DCRA owner-routed dispatch. x [B, S, D] -> (out [B, S, D], aux []),
    and a :class:`DispatchStats` third when ``return_stats``.

    ``queues`` overrides the dispatch queue sizing; the default derives
    it from ``cfg.moe.capacity_factor`` (:func:`dispatch_queues`).

    Traced as ``moe``, with ``moe.route`` (router, top-k, the buckets and
    the gathers before the FFN), ``moe.ffn``, ``moe.combine`` (the
    return, the combine, aux and the output's layout) and the ``wire``
    spans of the exchanges inside it; the shards' copies of ``x`` and
    the weights and the statistics are the root's own.
    """
    with trace.span("moe"):
        return _moe_dcra(params, x, cfg, info, queues, return_stats)


def _moe_dcra(params, x, cfg, info, queues, return_stats):  # noqa: PLR0917
    mc = cfg.moe
    if mc is None:
        raise ValueError(f"{cfg.name} has no MoE config")
    if queues is None:
        queues = dispatch_queues(mc)
    impl = resolve_route_impl(queues.route_impl)
    fab = info.mesh
    xchg = fab.exchange                 # None on a virtual fabric
    if x.device != fab.device:
        raise ValueError(f"x is on {x.device}, the fabric on {fab.device}")
    E, K = mc.num_experts, mc.top_k
    group, spans_pods, tp_ffn = info.dispatch_plan(E)
    n_ex = info.axis_size(group)
    n_pod = info.axis_size(info.pod_axis) if spans_pods else 1
    E_local = E // (n_ex * n_pod)
    n_tp = info.axis_size(info.tp_axis) if tp_ffn else 1

    batch_ax = ((info.pod_axis, info.data_axis) if info.pod_axis
                else info.data_axis)

    def _div(n, ax):
        return ax is not None and n % info.axis_size(ax) == 0

    b_in, s_in, _ = x.shape
    if not _div(b_in, batch_ax):       # tiny-batch decode fallbacks
        batch_ax = info.data_axis if _div(b_in, info.data_axis) else None
    # preferred: seq sharded over the whole dispatch group (+tp when the
    # FFN is tp-split), so tokens arrive distinct on every shard
    grp = tuple(group)
    seq_group = grp + ((info.tp_axis,) if tp_ffn else ())
    if _div(s_in, seq_group):
        seq_ax, seq_mode = seq_group, "group"
    elif _div(s_in, info.tp_axis) and info.axis_size(info.tp_axis) > 1:
        seq_ax, seq_mode = info.tp_axis, "tp"
    else:
        seq_ax, seq_mode = None, None
    x_spec = (batch_ax, seq_ax, None)
    e_dim = ((info.pod_axis,) + grp) if spans_pods else grp
    f_axis = info.tp_axis if tp_ffn else None
    d_axis = info.data_axis if info.fsdp else None

    # ---- the shard_map boundary: per-shard blocks --------------------
    # (S below is this process's shard count: all of them on a virtual
    # fabric)
    xb = fab.shard(x, x_spec)                                # [S, b, s, D]
    wg = fab.shard(params["wg"], (e_dim, d_axis, f_axis))
    wu = fab.shard(params["wu"], (e_dim, d_axis, f_axis))
    wd = fab.shard(params["wd"], (e_dim, f_axis, d_axis))
    # the router replicated a shard: its gradient is summed over the
    # shards in shard order on every fabric
    router = fab.shard(params["router"], (None, None))      # [S, D, E]
    S, dev = fab.n_local_shards, x.device

    tp_gather = tp_ffn and n_tp > 1 and seq_mode is not None
    if tp_gather:
        # the FFN is tp-split on F: every tp rank needs the same tokens
        xb = fab.all_gather(xb, info.tp_axis, 1)
    b_l, s_l, D = xb.shape[1:]
    T_l = b_l * s_l
    xf = xb.reshape(S, T_l, D)
    # outside "group" seq mode the tokens are replicated over the expert
    # axis: each expert rank dispatches its 1/n_ex slice, re-gathered after
    n_slice = info.axis_size(info.expert_axis)
    do_slice = seq_mode != "group" and n_slice > 1 and T_l % n_slice == 0
    if do_slice:
        T_l //= n_slice
        xf = fab.shard_slice(xf, info.expert_axis, 0)
    if info.fsdp:
        wg = fab.all_gather(wg, info.data_axis, 1)
        wu = fab.all_gather(wu, info.data_axis, 1)
        wd = fab.all_gather(wd, info.data_axis, 2)

    with trace.span("moe.route"):
        # ---- routing (task spawning) --------------------------------------
        logits = torch.matmul(xf.float(), router.float())        # [S, T_l, E]
        probs = torch.softmax(logits, dim=-1)
        gates, eids = topk(probs, K)                             # [S, T_l, K]
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        eids_f = eids.reshape(S, T_l * K).to(torch.int32)
        gates_f = gates.reshape(S, T_l * K).float()
        src_f = torch.arange(T_l, device=dev, dtype=torch.int32
                             ).repeat_interleave(K).expand(S, -1).contiguous()
        owner = eids_f // E_local                                # global shard
        cap1 = queues.channel_cap("dispatch", T_l * K, n_ex)
        all_valid = torch.ones(S, T_l * K, dtype=torch.bool, device=dev)
        group_dims = fab.axis_dims(grp)
        seen = {}

        def _route(stage, dest, valid, aux, n_buckets, cap):
            # the buckets carry only their int columns: a zero f32 payload
            dummy = torch.zeros(S, dest.shape[1], 1, device=dev)
            _, ints, task_slot, _ = bucket(dummy, dest, valid, aux, n_buckets,
                                           cap, impl=impl)
            if return_stats:
                seen[stage] = (dest, valid, task_slot, n_buckets, cap)
            return ints, task_slot

        # Every gather below passes its inverse (each row's readers in order:
        # a bucket's task_slot), so its gradient is gathered back and added
        # in a fixed order; token t's K tasks are t*K..t*K+K-1 (src_f).
        if not spans_pods:
            # ---- single-stage fused a2a (tile-NoC) ------------------------
            (eid1, tok1), slot_of_task = _route(
                "dispatch", owner, all_valid, [eids_f % E_local, src_f], n_ex,
                cap1)
            xb1 = gather_rows(xf, tok1, slot_of_task, K)
            xr, (eidr,) = fused_all_to_all(xb1, [eid1], fab.shape, group_dims,
                                           xchg)
        else:
            # ---- stage 1 over the group (tile-NoC) ------------------------
            e_coord = owner % n_ex
            p_coord = owner // n_ex
            (pc1, eid1, tok1), slot_of_task = _route(
                "dispatch", e_coord, all_valid,
                [p_coord, eids_f % E_local, src_f], n_ex, cap1)
            xb1 = gather_rows(xf, tok1, slot_of_task, K)
            xs1, (pcs, eids1) = fused_all_to_all(xb1, [pc1, eid1], fab.shape,
                                                 group_dims, xchg)
            n1 = xs1.shape[1]
            # ---- stage 2 over the pod axis (die-NoC portal) ---------------
            cap2 = queues.channel_cap("portal", n1, n_pod)
            arange1 = torch.arange(n1, device=dev, dtype=torch.int32).expand(
                S, -1).contiguous()
            (eid2, slot1_of_s2), slot2_of_s1 = _route(
                "portal", pcs.clamp(min=0), pcs >= 0, [eids1, arange1], n_pod,
                cap2)
            xb2 = gather_rows(xs1, slot1_of_s2, slot2_of_s1)
            xr, (eidr,) = fused_all_to_all(xb2, [eid2], fab.shape,
                                           fab.axis_dims(info.pod_axis), xchg)

        N_r = xr.shape[1]
        validr = eidr >= 0
        xe = None
        if E_local > 1:
            # second-level IQ: bucket the received tasks by local expert
            cap_e = queues.channel_cap("expert", N_r, E_local)
            arange_r = torch.arange(N_r, device=dev, dtype=torch.int32).expand(
                S, -1).contiguous()
            (srce,), slote_of_r = _route("expert", eidr.clamp(min=0), validr,
                                         [arange_r], E_local, cap_e)
            xe = gather_rows(xr, srce, slote_of_r)

    # ---- local expert execution (the owner computes) -----------------
    if E_local == 1:
        ye = _expert_ffn(xr[:, None].to(xb.dtype), wg, wu, wd, fab,
                         info.tp_axis, n_tp)[:, 0]
    else:
        ye = _expert_ffn(xe.view(S, E_local, cap_e, D).to(xb.dtype),
                         wg, wu, wd, fab, info.tp_axis, n_tp)

    with trace.span("moe.combine"):
        if E_local == 1:
            ye = ye * validr[..., None].to(ye.dtype)
        else:
            ye = slot_scatter(ye.reshape(S, E_local * cap_e, D),
                              srce.clamp(min=0), srce >= 0, N_r)

        # ---- return path (retrace the NoC route) -------------------------
        if not spans_pods:
            yb1 = noc_all_to_all(ye, fab.shape, group_dims, xchg)
        else:
            y2 = noc_all_to_all(ye, fab.shape, fab.axis_dims(info.pod_axis),
                                xchg)
            y1 = slot_scatter(y2, slot1_of_s2.clamp(min=0), slot1_of_s2 >= 0,
                              n1)
            yb1 = noc_all_to_all(y1, fab.shape, group_dims, xchg)

        out = combine(yb1, slot_of_task, gates_f, K)       # [S, T_l, D] f32

        # aux: load-balance loss, averaged over all shards (every shard's
        # value gathered, so the mean adds them in one order on any fabric)
        frac = torch.nn.functional.one_hot(eids, E).float().sum(2).mean(1)
        aux = fab.unshard((E * (frac * probs.mean(1)).sum(-1))[:, None],
                          (fab.axis_names,)).mean()
        out = out.view(S, T_l, D)
        if do_slice:   # restore the expert-replicated layout
            out = fab.all_gather(out, info.expert_axis, 0)
        out = out.reshape(S, b_l, s_l, D).to(x.dtype)
        if tp_gather:  # back to this rank's seq shard
            out = fab.shard_slice(out, info.tp_axis, 1)
        out = fab.unshard(out, x_spec)
    if not return_stats:
        return out, aux
    # the statistics are global: every shard's, gathered across processes
    every = fab.gather_shards
    stats = DispatchStats(topk_ids=every(eids), e_local=E_local,
                          expert_base=torch.from_numpy(
                              fab.axis_index(e_dim)).to(dev) * E_local,
                          expert_rows=None if xe is None else every(xe))
    for stage, (dest, valid, task_slot, n_buckets, cap) in seen.items():
        stats.buckets[stage] = tuple(every(c) for c in _bucket_counts(
            dest, valid, task_slot, n_buckets))
        stats.caps[stage] = cap
    return out, aux, stats
