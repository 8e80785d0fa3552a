"""Task-queue sizing: the single source of IQ capacities, and the
per-round queue pressure the analytic engine records.

Counterpart of ``repro/core/queues.py``. A capacity is either an explicit
entry count (``iq_sizes`` / ``default_iq``, honoured exactly) or a
relative capacity factor (``iq_factors``: ``tasks_per_round * factor /
n_channels``, lane-aligned with :func:`round8`). Output queues
(``oq_sizes`` / ``default_oq``) only price producer stalls in the
analytic performance model.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np


def round8(x: int) -> int:
    """Round a capacity up to a multiple of 8 (at least 8)."""
    return max(8, -(-x // 8) * 8)


# The MoE dispatch's bounded-queue task names (see for_moe_dispatch).
MOE_DISPATCH_TASKS = ("dispatch", "portal", "expert")


@dataclass
class QueueConfig:
    iq_sizes: Dict[str, int] = field(default_factory=dict)
    default_iq: Optional[int] = 12
    iq_factors: Dict[str, float] = field(default_factory=dict)
    # routing engine: "pallas" | "sort" | "onehot" (None = "pallas")
    route_impl: Optional[str] = None
    oq_sizes: Dict[str, int] = field(default_factory=dict)
    default_oq: int = 12

    def oq(self, task: str) -> int:
        return self.oq_sizes.get(task, self.default_oq)

    def channel_cap(self, task: str, tasks_per_round: int,
                    n_channels: int, lane_align: bool = True
                    ) -> Optional[int]:
        """One routing round's per-channel bucket capacity (``None`` =
        unbounded). Explicit sizes are exact; factor sizes are
        ``round8``-aligned unless ``lane_align=False``."""
        explicit = self.iq_sizes.get(task)
        if explicit is None and task not in self.iq_factors:
            explicit = self.default_iq
        if explicit is not None:
            return max(1, int(explicit))
        factor = self.iq_factors.get(task)
        if factor is None:
            return None
        cap = int(tasks_per_round * factor / max(n_channels, 1))
        return round8(cap) if lane_align else max(1, cap)

    def round_budget(self, task: str, tasks_per_round: int,
                     n_channels: int) -> Optional[int]:
        """Per-round admission budget: per-channel capacity times the
        channel count (``None`` = unbounded)."""
        cap = self.channel_cap(task, tasks_per_round, n_channels)
        return None if cap is None else int(cap) * max(1, n_channels)

    @classmethod
    def unbounded(cls) -> "QueueConfig":
        return cls(default_iq=None)

    @classmethod
    def from_factor(cls, factor: float, task: str = "T3") -> "QueueConfig":
        return cls(default_iq=None, iq_factors={task: factor})

    @classmethod
    def from_cap(cls, cap: int, task: str = "T3") -> "QueueConfig":
        return cls(default_iq=None, iq_sizes={task: int(cap)})

    @classmethod
    def for_moe_dispatch(cls, factor: float) -> "QueueConfig":
        """The MoE dispatch's three bounded buckets (stage-1 tile-NoC
        "dispatch", stage-2 pod portal "portal", per-local-expert receive
        "expert") at one capacity factor."""
        return cls(default_iq=None,
                   iq_factors={t: factor for t in MOE_DISPATCH_TASKS})


@dataclass
class QueueStats:
    """Per-round aggregate queue pressure (peak IQ / OQ occupancy and
    tasks routed, per task class)."""
    peak_iq: Dict[str, int] = field(default_factory=dict)
    peak_oq: Dict[str, int] = field(default_factory=dict)
    total_tasks: Dict[str, int] = field(default_factory=dict)

    def record(self, task: str, per_tile_in: np.ndarray,
               per_tile_out: np.ndarray):
        self.peak_iq[task] = max(self.peak_iq.get(task, 0),
                                 int(per_tile_in.max(initial=0)))
        self.peak_oq[task] = max(self.peak_oq.get(task, 0),
                                 int(per_tile_out.max(initial=0)))
        self.total_tasks[task] = self.total_tasks.get(task, 0) + \
            int(per_tile_in.sum())
