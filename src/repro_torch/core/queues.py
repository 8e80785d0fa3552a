"""Task-queue sizing: the single source of IQ capacities.

Counterpart of ``repro/core/queues.py`` (the part the routing layer
reads). A capacity is either an explicit entry count (``iq_sizes`` /
``default_iq``, honoured exactly) or a relative capacity factor
(``iq_factors``: ``tasks_per_round * factor / n_channels``, lane-aligned
with :func:`round8`).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional


def round8(x: int) -> int:
    """Round a capacity up to a multiple of 8 (at least 8)."""
    return max(8, -(-x // 8) * 8)


@dataclass
class QueueConfig:
    iq_sizes: Dict[str, int] = field(default_factory=dict)
    default_iq: Optional[int] = 12
    iq_factors: Dict[str, float] = field(default_factory=dict)
    # routing engine: "pallas" | "sort" | "onehot" (None = "pallas")
    route_impl: Optional[str] = None

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
