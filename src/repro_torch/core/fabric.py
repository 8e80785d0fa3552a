"""The virtual-shard fabric: S shards stacked on the leading dimension of
one device (counterpart of ``repro/core/fabric.py:67-212``).

A :class:`Fabric` names its axes and their sizes, like a device mesh,
but every shard lives on ``device``: a shard's arrays are row ``g`` of
``[S, ...]`` tensors, with ``g`` the row-major index over the axes
(``g = pod * n_intra + intra`` for a ``("pod", "data")`` fabric). The
NoC ``all_to_all`` over an axis becomes a transpose
(:func:`repro_torch.core.routing.noc_all_to_all`) and ``psum`` a sum
over the shard dimension.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import cached_property
from typing import Dict, Optional, Sequence, Tuple

import torch

#: conventional names of the axis that crosses pods
PORTAL_AXIS_NAMES = ("pod", "portal")


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card, and
    raises when there is none (the port never falls back to the CPU
    unless asked)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run "
                               "on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


@dataclass(frozen=True)
class Fabric:
    """Frozen topology of one launch: axis names, axis sizes, device.
    ``portal_axis`` names the axis that crosses pods (``None`` = flat)."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    device: torch.device
    portal_axis: Optional[str] = None

    @classmethod
    def virtual(cls, axis_shapes: Sequence[int], axis_names: Sequence[str],
                device=None, portal_axis: Optional[str] = None) -> "Fabric":
        """``prod(axis_shapes)`` virtual shards on ``device`` (default the
        card). The portal axis is detected from :data:`PORTAL_AXIS_NAMES`
        unless named."""
        names = tuple(axis_names)
        shape = tuple(int(s) for s in axis_shapes)
        if len(names) != len(shape) or len(set(names)) != len(names):
            raise ValueError(f"axis names {names} do not match shape {shape}")
        if any(s < 1 for s in shape):
            raise ValueError(f"axis sizes must be >= 1, got {shape}")
        if portal_axis is None:
            portal_axis = next((a for a in PORTAL_AXIS_NAMES if a in names),
                               None)
        return cls(names, shape, resolve_device(device), portal_axis)

    @classmethod
    def fake(cls, n_dev: int, axis: str = "data", device=None) -> "Fabric":
        """A flat ``n_dev``-shard fabric."""
        return cls.virtual((int(n_dev),), (axis,), device=device)

    @cached_property
    def axis_sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    @property
    def n_devices(self) -> int:
        return math.prod(self.shape)

    @cached_property
    def pod_axis(self) -> Optional[str]:
        """The portal axis when it routes across pods (size > 1)."""
        if self.portal_axis is None:
            return None
        if self.axis_sizes.get(self.portal_axis, 1) <= 1:
            return None
        return self.portal_axis

    def fabric_key(self) -> tuple:
        """Stable identity for the round-function cache."""
        return (self.axis_names, self.shape, str(self.device))
