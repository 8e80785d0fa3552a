"""LaunchOptions — every launch-configuration knob in one frozen object
(counterpart of ``repro/sparse/options.py``; the legacy-kwarg shim of
the reference is not ported, so entry points take ``options=`` only).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Optional

from ..core.queues import QueueConfig

ROUND_MODES = ("lockstep", "pipelined")


@dataclass(frozen=True)
class LaunchOptions:
    """``axis`` / ``pod_axis`` name the fabric axes (``pod_axis`` selects
    the pod/portal path); at most one of ``queues`` / ``cap`` /
    ``capacity_factor`` sizes the IQs; ``seed`` fixes the edge-pack
    shuffle; ``route_impl`` picks the routing engine; ``config`` and
    ``objective`` are the reference's auto-configuration knobs."""
    axis: str = "data"
    pod_axis: Optional[str] = None
    cap: Optional[int] = None
    capacity_factor: Optional[float] = None
    queues: Optional[QueueConfig] = None
    config: Any = None
    objective: str = "teps"
    seed: int = 0
    route_impl: Optional[str] = None
    round_mode: str = "lockstep"

    def resolve(self) -> "LaunchOptions":
        """The cross-field conflict checks; returns ``self``."""
        sizing = tuple(name for name, v in
                       (("queues", self.queues), ("cap", self.cap),
                        ("capacity_factor", self.capacity_factor))
                       if v is not None)
        if len(sizing) > 1:
            raise ValueError(f"{sizing[0]}= conflicts with explicit "
                             f"{sizing[1:]}: IQ sizing resolves through "
                             f"exactly one of queues/cap/capacity_factor")
        if self.config is not None and sizing:
            raise ValueError(f"config= conflicts with explicit {sizing}: "
                             f"queue sizing comes from the resolved "
                             f"LaunchConfig, drop one of them")
        if self.round_mode not in ROUND_MODES:
            raise ValueError(f"unknown round_mode {self.round_mode!r} "
                             f"(expected one of {ROUND_MODES})")
        if self.route_impl is not None:
            from ..kernels.route import resolve_route_impl
            resolve_route_impl(self.route_impl)      # raises on unknown
        return self

    def with_(self, **changes) -> "LaunchOptions":
        return replace(self, **changes)


def resolve_options(options: Optional[LaunchOptions] = None
                    ) -> LaunchOptions:
    """``options`` checked (defaults when ``None``)."""
    if options is None:
        return LaunchOptions().resolve()
    if not isinstance(options, LaunchOptions):
        raise TypeError(f"options= expects a LaunchOptions, got "
                        f"{type(options).__name__}")
    return options.resolve()
