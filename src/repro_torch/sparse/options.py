"""LaunchOptions — every launch-configuration knob in one frozen object
(counterpart of ``repro/sparse/options.py``). Entry points take
``options=``; the legacy launch kwargs (``axis=``, ``capacity_factor=``,
``cap=``, ``seed=``, ``route_impl=``, ``round_mode=`` ...) keep working
through :func:`resolve_options`, which folds them into a
:class:`LaunchOptions` with one ``DeprecationWarning`` a process, so both
spellings reach the same checks and the same cache key.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, fields, replace
from typing import Any, Optional

from ..core.queues import QueueConfig

ROUND_MODES = ("lockstep", "pipelined")

# legacy kwargs whose unset value is a real value, not None: passing the
# default explicitly is the same as not passing it
_NON_NONE_DEFAULTS = {"axis": "data", "objective": "teps", "seed": 0}

_WARNED = [False]        # one-element list so tests can reset the latch


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


_FIELD_NAMES = tuple(f.name for f in fields(LaunchOptions))


def _warn_legacy(names) -> None:
    if _WARNED[0]:
        return
    _WARNED[0] = True
    warnings.warn(
        f"launch kwargs {tuple(names)} are deprecated: pass "
        f"options=LaunchOptions(...) instead (the legacy kwargs keep "
        f"working through this shim)", DeprecationWarning, stacklevel=4)


def resolve_options(options: Optional[LaunchOptions] = None,
                    **legacy) -> LaunchOptions:
    """``options`` checked, or the legacy kwargs folded into one
    (``repro/sparse/options.py:97-136``). With ``options=`` set, every
    legacy kwarg must be at its default: both raise ``ValueError``. An
    unknown kwarg raises ``TypeError``. The first non-default legacy
    kwarg of a process warns once (``DeprecationWarning``). Either way
    the result is :meth:`LaunchOptions.resolve`-d."""
    unknown = [k for k in legacy if k not in _FIELD_NAMES]
    if unknown:
        raise TypeError(f"unknown launch kwargs {unknown}")
    explicit = {k: v for k, v in legacy.items()
                if v is not None and v != _NON_NONE_DEFAULTS.get(k)}
    if options is not None:
        if not isinstance(options, LaunchOptions):
            raise TypeError(f"options= expects a LaunchOptions, got "
                            f"{type(options).__name__}")
        if explicit:
            raise ValueError(f"options= conflicts with explicit legacy "
                             f"kwargs {tuple(sorted(explicit))}: fold "
                             f"them into the LaunchOptions")
        return options.resolve()
    if explicit:
        _warn_legacy(sorted(explicit))
    return LaunchOptions(**{k: v for k, v in legacy.items()
                            if v is not None}).resolve()
