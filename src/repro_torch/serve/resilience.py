"""Serving resilience: deterministic chaos plans and circuit breakers
(counterpart of ``repro/serve/resilience.py``).

The serving loop has four failure seams, and every one of them can be
exercised deterministically from here (the
:class:`~repro_torch.runtime.fault_tolerance.InjectionSchedule` house style:
inject the failure so the recovery is *tested*, not just written):

* ``FAULT_LAUNCH`` — the fused launch itself raises at dispatch time
  (a flaky host's tracing/dispatch path);
* ``FAULT_DEVICE`` — the launch dispatches but the device future
  surfaces an error at harvest (a device fault mid-launch);
* ``FAULT_MOE`` — the MoE lane's synchronous dispatch raises;
* ``FAULT_HOST_LOSS`` — a host disappears: the server shrinks its
  :class:`~repro_torch.core.fabric.Fabric` to the surviving devices,
  re-prewarms the shape classes that still have queued traffic,
  requeues the poisoned window's riders, and keeps serving.

A :class:`ServeFailurePlan` keys faults by **launch index** (the
server's monotone count of fused launches, graph + MoE), so a chaos run
replays bit-for-bit: same plan, same stream -> same faults at the same
launches, and min-reduce survivors land bit-identical to a fault-free
run (drop-free sizing is device-count independent, so even the
post-shrink relaunches reproduce the exact distances).

The :class:`CircuitBreaker` is the fail-fast half of the story: one
breaker per (program, graph) shape class, opened by
``ServeOptions.breaker_threshold`` consecutive launch failures. An open
breaker rejects new submissions of its class retriably (naming itself in
the reason) instead of burning device time on a class that keeps
failing; the next formed batch of the class is admitted as a single
half-open *probe* — success closes the breaker, failure re-opens it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from ..runtime.fault_tolerance import (FailurePlan, InjectedFailure,
                                       InjectionSchedule, RetryLedger)

__all__ = [
    "BREAKER_CLOSED", "BREAKER_HALF_OPEN", "BREAKER_OPEN", "CircuitBreaker",
    "FAULT_DEVICE", "FAULT_HOST_LOSS", "FAULT_KINDS", "FAULT_LAUNCH",
    "FAULT_MOE", "FailurePlan", "InjectedFailure", "InjectionSchedule",
    "RetryLedger", "ServeFailurePlan", "seeded_chaos_plan",
]

#: the four serving failure seams a plan may target (see module docstring)
FAULT_LAUNCH = "launch"
FAULT_DEVICE = "device"
FAULT_MOE = "moe"
FAULT_HOST_LOSS = "host_loss"
FAULT_KINDS = (FAULT_LAUNCH, FAULT_DEVICE, FAULT_MOE, FAULT_HOST_LOSS)


@dataclass
class ServeFailurePlan(InjectionSchedule):
    """Deterministic serving fault schedule ``{launch index: kind}``.

    ``kind`` is one of :data:`FAULT_KINDS`. Seam mapping at fire time:

    * at a graph launch, ``launch`` (and ``moe``, which has no graph
      seam) raises at dispatch; ``device`` lets the launch dispatch and
      surfaces as an error from the device future at harvest;
      ``host_loss`` shrinks the fabric to ``keep_devices`` *instead of*
      launching — the batch (and any poisoned inflight riders) is
      requeued and relaunched on the survivors, consuming the same
      launch index.
    * at an MoE launch, every kind degrades to a dispatch exception —
      the MoE lane is synchronous and its fabric does not shrink.

    Each scheduled index fires exactly once; ``fired`` records the
    history and :attr:`~InjectionSchedule.exhausted` lets a chaos test
    assert the plan actually ran.
    """
    #: surviving device count after a ``host_loss`` fault (None = keep
    #: the first half of the current fabric)
    keep_devices: Optional[int] = None

    noun = "launch"

    def __post_init__(self):
        bad = {k for k in self.at.values()} - set(FAULT_KINDS)
        if bad:
            raise ValueError(
                f"unknown fault kinds {sorted(bad)}; pick from {FAULT_KINDS}")


def seeded_chaos_plan(seed: int, n_launches: int, *,
                      keep_devices: Optional[int] = None
                      ) -> ServeFailurePlan:
    """One launch fault, one device fault, one host loss at three
    distinct launch indices derived deterministically from ``seed`` —
    the canonical chaos-smoke plan (CI and the hypothesis tier replay
    the same seeds).

    Pure integer mixing (splitmix-style), no ``random``: the same seed
    always yields the same plan, in any process, under any hash seed.
    The host loss is placed last so the shrunken fabric serves the tail
    of the stream, and indices stay within the fault-free launch count
    ``n_launches`` so every fault is guaranteed to fire.
    """
    if n_launches < 3:
        raise ValueError(f"need >= 3 launches to place 3 faults, "
                         f"got {n_launches}")

    def mix(x: int) -> int:
        x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        return x ^ (x >> 31)

    picks = []
    i = 0
    while len(picks) < 3:
        cand = mix(seed * 1_000_003 + i) % n_launches
        if cand not in picks:
            picks.append(cand)
        i += 1
    picks.sort()
    return ServeFailurePlan(
        at={picks[0]: FAULT_LAUNCH, picks[1]: FAULT_DEVICE,
            picks[2]: FAULT_HOST_LOSS},
        keep_devices=keep_devices)


BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half_open"


@dataclass
class CircuitBreaker:
    """Per-shape-class fail-fast: CLOSED -> (``threshold`` consecutive
    launch failures) -> OPEN -> (one probe batch) -> HALF_OPEN ->
    success closes / failure re-opens.

    While not CLOSED, new submissions of the class are rejected
    *retriably* at admission (fail fast, spend no device time); queued
    work is held except for the single half-open probe the engine admits
    via :meth:`allows_launch`. ``record_failure`` / ``record_success``
    return True exactly on the open/close **transition**, so the engine
    can count ``breaker_opens`` / ``breaker_closes`` without re-deriving
    state edges.
    """
    threshold: int
    klass: Tuple[str, Optional[str]] = ("?", None)
    state: str = BREAKER_CLOSED
    failures: int = 0                 # consecutive failed launches
    opens: int = 0
    closes: int = 0

    def allows_launch(self) -> bool:
        """May a formed batch of this class launch now? CLOSED: yes.
        OPEN: yes, once — the batch becomes the half-open probe.
        HALF_OPEN: no — the probe is still in flight; hold the queue."""
        if self.state == BREAKER_CLOSED:
            return True
        if self.state == BREAKER_OPEN:
            self.state = BREAKER_HALF_OPEN
            return True
        return False

    def record_failure(self) -> bool:
        """Count one failed launch; True when this failure OPENED the
        breaker (a half-open probe failing re-opens immediately)."""
        self.failures += 1
        if self.state == BREAKER_HALF_OPEN or self.failures >= self.threshold:
            was = self.state
            self.state = BREAKER_OPEN
            if was != BREAKER_OPEN:
                self.opens += 1
                return True
        return False

    def record_success(self) -> bool:
        """Count one successful launch; True when it CLOSED the breaker
        (the half-open probe succeeded)."""
        self.failures = 0
        was = self.state
        self.state = BREAKER_CLOSED
        if was != BREAKER_CLOSED:
            self.closes += 1
            return True
        return False

    def reject_reason(self) -> str:
        prog, graph = self.klass
        name = prog if graph is None else f"{prog}/{graph}"
        return (f"circuit breaker {self.state} for shape class {name}: "
                f"{self.failures} consecutive launch failures "
                f"(threshold {self.threshold}); resubmit after the "
                f"half-open probe closes it")
