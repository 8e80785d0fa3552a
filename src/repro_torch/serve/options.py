"""ServeOptions — the serving-loop knobs, LaunchOptions' counterpart
(counterpart of ``repro/serve/options.py``).

:class:`~repro_torch.sparse.options.LaunchOptions` configures one *launch*
(queue sizing, route impl, round mode); :class:`ServeOptions` configures
the *loop* that issues launches: how many fused batches may be in flight
at once, how batches are formed across tenants, and whether retired
state buffers are donated back to the allocator — plus the failure
posture: how many times a transiently-failed request is retried, how
long it backs off, when it is past its deadline, and when a shape
class's circuit breaker opens. The defaults (``inflight_depth=1``, FIFO
formation, no donation, no retries, no deadline, no breaker) reproduce
the synchronous drain loop bit-for-bit — responses, cache keys, ledger.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

#: batch-formation disciplines (see repro_torch.serve.batching formers)
FAIRNESS_MODES = ("fifo", "drr")


@dataclass(frozen=True)
class ServeOptions:
    """Immutable serving-loop configuration.

    * ``inflight_depth`` — size of the launch window: batch k+1 is
      formed, admitted and dispatched while batch k's arrays are still
      computing on device; harvesting is lazy (poll each launch's
      CUDA event, block only at the window boundary or in ``drain``).
      Depth 1 = today's launch-then-block loop.
    * ``fairness`` — ``"fifo"`` is head-of-line batch formation (today's
      behavior, byte-compatible cache keys); ``"drr"`` is deficit
      round-robin across tenants: per-tenant FIFO queues, deficit
      counters charged by each request's admission demand, starvation-
      free (a pending tenant becomes the batch setter within
      ``n_tenants`` formations), order preserved within a tenant.
    * ``drr_quantum`` — deficit refill per formation pass; ``None``
      (default) adapts to the largest demand seen so every head fits on
      its first visit. A smaller fixed quantum makes heavyweight
      requests wait extra passes banking deficit — classic DRR.
    * ``donate_buffers`` — each launch gives its packed tenant-column
      state inputs to its round loop, which reuses them instead of
      holding them to the end (``launch_program(donate_states=True)``):
      one state fewer at the launch's peak, no copy. It joins the cache key
      ONLY when set — default keys stay byte-identical (pre-warm builds
      the donated shape class when enabled).
    * ``max_retries`` — transient failures (launch exceptions, device
      errors at harvest, MoE dispatch faults, host loss) requeue the
      failed batch's riders at the **head of their tenant's queue** up
      to this many times per request before the request fails
      non-retriably; 0 (default) keeps every failure terminal on first
      strike, the historical behavior.
    * ``backoff_base_s`` — exponential backoff before a retry relaunch:
      attempt n waits ``base * 2**(n-1) * (1 + jitter)`` where the
      jitter is a deterministic hash of ``req_id`` (no ``random`` — a
      replayed chaos run waits identical delays). 0 (default) retries
      immediately.
    * ``deadline_s`` — per-request end-to-end budget measured from
      ``submit()``: a request past its deadline at batch formation or
      after a failed launch fails non-retriably with a distinct
      ``deadline ... exceeded`` reason, never silently retried forever.
      ``None`` (default) = no deadline.
    * ``breaker_threshold`` — per-(program, graph) circuit breaker:
      this many *consecutive* failed launches of one shape class open
      it (new submissions of the class fail fast with a retriable
      rejection naming the breaker); the next formed batch is the
      half-open probe, whose success closes it. ``None`` (default)
      disables breakers.
    """
    inflight_depth: int = 1
    fairness: str = "fifo"
    drr_quantum: Optional[int] = None
    donate_buffers: bool = False
    max_retries: int = 0
    backoff_base_s: float = 0.0
    deadline_s: Optional[float] = None
    breaker_threshold: Optional[int] = None

    def resolve(self) -> "ServeOptions":
        """Validate and return self (mirrors LaunchOptions.resolve)."""
        if int(self.inflight_depth) < 1:
            raise ValueError(
                f"inflight_depth must be >= 1, got {self.inflight_depth}")
        if self.fairness not in FAIRNESS_MODES:
            raise ValueError(f"fairness must be one of {FAIRNESS_MODES}, "
                             f"got {self.fairness!r}")
        if self.drr_quantum is not None and int(self.drr_quantum) < 1:
            raise ValueError(
                f"drr_quantum must be >= 1 or None, got {self.drr_quantum}")
        if int(self.max_retries) < 0:
            raise ValueError(
                f"max_retries must be >= 0, got {self.max_retries}")
        if float(self.backoff_base_s) < 0.0:
            raise ValueError(
                f"backoff_base_s must be >= 0, got {self.backoff_base_s}")
        if self.deadline_s is not None and float(self.deadline_s) <= 0.0:
            raise ValueError(
                f"deadline_s must be > 0 or None, got {self.deadline_s}")
        if self.breaker_threshold is not None \
                and int(self.breaker_threshold) < 1:
            raise ValueError(f"breaker_threshold must be >= 1 or None, "
                             f"got {self.breaker_threshold}")
        return self
