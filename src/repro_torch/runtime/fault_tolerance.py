"""Failure injection and retry bookkeeping (counterpart of
``repro/runtime/fault_tolerance.py:31-140``).

The primitives the serving tier builds on (:mod:`repro_torch.serve.
resilience`): :class:`InjectionSchedule`, the deterministic fault
schedule every chaos plan derives from, its training-step form
:class:`FailurePlan`, the :class:`InjectedFailure` a fired fault raises,
and the :class:`RetryLedger` of attempts and backoff. The reference's
checkpoint-bound training loop and straggler watchdog wait for the LM
stack (``ROADMAP.md`` queue 1, item 5).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


class InjectedFailure(RuntimeError):
    """Stands in for an ICI timeout / preempted worker / lost host."""


@dataclass
class InjectionSchedule:
    """Deterministic fault schedule ``{index: kind}`` — the house chaos
    primitive.

    ``index`` is whatever the consuming loop counts (training *steps*,
    fused serving *launches* in
    :class:`repro_torch.serve.resilience.ServeFailurePlan`); each scheduled
    index fires exactly once (popped on :meth:`due`), and every firing
    is appended to ``fired`` so a chaos run can assert its plan actually
    executed — a plan that never fires is a test that never tested.
    """
    at: Dict[int, str] = field(default_factory=dict)
    fired: List[Tuple[int, str]] = field(default_factory=list)

    #: what ``index`` counts, for failure messages (subclasses override)
    noun = "step"

    def peek(self, index: int) -> Optional[str]:
        """The fault scheduled at ``index`` without consuming it."""
        return self.at.get(index)

    def due(self, index: int) -> Optional[str]:
        """Pop-and-record the fault scheduled at ``index`` (None = no
        fault due) — each scheduled index fires exactly once."""
        kind = self.at.pop(index, None)
        if kind is not None:
            self.fired.append((index, kind))
        return kind

    def check(self, index: int):
        """Raise :class:`InjectedFailure` when a fault is due."""
        kind = self.due(index)
        if kind:
            raise InjectedFailure(f"{kind} at {self.noun} {index}")

    @property
    def exhausted(self) -> bool:
        """True once every scheduled fault has fired."""
        return not self.at


class FailurePlan(InjectionSchedule):
    """Deterministic training failure schedule: {step: kind} (the
    historical constructor; the live schedule is ``self.at``)."""

    def __init__(self, at_steps: Optional[Dict[int, str]] = None):
        super().__init__(at=dict(at_steps or {}))

    @property
    def at_steps(self) -> Dict[int, str]:
        return self.at


@dataclass
class RetryLedger:
    """Shared restart/retry bookkeeping — ONE counting rule for the
    training loop and the serving retry path.

    One integer ``key`` names one retriable unit: a training loop uses a
    single key (the whole loop restarts), the serving tier keys by
    ``req_id``. :meth:`record_failure` counts one failure and answers
    whether the unit still has retry budget; :meth:`backoff_s` derives
    the exponential backoff for the *next* attempt with a deterministic
    per-key jitter — an integer hash of the key, never ``random`` — so a
    replayed chaos run waits identical delays and stays reproducible.
    """
    max_retries: int
    backoff_base_s: float = 0.0
    attempts: Dict[int, int] = field(default_factory=dict)
    total_retries: int = 0               # granted retries, all keys

    def attempt(self, key: int) -> int:
        """Failures recorded for ``key`` so far (0 = never failed)."""
        return self.attempts.get(int(key), 0)

    def record_failure(self, key: int) -> bool:
        """Count one failure of ``key``; True while retry budget remains
        (the failure may be retried), False when exhausted."""
        key = int(key)
        n = self.attempts.get(key, 0) + 1
        self.attempts[key] = n
        if n > self.max_retries:
            return False
        self.total_retries += 1
        return True

    def backoff_s(self, key: int) -> float:
        """Deterministic exponential backoff before retrying ``key``:
        ``base * 2**(attempt-1) * (1 + jitter)`` with ``jitter`` in
        [0, 1) hashed from the key (Knuth multiplicative mix) — spread
        without randomness."""
        if self.backoff_base_s <= 0.0:
            return 0.0
        n = max(1, self.attempts.get(int(key), 1))
        jitter = ((int(key) * 2654435761 + 0x9E3779B9) & 0xFFFFFFFF) / 2**32
        return self.backoff_base_s * 2.0 ** (n - 1) * (1.0 + jitter)

    def clear(self, key: int) -> None:
        """Drop ``key``'s attempt count (the unit reached a terminal
        outcome) — keeps a resident server's ledger O(inflight), while
        ``total_retries`` preserves the aggregate."""
        self.attempts.pop(int(key), None)
