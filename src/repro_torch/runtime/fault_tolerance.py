"""Fault-tolerant runtime primitives: failure injection, retry
bookkeeping, straggler detection and checkpoint-restart (counterpart of
``repro/runtime/fault_tolerance.py``).

:class:`InjectionSchedule` is the deterministic fault schedule every
chaos plan derives from (the serving tier's
:class:`repro_torch.serve.resilience.ServeFailurePlan` too), its
training-step form :class:`FailurePlan`, the :class:`InjectedFailure` a
fired fault raises, and the :class:`RetryLedger` of attempts and
backoff, one counting rule for :func:`run_training`'s restarts and the
serving retry path. :class:`StragglerWatchdog` flags steps slower than a
multiple of the trailing median; :func:`run_training` is the restartable
loop over :mod:`repro_torch.checkpoint.checkpoint`.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..checkpoint import checkpoint as ckpt

log = logging.getLogger("repro_torch.runtime")


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

    One integer ``key`` names one retriable unit: :func:`run_training`
    uses a single key (the whole loop restarts), the serving tier keys by
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


@dataclass
class StragglerWatchdog:
    """Flags steps slower than ``factor`` x the trailing-median step time."""
    factor: float = 3.0
    window: int = 16
    history: List[float] = field(default_factory=list)
    steps: List[int] = field(default_factory=list)   # step of each entry
    flagged: List[int] = field(default_factory=list)
    on_straggler: Optional[Callable[[int, float], None]] = None

    def observe(self, step: int, seconds: float):
        hist = self.history[-self.window:]
        if len(hist) >= 4:
            # true median: an even window averages its two middle entries
            s = sorted(hist)
            mid = len(s) // 2
            med = s[mid] if len(s) % 2 else (s[mid - 1] + s[mid]) / 2.0
            if seconds > self.factor * med:
                self.flagged.append(step)
                log.warning("straggler: step %d took %.3fs (median %.3fs)",
                            step, seconds, med)
                if self.on_straggler:
                    self.on_straggler(step, seconds)
        self.history.append(seconds)
        self.steps.append(step)

    def rollback(self, step: int):
        """Forget observations of steps >= ``step``: a restart replays
        them, and keeping them would count them twice in the median."""
        keep = [i for i, s in enumerate(self.steps) if s < step]
        self.history = [self.history[i] for i in keep]
        self.steps = [self.steps[i] for i in keep]
        self.flagged = [s for s in self.flagged if s < step]


@dataclass
class TrainLoopResult:
    final_step: int
    restarts: int
    metrics_history: List[dict]
    straggler_steps: List[int]


def run_training(step_fn: Callable, init_state: Callable[[], tuple],
                 batch_fn: Callable[[int], Any], total_steps: int,
                 ckpt_dir: str, ckpt_every: int = 10,
                 max_restarts: int = 3,
                 backoff_base_s: float = 0.0,
                 failure_plan: Optional[FailurePlan] = None,
                 watchdog: Optional[StragglerWatchdog] = None,
                 shardings: Optional[tuple] = None) -> TrainLoopResult:
    """Restartable loop over ``state = (params, opt_state)``:
    ``step_fn(params, opt_state, batch) -> (params, opt_state, metrics)``.

    On an :class:`InjectedFailure` it reloads the latest checkpoint (into
    a fresh ``init_state()``'s structure) and continues: the data is
    keyed by step, so no loader state is needed. Restarts count on a
    :class:`RetryLedger` of one key; ``backoff_base_s`` waits its
    deterministic backoff before each. Steps after the restored one run
    again, and their first metrics and watchdog observations are
    dropped.
    """
    watchdog = watchdog or StragglerWatchdog()
    ledger = RetryLedger(max_retries=max_restarts,
                         backoff_base_s=backoff_base_s)
    history: List[tuple] = []          # (step, metrics), deduped on restart

    def load_or_init():
        last = ckpt.latest_step(ckpt_dir)
        if last is None:
            return 0, init_state()
        restored = ckpt.restore(ckpt_dir, last, init_state(), shardings)
        return last + 1, restored

    step, state = load_or_init()
    while step < total_steps:
        try:
            t0 = time.perf_counter()
            if failure_plan:
                failure_plan.check(step)
            params, opt_state = state
            params, opt_state, metrics = step_fn(params, opt_state,
                                                 batch_fn(step))
            state = (params, opt_state)
            # reading the metrics waits for the device, so the step's time
            # is its device time too
            history.append((step, {k: float(v) for k, v in metrics.items()}))
            watchdog.observe(step, time.perf_counter() - t0)
            if (step + 1) % ckpt_every == 0 or step + 1 == total_steps:
                ckpt.save(ckpt_dir, step, state)
            step += 1
        except InjectedFailure as e:
            granted = ledger.record_failure(0)
            log.warning("failure: %s -> restart %d", e, ledger.attempt(0))
            if not granted:
                raise
            delay = ledger.backoff_s(0)
            if delay > 0:
                time.sleep(delay)
            step, state = load_or_init()
            history = [(s, m) for s, m in history if s < step]
            watchdog.rollback(step)
    return TrainLoopResult(step, ledger.total_retries,
                           [m for _, m in history], watchdog.flagged)
