"""Serving observability: per-tenant / per-round counters and latency
quantiles (counterpart of ``repro/serve/stats.py``).

Everything is plain counters + **bounded** latency reservoirs;
``snapshot()`` renders one JSON-able dict (the tests and
``chip_smoke.py`` assert on it). A resident server runs for days, so every
per-event list is a ``deque(maxlen=STATS_WINDOW)``: quantiles are
computed over the most recent window and host memory stays O(window) no
matter how long the server lives (tests/test_torch_serve.py pins the cap).
Accounting invariant (asserted by :meth:`ServingStats.verify`): every
submitted request is exactly one of served / rejected / failed — nothing
is silently dropped — and every NoC-level task drop the engine observed
is attributed to a response (``noc_drops``), never swallowed.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict

#: bound on every per-event reservoir (latencies, queue-depth samples);
#: quantiles are over the most recent STATS_WINDOW events
STATS_WINDOW = 4096


def _window() -> Deque:
    return deque(maxlen=STATS_WINDOW)


def _quantile(xs, q: float) -> float:
    """Nearest-rank quantile (no numpy dependency for the hot path)."""
    s = sorted(xs)
    if not s:
        return 0.0
    i = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
    return s[i]


@dataclass
class TenantStats:
    submitted: int = 0
    served: int = 0
    rejected: int = 0                 # admission-control rejections
    failed: int = 0
    retries: int = 0                  # failed-launch requeues (a retry is
                                      # NOT a resubmission: the request
                                      # stays admitted, the ledger's
                                      # submitted count is untouched)
    # launch-level attribution: drops/messages/rounds of every fused
    # launch this tenant rode (columns share one NoC, so per-column
    # splits don't exist at the engine level)
    noc_drops: int = 0                # IQ-overflow task drops
    messages: int = 0                 # routed tasks
    rounds: int = 0                   # NoC rounds
    latencies: Deque[float] = field(default_factory=_window)
    # end-to-end latency decomposed: time queued before launch vs time
    # the fused launch spent computing (submit -> launch -> harvest)
    queue_waits: Deque[float] = field(default_factory=_window)
    device_times: Deque[float] = field(default_factory=_window)

    def snapshot(self) -> Dict:
        return {
            "submitted": self.submitted, "served": self.served,
            "rejected": self.rejected, "failed": self.failed,
            "retries": self.retries,
            "noc_drops": self.noc_drops, "messages": self.messages,
            "rounds": self.rounds,
            "p50_latency_s": _quantile(self.latencies, 0.50),
            "p99_latency_s": _quantile(self.latencies, 0.99),
            "p50_queue_wait_s": _quantile(self.queue_waits, 0.50),
            "p99_queue_wait_s": _quantile(self.queue_waits, 0.99),
            "p50_device_s": _quantile(self.device_times, 0.50),
            "p99_device_s": _quantile(self.device_times, 0.99),
        }


@dataclass
class ServingStats:
    """Aggregate + per-tenant serving counters."""
    tenants: Dict[str, TenantStats] = field(default_factory=dict)
    noc_drops: int = 0                # aggregate IQ-overflow task drops
    launches: int = 0                 # fused launches
    batched_requests: int = 0         # real (non-padding) requests served
    pad_columns: int = 0              # dummy columns burned on padding
    cache_hits: int = 0               # round-function cache hits
    cache_misses: int = 0
    prewarmed_keys: int = 0
    # resilience counters (repro_torch.serve.resilience): how often the
    # recovery machinery actually engaged — a chaos test asserts these
    retries: int = 0                  # failed-launch rider requeues
    breaker_opens: int = 0            # circuit-breaker open transitions
    breaker_closes: int = 0           # half-open probe successes
    host_losses: int = 0              # fabric shrinks survived
    max_queue_depth: int = 0          # running max (survives the window)
    queue_depth_samples: Deque[int] = field(default_factory=_window)
    round_latencies: Deque[float] = field(default_factory=_window)

    def tenant(self, name: str) -> TenantStats:
        ts = self.tenants.get(name)
        if ts is None:
            ts = self.tenants[name] = TenantStats()
        return ts

    @property
    def cache_hit_rate(self) -> float:
        total = self.cache_hits + self.cache_misses
        return self.cache_hits / total if total else 0.0

    def observe_queue_depth(self, depth: int) -> None:
        depth = int(depth)
        self.queue_depth_samples.append(depth)
        if depth > self.max_queue_depth:
            self.max_queue_depth = depth

    def verify(self) -> None:
        """The no-silent-drop ledger: submitted == served + rejected +
        failed, per tenant (in-flight requests must be drained first).
        Retries deliberately do NOT enter the equation — a retried
        request is still one submission with one eventual outcome; the
        per-tenant ``retries`` counter tracks the extra attempts."""
        for name, ts in self.tenants.items():
            acc = ts.served + ts.rejected + ts.failed
            if ts.submitted != acc:
                raise AssertionError(
                    f"tenant {name!r}: {ts.submitted} submitted but only "
                    f"{acc} accounted (served {ts.served} + rejected "
                    f"{ts.rejected} + failed {ts.failed})")

    def snapshot(self) -> Dict:
        return {
            "noc_drops": self.noc_drops,
            "launches": self.launches,
            "batched_requests": self.batched_requests,
            "pad_columns": self.pad_columns,
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
            "cache_hit_rate": self.cache_hit_rate,
            "prewarmed_keys": self.prewarmed_keys,
            "retries": self.retries,
            "breaker_opens": self.breaker_opens,
            "breaker_closes": self.breaker_closes,
            "host_losses": self.host_losses,
            "max_queue_depth": self.max_queue_depth,
            "p50_round_latency_s": _quantile(self.round_latencies, 0.50),
            "p99_round_latency_s": _quantile(self.round_latencies, 0.99),
            "tenants": {t: s.snapshot() for t, s in self.tenants.items()},
        }
