"""Resident serving runtime — TaskPrograms as a service (counterpart of
``repro/serve/``).

A :class:`~repro_torch.serve.engine.ProgramServer` keeps round functions
warm (the round-function cache plus an explicit pre-warm API) and its
graphs resident on the card, fuses many tenants' graph queries into one
tenant-column frontier so a single launch serves N tenants, applies
admission control through
:class:`~repro_torch.core.queues.QueueConfig` per-tenant round budgets
(overflow -> graceful retriable rejection, never a silent drop), and
exports per-tenant serving stats (queue depth, cache hit rate, drops,
p50/p99 round latency). The failure posture is first-class
(:mod:`repro_torch.serve.resilience`): deterministic fault injection by launch
index (:class:`ServeFailurePlan`), retry/backoff/deadlines
(``ServeOptions``), per-shape-class circuit breakers, and elastic
degrade on host loss.
"""
from ..sparse.options import LaunchOptions
from .batching import (DrrFormer, FifoFormer, TenantBatch, batched_program,
                       split_tenant_states, tenant_graph)
from .engine import (ADMISSION_TASK, MoEService, ProgramServer, Request,
                     Response, STATUS_FAILED, STATUS_OK, STATUS_REJECTED)
from .options import ServeOptions
from .resilience import (CircuitBreaker, FAULT_DEVICE, FAULT_HOST_LOSS,
                         FAULT_KINDS, FAULT_LAUNCH, FAULT_MOE,
                         ServeFailurePlan, seeded_chaos_plan)
from .stats import STATS_WINDOW, ServingStats, TenantStats

__all__ = [
    "ADMISSION_TASK", "CircuitBreaker", "DrrFormer", "FAULT_DEVICE",
    "FAULT_HOST_LOSS", "FAULT_KINDS", "FAULT_LAUNCH", "FAULT_MOE",
    "FifoFormer", "LaunchOptions", "MoEService", "ProgramServer", "Request",
    "Response", "ServeFailurePlan", "ServeOptions", "ServingStats",
    "STATS_WINDOW", "STATUS_FAILED", "STATUS_OK", "STATUS_REJECTED",
    "TenantBatch", "TenantStats", "batched_program", "seeded_chaos_plan",
    "split_tenant_states", "tenant_graph",
]
