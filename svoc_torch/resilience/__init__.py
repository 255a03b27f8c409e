"""Resilience layer: deterministic fault injection, retry/resume,
circuit breakers, and the fleet health supervisor.

Mirrors :mod:`svoc_tpu.resilience` (``resilience/__init__.py:1-75``) and
exports what it exports:

- :mod:`svoc_torch.resilience.faults` — seeded :class:`FaultPlan`
  schedules (transient errors, timeouts, stalls) and the
  :class:`FaultInjectingBackend` chaos wrapper, exactly replayable;
- :mod:`svoc_torch.resilience.retry` — :class:`RetryPolicy`
  (decorrelated-jitter backoff, attempt/overall deadlines) and
  :func:`commit_fleet_with_resume`, the idempotency-aware resume of
  partial fleet commits (re-sends only stranded oracles);
- :mod:`svoc_torch.resilience.breaker` — per-backend
  closed/open/half-open :class:`CircuitBreaker`, exported as a gauge;
- :mod:`svoc_torch.resilience.supervisor` —
  :class:`FleetHealthSupervisor`: reliability signals + commit-failure
  history → hysteresis health scores → automatic replacement votes;
- :mod:`svoc_torch.resilience.chaos` — the seeded end-to-end chaos
  scenarios (:mod:`svoc_torch.tools.chaos_smoke` and the replay tests).
"""

from svoc_torch.resilience.breaker import (
    BREAKER_CLOSED,
    BREAKER_HALF_OPEN,
    BREAKER_OPEN,
    CircuitBreaker,
    CircuitOpenError,
)
from svoc_torch.resilience.faults import (
    FaultInjectingBackend,
    FaultPlan,
    FaultSpec,
    InjectedFault,
    InjectedTimeout,
)
from svoc_torch.resilience.retry import (
    CommitOutcome,
    RetryPolicy,
    call_with_retry,
    commit_fleet_with_resume,
)
from svoc_torch.resilience.supervisor import (
    FleetHealthSupervisor,
    SupervisorConfig,
)

__all__ = [
    "BREAKER_CLOSED",
    "BREAKER_HALF_OPEN",
    "BREAKER_OPEN",
    "CircuitBreaker",
    "CircuitOpenError",
    "CommitOutcome",
    "FaultInjectingBackend",
    "FaultPlan",
    "FaultSpec",
    "FleetHealthSupervisor",
    "InjectedFault",
    "InjectedTimeout",
    "RetryPolicy",
    "SupervisorConfig",
    "call_with_retry",
    "commit_fleet_with_resume",
]
