"""Resilience layer: retry/resume, circuit breakers, and the fleet
health supervisor.

Mirrors :mod:`svoc_tpu.resilience` (``resilience/__init__.py:1-75``)
without ``faults`` and ``chaos`` (the seeded fault injection and the
single-claim Byzantine scenario), which the claim fabric does not use:

- :mod:`svoc_torch.resilience.retry` — :class:`RetryPolicy`
  (decorrelated-jitter backoff, attempt/overall deadlines) and
  :func:`commit_fleet_with_resume`, the idempotency-aware resume of
  partial fleet commits (re-sends only stranded oracles);
- :mod:`svoc_torch.resilience.breaker` — per-backend
  closed/open/half-open :class:`CircuitBreaker`, exported as a gauge;
- :mod:`svoc_torch.resilience.supervisor` —
  :class:`FleetHealthSupervisor`: reliability signals + commit-failure
  history → hysteresis health scores → automatic replacement votes.
"""

from svoc_torch.resilience.breaker import (
    BREAKER_CLOSED,
    BREAKER_HALF_OPEN,
    BREAKER_OPEN,
    CircuitBreaker,
    CircuitOpenError,
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
    "FleetHealthSupervisor",
    "RetryPolicy",
    "SupervisorConfig",
    "call_with_retry",
    "commit_fleet_with_resume",
]
