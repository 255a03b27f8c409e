"""Per-backend circuit breaker (closed → open → half-open).

Mirrors :mod:`svoc_tpu.resilience.breaker` (``breaker.py:1-229``), the
whole module.

A Sepolia outage turns every fleet commit into ``n_oracles`` slow
failures; retrying through a dead backend multiplies the damage
(retry-storm) and keeps the auto loop wedged against its deadline.  A
breaker converts that into one cheap, observable decision: after
``failure_threshold`` consecutive failures the circuit OPENS and
callers short-circuit with :class:`CircuitOpenError`; after
``reset_timeout_s`` it admits ``half_open_max_probes`` probe calls
(HALF-OPEN) — one success re-closes it, one failure re-opens.

State is exported live as the ``circuit_breaker_state{backend=...}``
gauge (0 closed / 1 open / 2 half-open) in the shared metrics registry,
with transitions counted in
``breaker_transitions_total{to=...}`` — so ``GET /metrics``, the web
UI, and soak artifacts all read the same series.

Thread-safe: all state transitions run under one lock (the auto loop,
console, and web handlers share the session's breaker).  The clock is
injectable for deterministic tests and chaos replay.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from svoc_torch.utils.metrics import MetricsRegistry
from svoc_torch.utils.metrics import registry as _default_registry

BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half-open"

#: Gauge encoding (docs/OBSERVABILITY.md): the state name is the truth,
#: the number is for dashboards.
_STATE_VALUES = {BREAKER_CLOSED: 0, BREAKER_OPEN: 1, BREAKER_HALF_OPEN: 2}


class CircuitOpenError(RuntimeError):
    """Short-circuited: the breaker is OPEN (or half-open and out of
    probe budget).  ``sent`` carries partial-commit accounting when a
    fleet commit was aborted mid-cycle."""

    def __init__(self, name: str, retry_after_s: float = 0.0, sent: int = 0):
        self.name = name
        self.retry_after_s = retry_after_s
        self.sent = sent
        super().__init__(
            f"circuit breaker {name!r} is open"
            + (f" (retry in ~{retry_after_s:.1f}s)" if retry_after_s > 0 else "")
        )


class CircuitBreaker:
    def __init__(
        self,
        name: str = "chain",
        *,
        failure_threshold: int = 5,
        reset_timeout_s: float = 30.0,
        half_open_max_probes: int = 1,
        clock: Callable[[], float] = time.monotonic,
        registry: Optional[MetricsRegistry] = None,
        journal=None,
    ):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.name = name
        self.failure_threshold = failure_threshold
        self.reset_timeout_s = reset_timeout_s
        self.half_open_max_probes = half_open_max_probes
        self._clock = clock
        self._registry = registry or _default_registry
        #: Event journal (``svoc_torch.utils.events``): every transition
        #: emits ``breaker.transition`` — the flight-recorder twin of
        #: the gauge, joinable with the commit events around it.  None
        #: = process default journal.
        self._journal = journal
        #: Transitions recorded under the lock, emitted AFTER release:
        #: journal subscribers (the postmortem trigger) may read
        #: breaker state back, and emitting under ``self._lock`` would
        #: deadlock that re-entry.
        self._pending_events: list = []
        self._lock = threading.Lock()
        self._state = BREAKER_CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probes_in_flight = 0
        self._half_open_since = 0.0
        # The gauge exists (at 0 = closed) from construction, so
        # /metrics always shows breaker state, not only after the first
        # incident.
        self._gauge = self._registry.gauge(
            "circuit_breaker_state", labels={"backend": name}
        )
        self._gauge.set(_STATE_VALUES[BREAKER_CLOSED])

    # -- transitions (all callers hold self._lock) --------------------------

    def _transition(self, state: str) -> None:
        if state == self._state:
            return
        from_state = self._state
        self._state = state
        self._gauge.set(_STATE_VALUES[state])
        self._registry.counter(
            "breaker_transitions", labels={"backend": self.name, "to": state}
        ).add(1)
        self._pending_events.append(
            {
                "backend": self.name,
                "from": from_state,
                "to": state,
                "consecutive_failures": self._consecutive_failures,
            }
        )

    def _flush_events(self) -> None:
        """Emit queued transition events — callers must NOT hold
        ``self._lock`` (journal subscribers may read breaker state)."""
        with self._lock:
            pending, self._pending_events = self._pending_events, []
        if not pending:
            return
        j = self._journal
        if j is None:
            from svoc_torch.utils.events import journal as j
        for data in pending:
            j.emit("breaker.transition", **data)

    # -- the public protocol ------------------------------------------------

    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """May the caller attempt the operation now?  Half-open probe
        slots are *claimed* by this call — a True answer must be
        followed by exactly one ``record_success``/``record_failure``."""
        try:
            with self._lock:
                if self._state == BREAKER_CLOSED:
                    return True
                if self._state == BREAKER_OPEN:
                    if self._clock() - self._opened_at >= self.reset_timeout_s:
                        self._transition(BREAKER_HALF_OPEN)
                        self._probes_in_flight = 0
                        self._half_open_since = self._clock()  # svoc: volatile(restore collapses half-open to OPEN with a fresh reset window — restore_breaker_state — so the probe-window clock re-arms on the next transition)
                    else:
                        return False
                # half-open: admit up to the probe budget.  A probe whose
                # caller died between allow() and record_* would otherwise
                # wedge the breaker half-open with zero budget forever —
                # after a full reset window with no verdict, reopen the
                # probe window.
                if (
                    self._probes_in_flight >= self.half_open_max_probes
                    and self._clock() - self._half_open_since
                    >= self.reset_timeout_s
                ):
                    self._probes_in_flight = 0
                    self._half_open_since = self._clock()
                if self._probes_in_flight < self.half_open_max_probes:
                    self._probes_in_flight += 1
                    return True
                return False
        finally:
            self._flush_events()

    def retry_after_s(self) -> float:
        """Seconds until the next half-open probe window (0 when the
        breaker already admits calls)."""
        with self._lock:
            if self._state != BREAKER_OPEN:
                return 0.0
            return max(
                0.0, self.reset_timeout_s - (self._clock() - self._opened_at)
            )

    def record_success(self) -> None:
        with self._lock:
            self._consecutive_failures = 0
            self._probes_in_flight = 0
            self._transition(BREAKER_CLOSED)
        self._flush_events()

    def record_failure(self) -> None:
        with self._lock:
            self._consecutive_failures += 1
            if self._state == BREAKER_HALF_OPEN:
                # the probe failed — straight back to open
                self._opened_at = self._clock()
                self._probes_in_flight = 0
                self._transition(BREAKER_OPEN)
            elif (
                self._state == BREAKER_CLOSED
                and self._consecutive_failures >= self.failure_threshold
            ):
                self._opened_at = self._clock()
                self._transition(BREAKER_OPEN)
        self._flush_events()

    def guard(self):
        """``with breaker.guard():`` — raises :class:`CircuitOpenError`
        when not admitted, records success/failure from the block's
        outcome."""
        return _BreakerGuard(self)


class _BreakerGuard:
    def __init__(self, breaker: CircuitBreaker):
        self._breaker = breaker

    def __enter__(self):
        if not self._breaker.allow():
            raise CircuitOpenError(
                self._breaker.name, self._breaker.retry_after_s()
            )
        return self._breaker

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None:
            self._breaker.record_success()
        else:
            self._breaker.record_failure()
        return False
