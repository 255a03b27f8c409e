"""Retry policies and idempotency-aware resume of partial fleet commits.

Mirrors :mod:`svoc_tpu.resilience.retry` (``retry.py:1-492``), the
whole module.  The reference imports ``report_batch_fallback`` from
``svoc_tpu/consensus/dispatch.py:389``; the port has no ``dispatch``
module (one consensus route per device), so the counted, log-once
batched-commit fallback lives here, as :func:`report_batch_fallback`.

Two layers:

- :func:`call_with_retry` — the generic wrapper: exponential backoff
  with *decorrelated jitter* (``sleep = min(cap, U(base, 3·prev))`` —
  the AWS-architecture variant that avoids thundering-herd
  synchronization without the full-jitter's occasional zero waits),
  bounded by ``max_attempts`` and an overall deadline.

- :func:`commit_fleet_with_resume` — the fleet-commit specialization.
  The chain has no rollback: a failure after k transactions leaves k
  predictions on chain (``ChainCommitError.committed``), so a naive
  whole-fleet retry would DOUBLE-SEND the committed prefix (burning
  nonces and gas, and on the local simulator re-running consensus
  transitions no fetch produced).  Resume instead restarts the loop at
  the failed oracle (``start=e.committed`` — commit order is
  oracle-list order, so the absolute committed count IS the failure
  index), re-sending only the stranded suffix.  An oracle that keeps
  failing past its per-oracle attempt budget is *skipped* (recorded in
  ``CommitOutcome.stranded``) so one dead signer cannot starve the
  rest of the fleet — G-Core's degraded-but-alive discipline; the
  health supervisor then decides whether to vote it out.

Metric series (shared registry): ``retries_total{op=...}``,
``commit_resumes_total``, ``commit_stranded_total``.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

from svoc_torch.io.chain import (
    BatchCommitUnsupported,
    ChainAdapter,
    ChainCommitError,
)
from svoc_torch.resilience.breaker import CircuitBreaker, CircuitOpenError
from svoc_torch.utils.metrics import MetricsRegistry
from svoc_torch.utils.metrics import registry as _default_registry


# ---------------------------------------------------------------------------
# The commit-plane mode and its counted fallback (the reference keeps both
# in ``svoc_tpu/consensus/dispatch.py:165-203, 302-414``).
# ---------------------------------------------------------------------------

ALLOWED_COMMIT_MODES = ("per_tx", "batched")
COMMIT_MODE_ENV = "SVOC_COMMIT_MODE"
#: The port's default commit plane.  The reference resolves its default
#: from the committed ``PERF_DECISIONS.json`` record (``:5``,
#: ``"commit_mode": "batched"``); the port reads no file of the JAX
#: package and keeps that decision as this constant.
DEFAULT_COMMIT_MODE = "batched"
BATCH_FALLBACK_COUNTER = "commit_batch_fallback"


class CommitModeError(ValueError):
    """An unknown commit-plane mode was requested."""


def validate_commit_mode(mode: str, source: str = "caller") -> str:
    if mode not in ALLOWED_COMMIT_MODES:
        allowed = ", ".join(repr(v) for v in ALLOWED_COMMIT_MODES)
        raise CommitModeError(
            f"commit_mode {mode!r} (from {source}) is not a known commit "
            f"mode: allowed values are {allowed}; set {COMMIT_MODE_ENV} "
            "to override the default"
        )
    return mode


def resolve_commit_mode() -> str:
    """``SVOC_COMMIT_MODE`` when set, else :data:`DEFAULT_COMMIT_MODE`.
    ``"batched"`` sends a clean fleet as ONE chain RPC with a counted
    per-tx fallback; ``"per_tx"`` keeps the one-signed-tx-per-oracle
    loop.  Both give the same journal events and chain state; resolve
    it once per Session."""
    env = os.environ.get(COMMIT_MODE_ENV, "").strip()
    if env:
        return validate_commit_mode(env, COMMIT_MODE_ENV)
    return DEFAULT_COMMIT_MODE


_batch_fallback_lock = threading.Lock()
_batch_fallback_logged: set = set()
_batch_log = logging.getLogger("svoc_torch.io.chain.batch")


def report_batch_fallback(
    reason: str,
    *,
    detail: str = "",
    metrics: Optional[MetricsRegistry] = None,
) -> None:
    """Count one batched-commit → per-tx fallback
    (``commit_batch_fallback{reason=}``) and log the FIRST occurrence of
    each reason.

    Reasons: ``unsupported`` (the backend has no batched entrypoint),
    ``skip_slots`` (quarantine refusals force tx granularity),
    ``batch_error`` (the single batched RPC failed mid-fleet; the resume
    loop re-sends the stranded suffix per tx), ``uncertified`` (a
    raise-mode backend declined before mutation)."""
    (metrics or _default_registry).counter(
        BATCH_FALLBACK_COUNTER, labels={"reason": reason}
    ).add(1)
    with _batch_fallback_lock:
        if reason in _batch_fallback_logged:
            return
        _batch_fallback_logged.add(reason)
    _batch_log.warning(
        "batched fleet commit fell back to the per-tx loop (reason=%s%s); "
        "further fallbacks are counted in %s{reason=%s} without logging",
        reason,
        f": {detail}" if detail else "",
        BATCH_FALLBACK_COUNTER,
        reason,
    )


def reset_batch_fallback_log() -> None:
    """Re-arm the one-shot batched-commit log (tests)."""
    with _batch_fallback_lock:
        _batch_fallback_logged.clear()


@dataclass(frozen=True)
class RetryPolicy:
    """Backoff and deadline configuration.

    ``max_attempts`` bounds *consecutive* failures of one operation
    (for fleet commits: per oracle — the budget before that oracle is
    stranded).  ``attempt_deadline_s`` is the per-attempt time budget:
    a failed attempt that already overran it skips the backoff sleep
    (the stall itself was the backoff).  ``overall_deadline_s`` bounds
    the whole retried operation; when the next backoff would cross it,
    the last error propagates.  ``jitter_seed`` pins the jitter RNG for
    deterministic chaos replay (None = nondeterministic, production).
    """

    max_attempts: int = 4
    base_s: float = 0.05
    cap_s: float = 2.0
    attempt_deadline_s: Optional[float] = None
    overall_deadline_s: Optional[float] = None
    jitter_seed: Optional[int] = None

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.base_s < 0 or self.cap_s < self.base_s:
            raise ValueError("need 0 <= base_s <= cap_s")

    def delays(self) -> Iterator[float]:
        """The decorrelated-jitter backoff sequence."""
        rng = random.Random(self.jitter_seed)
        prev = self.base_s
        while True:
            prev = min(self.cap_s, rng.uniform(self.base_s, prev * 3))
            yield prev


def call_with_retry(
    fn: Callable[[], Any],
    policy: RetryPolicy = RetryPolicy(),
    *,
    op: str = "call",
    retry_on: Tuple[type, ...] = (Exception,),
    sleep: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.monotonic,
    on_retry: Optional[Callable[[int, BaseException, float], None]] = None,
    registry: Optional[MetricsRegistry] = None,
):
    """Run ``fn`` under the policy; re-raises the last error on
    exhaustion (never wraps — callers keep their typed exceptions and,
    for :class:`ChainCommitError`, the partial-commit accounting)."""
    reg = registry or _default_registry
    deadline = (
        clock() + policy.overall_deadline_s
        if policy.overall_deadline_s is not None
        else None
    )
    delays = policy.delays()
    attempt = 0
    while True:
        attempt += 1
        t0 = clock()
        try:
            return fn()
        except retry_on as e:
            if attempt >= policy.max_attempts:
                raise
            delay = next(delays)
            if (
                policy.attempt_deadline_s is not None
                and clock() - t0 > policy.attempt_deadline_s
            ):
                delay = 0.0  # the attempt itself overran — don't stack waits
            if deadline is not None and clock() + delay > deadline:
                raise
            reg.counter("retries", labels={"op": op}).add(1)
            if on_retry is not None:
                on_retry(attempt, e, delay)
            sleep(delay)


@dataclass(frozen=True)
class CommitOutcome:
    """What a resilient fleet commit actually did.

    ``sent`` counts transactions that reached the chain this cycle
    (each oracle at most once — resume never re-sends a committed
    prefix); ``stranded`` the oracle addresses skipped after exhausting
    their per-oracle attempt budget; ``attempts`` the commit-loop
    passes (1 = clean single pass).
    """

    sent: int
    total: int
    stranded: Tuple[Any, ...] = ()
    attempts: int = 1

    @property
    def complete(self) -> bool:
        return not self.stranded and self.sent == self.total


def _landed(e: ChainCommitError, start: int, wal=None) -> int:
    """Txs the failing attempt actually landed: ``sent_count`` when the
    raiser supplied it (it diverges from the index delta whenever
    quarantine skips sit inside the attempted range); else the WAL's
    durable landed count for the attempt when a commit-intent WAL is
    riding the loop (the raiser died BEFORE reporting — its index is a
    guess, the fsynced landed records are not); else the
    attempt-relative index delta — never ``committed`` itself, which on
    a resumed attempt counts the already-landed prefix (older
    pickles and third-party raisers may lack the attribute)."""
    sent_count = getattr(e, "sent_count", None)
    if sent_count is not None:
        return sent_count
    if wal is not None:
        return wal.attempt_landed
    return e.committed - start


def _failure_index(e: ChainCommitError, wal=None) -> int:
    """The absolute fleet index to resume at.  ``e.committed`` on the
    well-behaved paths; when the raiser supplied no ``sent_count`` (it
    died before reporting) AND a commit-intent WAL rode the attempt,
    the WAL's attempt cursor — the last slot with a durable intent and
    no landed record — is authoritative: a backend that raised with an
    optimistically-advanced ``committed`` would otherwise make resume
    SKIP a tx that never landed (the pre-report death window,
    docs/RESILIENCE.md §durability)."""
    if wal is not None and getattr(e, "sent_count", None) is None:
        cursor = wal.attempt_cursor()
        if cursor is not None:
            return cursor
    return e.committed


def commit_fleet_with_resume(
    adapter: ChainAdapter,
    predictions: Sequence,
    policy: RetryPolicy = RetryPolicy(),
    *,
    breaker: Optional[CircuitBreaker] = None,
    skip: Sequence[int] = (),
    sleep: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.monotonic,
    on_oracle_failure: Optional[Callable[[Any, ChainCommitError], None]] = None,
    registry: Optional[MetricsRegistry] = None,
    journal=None,
    lineage: Optional[str] = None,
    wal=None,
    commit_mode: str = "per_tx",
) -> CommitOutcome:
    """Commit the whole fleet, resuming across partial failures.

    Invariants:

    - **No duplicate transactions.**  Each resume restarts at the
      absolute failure index (``ChainCommitError.committed`` — commit
      order is oracle-list order), so an oracle whose tx succeeded is
      never re-sent (the chaos replay test counts per-oracle sends to
      prove it).
    - **Degraded beats dead.**  ``policy.max_attempts`` consecutive
      failures of ONE oracle strand that oracle (skipped, recorded,
      reported to ``on_oracle_failure`` each attempt) and the loop
      moves on; the supervisor owns the replacement decision.
    - **The breaker is consulted per attempt and credited by
      progress.**  An OPEN breaker raises :class:`CircuitOpenError`
      carrying the partial ``sent`` count.  An attempt that LANDED
      transactions before failing records breaker *success* — the
      backend is demonstrably alive, and a few flaky signers must not
      open the whole chain's breaker (that would be a total commit
      outage on a healthy backend); only zero-progress failures count
      toward the trip threshold.

    The caller is expected to hold whatever whole-fleet atomicity lock
    it uses for plain commits (``Session._commit_lock``) — this
    function adds retries *inside* that atomicity, it does not replace
    it.

    ``skip`` (absolute fleet indices) forwards the quarantine gate's
    refusals to the commit loop (docs/ROBUSTNESS.md): skipped slots
    never produce a tx and are excluded from ``sent``/``total`` — a
    cycle whose only anomalies were quarantined vectors still reports
    ``complete=True`` (the gate's health accounting, not the commit
    outcome, carries the refusal).

    ``journal``/``lineage`` (``svoc_torch.utils.events``): the commit's
    story lands in the flight recorder as ``commit.sent`` /
    ``commit.retried`` / ``commit.skipped`` / ``commit.failed`` events
    tagged with the block lineage — the audit record's commit leg.

    ``wal`` (duck-typed, the reference's
    :class:`svoc_tpu.durability.wal.WALCycle`): rides the
    loop with per-tx intent/landed records so the accounting survives
    process death, and serves as the authoritative resume cursor and
    landed count whenever the raiser supplied no ``sent_count``
    (:func:`_failure_index` / :func:`_landed`).  Every exit path —
    success, stranded-complete, deadline, breaker, transport — closes
    the cycle (``done``); only a kill leaves it open for the restart
    reconciler (docs/RESILIENCE.md §durability).

    ``commit_mode="batched"`` (docs/RESILIENCE.md §batched-commits)
    sends the FIRST attempt as one batched RPC carrying the whole
    fleet payload
    (:meth:`~svoc_torch.io.chain.ChainAdapter.update_predictions_batched`;
    with a WAL riding, one fsynced ``intent_batch``/``landed_batch``
    pair instead of 2N per-tx records).  Every way the batched plane
    cannot serve is a COUNTED fallback to the per-tx loop
    (``commit_batch_fallback{reason=}``, never silent): an unsupported
    backend or quarantine ``skip`` slots fall back within the same
    attempt (identical journal events to ``per_tx`` mode — the seeded
    fingerprint-identity contract), and a mid-batch chain failure
    (``reason="batch_error"``) resumes the stranded suffix through the
    exact per-tx retry machinery below.  Chain state, journal events,
    and ``CommitOutcome`` accounting are identical across modes.
    """
    reg = registry or _default_registry
    if journal is None:
        from svoc_torch.utils.events import journal

    deadline = (
        clock() + policy.overall_deadline_s
        if policy.overall_deadline_s is not None
        else None
    )
    delays = policy.delays()
    skip_set = frozenset(int(i) for i in skip)
    if skip_set:
        journal.emit(
            "commit.skipped",
            lineage=lineage,
            reason="quarantine",
            slots=sorted(skip_set),
        )
    start = 0
    sent = 0
    attempts = 0
    consecutive: Dict[int, int] = {}
    stranded: List[Any] = []
    #: One batched attempt at most: after a mid-batch failure the
    #: resume machinery below owns the stranded suffix per tx (the
    #: batched entrypoint has no skip/strand vocabulary).
    use_batched = commit_mode == "batched"
    while True:
        if breaker is not None and not breaker.allow():
            journal.emit(
                "commit.failed",
                lineage=lineage,
                reason="circuit_open",
                backend=breaker.name,
                sent=sent,
            )
            if wal is not None:
                wal.done(sent, stranded, failed="circuit_open")
            raise CircuitOpenError(
                breaker.name, breaker.retry_after_s(), sent=sent
            )
        attempts += 1
        if wal is not None:
            wal.new_attempt(start)
        t0 = clock()
        batched_attempt, use_batched = use_batched, False
        try:
            if batched_attempt:
                try:
                    n = adapter.update_predictions_batched(
                        predictions, start=start, skip=skip,
                        lineage=lineage, wal=wal,
                    )
                except BatchCommitUnsupported as e:
                    # Same attempt, per-tx plane: identical journal
                    # events and attempt accounting to per_tx mode —
                    # only the counted fallback (and the RPC count)
                    # tells the modes apart.
                    report_batch_fallback(
                        e.reason, detail=e.detail, metrics=reg
                    )
                    batched_attempt = False
                    n = adapter.update_all_the_predictions(
                        predictions, start=start, skip=skip,
                        lineage=lineage,
                        on_intent=wal.intent if wal is not None else None,
                        on_landed=wal.landed if wal is not None else None,
                    )
            else:
                n = adapter.update_all_the_predictions(
                    predictions, start=start, skip=skip, lineage=lineage,
                    on_intent=wal.intent if wal is not None else None,
                    on_landed=wal.landed if wal is not None else None,
                )
        except ChainCommitError as e:
            if batched_attempt:
                # The single RPC failed mid-fleet: the stranded suffix
                # re-enters the per-tx resume machinery below — a mode
                # degradation, so it is counted, never silent.
                report_batch_fallback(
                    "batch_error", detail=str(e.cause), metrics=reg
                )
            landed = _landed(e, start, wal)
            if breaker is not None:
                # Progress credit: an attempt that LANDED txs before
                # failing proves the backend alive — record success, or
                # a handful of flaky SIGNERS would trip the BACKEND
                # breaker and turn a degraded fleet into a total commit
                # outage.  Only zero-progress failures count — judged
                # by LANDED txs (``sent_count``), not the index delta:
                # a quarantine-skipped slot between ``start`` and the
                # failure advances the index without proving anything
                # about the backend.
                if landed > 0:
                    breaker.record_success()
                else:
                    breaker.record_failure()
            if on_oracle_failure is not None:
                on_oracle_failure(e.failed_oracle, e)
            sent += landed
            # Absolute index of the failed oracle — the WAL's durable
            # intent/landed records override a pre-report raiser's
            # guess (satellite fix: an over-advanced index here would
            # skip a tx that never landed).
            j = _failure_index(e, wal)
            consecutive[j] = consecutive.get(j, 0) + 1
            if consecutive[j] >= policy.max_attempts:
                # This oracle exhausted its budget — strand it and keep
                # the rest of the fleet alive.
                stranded.append(e.failed_oracle)
                reg.counter("commit_stranded").add(1)
                journal.emit(
                    "commit.skipped",
                    lineage=lineage,
                    reason="stranded",
                    index=j,
                    oracle=e.failed_oracle,
                    attempts=consecutive[j],
                )
                start = j + 1
                if start >= e.total:
                    if breaker is not None and sent > 0:
                        # The BACKEND is alive (other signers landed);
                        # one dead oracle is the supervisor's problem,
                        # not a reason to open the backend breaker.
                        breaker.record_success()
                    journal.emit(
                        "commit.sent",
                        lineage=lineage,
                        sent=sent,
                        total=e.total - len(skip_set),
                        attempts=attempts,
                        stranded=len(stranded),
                    )
                    if wal is not None:
                        wal.done(sent, stranded)
                    return CommitOutcome(
                        sent=sent,
                        # Eligible slots only: quarantine skips are
                        # excluded from ``total`` exactly as from
                        # ``sent`` (docstring) — stranded slots stay
                        # counted, they are what marks incompleteness.
                        total=e.total - len(skip_set),
                        stranded=tuple(stranded),
                        attempts=attempts,
                    )
                reg.counter("retries", labels={"op": "commit"}).add(1)
                reg.counter("commit_resumes").add(1)
                continue  # no backoff: the budget burn was the wait
            start = j
            delay = next(delays)
            if (
                policy.attempt_deadline_s is not None
                and clock() - t0 > policy.attempt_deadline_s
            ):
                delay = 0.0
            if deadline is not None and clock() + delay > deadline:
                # e.committed is the FLEET INDEX of the failure (it
                # counts stranded positions that were skipped, never
                # sent) — carry the true landed-tx count alongside so
                # callers' chain_transactions accounting stays honest.
                e.resilient_sent = sent
                journal.emit(
                    "commit.failed",
                    lineage=lineage,
                    reason="deadline",
                    index=j,
                    oracle=e.failed_oracle,
                    sent=sent,
                    cause=str(e.cause),
                )
                if wal is not None:
                    wal.done(sent, stranded, failed="deadline")
                raise
            reg.counter("retries", labels={"op": "commit"}).add(1)
            journal.emit(
                "commit.retried",
                lineage=lineage,
                index=j,
                oracle=e.failed_oracle,
                attempt=consecutive[j],
                landed=landed,
                cause=str(e.cause),
            )
            if start > 0:
                reg.counter("commit_resumes").add(1)
            sleep(delay)
        except Exception:
            # Not a tx-level failure: the commit's own chain READ (the
            # oracle-list fetch is the first RPC of every attempt) or a
            # codec/programming error.  Record it on the breaker —
            # otherwise a full transport outage would bypass the trip
            # logic entirely (and a claimed half-open probe slot would
            # leak, wedging the breaker half-open forever).
            if breaker is not None:
                breaker.record_failure()
            journal.emit(
                "commit.failed",
                lineage=lineage,
                reason="transport",
                sent=sent,
            )
            if wal is not None:
                wal.done(sent, stranded, failed="transport")
            raise
        else:
            if breaker is not None:
                breaker.record_success()
            sent += n
            # The final attempt covered [start, fleet_total) and sent
            # ``n`` txs, passing over the skipped slots ≥ start — so
            # fleet_total = start + n + |skip ≥ start|, and the
            # eligible total excludes EVERY skipped slot (a resume past
            # a skipped slot must not report the cycle incomplete: the
            # refusal is the gate's accounting, not the commit's).
            fleet_total = start + n + sum(1 for i in skip_set if i >= start)
            journal.emit(
                "commit.sent",
                lineage=lineage,
                sent=sent,
                total=fleet_total - len(skip_set),
                attempts=attempts,
                stranded=len(stranded),
            )
            if wal is not None:
                wal.done(sent, stranded)
            return CommitOutcome(
                sent=sent,
                total=fleet_total - len(skip_set),
                stranded=tuple(stranded),
                attempts=attempts,
            )
