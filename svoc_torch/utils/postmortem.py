"""Debug-bundle assembly and the auto-trigger monitor.

Mirrors :mod:`svoc_tpu.utils.postmortem` (``postmortem.py:1-450``):
:class:`SignalChain`, :func:`build_bundle` and
:class:`PostmortemMonitor`.  ``profiler=`` takes a
:class:`~svoc_torch.obsplane.profiler.ProfileCapture` (any object with
``maybe_capture(reason)``): breaker-open and SLO-burn events start a
bounded, rate-limited capture (``postmortem.py:261-277, 384-391``).

When something breaks at 2 a.m. the evidence is spread over four
subsystems — the event journal, the span ring, the metrics registry,
and the session's resilience/robustness snapshots — and most of it
lives in bounded rings that the NEXT hour of traffic will overwrite.
A **postmortem bundle** freezes all of it into one atomically-written
JSON file at the moment of the incident:

- the journal tail (typed events, newest last), its counts-by-type and
  fingerprint,
- the span ring tail (with lineage ids, joinable against the events),
- the metrics registry (counters, gauges, per-stage percentiles),
- the SLO evaluator's burn-rate snapshot (when wired),
- the session's resilience snapshot + configuration,
- the relevant environment (``SVOC_*`` / ``JAX_*`` / ``XLA_*``, the
  reference's filter, kept so bundles compare key for key).

:func:`build_bundle` assembles one on demand (tests, a drain); :class:`PostmortemMonitor` subscribes to a
journal and builds one automatically on incident-class events —
breaker-open transitions, quarantine spikes, ``interval_valid=False``
consensus results, producer crashes — rate-limited and bounded so an
incident storm produces a handful of bundles, not a disk full.

Writes are atomic (tmp + ``os.replace``): a bundle either exists whole
or not at all — half a postmortem is worse than none.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from svoc_torch.utils.artifacts import atomic_write_json
from svoc_torch.utils.events import EventJournal, EventRecord
from svoc_torch.utils.events import journal as _default_journal
from svoc_torch.utils.metrics import MetricsRegistry
from svoc_torch.utils.metrics import registry as _default_registry
from svoc_torch.utils.metrics import tracer as _default_tracer

BUNDLE_FORMAT = "svoc-postmortem-v1"

#: Keys a complete bundle must carry.
BUNDLE_KEYS = (
    "format",
    "built_at",
    "trigger",
    "journal",
    "spans",
    "metrics",
    "slo",
    "resilience",
    "config",
    "env",
)

class SignalChain:
    """Install one callback on a set of signals, CHAINING whatever was
    there before — the one implementation of the prev-handler dance
    shared by :class:`PostmortemMonitor` and
    :class:`svoc_torch.durability.recovery.GracefulDrain`:

    - a callable previous handler runs after the callback;
    - ``SIG_IGN`` stays ignored (the callback runs, but an ignored
      signal is never converted into process death);
    - the default disposition is restored and the signal re-delivered
      otherwise, so the process still dies with the conventional exit
      status.

    Install failures (non-main thread, unsupported platform) are
    skipped silently — hooks are best-effort by design.
    """

    def __init__(self, callback: Callable[[int, Any], None]):
        self._callback = callback
        self._prev: Dict[int, Any] = {}

    def install(self, signals) -> None:
        import signal as _signal

        for sig in signals:
            try:
                prev = _signal.signal(sig, self._on_signal)
            except (ValueError, OSError):
                continue
            self._prev[sig] = prev

    def uninstall(self) -> None:
        import signal as _signal

        for sig, prev in self._prev.items():
            try:
                _signal.signal(
                    sig, prev if prev is not None else _signal.SIG_DFL
                )
            except (ValueError, OSError):
                pass
        self._prev.clear()

    def _on_signal(self, signum, frame) -> None:
        import signal as _signal

        self._callback(signum, frame)
        prev = self._prev.get(signum)
        if prev is _signal.SIG_IGN:
            return
        if callable(prev):
            prev(signum, frame)
        else:
            _signal.signal(signum, _signal.SIG_DFL)
            os.kill(os.getpid(), signum)


_bundle_counter = iter(range(1, 10**9))
_bundle_counter_lock = threading.Lock()


def _next_bundle_id() -> int:
    with _bundle_counter_lock:
        return next(_bundle_counter)


def _config_dict(config: Any) -> Optional[Dict[str, Any]]:
    if config is None:
        return None
    if dataclasses.is_dataclass(config):
        from svoc_torch.utils.events import _json_safe

        return _json_safe(dataclasses.asdict(config))
    return {"repr": repr(config)}


def build_bundle(
    path: Optional[str] = None,
    *,
    out_dir: str = ".",
    trigger: str = "manual",
    trigger_event: Optional[Dict[str, Any]] = None,
    session=None,
    registry: Optional[MetricsRegistry] = None,
    tracer=None,
    journal: Optional[EventJournal] = None,
    slo=None,
    events_tail: int = 512,
    spans_tail: int = 256,
    extra: Optional[Dict[str, Any]] = None,
) -> str:
    """Assemble and atomically write one bundle; returns its path.

    Everything defaults to the process-wide singletons; pass a
    ``session`` to include its resilience snapshot and configuration,
    and an ``slo`` evaluator to freeze the burn rates.
    """
    reg = registry or _default_registry
    t = tracer if tracer is not None else _default_tracer
    j = journal if journal is not None else _default_journal

    counters = {key: c.count for key, c in sorted(reg.counters.items())}
    gauges = {key: g.get() for key, g in sorted(reg.gauges.items())}
    bundle: Dict[str, Any] = {
        "format": BUNDLE_FORMAT,
        "built_at": time.strftime("%Y-%m-%d %H:%M:%S"),
        "trigger": trigger,
        "trigger_event": trigger_event,
        "journal": {
            "counts_by_type": j.counts_by_type(),
            "last_seq": j.last_seq(),
            "fingerprint": j.fingerprint(),
            "events": [e.as_dict() for e in j.recent(events_tail)],
        },
        "spans": [
            {
                "name": s.name,
                "start_s": round(s.start_s, 6),
                "duration_s": round(s.duration_s, 6),
                "span_id": s.span_id,
                "parent_id": s.parent_id,
                "thread": s.thread,
                "lineage": getattr(s, "lineage", None),
            }
            for s in t.recent(spans_tail)
        ],
        "metrics": {
            "stage_seconds": reg.stage_snapshot(),
            "counters": counters,
            "gauges": gauges,
        },
        "slo": None,
        "resilience": None,
        "config": None,
        "env": {
            k: v
            for k, v in sorted(os.environ.items())
            if k.startswith(("SVOC_", "JAX_", "XLA_"))
        },
    }
    if slo is not None:
        try:
            bundle["slo"] = slo.evaluate()
        except Exception as e:
            bundle["slo"] = {"error": repr(e)}
    if session is not None:
        try:
            bundle["resilience"] = session.resilience_snapshot()
        except Exception as e:
            bundle["resilience"] = {"error": repr(e)}
        bundle["config"] = _config_dict(getattr(session, "config", None))
    if extra:
        bundle["extra"] = extra

    if path is None:
        path = os.path.join(
            out_dir,
            f"postmortem-{trigger.replace('/', '_')}-{_next_bundle_id():03d}.json",
        )
    # Durable, not just atomic: a bundle exists to
    # outlive the incident — including a host that dies right after.
    atomic_write_json(path, bundle)
    return path


class PostmortemMonitor:
    """Auto-trigger: subscribe to a journal and bundle on incidents.

    Classification (docs/OBSERVABILITY.md §postmortem):

    - ``breaker.transition`` with ``to="open"`` — the chain was just
      declared down,
    - ``quarantine.verdict`` refusing ≥ ``quarantine_spike`` slots in
      one block — an upstream data incident,
    - ``consensus.result`` with ``interval_valid=False`` — the block
      could not produce a meaningful interval,
    - ``pipeline.producer_error`` — the prefetch producer crashed,
    - any ``crash`` event (emitters may report their own).

    Rate-limited (``min_interval_s`` between bundles) and bounded
    (``max_bundles`` lifetime) so an incident storm cannot fill the
    disk; every bundle built is itself journaled as
    ``postmortem.bundle`` (which the classifier ignores — no
    recursion).  Callbacks run on the EMITTING thread, so bundle
    assembly is bounded ring/registry reads only — no chain I/O.
    """

    def __init__(
        self,
        out_dir: str = ".",
        *,
        session=None,
        registry: Optional[MetricsRegistry] = None,
        tracer=None,
        journal: Optional[EventJournal] = None,
        slo=None,
        quarantine_spike: int = 3,
        min_interval_s: float = 60.0,
        max_bundles: int = 8,
        clock: Callable[[], float] = time.monotonic,
        profiler=None,
    ):
        self.out_dir = out_dir
        self._session = session
        self._registry = registry
        self._tracer = tracer
        self._journal = journal if journal is not None else _default_journal
        self._slo = slo
        self.quarantine_spike = quarantine_spike
        self.min_interval_s = min_interval_s
        self.max_bundles = max_bundles
        self._clock = clock
        #: An optional profile capture (duck-typed:
        #: ``maybe_capture(reason)``): incident-class events (breaker-open, SLO
        #: burn) trigger a bounded, rate-limited automatic capture —
        #: the device-side view a bundle's host rings cannot carry.
        self._profiler = profiler
        self._lock = threading.Lock()
        self._last_built: Optional[float] = None
        #: Suppression latch per reason: the counter bumps on EVERY
        #: suppressed incident, the ``postmortem.suppressed`` journal
        #: event fires ONCE per latch (cleared by the next bundle that
        #: does build) — visible without being an event storm of its
        #: own.
        self._suppressed_latched: set = set()
        #: Paths of every bundle this monitor built (soak artifacts).
        self.bundles: List[str] = []
        self._shutdown_done = False
        self._signal_chain = SignalChain(
            lambda signum, _frame: self.shutdown(f"signal_{signum}")
        )
        self._atexit_registered = False

    def install(self) -> "PostmortemMonitor":
        self._journal.subscribe(self._on_event)
        return self

    def uninstall(self) -> None:
        self._journal.unsubscribe(self._on_event)

    # -- orderly-shutdown bundles (docs/RESILIENCE.md §drain) ---------------

    def install_shutdown_hooks(self, signals=None) -> "PostmortemMonitor":
        """Register SIGTERM + atexit hooks so an ORDERLY shutdown (and
        the parent of an OOM-killed child, whose own atexit still runs)
        always leaves a final bundle.  The bundle is classified
        ``shutdown`` — not ``crash`` — and is EXEMPT from the 60 s rate
        limit and the lifetime cap: a dying process gets its last word
        even mid-incident-storm.  Chained via :class:`SignalChain`: a
        previously-installed handler still runs after the bundle is
        written, and an ignored signal stays ignored."""
        import atexit
        import signal as _signal

        if signals is None:
            signals = (_signal.SIGTERM,)
        self._signal_chain.install(signals)
        if not self._atexit_registered:
            atexit.register(self.shutdown, "atexit")
            self._atexit_registered = True
        return self

    def uninstall_shutdown_hooks(self) -> None:
        self._signal_chain.uninstall()

    def shutdown(self, reason: str = "shutdown") -> Optional[str]:
        """Build the final bundle, once (later calls — e.g. atexit
        after a SIGTERM already bundled — are no-ops)."""
        with self._lock:
            if self._shutdown_done:
                return None
            self._shutdown_done = True
        try:
            path = build_bundle(
                out_dir=self.out_dir,
                trigger="shutdown",
                trigger_event={"reason": reason},
                session=self._session,
                registry=self._registry,
                tracer=self._tracer,
                journal=self._journal,
                slo=self._slo,
            )
        except Exception:
            # A failing teardown bundle must never turn a clean
            # shutdown into a crash.
            (self._registry or _default_registry).counter(
                "postmortem_errors"
            ).add(1)
            return None
        with self._lock:
            self.bundles.append(path)
        (self._registry or _default_registry).counter(
            "postmortem_bundles", labels={"trigger": "shutdown"}
        ).add(1)
        self._journal.emit(
            "postmortem.bundle", trigger="shutdown", reason=reason, path=path
        )
        return path

    def classify(self, record: EventRecord) -> Optional[str]:
        """The trigger name for an incident-class event, else None."""
        if record.type == "breaker.transition" and record.data.get("to") == "open":
            return "breaker_open"
        if record.type == "quarantine.verdict":
            refused = int(record.data.get("total", 0) or 0) - int(
                record.data.get("admitted", 0) or 0
            )
            if refused >= self.quarantine_spike:
                return "quarantine_spike"
        if (
            record.type == "consensus.result"
            and record.data.get("interval_valid") is False
        ):
            return "interval_invalid"
        if record.type == "pipeline.producer_error":
            return "producer_error"
        if record.type == "crash":
            return "crash"
        return None

    def _on_event(self, record: EventRecord) -> None:
        trigger = self.classify(record)
        if self._profiler is not None and (
            trigger == "breaker_open" or record.type == "slo.alert"
        ):
            # Incident-triggered device capture (docs/OBSERVABILITY.md
            # §cost-attribution): bounded duration + its own rate limit
            # live in the profiler; a capture failure lands in
            # profile_errors and never blocks the bundle below.
            self._profiler.maybe_capture(
                "slo_burn" if record.type == "slo.alert" else trigger
            )
        if trigger is None:
            return
        now = self._clock()
        suppressed: Optional[str] = None
        first_latch = False
        with self._lock:
            if len(self.bundles) >= self.max_bundles:
                suppressed = "cap"
            elif (
                self._last_built is not None
                and now - self._last_built < self.min_interval_s
            ):
                suppressed = "rate_limit"
            else:
                self._last_built = now
            if suppressed is not None:
                first_latch = suppressed not in self._suppressed_latched
                self._suppressed_latched.add(suppressed)
        if suppressed is not None:
            # Visible suppression (the satellite contract): every
            # suppressed incident counts; the journal sees ONE latch
            # event per reason, emitted outside the monitor lock
            # (journal lock is a leaf).  classify() has no
            # rule for postmortem.suppressed, so no recursion.
            (self._registry or _default_registry).counter(
                "postmortem_suppressed", labels={"reason": suppressed}
            ).add(1)
            if first_latch:
                self._journal.emit(
                    "postmortem.suppressed",
                    lineage=record.lineage,
                    reason=suppressed,
                    trigger=trigger,
                )
            return
        path = build_bundle(
            out_dir=self.out_dir,
            trigger=trigger,
            trigger_event=record.as_dict(),
            session=self._session,
            registry=self._registry,
            tracer=self._tracer,
            journal=self._journal,
            slo=self._slo,
        )
        with self._lock:
            self.bundles.append(path)
            # A successful bundle re-arms the suppression latches: the
            # NEXT suppression window journals again.
            self._suppressed_latched.clear()
        (self._registry or _default_registry).counter(
            "postmortem_bundles", labels={"trigger": trigger}
        ).add(1)
        self._journal.emit(
            "postmortem.bundle", lineage=record.lineage,
            trigger=trigger, path=path,
        )
