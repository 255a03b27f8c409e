"""Flight recorder: the typed event journal and block-lineage layer.

Mirrors :mod:`svoc_tpu.utils.events` (``events.py:1-771``), the whole
module, over the port's :mod:`svoc_torch.utils.metrics`.

Histograms aggregate the *distribution* and the resilience /
robustness layers make individual incidents *survivable* —
but when an oracle gets voted out at 2 a.m. no single record explains
which block, which quarantine verdict, which breaker transition, and
which replacement vote caused it.  This module is that record, the
correlation layer G-Core / HybridFlow-scale orchestrators treat as a
first-class subsystem:

- :class:`EventRecord` — one typed, structured event with a monotone
  per-journal sequence number, a wall-clock timestamp (excluded from
  replay fingerprints), an optional **block lineage id**, and JSON-safe
  payload data.
- :class:`EventJournal` — a process-wide, lock-guarded bounded ring of
  events with JSONL export (sharing the ``SVOC_TRACE_FILE`` rotation
  with spans), subscriber callbacks (the postmortem auto-trigger), and
  a seeded-run **fingerprint** so chaos/Byzantine replays can assert
  event-stream identity, not just outcome identity.
- :class:`RotatingJsonlWriter` — size-capped JSONL segments shared by
  the span tracer and the journal (``SVOC_TRACE_MAX_BYTES`` /
  ``SVOC_TRACE_KEEP``), exported as the ``trace_file_bytes`` gauge.
- :func:`mint_lineage` / :func:`audit_record` — the lineage id minted
  at ``Session.fetch`` and the per-block audit assembly ("block
  blk-00001f: 2 quarantined (nan, range), committed 5/7, oracle 0x16
  charged, breaker stayed closed").

Event taxonomy (docs/OBSERVABILITY.md §events): ``block.fetched``,
``quarantine.verdict``, ``consensus.result``, ``commit.sent`` /
``commit.retried`` / ``commit.skipped`` / ``commit.failed``,
``breaker.transition``, ``supervisor.health`` / ``supervisor.charge`` /
``supervisor.replacement``, ``pipeline.producer_error``,
``trace.write_error``, ``slo.alert``, ``postmortem.bundle``, and the
serving tier's ``serving.admitted`` / ``serving.shed`` /
``serving.step`` (docs/SERVING.md).

Cost model: emission is host-side only (never inside device code)
and the per-event cost is one lock-guarded deque append plus an
optional buffered file write — the same order as a completed span.
Fingerprints digest ``(seq, type, lineage, data)`` and **never** wall
timestamps, so two seeded replays of one scenario agree byte-for-byte.

Thread-safety/deadlock contract: the journal lock is a leaf lock;
subscriber callbacks run on the emitting thread OUTSIDE the journal
lock, so emitters must not hold their own locks across ``emit`` when a
subscriber could re-enter them (the circuit breaker queues transition
events and flushes them after releasing its lock for exactly this
reason).
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, Tuple

from svoc_torch.utils.metrics import MetricsRegistry
from svoc_torch.utils.metrics import registry as _default_registry

#: The documented event types (docs/OBSERVABILITY.md).  Emission is not
#: restricted to this set — new subsystems may add types — but the
#: audit/summary helpers key their severity handling off it.
EVENT_TYPES: Tuple[str, ...] = (
    "block.fetched",
    "quarantine.verdict",
    "consensus.result",
    "commit.sent",
    "commit.retried",
    "commit.skipped",
    "commit.failed",
    "commit.deferred",
    "breaker.transition",
    "supervisor.health",
    "supervisor.charge",
    "supervisor.replacement",
    "pipeline.producer_error",
    "trace.write_error",
    "slo.alert",
    "postmortem.bundle",
    "postmortem.suppressed",
    "profile.captured",
    "serving.admitted",
    "serving.shed",
    "serving.step",
    "serving.deferred",
    "durability.snapshot",
    "durability.reconcile",
    "durability.drain",
)

#: Types (plus breaker.transition→open) surfaced as "alerts" in journal
#: summaries and soak/bench artifacts.
ALERT_TYPES = frozenset(
    {"slo.alert", "pipeline.producer_error", "trace.write_error",
     "commit.failed", "postmortem.bundle"}
)


def fsync_dir(path: str) -> None:
    """fsync the DIRECTORY containing ``path`` — renames and creates
    are metadata, and until the directory entry is durable a crash can
    resurrect the pre-rename layout.  Shared by the rotating trace
    writer, the commit-intent WAL, and the snapshot writer; failures
    are swallowed (platforms without directory fds)."""
    dirname = os.path.dirname(os.path.abspath(path))
    try:
        fd = os.open(dirname, os.O_RDONLY)
    except OSError:  # svoclint: disable=SVOC014 -- deliberate: platforms without directory fds cannot fsync a directory at all — best-effort is this helper's documented contract and there is nothing to degrade TO
        return
    try:
        with contextlib.suppress(OSError):
            os.fsync(fd)
    finally:
        os.close(fd)


def _json_safe(value: Any) -> Any:
    """Coerce to JSON-serializable, deterministically: numpy scalars →
    Python, tuples/sets → lists, mappings recursed, everything else
    repr'd (addresses may be symbolic objects in tests)."""
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, Mapping):
        return {str(k): _json_safe(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_json_safe(v) for v in value]
    if isinstance(value, (set, frozenset)):
        return sorted(_json_safe(v) for v in value)
    item = getattr(value, "item", None)
    if callable(item):
        try:  # numpy / torch scalars
            return _json_safe(item())
        except (TypeError, ValueError):  # svoclint: disable=SVOC014 -- deliberate: repr() below IS the output for non-scalar .item() objects — a codec choice inside pure data conversion, not a degraded serving path
            pass
    return repr(value)


@dataclasses.dataclass(frozen=True)
class EventRecord:
    """One journal entry.  ``ts`` is wall-clock for operators and is
    excluded from :meth:`fingerprint_payload` — replay identity must
    not depend on the clock."""

    seq: int
    ts: float
    type: str
    lineage: Optional[str]
    data: Dict[str, Any]

    def as_dict(self) -> Dict[str, Any]:
        return {
            "seq": self.seq,
            "ts": round(self.ts, 6),
            "event": self.type,
            "lineage": self.lineage,
            "data": self.data,
        }

    def to_json(self) -> str:
        return json.dumps(self.as_dict(), sort_keys=True)

    def fingerprint_payload(self) -> Dict[str, Any]:
        """The replay-stable projection: everything except ``ts``."""
        return {
            "seq": self.seq,
            "event": self.type,
            "lineage": self.lineage,
            "data": self.data,
        }


class RotatingJsonlWriter:
    """Size-capped append-only JSONL with K rotated segments.

    ``path`` is the active segment; on overflow it rotates to
    ``path.1`` … ``path.<keep>`` (oldest dropped), so a 90-minute soak
    with ``SVOC_TRACE_FILE`` set is bounded at ``(keep+1)·max_bytes``
    instead of growing without limit.  Line-buffered like the
    tracer file, so every written line is durable without an explicit
    flush.  Thread-safe; the live size is exported as the
    ``trace_file_bytes{path=<basename>}`` gauge.
    """

    MAX_BYTES_ENV = "SVOC_TRACE_MAX_BYTES"
    KEEP_ENV = "SVOC_TRACE_KEEP"
    #: Opt-in crash durability (docs/OBSERVABILITY.md §tracing): "1"
    #: fsyncs the file after EVERY written line (and the directory on
    #: rotation), so the journal tail the recovery manager replays
    #: after a SIGKILL is complete up to the last emit.  Costs one
    #: fdatasync per event (~50 µs–2 ms depending on the disk) — leave
    #: it off for pure-observability traces, turn it on when the trace
    #: is a durability artifact (docs/RESILIENCE.md §durability).
    FSYNC_ENV = "SVOC_TRACE_FSYNC"
    DEFAULT_MAX_BYTES = 64 * 1024 * 1024
    DEFAULT_KEEP = 3

    def __init__(
        self,
        path: str,
        max_bytes: Optional[int] = None,
        keep: Optional[int] = None,
        registry: Optional[MetricsRegistry] = None,
        fsync: Optional[bool] = None,
    ):
        self.path = path
        if max_bytes is None:
            max_bytes = int(
                os.environ.get(self.MAX_BYTES_ENV, self.DEFAULT_MAX_BYTES)
            )
        if keep is None:
            keep = int(os.environ.get(self.KEEP_ENV, self.DEFAULT_KEEP))
        if fsync is None:
            fsync = os.environ.get(self.FSYNC_ENV, "") == "1"
        if max_bytes < 1:
            raise ValueError("max_bytes must be >= 1")
        if keep < 0:
            raise ValueError("keep must be >= 0")
        self.max_bytes = max_bytes
        self.keep = keep
        self.fsync = bool(fsync)
        self._registry = registry or _default_registry
        self._lock = threading.Lock()
        self._file = None
        self._size = 0
        self._gauge = self._registry.gauge(
            "trace_file_bytes", labels={"path": os.path.basename(path)}
        )

    def _open_locked(self) -> None:
        if self._file is None:
            self._file = open(self.path, "a", buffering=1)
            try:
                self._size = os.path.getsize(self.path)
            except OSError:  # svoclint: disable=SVOC014 -- deliberate: 0 is the CORRECT size for a just-created file — the rotation accounting starts fresh, nothing degrades
                self._size = 0

    def _rotate_locked(self) -> None:
        if self._file is not None:
            with contextlib.suppress(OSError):
                self._file.close()
            self._file = None
        if self.keep == 0:
            # No rotated segments kept: truncate in place.
            with contextlib.suppress(OSError):
                os.remove(self.path)
        else:
            with contextlib.suppress(OSError):
                os.remove(f"{self.path}.{self.keep}")
            for i in range(self.keep - 1, 0, -1):
                src = f"{self.path}.{i}"
                if os.path.exists(src):
                    with contextlib.suppress(OSError):
                        os.replace(src, f"{self.path}.{i + 1}")
            with contextlib.suppress(OSError):
                os.replace(self.path, f"{self.path}.1")
        if self.fsync:
            # The renames above are metadata: a torn segment chain
            # would break the recovery manager's walk.
            fsync_dir(self.path)
        self._size = 0

    def write_line(self, line: str) -> None:
        """Append one line (newline added).  Raises ``OSError`` on
        failure — the caller owns the never-break-the-pipeline policy
        (and the error accounting: ``trace_write_errors``)."""
        text = line + "\n"
        # Size accounting in BYTES (the cap's documented unit, and what
        # _open_locked seeds from os.path.getsize) — counting str
        # length would undercount multibyte payloads ~4× and blow the
        # (keep+1)·max_bytes soak bound.
        nbytes = len(text.encode("utf-8"))
        with self._lock:
            self._open_locked()
            if self._size and self._size + nbytes > self.max_bytes:
                self._rotate_locked()
                self._open_locked()
            self._file.write(text)
            if self.fsync:
                # Line-buffered write already reached the OS; fsync
                # pushes it to the platter so a SIGKILL one instruction
                # later cannot lose it (the recovery manager's replay
                # contract, docs/RESILIENCE.md §durability).
                with contextlib.suppress(OSError):
                    os.fsync(self._file.fileno())
            self._size += nbytes
            self._gauge.set(self._size)

    def flush(self) -> None:
        with self._lock:
            if self._file is not None:
                with contextlib.suppress(OSError):
                    self._file.flush()

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                with contextlib.suppress(OSError):
                    self._file.close()
                self._file = None

    def segments(self) -> List[str]:
        """Existing segment paths, newest first (active segment first)."""
        out = [self.path] if os.path.exists(self.path) else []
        for i in range(1, self.keep + 1):
            seg = f"{self.path}.{i}"
            if os.path.exists(seg):
                out.append(seg)
        return out


#: One writer per (real)path, process-wide, so the span tracer and the
#: event journal pointed at the same ``SVOC_TRACE_FILE`` share one size
#: account and one rotation schedule — two independent writers would
#: race the rename and double-rotate.
_writer_pool: Dict[str, RotatingJsonlWriter] = {}
_writer_pool_lock = threading.Lock()


def shared_writer(path: str) -> RotatingJsonlWriter:
    key = os.path.realpath(path)
    with _writer_pool_lock:
        writer = _writer_pool.get(key)
        if writer is None:
            writer = _writer_pool[key] = RotatingJsonlWriter(path)
        return writer


def release_writer(path: str) -> None:
    """Close the pooled writer's file handle for ``path`` (the writer
    stays pooled and reopens lazily on the next write).  Called when a
    tracer/journal is re-pointed away from a path — without it every
    abandoned trace destination would hold an open fd for the process
    lifetime."""
    key = os.path.realpath(path)
    with _writer_pool_lock:
        writer = _writer_pool.get(key)
    if writer is not None:
        writer.close()


def mint_lineage(n: int, prefix: str = "blk") -> str:
    """The canonical lineage-id form: ``blk-00001f`` for fetch claim 31.
    Deterministic in ``n`` so seeded replays mint identical ids."""
    return f"{prefix}-{int(n):06x}"


_lineage_scopes = itertools.count(1)


def lineage_scope() -> int:
    """A process-unique ordinal for lineage-minting scopes.  Several
    sessions share one process (and one default journal); without a
    scope each would mint ``blk-000001`` for its first fetch and their
    audit records would merge.  ``Session`` takes one at construction
    and mints ``blk<scope>-<claim>``."""
    return next(_lineage_scopes)


class EventJournal:
    """Bounded, lock-guarded ring of typed events + export/fingerprint.

    The process-wide default instance is :data:`journal`; seeded
    scenarios (``resilience/chaos.py``) construct their own so a replay
    starts from sequence 1 and two runs of one seed digest identically.
    """

    #: Same env var as the tracer: events and spans share one flight-
    #: recorder file (distinguished by their ``event`` vs ``name`` keys).
    TRACE_ENV = "SVOC_TRACE_FILE"

    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        capacity: int = 4096,
    ):
        self._registry = registry or _default_registry
        self._ring: deque = deque(maxlen=capacity)
        self._seq = itertools.count(1)
        self._lock = threading.Lock()
        self._subscribers: List[Callable[[EventRecord], None]] = []
        self._trace_path: Optional[str] = None
        self._trace_error = False

    # -- configuration ------------------------------------------------------

    def set_trace_file(self, path: Optional[str]) -> None:
        """Pin (or clear) the JSONL destination, overriding the env
        var; clears the write-error latch like the tracer's and
        releases the previous destination's pooled file handle."""
        with self._lock:
            old = self._resolve_path()
            self._trace_path = path
            self._trace_error = False
        if old and old != path:
            release_writer(old)

    def _resolve_path(self) -> Optional[str]:
        return self._trace_path or os.environ.get(self.TRACE_ENV) or None

    def subscribe(self, fn: Callable[[EventRecord], None]) -> None:
        """Register a callback run (on the emitting thread, outside the
        journal lock) for every subsequent event."""
        with self._lock:
            if fn not in self._subscribers:
                self._subscribers.append(fn)

    def unsubscribe(self, fn: Callable[[EventRecord], None]) -> None:
        with self._lock:
            if fn in self._subscribers:
                self._subscribers.remove(fn)

    # -- emission -----------------------------------------------------------

    def emit(
        self, event_type: str, lineage: Optional[str] = None, **data: Any
    ) -> EventRecord:
        """Record one event; returns the stored record."""
        safe_data = {k: _json_safe(v) for k, v in data.items()}
        with self._lock:
            # Seq allocation AND the append happen under one lock hold:
            # allocated outside, a preempted emitter could append its
            # lower seq after a racing higher one, breaking the strict
            # ring ordering since()/last_seq() consumers (the SSE
            # cursor) rely on.
            record = EventRecord(
                seq=next(self._seq),
                ts=time.time(),
                type=str(event_type),
                lineage=lineage,
                data=safe_data,
            )
            self._ring.append(record)
            subscribers = list(self._subscribers)
            path = self._resolve_path()
            write = path is not None and not self._trace_error
        self._registry.counter(
            "events_emitted", labels={"type": record.type}
        ).add(1)
        if write:
            try:
                shared_writer(path).write_line(record.to_json())
            except (OSError, ValueError):
                # A bad path must never take down the pipeline: latch
                # (until reconfigured) and count — same policy as the
                # tracer's write-error surfacing.
                with self._lock:
                    self._trace_error = True
                self._registry.counter("trace_write_errors").add(1)
        for fn in subscribers:
            try:
                fn(record)
            except Exception:
                # A broken subscriber (postmortem trigger mid-teardown)
                # must not poison emission for everyone else.
                self._registry.counter("event_subscriber_errors").add(1)
        return record

    # -- reads --------------------------------------------------------------

    def recent(
        self,
        n: Optional[int] = None,
        *,
        type: Optional[str] = None,
        lineage: Optional[str] = None,
        lineage_prefix: Optional[str] = None,
    ) -> List[EventRecord]:
        """Newest-last slice of the ring, optionally filtered by type
        and/or lineage BEFORE the tail cut (so ``recent(5,
        lineage=...)`` is the block's last 5 events, not the journal's
        last 5 that happen to match).  ``lineage_prefix`` matches a
        lineage FAMILY — the multi-claim fabric's per-claim partition:
        a claim session mints ``blk<scope>-<claim>-<n>`` ids, so the
        prefix ``blk<scope>-<claim>-`` selects every block that claim
        ever published (docs/FABRIC.md)."""
        with self._lock:
            events = list(self._ring)
        if type is not None:
            events = [e for e in events if e.type == type]
        if lineage is not None:
            events = [e for e in events if e.lineage == lineage]
        if lineage_prefix is not None:
            events = [
                e
                for e in events
                if e.lineage is not None
                and e.lineage.startswith(lineage_prefix)
            ]
        return events if n is None else events[-n:]

    def since(self, seq: int, limit: Optional[int] = None) -> List[EventRecord]:
        """Events with ``seq`` strictly greater than the given one —
        the SSE stream's cursor read."""
        with self._lock:
            events = [e for e in self._ring if e.seq > seq]
        return events if limit is None else events[:limit]

    def last_seq(self) -> int:
        with self._lock:
            return self._ring[-1].seq if self._ring else 0

    def counts_by_type(self) -> Dict[str, int]:
        with self._lock:
            events = list(self._ring)
        out: Dict[str, int] = {}
        for e in events:
            out[e.type] = out.get(e.type, 0) + 1
        return dict(sorted(out.items()))

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    # -- snapshot / recovery (docs/RESILIENCE.md §durability) ---------------

    def export_ring(self) -> List[Dict[str, Any]]:
        """The full buffered ring as JSON-safe dicts (``ts`` included —
        operators want wall time back after a restore; fingerprints
        still ignore it).  What the recovery manager's snapshot
        embeds."""
        with self._lock:
            return [e.as_dict() for e in self._ring]

    def restore(self, records: Iterable[Mapping[str, Any]]) -> int:
        """Rebuild the ring from :meth:`export_ring`-shaped dicts (a
        snapshot's journal section, optionally extended with the
        fsynced trace tail — :func:`read_trace_events`), PRESERVING the
        original seqs so fingerprints and audit records survive a
        process death.  Records are deduped by seq and sorted; the next
        ``emit`` continues numbering after the highest restored seq.
        Deliberately does NOT run subscribers — a restore replays
        history, it does not re-trigger postmortems.  Returns the
        number of restored events."""
        by_seq: Dict[int, EventRecord] = {}
        for r in records:
            rec = EventRecord(
                seq=int(r["seq"]),
                ts=float(r.get("ts", 0.0) or 0.0),
                type=str(r["event"]),
                lineage=r.get("lineage"),
                data=dict(r.get("data") or {}),
            )
            by_seq[rec.seq] = rec
        ordered = [by_seq[s] for s in sorted(by_seq)]
        with self._lock:
            self._ring.clear()
            self._ring.extend(ordered)
            last = ordered[-1].seq if ordered else 0
            self._seq = itertools.count(last + 1)
        return len(ordered)

    # -- replay identity ----------------------------------------------------

    def fingerprint(self, lineage_prefix: Optional[str] = None) -> str:
        """Canonical digest of the buffered event stream — sequence,
        types, lineage and data; never wall timestamps.  Two seeded
        replays of one scenario must agree on this byte-for-byte.

        ``lineage_prefix`` digests one claim's slice of a shared
        journal (the fabric smoke's per-claim replay witness).
        The filtered payloads still carry their GLOBAL seqs — per-claim
        identity across runs therefore also certifies that the
        scheduler interleaved the claims identically, which is exactly
        what a seeded fabric replay must reproduce."""
        with self._lock:
            events = list(self._ring)
        if lineage_prefix is not None:
            events = [
                e
                for e in events
                if e.lineage is not None
                and e.lineage.startswith(lineage_prefix)
            ]
        payloads = [e.fingerprint_payload() for e in events]
        return hashlib.sha256(
            json.dumps(payloads, sort_keys=True).encode()
        ).hexdigest()

    def summary(self, last_alerts: int = 5) -> Dict[str, Any]:
        """The artifact-embedded journal digest (soak/bench): counts by
        type, the last N alert-class events, and the fingerprint."""
        with self._lock:
            events = list(self._ring)
        alerts = [
            e.as_dict()
            for e in events
            if e.type in ALERT_TYPES
            or (e.type == "breaker.transition" and e.data.get("to") == "open")
        ]
        counts: Dict[str, int] = {}
        for e in events:
            counts[e.type] = counts.get(e.type, 0) + 1
        return {
            "events": len(events),
            "last_seq": events[-1].seq if events else 0,
            "counts_by_type": dict(sorted(counts.items())),
            "alerts": alerts[-last_alerts:],
            "fingerprint": self.fingerprint(),
        }


def read_trace_events(
    path: str, since_seq: int = 0, keep: Optional[int] = None
) -> List[Dict[str, Any]]:
    """Read journal events back out of a (possibly rotated) trace file
    — the recovery manager's roll-forward source (docs/RESILIENCE.md
    §durability).  Walks the rotated segments oldest→newest, keeps only
    EVENT lines (keyed ``event`` — the file is shared with span lines
    keyed ``name``), drops seqs ≤ ``since_seq``, and tolerates a torn
    final line (a SIGKILL mid-append leaves half a record; everything
    before it was fsynced when ``SVOC_TRACE_FSYNC=1``).  Mid-file
    garbage raises — that is corruption, not a crash artifact."""
    if keep is None:
        keep = int(
            os.environ.get(
                RotatingJsonlWriter.KEEP_ENV, RotatingJsonlWriter.DEFAULT_KEEP
            )
        )
    segments = [
        f"{path}.{i}" for i in range(keep, 0, -1) if os.path.exists(f"{path}.{i}")
    ]
    if os.path.exists(path):
        segments.append(path)
    out: List[Dict[str, Any]] = []
    for seg_idx, seg in enumerate(segments):
        with open(seg, "r") as f:
            lines = f.read().split("\n")
        # A trailing "" element means the file ends in a newline — the
        # normal case; anything else is a torn tail.
        torn = lines and lines[-1] != ""
        body, tail = (lines[:-1], lines[-1]) if lines else ([], "")
        for line in body:
            if not line:
                continue
            record = json.loads(line)
            if "event" in record and int(record.get("seq", 0)) > since_seq:
                out.append(record)
        if torn and tail:
            is_last = seg_idx == len(segments) - 1
            try:
                record = json.loads(tail)
            except ValueError:
                if not is_last:
                    raise ValueError(
                        f"corrupt trace segment {seg!r}: torn line in a "
                        "non-final segment"
                    )
                continue  # the crash artifact: ignore the torn append
            if "event" in record and int(record.get("seq", 0)) > since_seq:
                out.append(record)
    return out


#: Process-wide default journal (the apps layer, soak, and bench use
#: this), feeding the default metrics registry's ``events_emitted``
#: counters.
journal = EventJournal()


def emit_event(
    event_type: str, lineage: Optional[str] = None, **data: Any
) -> EventRecord:
    """``emit_event("block.fetched", lineage=..., n_comments=30)`` —
    the one-liner callsites use on the default journal.  Host-side
    only."""
    return journal.emit(event_type, lineage=lineage, **data)


def resolve_journal(injected) -> EventJournal:
    """An injected journal, or the process default — the one resolver
    the fabric router, the MultiSession facade, the durability plane,
    and the chaos harnesses share (``fabric.router`` re-exports it)."""
    if injected is not None:
        return injected
    return journal


# ---------------------------------------------------------------------------
# Per-block audit assembly
# ---------------------------------------------------------------------------


def _summarize(events: Iterable[EventRecord]) -> Dict[str, Any]:
    """The human-facing digest of one block's event stream."""
    quarantined: Dict[str, str] = {}
    charged: List[str] = []
    replaced: List[Dict[str, Any]] = []
    breaker: List[str] = []
    sent = skipped = retried = 0
    failures: List[str] = []
    interval_valid: Optional[bool] = None
    for e in events:
        if e.type == "quarantine.verdict":
            for slot, reason in (e.data.get("reasons") or {}).items():
                quarantined[str(slot)] = reason
        elif e.type == "supervisor.charge":
            charged.append(str(e.data.get("oracle")))
        elif e.type == "supervisor.replacement":
            replaced.append(dict(e.data))
        elif e.type == "breaker.transition":
            breaker.append(str(e.data.get("to")))
        elif e.type == "commit.sent":
            sent += int(e.data.get("sent", 0) or 0)
        elif e.type == "commit.skipped":
            skipped += len(e.data.get("slots") or []) or int(
                bool(e.data.get("oracle"))
            )
        elif e.type == "commit.retried":
            retried += 1
        elif e.type == "commit.failed":
            failures.append(str(e.data.get("cause", "")))
        elif e.type == "consensus.result":
            if "interval_valid" in e.data:
                interval_valid = bool(e.data["interval_valid"])
    return {
        "quarantined": quarantined,
        "charged": charged,
        "replacements": replaced,
        "breaker_transitions": breaker,
        "commit_sent": sent,
        "commit_skipped": skipped,
        "commit_retries": retried,
        "commit_failures": failures,
        "interval_valid": interval_valid,
    }


def audit_record(
    lineage: str,
    *,
    journal: Optional[EventJournal] = None,
    tracer: Optional[Any] = None,
) -> Dict[str, Any]:
    """Everything the flight recorder knows about one block: its
    events, its spans (the tracer threads lineage through nested
    stages), and a derived summary — the ``GET /api/audit/<block>`` /
    console ``audit`` payload."""
    from svoc_torch.utils import metrics as _metrics

    j = journal if journal is not None else globals()["journal"]
    t = tracer if tracer is not None else _metrics.tracer
    events = j.recent(lineage=lineage)
    spans = [
        {
            "name": s.name,
            "duration_s": round(s.duration_s, 6),
            "span_id": s.span_id,
            "parent_id": s.parent_id,
            "thread": s.thread,
        }
        for s in t.recent()
        if getattr(s, "lineage", None) == lineage
    ]
    return {
        "lineage": lineage,
        "found": bool(events) or bool(spans),
        "events": [e.as_dict() for e in events],
        "spans": spans,
        "summary": _summarize(events),
    }
