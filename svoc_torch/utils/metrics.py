"""Observability core: counters, gauges, histograms, spans, exposition.

Mirrors the jax-free core of :mod:`svoc_tpu.utils.metrics`
(``metrics.py:57-755``): :class:`Counter` (windowed rates),
:class:`Gauge`, :class:`Histogram` (fixed log-spaced buckets, p50/p95/
p99), :class:`LatencyTimer`, :class:`SpanRecord`, :class:`Tracer` and
:func:`stage_span` (nestable host-side spans, each feeding the shared
``stage_seconds{stage=}`` histogram), :class:`MetricsRegistry` with its
Prometheus exposition, and the process-wide :data:`registry` and
:data:`tracer`.  The chain adapter counts its RPCs and fallbacks here,
the batched commit's certification runs under a ``consensus_certify``
span, and the codec counts its saturations.

Spans are timed around dispatch on the host and never synchronise the
device.  Everything is thread-safe.

The Tracer's JSONL file sink (``SVOC_TRACE_FILE`` or
:meth:`Tracer.set_trace_file`) writes through
:func:`svoc_torch.utils.events.shared_writer`, so spans and journal
events rotate as one file.

The runtime end (``metrics.py:756-974``) reads the port's runtime
where the reference reads JAX's: :func:`install_compile_listener` counts
the kernel builds and cache hits that :mod:`svoc_torch.ops._build`
reports (``kernel_builds_total``, the ``kernel_build_seconds`` histogram
that stands where ``xla_compile_seconds`` does, and
``kernel_cache_events{event=hit|miss}`` where ``xla_cache_events``
does), :func:`compile_snapshot` digests them with the prewarm outcomes,
:func:`sample_runtime_gauges` reads the CUDA caching allocator,
:func:`set_mfu_gauge` takes the port's copy of ``bench.py``'s FLOP model
(:func:`encoder_matmul_flops_per_token`) and the H100's dense bf16 peak,
and :func:`profile_trace` runs ``torch.profiler``.  Only these functions
import torch, inside their bodies.
"""

from __future__ import annotations

import bisect
import contextlib
import itertools
import json
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple


@dataclass
class Counter:
    """A monotone event counter with windowed rate reporting.

    ``rate()`` covers only the trailing ``window_s`` seconds, so the
    ``metrics`` command reports *recent* throughput — a lifetime
    average would decay forever after any idle period.
    ``lifetime_rate()`` keeps the old semantics explicitly.
    """

    count: float = 0.0
    window_s: float = 30.0
    started_at: float = field(default_factory=time.perf_counter)
    _events: deque = field(default_factory=deque)  # (timestamp, count_after)
    # add() runs on the auto_fetch daemon thread while rate() serves the
    # web/console thread — guard the deque walk.
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def add(self, n: float = 1.0) -> None:
        now = time.perf_counter()
        with self._lock:
            self.count += n
            self._events.append((now, self.count))
            self._prune(now)

    def _prune(self, now: float) -> None:
        horizon = now - self.window_s
        while self._events and self._events[0][0] < horizon:
            self._events.popleft()

    def rate(self) -> float:
        """Events/sec over the trailing window (0 when idle)."""
        now = time.perf_counter()
        with self._lock:
            self._prune(now)
            if not self._events:
                return 0.0
            t_oldest, c_oldest = self._events[0]
            span = now - t_oldest
            if span <= 0:
                return 0.0
            # Count since the window's first sample (whose own
            # increment belongs to the time before it).
            return (self.count - c_oldest) / span

    def lifetime_rate(self) -> float:
        elapsed = time.perf_counter() - self.started_at
        return self.count / elapsed if elapsed > 0 else 0.0

    def reset(self) -> None:
        with self._lock:
            self.count = 0.0
            self.started_at = time.perf_counter()
            self._events.clear()


@dataclass
class Gauge:
    """A last-written value (device bytes, MFU, queue depth, …)."""

    value: float = 0.0
    _lock: threading.Lock = field(
        default_factory=threading.Lock, repr=False, compare=False
    )

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def add(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n

    def get(self) -> float:
        with self._lock:
            return self.value


def log_buckets(
    lo: float = 1e-4, hi: float = 120.0, per_decade: int = 4
) -> Tuple[float, ...]:
    """Fixed log-spaced bucket upper bounds, ``lo``…``hi`` inclusive.

    The default grid (100 µs → 120 s, 4/decade ⇒ ~1.78× steps) spans
    everything the pipeline produces — sub-ms consensus dispatches up
    to first-call XLA compiles — with ≤ ~78 % worst-case interpolation
    error per bucket, far inside what p95/p99 regressions look like.
    """
    edges = []
    step = 10.0 ** (1.0 / per_decade)
    v = lo
    while v < hi * (1.0 + 1e-9):
        edges.append(float(f"{v:.6g}"))  # stable, readable bounds
        v *= step
    return tuple(edges)


DEFAULT_BUCKETS = log_buckets()


class Histogram:
    """Fixed-bucket histogram with percentile snapshots.

    Buckets are cumulative-upper-bound (Prometheus ``le`` semantics)
    with a final +Inf overflow bucket.  Percentiles interpolate
    linearly inside the selected bucket — exact enough for log-spaced
    buckets, and crucially *monotone* (a p99 regression can never hide
    behind sample order).  Thread-safe: ``observe`` runs on producer /
    auto_fetch threads while snapshots serve the web thread.
    """

    def __init__(self, buckets: Optional[Tuple[float, ...]] = None):
        self.buckets: Tuple[float, ...] = tuple(sorted(buckets or DEFAULT_BUCKETS))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")
        self._counts = [0] * (len(self.buckets) + 1)  # last = +Inf
        self._sum = 0.0
        self._count = 0
        self._min = None
        self._max = None
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        idx = bisect.bisect_left(self.buckets, value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1
            if self._min is None or value < self._min:
                self._min = value
            if self._max is None or value > self._max:
                self._max = value

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def percentile(self, q: float) -> float:
        """The q-th percentile (``q`` in [0, 100]), bucket-interpolated.

        0 with no samples.  The overflow bucket reports the observed
        max (a finite, honest answer — the +Inf bound is not a value).
        """
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"percentile q={q} outside [0, 100]")
        with self._lock:
            if not self._count:
                return 0.0
            target = q / 100.0 * self._count
            cumulative = 0
            for i, c in enumerate(self._counts):
                cumulative += c
                if cumulative >= target and c:
                    lo = self.buckets[i - 1] if i > 0 else min(
                        self._min or 0.0, self.buckets[0]
                    )
                    if i >= len(self.buckets):  # overflow bucket
                        return float(self._max)
                    hi = self.buckets[i]
                    frac = (target - (cumulative - c)) / c
                    return float(lo + (hi - lo) * min(max(frac, 0.0), 1.0))
            return float(self._max or 0.0)

    def snapshot(self) -> Dict[str, float]:
        """``{count, sum, min, max, p50, p95, p99}`` — the series every
        artifact (BENCH / SOAK) and the live endpoint derive from, so
        they can never disagree."""
        p50, p95, p99 = (self.percentile(q) for q in (50, 95, 99))
        with self._lock:
            return {
                "count": self._count,
                "sum": round(self._sum, 6),
                "min": round(self._min, 6) if self._min is not None else 0.0,
                "max": round(self._max, 6) if self._max is not None else 0.0,
                "p50": round(p50, 6),
                "p95": round(p95, 6),
                "p99": round(p99, 6),
            }

    def cumulative_buckets(self) -> List[Tuple[float, int]]:
        """``[(le, cumulative_count), ...]`` ending with ``(inf, n)`` —
        the Prometheus ``_bucket`` series."""
        with self._lock:
            out = []
            cumulative = 0
            for bound, c in zip(self.buckets, self._counts):
                cumulative += c
                out.append((bound, cumulative))
            out.append((float("inf"), cumulative + self._counts[-1]))
            return out


@dataclass
class LatencyTimer:
    """Running latency stats (count / mean / max, EMA of recent).

    Thread-safe like :class:`Counter`: fetch/commit timers are observed
    concurrently from the auto_fetch loop, the console, and web
    handlers — unsynchronized read-modify-writes would lose samples and
    desynchronize ``total_s`` from ``n``."""

    n: int = 0
    total_s: float = 0.0
    max_s: float = 0.0
    ema_s: Optional[float] = None
    ema_alpha: float = 0.1
    _lock: threading.Lock = field(
        default_factory=threading.Lock, repr=False, compare=False
    )

    def observe(self, seconds: float) -> None:
        with self._lock:
            self.n += 1
            self.total_s += seconds
            self.max_s = max(self.max_s, seconds)
            self.ema_s = (
                seconds
                if self.ema_s is None
                else self.ema_alpha * seconds + (1 - self.ema_alpha) * self.ema_s
            )

    @property
    def mean_s(self) -> float:
        with self._lock:
            return self.total_s / self.n if self.n else 0.0

    @contextlib.contextmanager
    def time(self) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(time.perf_counter() - t0)


def _series_key(name: str, labels: Optional[Dict[str, str]]) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


def _prom_name(name: str) -> str:
    """Sanitize to the Prometheus metric-name charset, ``svoc_``-prefixed."""
    safe = "".join(c if c.isalnum() or c in "_:" else "_" for c in name)
    if safe and safe[0].isdigit():
        safe = "_" + safe
    return safe if safe.startswith("svoc_") else "svoc_" + safe


@dataclass(frozen=True)
class SpanRecord:
    """One completed span — what the ring buffer and JSONL trace hold.

    ``lineage`` is the block-lineage id (the reference's
    ``utils/events``) this span belongs to — set explicitly or inherited from the
    enclosing span, so every stage of one fetched block is joinable
    into its audit record."""

    name: str
    start_s: float  # epoch seconds (wall clock, for cross-process merge)
    duration_s: float
    span_id: int
    parent_id: Optional[int]
    thread: str
    depth: int
    lineage: Optional[str] = None

    def to_json(self) -> str:
        payload = {
            "name": self.name,
            "start_s": round(self.start_s, 6),
            "duration_s": round(self.duration_s, 6),
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "thread": self.thread,
            "depth": self.depth,
        }
        if self.lineage is not None:
            payload["lineage"] = self.lineage
        return json.dumps(payload)


class Tracer:
    """Nestable spans: a thread-local stack and a bounded ring buffer.

    ``with tracer.span("tokenize"):`` times the enclosed host-side work
    (around dispatch — never inside traced/jitted code, never forcing a
    device sync).  On completion the span:

    - appends a :class:`SpanRecord` to a bounded ring (``capacity``
      newest spans, O(1) memory forever),
    - feeds the shared per-stage histogram
      (``stage_seconds{stage=<name>}``) in the attached registry, so
      scraped percentiles and traces are the same data.

    Nesting is tracked per thread: a ``forward`` span opened inside a
    ``fetch`` span records ``fetch``'s id as its parent, so the JSONL
    reconstructs the stage tree.  Lineage propagates the same way: a
    child span with no explicit ``lineage=`` inherits the enclosing
    span's (set via ``span(..., lineage=)`` or
    :meth:`annotate_lineage`), so every stage of one fetched block
    carries the block's id without any per-callsite plumbing.
    Thread-safe; span bodies of different threads interleave freely
    (lineage does NOT cross threads — producer threads pass it
    explicitly, e.g. ``PrefetchPipeline(lineage=...)``).

    Optional JSONL export: when a trace file is configured
    (``SVOC_TRACE_FILE`` or :meth:`set_trace_file`) every completed
    span is written as one JSON line through the shared size-capped
    writer of :mod:`svoc_torch.utils.events` (``SVOC_TRACE_MAX_BYTES`` /
    ``SVOC_TRACE_KEEP``), so spans and events land in one bounded
    file.  Write failures are surfaced — the ``trace_write_errors``
    counter plus a one-shot ``trace.write_error`` journal event — never
    silently dropped.
    """

    #: Env var consulted (per completion, so tests can monkeypatch it
    #: after import) when no explicit trace file was configured.
    TRACE_ENV = "SVOC_TRACE_FILE"

    def __init__(self, registry: "MetricsRegistry" = None, capacity: int = 4096):
        self._registry = registry
        self._ring: deque = deque(maxlen=capacity)
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()  # ring + error latch
        self._trace_path: Optional[str] = None
        self._trace_error = False

    # -- configuration ------------------------------------------------------

    def set_trace_file(self, path: Optional[str]) -> None:
        """Pin (or clear, with None) the JSONL destination, overriding
        the env var.  The file opens lazily on the first completed span
        and appends.  Clears the write-error latch so a repaired path
        resumes export, and releases the previous destination's pooled
        file handle."""
        with self._lock:
            old = self._resolve_path()
            self._trace_path = path
            self._trace_error = False
        if old and old != path:
            from svoc_torch.utils.events import release_writer

            release_writer(old)

    def _resolve_path(self) -> Optional[str]:
        return self._trace_path or os.environ.get(self.TRACE_ENV) or None

    # -- the span API -------------------------------------------------------

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    @contextlib.contextmanager
    def span(self, name: str, lineage: Optional[str] = None) -> Iterator[int]:
        """Time a host-side stage; yields the span id (for tests/tools).
        ``lineage=None`` inherits the enclosing span's lineage."""
        stack = self._stack()
        span_id = next(self._ids)
        parent = stack[-1][0] if stack else None
        if lineage is None and stack:
            lineage = stack[-1][1]
        entry = [span_id, lineage]
        stack.append(entry)
        start_wall = time.time()
        t0 = time.perf_counter()
        try:
            yield span_id
        finally:
            duration = time.perf_counter() - t0
            stack.pop()
            self._complete(
                SpanRecord(
                    name=name,
                    start_s=start_wall,
                    duration_s=duration,
                    span_id=span_id,
                    parent_id=parent,
                    thread=threading.current_thread().name,
                    depth=len(stack),
                    lineage=entry[1],
                )
            )

    def annotate_lineage(self, lineage: Optional[str]) -> bool:
        """Attach a lineage id to the CURRENT thread's innermost open
        span (and, through inheritance, every child opened after this
        call).  Used where the id is only minted inside the span — e.g.
        ``Session.fetch`` claims its window cursor after opening the
        ``fetch`` span.  Returns False when no span is open."""
        stack = self._stack()
        if not stack:
            return False
        stack[-1][1] = lineage
        return True

    def current_lineage(self) -> Optional[str]:
        """The innermost open span's effective lineage on this thread."""
        stack = self._stack()
        return stack[-1][1] if stack else None

    def _complete(self, record: SpanRecord) -> None:
        if self._registry is not None:
            self._registry.histogram(
                "stage_seconds", labels={"stage": record.name}
            ).observe(record.duration_s)
        path = self._resolve_path()
        with self._lock:
            self._ring.append(record)
            if path is None:
                self._trace_error = False
                return
            if self._trace_error:
                return
        try:
            # Imported lazily: events.py imports this module at load time.
            from svoc_torch.utils.events import shared_writer

            shared_writer(path).write_line(record.to_json())
        except (OSError, ValueError) as e:
            # A bad path must never take down the pipeline, nor vanish:
            # latch export off (until reconfigured), count the latch, and
            # emit one event so the journal records why the trace went
            # quiet.
            with self._lock:
                self._trace_error = True
            reg = self._registry or registry
            reg.counter("trace_write_errors").add(1)
            try:
                from svoc_torch.utils import events as _events

                _events.journal.emit("trace.write_error", path=path, error=repr(e))
            except Exception:  # svoclint: disable=SVOC014 -- deliberate: recursion guard — the write-error EVENT failing to journal must not re-enter the journal; the latch + trace_write_errors counter above already made the failure visible
                pass  # the journal's own export failing must not recurse

    def recent(self, n: Optional[int] = None) -> List[SpanRecord]:
        """The newest ``n`` spans (all buffered when ``n`` is None)."""
        with self._lock:
            spans = list(self._ring)
        return spans if n is None else spans[-n:]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def flush(self) -> None:
        """Flush the shared JSONL writer so every line is durable."""
        path = self._resolve_path()
        if path is None:
            return
        from svoc_torch.utils.events import shared_writer

        shared_writer(path).flush()


class MetricsRegistry:
    """Named counters/timers/histograms/gauges + reporting/exposition."""

    def __init__(self) -> None:
        self.counters: Dict[str, Counter] = {}
        self.timers: Dict[str, LatencyTimer] = {}
        self.histograms: Dict[str, Histogram] = {}
        self.gauges: Dict[str, Gauge] = {}
        # setdefault on a plain dict is atomic under the GIL, but the
        # constructed-then-discarded loser of a race would drop the
        # winner's concurrent observations on Histogram (its buckets
        # allocate state) — create-once under a lock instead.
        self._lock = threading.Lock()
        #: Per-series labels, keyed like the metric dicts — used by the
        #: Prometheus renderer to group families.
        self._labels: Dict[str, Tuple[str, Dict[str, str]]] = {}

    def _get(self, store: Dict, name: str, labels, factory):
        key = _series_key(name, labels)
        obj = store.get(key)
        if obj is None:
            with self._lock:
                obj = store.get(key)
                if obj is None:
                    obj = store[key] = factory()
                    self._labels[key] = (name, dict(labels or {}))
        return obj

    def counter(self, name: str, labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get(self.counters, name, labels, Counter)

    def timer(self, name: str, labels: Optional[Dict[str, str]] = None) -> LatencyTimer:
        return self._get(self.timers, name, labels, LatencyTimer)

    def histogram(
        self,
        name: str,
        labels: Optional[Dict[str, str]] = None,
        buckets: Optional[Tuple[float, ...]] = None,
    ) -> Histogram:
        return self._get(
            self.histograms, name, labels, lambda: Histogram(buckets)
        )

    def gauge(self, name: str, labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._get(self.gauges, name, labels, Gauge)

    def stage_histogram(self, stage: str) -> Histogram:
        """The shared per-stage series every span feeds."""
        return self.histogram("stage_seconds", labels={"stage": stage})

    def family_total(self, name: str) -> float:
        """Sum of every counter series in the family ``name``, labels
        folded — e.g. ``family_total("faults_injected")`` totals the
        per-kind chaos counters for soak artifacts."""
        # Snapshot under the registry lock: other threads INSERT new
        # labeled series under it (first retry, first injected fault),
        # and iterating the live dict would race those inserts.
        with self._lock:
            items = list(self.counters.items())
        total = 0.0
        for key, c in items:
            fam, _labels = self._labels.get(key, (key, {}))
            if fam == name:
                total += c.count
        return total

    def family_series(self, name: str) -> List[Tuple[Dict[str, str], float]]:
        """Every counter series in the family ``name`` as
        ``(labels, count)`` pairs — the per-label breakdown
        ``family_total`` folds away (serving artifacts report shed
        counts per reason)."""
        with self._lock:
            items = list(self.counters.items())
        out: List[Tuple[Dict[str, str], float]] = []
        for key, c in items:
            fam, labels = self._labels.get(key, (key, {}))
            if fam == name:
                out.append((dict(labels), c.count))
        return out

    def counters_snapshot(self) -> List[Dict[str, Any]]:
        """Every counter series as ``{name, labels, count}`` — the
        recovery snapshot's SLO-continuity section (docs/RESILIENCE.md
        §durability): burn-rate evaluators difference CUMULATIVE
        counters, so a restart that zeroed them would read an error
        burst as recovery (goods jump from 0) or vice versa."""
        with self._lock:
            items = list(self.counters.items())
            labels = dict(self._labels)
        out: List[Dict[str, Any]] = []
        for key, c in items:
            name, lbl = labels.get(key, (key, {}))
            out.append({"name": name, "labels": dict(lbl), "count": c.count})
        return out

    def restore_counters(self, entries: List[Dict[str, Any]]) -> int:
        """Re-seed counter series from :meth:`counters_snapshot` (adds
        onto current values — callers restore into a FRESH registry).
        Returns the number of restored series."""
        n = 0
        for e in entries:
            value = float(e.get("count", 0.0))
            if value:
                self.counter(e["name"], labels=e.get("labels") or None).add(
                    value
                )
                n += 1
        return n

    def stage_snapshot(self) -> Dict[str, Dict[str, float]]:
        """``{stage: {count, sum, p50, p95, p99, ...}}`` for every stage
        observed so far — the block BENCH/SOAK artifacts embed."""
        out = {}
        for key, h in sorted(self.histograms.items()):
            name, labels = self._labels.get(key, (key, {}))
            if name == "stage_seconds" and "stage" in labels:
                out[labels["stage"]] = h.snapshot()
        return out

    def report(self) -> List[str]:
        lines = []
        for key, c in sorted(self.counters.items()):
            lines.append(f"{key}: {c.count:,.0f} ({c.rate():,.1f}/s recent)")
        for key, g in sorted(self.gauges.items()):
            lines.append(f"{key}: {g.get():,.6g}")
        for key, t in sorted(self.timers.items()):
            lines.append(
                f"{key}: n={t.n} mean={t.mean_s * 1e3:.2f}ms "
                f"max={t.max_s * 1e3:.2f}ms"
            )
        for key, h in sorted(self.histograms.items()):
            s = h.snapshot()
            lines.append(
                f"{key}: n={s['count']} p50={s['p50'] * 1e3:.2f}ms "
                f"p95={s['p95'] * 1e3:.2f}ms p99={s['p99'] * 1e3:.2f}ms "
                f"max={s['max'] * 1e3:.2f}ms"
            )
        return lines

    def render_prometheus(self) -> str:
        """Prometheus text exposition (format 0.0.4) of every series.

        Families emit one ``# TYPE`` line; histogram families emit the
        classic cumulative ``_bucket{le=...}`` / ``_sum`` / ``_count``
        triple (p50/p95/p99 derivable server-side via
        ``histogram_quantile``); timers render as summary-style
        ``_count`` / ``_sum`` plus a ``_max`` gauge.
        """
        lines: List[str] = []
        typed: set = set()

        def labels_of(key: str) -> Tuple[str, Dict[str, str]]:
            return self._labels.get(key, (key, {}))

        def fmt_labels(labels: Dict[str, str], extra: str = "") -> str:
            inner = ",".join(
                f'{k}="{v}"' for k, v in sorted(labels.items())
            )
            if extra:
                inner = f"{inner},{extra}" if inner else extra
            return "{" + inner + "}" if inner else ""

        def type_line(prom: str, kind: str) -> None:
            if prom not in typed:
                typed.add(prom)
                lines.append(f"# TYPE {prom} {kind}")

        for key, c in sorted(self.counters.items()):
            name, labels = labels_of(key)
            prom = _prom_name(name + "_total")
            type_line(prom, "counter")
            lines.append(f"{prom}{fmt_labels(labels)} {c.count:g}")
        for key, g in sorted(self.gauges.items()):
            name, labels = labels_of(key)
            prom = _prom_name(name)
            type_line(prom, "gauge")
            lines.append(f"{prom}{fmt_labels(labels)} {g.get():g}")
        for key, t in sorted(self.timers.items()):
            name, labels = labels_of(key)
            prom = _prom_name(name + "_seconds")
            type_line(prom, "summary")
            lab = fmt_labels(labels)
            lines.append(f"{prom}_count{lab} {t.n}")
            lines.append(f"{prom}_sum{lab} {t.total_s:g}")
            prom_max = _prom_name(name + "_seconds_max")
            type_line(prom_max, "gauge")
            lines.append(f"{prom_max}{lab} {t.max_s:g}")
        for key, h in sorted(self.histograms.items()):
            name, labels = labels_of(key)
            prom = _prom_name(name)
            type_line(prom, "histogram")
            for bound, cumulative in h.cumulative_buckets():
                le = "+Inf" if bound == float("inf") else f"{bound:g}"
                le_label = 'le="' + le + '"'
                lines.append(
                    f"{prom}_bucket{fmt_labels(labels, le_label)} {cumulative}"
                )
            lab = fmt_labels(labels)
            lines.append(f"{prom}_sum{lab} {h.sum:g}")
            lines.append(f"{prom}_count{lab} {h.count}")
        return "\n".join(lines) + "\n"


#: Process-wide default registry (the apps layer and bench use this).
registry = MetricsRegistry()

#: Process-wide default tracer, feeding the default registry's
#: per-stage histograms.
tracer = Tracer(registry)


def stage_span(name: str, lineage: Optional[str] = None):
    """``with stage_span("forward"):`` — the one-liner every hot-path
    callsite uses: a span on the default tracer, feeding the shared
    ``stage_seconds{stage=name}`` histogram in the default registry.
    ``lineage=None`` inherits the enclosing span's block lineage."""
    return tracer.span(name, lineage=lineage)



# ---------------------------------------------------------------------------
# The runtime end (``svoc_tpu/utils/metrics.py:756-974``)
# ---------------------------------------------------------------------------

#: The NVIDIA H100's dense bf16 tensor-core peak (989 TFLOP/s, SXM), the
#: denominator of :func:`set_mfu_gauge` on the card.
H100_BF16_DENSE_PEAK_FLOPS = 989e12

_compile_listener_lock = threading.Lock()
_compile_listener_installed = False


def _on_kernel_cache_event(event: str, name: str, seconds: float) -> None:
    if event == "miss":
        registry.counter("kernel_builds_total").add(1)
        registry.histogram("kernel_build_seconds").observe(max(0.0, seconds))
    registry.counter("kernel_cache_events", labels={"event": event}).add(1)


def install_compile_listener() -> bool:
    """Count every kernel build and cache hit of this process (once per
    process) into the default :data:`registry`: builds are process-wide
    events, as the reference's compiles are.  A miss is an ``nvcc`` run
    this process paid (``kernel_builds_total``, ``kernel_build_seconds``,
    ``kernel_cache_events{event="miss"}``); a hit is a first load of a
    library found in the build directory (``kernel_cache_events{event=
    "hit"}``).  Returns True."""
    global _compile_listener_installed
    with _compile_listener_lock:
        if not _compile_listener_installed:
            from svoc_torch.ops import _build

            _build.add_listener(_on_kernel_cache_event)
            _compile_listener_installed = True
    return True


def compile_snapshot(reg: Optional["MetricsRegistry"] = None) -> Dict[str, Any]:
    """JSON-safe digest of the compile plane's series: the builds, their
    seconds and percentiles, the cache's hits and misses, and the
    prewarm outcomes.  Reads the default registry unless told
    otherwise (where :func:`install_compile_listener` counts)."""
    reg = reg or registry
    h = reg.histogram("kernel_build_seconds")
    outcomes = ("compiled", "primed", "skipped", "error", "budget_exhausted")
    return {
        "kernel_builds_total": reg.counter("kernel_builds_total").count,
        "kernel_build_seconds_sum": round(h.sum, 6),
        "kernel_build_p50_ms": round(h.percentile(50) * 1e3, 3),
        "kernel_build_p99_ms": round(h.percentile(99) * 1e3, 3),
        "cache_hits": reg.counter("kernel_cache_events", labels={"event": "hit"}).count,
        "cache_misses": reg.counter("kernel_cache_events", labels={"event": "miss"}).count,
        "prewarm_outcomes": {
            o: reg.counter("compile_prewarm", labels={"outcome": o}).count for o in outcomes
        },
    }


def sample_runtime_gauges(reg: Optional[MetricsRegistry] = None) -> Dict[str, float]:
    """Refresh the device gauges; returns ``{series_key: value}``.

    ``device_live_bytes{device="cuda:<i>"}`` is
    ``torch.cuda.memory_allocated(i)``, the bytes of live tensors in the
    caching allocator, and ``device_live_arrays`` the allocator's count of
    active blocks over every card (``memory_stats()["active.all.current"]``),
    where the reference counts ``jax.live_arrays()``.  Installs the
    compile listener.  On demand only, never on the serving path; before
    this process first touches CUDA it returns nothing (the reference's
    gauges wait for the backend the same way)."""
    reg = reg or registry
    out: Dict[str, float] = {}
    install_compile_listener()
    import torch

    if not torch.cuda.is_initialized():
        return out
    blocks = 0
    for index in range(torch.cuda.device_count()):
        dev = f"cuda:{index}"
        nbytes = float(torch.cuda.memory_allocated(index))
        reg.gauge("device_live_bytes", labels={"device": dev}).set(nbytes)
        out[_series_key("device_live_bytes", {"device": dev})] = nbytes
        blocks += int(torch.cuda.memory_stats(index).get("active.all.current", 0))
    reg.gauge("device_live_arrays").set(float(blocks))
    out["device_live_arrays"] = float(blocks)
    return out


def encoder_matmul_flops_per_token(cfg, seq_len: int) -> float:
    """``bench.py``'s analytic forward matmul FLOPs a token: per layer
    the QKV and output projections (4·h²), the MLP (2·h·i) and the two
    attention products (2·seq·h each); a multiply-add is 2 FLOPs."""
    per_layer = 2 * (4 * cfg.hidden * cfg.hidden + 2 * cfg.hidden * cfg.intermediate)
    per_layer += 4 * seq_len * cfg.hidden
    return float(cfg.n_layers * per_layer)


def set_mfu_gauge(
    step_seconds: float,
    flops_per_step: float,
    peak_flops: Optional[float] = H100_BF16_DENSE_PEAK_FLOPS,
    reg: Optional[MetricsRegistry] = None,
) -> Optional[float]:
    """The step-time MFU gauge: ``flops_per_step`` (from
    :func:`encoder_matmul_flops_per_token` × tokens) over the step's
    seconds and ``peak_flops`` (default the H100's dense bf16 peak).
    Sets ``mfu_estimate`` and ``step_seconds``; returns the MFU, or None
    when the peak is unknown (None or 0) or the step took no time."""
    reg = reg or registry
    if not peak_flops or step_seconds <= 0:
        return None
    mfu = flops_per_step / step_seconds / peak_flops
    reg.gauge("mfu_estimate").set(mfu)
    reg.gauge("step_seconds").set(step_seconds)
    return mfu


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[Any]:
    """``torch.profiler`` around a block (CUDA activity too when a card
    is present), its Chrome trace written to ``log_dir/trace.json``;
    yields the profiler, whose ``key_averages()`` the caller may read."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
