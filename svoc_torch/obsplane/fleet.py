"""The fleet observability plane: cross-replica hop-chain tracing,
merged fleet telemetry + SLOs, and seeded anomaly detection —
**replay-invisible by construction**.

Mirrors :mod:`svoc_tpu.obsplane.fleet` (``fleet.py:1-651``):
``ACCOUNTING_FAMILIES``, :func:`resolve_fleet_plane_enabled`,
:class:`FleetAggregator` and :class:`FleetPlane` (sources, hops, merge,
the Prometheus exposition, SLOs, ``on_step``, anomalies that trigger
:class:`~svoc_torch.obsplane.profiler.ProfileCapture` and
:func:`~svoc_torch.utils.postmortem.build_bundle`, accounting).  The
plane is host code: it reads registries and writes observation records,
and launches nothing on the card.  Where the port departs:

- the committed decision is the constant :data:`FLEET_PLANE_DECISION`
  (the reference reads ``PERF_DECISIONS.json``'s ``fleet_plane``, which
  holds no such key, so it resolves off there too); the port reads no
  file of the JAX package, as ``obsplane/plane.py`` pins the cost plane;
- the anomaly's capture is ``torch.profiler``'s, owned by the thread that
  started it (:mod:`svoc_torch.obsplane.profiler`): :meth:`FleetPlane.on_step`
  starts it and stops it a step later on the same (the router's) thread;
- :meth:`FleetPlane.attach` wires it into the operator console
  (:mod:`svoc_torch.apps.commands`), as the reference's does.

Every record this plane produces rides the ``obs`` observation channel
(:class:`~svoc_torch.obsplane.timeline.ObservationLog` — the third line
shape), NEVER the fingerprinted event journal: the replay fingerprint
digests journal records including their seqs, so one fleet-plane
journal event would shift sibling seqs and break the ON-vs-OFF
byte-identity the fleet-obs smoke certifies.  That rule
extends to the machinery the plane reuses: the fleet SLO evaluator and
the anomaly-triggered profiler are constructed over a journal-shaped
SHIM (:class:`_ObsJournal`) that turns their ``slo.alert`` /
``profile.captured`` emissions into observation records tagged
``scope=fleet`` — same taxonomy, different channel.

Three pillars:

- **hop chains** (:mod:`svoc_torch.obsplane.hopchain`) — the router
  mints a :class:`HopContext` per routing decision and the plane
  records both sides of every hop on per-source observation sidecars
  (``fleet-obs.jsonl`` next to the cluster trace for the router,
  ``obs*.jsonl`` in each replica's durable dir).  The sidecars are
  deliberately SEPARATE, non-fsynced files: hop records are derived
  telemetry with no durability contract, while the flight-recorder
  files fsync per line (replica/cluster writers pin ``fsync=True``) —
  putting telemetry on the durability hot path would spend the
  overhead budget on fsyncs.
- **aggregation** (:class:`FleetAggregator`) — per-source
  :class:`MetricsRegistry` state merges into one registry: counters
  SUM per (family, labels); gauges keep a ``replica=`` label;
  histograms merge per-bucket counts (matching grids — a mismatched
  grid keeps its ``replica=`` label instead of corrupting the sum);
  timers sum count/total and keep the max.  Retired stacks fold in
  under ``replica="<key>@retired"`` as the element-wise MAX of the
  last in-process scrape and the recovered durable authority — both
  are true lower bounds on the dead process's work, and the max keeps
  every fleet counter monotone through a kill → failover (the
  regression the fleet-obs tests pin).  ``fleet_accounting``'s
  ``unaccounted`` field still reports the in-flight gap the durable
  authority alone would show.
- **anomaly detection** (:mod:`svoc_torch.obsplane.anomaly`) — sampled
  on the router's step cadence over the merged degradation families;
  sustained breaches auto-trigger :meth:`ProfileCapture.maybe_capture`
  and a postmortem bundle carrying the fleet's observation accounting.

``enabled`` resolves ONCE at construction (the argument >
``SVOC_FLEET_PLANE`` env > :data:`FLEET_PLANE_DECISION` — the SVOC011
pinning discipline, same as the cost plane); disabled, every hook is
one attribute check and the router's byte stream is untouched.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from svoc_torch.obsplane.anomaly import AnomalyConfig, AnomalyDetector
from svoc_torch.obsplane.hopchain import HopContext
from svoc_torch.obsplane.profiler import ProfileCapture
from svoc_torch.obsplane.timeline import ObservationLog
from svoc_torch.utils.metrics import MetricsRegistry

#: The request-accounting families whose MERGED totals the plane tracks
#: per step — the monotonicity regression and the fleet SLOs read these.
ACCOUNTING_FAMILIES = (
    "serving_admitted",
    "serving_completed",
    "serving_dropped",
    "serving_cached",
    "serving_shed",
    "cluster_forwarded",
    "cluster_unavailable",
)


#: The committed ``fleet_plane`` routing.  ``PERF_DECISIONS.json`` holds
#: no ``fleet_plane`` key, so the reference resolves off; so does the port.
FLEET_PLANE_DECISION = "off"


def resolve_fleet_plane_enabled(enabled: Optional[bool] = None) -> bool:
    """Construction-time resolution: explicit arg > ``SVOC_FLEET_PLANE``
    env (`1/on/true/yes` vs `0/off/false/no`) > :data:`FLEET_PLANE_DECISION`."""
    if enabled is not None:
        return bool(enabled)
    env = os.environ.get("SVOC_FLEET_PLANE", "").strip().lower()
    if env in ("1", "on", "true", "yes"):
        return True
    if env in ("0", "off", "false", "no"):
        return False
    return FLEET_PLANE_DECISION == "on"


class _ObsJournal:
    """Journal-shaped shim over the observation channel: the fleet SLO
    evaluator and the anomaly profiler ``emit()`` through this, so
    their ``slo.alert``/``profile.captured`` events become ``obs``
    records tagged ``scope=fleet`` — never fingerprinted journal
    entries.  This is what lets fleet alerts fire in EVERY smoke leg
    (including the fingerprint-identity legs) without breaking ON/OFF
    byte-identity."""

    def __init__(self, obslog: ObservationLog):
        self._obslog = obslog

    def emit(self, event_type: str, *, lineage: Optional[str] = None, **data):
        self._obslog.record(event_type, lineage=lineage, scope="fleet", **data)


def _entry_key(name: str, labels: Dict[str, str]) -> str:
    return name + "\x00" + json.dumps(labels or {}, sort_keys=True)


class FleetAggregator:
    """Pure merge math over per-source registry state (module
    docstring): ``merge()`` is side-effect-free on its inputs, and the
    retired ledger is the aggregator's only state."""

    def __init__(self):
        self._retired: Dict[str, List[dict]] = {}

    def retire(self, key: str, counters: List[dict]) -> None:
        """Fold a retired stack's final counter snapshot in; merged
        under ``replica="<key>@retired"`` from now on."""
        self._retired[key] = [
            {
                "name": e["name"],
                "labels": dict(e.get("labels") or {}),
                "count": float(e.get("count", 0.0)),
            }
            for e in counters
        ]

    def retired_keys(self) -> List[str]:
        return sorted(self._retired)

    def merge(self, sources: Dict[str, MetricsRegistry]) -> MetricsRegistry:
        """One fresh merged registry over ``sources`` + the retired
        ledger.  Safe against concurrent writers on the sources (each
        source's state is snapshotted under its own lock)."""
        out = MetricsRegistry()
        for sid in sorted(sources):
            reg = sources[sid]
            for entry in reg.counters_snapshot():
                out.counter(
                    entry["name"], labels=entry["labels"] or None
                ).add(entry["count"])
            with reg._lock:
                gauges = list(reg.gauges.items())
                timers = list(reg.timers.items())
                hists = list(reg.histograms.items())
                label_map = dict(reg._labels)
            for key, g in gauges:
                name, lbl = label_map.get(key, (key, {}))
                out.gauge(name, labels={**lbl, "replica": sid}).set(g.get())
            for key, t in timers:
                name, lbl = label_map.get(key, (key, {}))
                with t._lock:
                    n, total_s, max_s = t.n, t.total_s, t.max_s
                dst = out.timer(name, labels=lbl or None)
                with dst._lock:
                    dst.n += n
                    dst.total_s += total_s
                    dst.max_s = max(dst.max_s, max_s)
            for key, h in hists:
                name, lbl = label_map.get(key, (key, {}))
                with h._lock:
                    buckets = h.buckets
                    counts = list(h._counts)
                    hsum, hcount = h._sum, h._count
                    hmin, hmax = h._min, h._max
                dst = out.histogram(name, labels=lbl or None, buckets=buckets)
                if dst.buckets != buckets:
                    # Mismatched grid: bucket sums would corrupt —
                    # keep the source's distribution under its own
                    # replica-labeled series (documented semantics).
                    dst = out.histogram(
                        name,
                        labels={**lbl, "replica": sid},
                        buckets=buckets,
                    )
                with dst._lock:
                    for i, c in enumerate(counts):
                        dst._counts[i] += c
                    dst._sum += hsum
                    dst._count += hcount
                    if hmin is not None:
                        dst._min = hmin if dst._min is None else min(dst._min, hmin)
                    if hmax is not None:
                        dst._max = hmax if dst._max is None else max(dst._max, hmax)
        for key in sorted(self._retired):
            for entry in self._retired[key]:
                labels = dict(entry["labels"])
                labels.setdefault("replica", f"{key}@retired")
                out.counter(entry["name"], labels=labels).add(entry["count"])
        return out


class FleetPlane:
    """The one object the router, the reconfig controller, the web
    endpoints, and the console share (class docstring above).  All
    hooks are inert one-attribute checks when disabled."""

    def __init__(
        self,
        *,
        enabled: Optional[bool] = None,
        clock: Optional[Callable[[], float]] = None,
        journal=None,
        trace_path: Optional[str] = None,
        profile_dir: Optional[str] = None,
        bundle_dir: Optional[str] = None,
        anomaly: Optional[AnomalyConfig] = None,
        slo_latency_target_s: float = 0.25,
        slo_fast_window_s: float = 300.0,
        slo_slow_window_s: float = 3600.0,
        max_history: int = 4096,
    ):
        self.enabled = resolve_fleet_plane_enabled(enabled)
        self._clock = clock if clock is not None else time.monotonic
        #: Read-only context for postmortem bundles (the cluster
        #: journal) — the plane NEVER emits to it.
        self._journal = journal
        #: The plane's own series (fleet SLO gauges, anomaly counters,
        #: obs_lines_dropped) — merged in under source id "fleet".
        self.registry = MetricsRegistry()
        self.obslog = ObservationLog(
            trace_path=trace_path if self.enabled else None,
            metrics=self.registry,
            owner="router",
        )
        self._shim = _ObsJournal(self.obslog)
        self.aggregator = FleetAggregator()
        self.detector = AnomalyDetector(anomaly) if self.enabled else None
        self.profiler = (
            ProfileCapture(
                out_dir=profile_dir,
                journal=self._shim,
                metrics=self.registry,
                clock=self._clock,
            )
            if self.enabled and profile_dir
            else None
        )
        self._bundle_dir = bundle_dir
        self._slo_latency_target_s = slo_latency_target_s
        self._slo_fast_window_s = slo_fast_window_s
        self._slo_slow_window_s = slo_slow_window_s
        self._lock = threading.Lock()
        self._sources: Dict[str, dict] = {}
        self._chain_seq = 0
        self._step = 0
        self._slo = None
        self._slo_merged: Optional[MetricsRegistry] = None
        self._totals_history: deque = deque(maxlen=max_history)
        self._anomalies: deque = deque(maxlen=256)
        self._bundles: List[str] = []
        self._profile_started_step: Optional[int] = None

    # -- source roster -------------------------------------------------------

    def register_source(
        self,
        source_id: str,
        *,
        registry: MetricsRegistry,
        trace_path: Optional[str] = None,
    ) -> None:
        """Register one telemetry source (the router itself or a
        replica).  ``trace_path`` opens a per-source observation
        sidecar for that source's side of each hop; without one the
        source's hop records land on the plane's own log."""
        if not self.enabled:
            return
        log = (
            ObservationLog(
                trace_path=trace_path, metrics=self.registry, owner=source_id
            )
            if trace_path
            else None
        )
        with self._lock:
            self._sources[source_id] = {"registry": registry, "obslog": log}

    def retire_source(
        self, key: str, source_id: str, counters: List[dict]
    ) -> Optional[dict]:
        """Drop a source from the live roster and fold its counters
        into the retired ledger as the element-wise MAX of the last
        in-process scrape and ``counters`` (the recovered durable
        authority) — class docstring's monotonicity argument.  Returns
        the source's final observation accounting (for the router's
        retired ledger and postmortem bundles), or None when the plane
        is off."""
        if not self.enabled:
            return None
        with self._lock:
            src = self._sources.pop(source_id, None)
        folded: Dict[str, dict] = {}
        for entry in counters:
            e = {
                "name": entry["name"],
                "labels": dict(entry.get("labels") or {}),
                "count": float(entry.get("count", 0.0)),
            }
            folded[_entry_key(e["name"], e["labels"])] = e
        obs_stats = None
        if src is not None:
            for entry in src["registry"].counters_snapshot():
                k = _entry_key(entry["name"], entry["labels"])
                have = folded.get(k)
                if have is None:
                    folded[k] = {
                        "name": entry["name"],
                        "labels": dict(entry["labels"]),
                        "count": float(entry["count"]),
                    }
                else:
                    have["count"] = max(have["count"], float(entry["count"]))
            log = src["obslog"]
            if log is not None:
                obs_stats = {
                    "records": len(log),
                    "last_seq": log.last_seq(),
                    "dropped": log.dropped,
                }
                log.set_trace_file(None)
        self.aggregator.retire(
            key, [folded[k] for k in sorted(folded)]
        )
        if self.detector is not None:
            self.detector.drop_source(source_id)
        return obs_stats

    def _log_for(self, source_id: Optional[str]) -> ObservationLog:
        with self._lock:
            src = self._sources.get(source_id) if source_id else None
        if src is not None and src["obslog"] is not None:
            return src["obslog"]
        return self.obslog

    # -- hop chains ----------------------------------------------------------

    def hop_begin(
        self,
        claim_id: str,
        *,
        lineage: str,
        origin: str,
        target: Optional[str],
        reason: str,
    ) -> Optional[HopContext]:
        """Mint one hop chain for a routing decision; None when off."""
        if not self.enabled:
            return None
        with self._lock:
            self._chain_seq += 1
            chain = f"h{self._chain_seq:06d}"
        return HopContext(chain, claim_id, lineage, origin, target, reason)

    def hop_send(self, ctx: Optional[HopContext], **extra) -> None:
        """Record the origin-side ``send`` for the NEXT transport
        attempt (increments the hop seq) — called immediately before
        the transport call, so a request cut down mid-call leaves this
        record as its last trace."""
        if ctx is None:
            return
        ctx.hop += 1
        self._log_for(ctx.origin).record(
            "hop",
            lineage=ctx.lineage,
            hop=ctx.hop,
            side="send",
            **ctx.as_data(),
            **extra,
        )

    def hop_recv(self, ctx: Optional[HopContext], **extra) -> None:
        """Record the destination-side ``recv`` on the TARGET's sidecar
        — the hop landed; the chain is complete."""
        if ctx is None:
            return
        self._log_for(ctx.target).record(
            "hop",
            lineage=ctx.lineage,
            hop=ctx.hop,
            side="recv",
            **ctx.as_data(),
            **extra,
        )

    def hop_end(
        self, ctx: Optional[HopContext], *, outcome: str, **extra
    ) -> None:
        """Record a terminal ``end`` on the origin: a typed refusal or
        failure closed the chain without a recv."""
        if ctx is None:
            return
        self._log_for(ctx.origin).record(
            "hop",
            lineage=ctx.lineage,
            hop=ctx.hop,
            side="end",
            outcome=outcome,
            **ctx.as_data(),
            **extra,
        )

    def hop_refused(
        self,
        claim_id: str,
        *,
        lineage: str,
        reason: str,
        outcome: str,
        target: Optional[str] = None,
        **extra,
    ) -> None:
        """One-shot chain for a router-local verdict (redirect,
        reconfig-defer, replica-down shed): no transport attempt ever
        happens, so the chain is a single terminal record."""
        ctx = self.hop_begin(
            claim_id,
            lineage=lineage,
            origin="router",
            target=target,
            reason=reason,
        )
        self.hop_end(ctx, outcome=outcome, **extra)

    # -- aggregation + SLOs --------------------------------------------------

    def merged_registry(self) -> MetricsRegistry:
        """The fleet merge over every registered source (live registry
        state), the retired ledger, and the plane's own registry."""
        with self._lock:
            sources = {
                sid: src["registry"] for sid, src in self._sources.items()
            }
        sources["fleet"] = self.registry
        return self.aggregator.merge(sources)

    def render_prometheus_fleet(self) -> str:
        """``GET /metrics/fleet``: the merged exposition."""
        return self.merged_registry().render_prometheus()

    def _slo_source(self) -> MetricsRegistry:
        merged = self._slo_merged
        return merged if merged is not None else self.merged_registry()

    def _slo_evaluator(self):
        if self._slo is None:
            from svoc_torch.utils.slo import SLOEvaluator, fleet_slos

            self._slo = SLOEvaluator(
                fleet_slos(
                    self._slo_source,
                    latency_target_s=self._slo_latency_target_s,
                    fast_window_s=self._slo_fast_window_s,
                    slow_window_s=self._slo_slow_window_s,
                ),
                registry=self.registry,
                journal=self._shim,
                clock=self._clock,
            )
        return self._slo

    def evaluate_slos(self) -> dict:
        """One fleet SLO pass over a fresh merge (console / web)."""
        if not self.enabled:
            return {}
        return self._slo_evaluator().evaluate()

    # -- step cadence --------------------------------------------------------

    def on_step(self, live_sources: Dict[str, MetricsRegistry]) -> None:
        """The router's per-step hook: close out any anomaly-triggered
        profile from the PREVIOUS step (so ``profile.captured`` is
        witnessed deterministically in-run, and on the thread that
        started the capture, which ``torch.profiler`` requires), evaluate the fleet SLOs
        over one shared merge, append the accounting-family totals to
        the monotonicity history, and feed the anomaly detector the
        live sources' degradation families."""
        if not self.enabled:
            return
        self._step += 1
        if (
            self.profiler is not None
            and self._profile_started_step is not None
            and self._step > self._profile_started_step
        ):
            self.profiler.stop()
            self._profile_started_step = None
        merged = self.merged_registry()
        self._slo_merged = merged
        try:
            self._slo_evaluator().evaluate()
        finally:
            self._slo_merged = None
        self._totals_history.append(
            {
                "step": self._step,
                **{f: merged.family_total(f) for f in ACCOUNTING_FAMILIES},
            }
        )
        if self.detector is None:
            return
        totals: Dict[tuple, float] = {}
        for sid in sorted(live_sources):
            reg = live_sources[sid]
            for family in self.detector.config.families:
                totals[(sid, family)] = reg.family_total(family)
        for alert in self.detector.on_step(self._step, totals):
            self._record_anomaly(alert)

    def _record_anomaly(self, alert: dict) -> None:
        self._anomalies.append(alert)
        self.obslog.record("anomaly.detected", scope="fleet", **alert)
        self.registry.counter(
            "anomaly_detected",
            labels={"replica": alert["source"], "family": alert["family"]},
        ).add(1)
        if not alert["sustained"]:
            return
        if self.profiler is not None:
            report = self.profiler.maybe_capture("anomaly")
            if report is not None and report.get("status") == "started":
                self._profile_started_step = self._step
        if self._bundle_dir is not None:
            self._build_bundle(alert)

    def _build_bundle(self, alert: dict) -> None:
        from svoc_torch.utils.postmortem import build_bundle

        try:
            path = build_bundle(
                out_dir=self._bundle_dir,
                trigger="anomaly",
                trigger_event={"type": "anomaly.detected", "data": alert},
                registry=self.merged_registry(),
                journal=self._journal,
                slo=self._slo,
                extra={
                    "fleet_obs": self.obs_accounting(),
                    "anomaly": alert,
                },
            )
        except OSError as e:
            # Telemetry never takes serving down: a bundle that cannot
            # write is counted and typed, not raised (SVOC014).
            self.registry.counter(
                "fleet_plane_errors", labels={"op": "bundle"}
            ).add(1)
            self.obslog.record(
                "postmortem.bundle",
                scope="fleet",
                trigger="anomaly",
                error=f"{type(e).__name__}: {e}",
            )
            return
        self._bundles.append(path)
        self.registry.counter(
            "postmortem_bundles", labels={"trigger": "anomaly"}
        ).add(1)
        self.obslog.record(
            "postmortem.bundle", scope="fleet", trigger="anomaly", path=path
        )

    # -- accounting / views --------------------------------------------------

    def obs_accounting(self) -> Dict[str, dict]:
        """Per-source observation-channel accounting (records in ring,
        last seq, dropped exports) — ``fleet_accounting``'s
        ``observations`` section and the bundle's truncation witness."""
        with self._lock:
            items = sorted(self._sources.items())
        out: Dict[str, dict] = {}
        for sid, src in items:
            log = src["obslog"] if src["obslog"] is not None else self.obslog
            out[sid] = {
                "records": len(log),
                "last_seq": log.last_seq(),
                "dropped": log.dropped,
            }
        if "router" not in out:
            out["router"] = {
                "records": len(self.obslog),
                "last_seq": self.obslog.last_seq(),
                "dropped": self.obslog.dropped,
            }
        return out

    def source_observations(self, source_id: str) -> Optional[dict]:
        """One live source's observation accounting, or None."""
        return self.obs_accounting().get(source_id)

    def accounting_history(self) -> List[dict]:
        """Per-step merged accounting-family totals (on_step cadence)
        — the monotonicity regression's evidence."""
        return [dict(h) for h in self._totals_history]

    def anomalies(self) -> List[dict]:
        return [dict(a) for a in self._anomalies]

    def bundles(self) -> List[str]:
        return list(self._bundles)

    def snapshot(self) -> dict:
        """The ``/api/state`` fleet-obs section / console ``fleet``."""
        if not self.enabled:
            return {"enabled": False}
        out = {
            "enabled": True,
            "step": self._step,
            "sources": sorted(self._sources),
            "retired": self.aggregator.retired_keys(),
            "chains": self._chain_seq,
            "observations": self.obs_accounting(),
            "slo": {
                "alerting": self._slo.alerting() if self._slo else [],
            },
            "anomaly": (
                self.detector.summary() if self.detector is not None else {}
            ),
            "recent_anomalies": self.anomalies()[-8:],
            "bundles": self.bundles(),
        }
        if self.profiler is not None:
            out["profiler"] = self.profiler.status()
        return out

    def attach(self, console) -> None:
        """Expose through a CommandConsole: the ``fleet`` command,
        ``GET /metrics/fleet``, and the ``/api/state`` fleet section read
        ``console.fleetplane`` (``fleet.py:647``)."""
        console.fleetplane = self
