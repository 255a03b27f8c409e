"""Declarative SLOs evaluated as multi-window burn rates.

Mirrors :mod:`svoc_tpu.utils.slo` (``slo.py:1-479``), the fleet plane's
objectives (:func:`fleet_slos`, ``:221-301``) included.

An SLO here is a **good/total ratio objective** (the SRE-workbook
shape): commit success ratio, the fraction of ``consensus`` stage
dispatches under the latency target (a latency SLO *is* a ratio SLO
over the histogram's cumulative buckets), and the quarantine admission
ratio.  The evaluator samples the cumulative counters from the shared
:class:`~svoc_torch.utils.metrics.MetricsRegistry`, differences them over
a **fast** and a **slow** trailing window, and reports each window's
burn rate::

    error_rate = bad_delta / total_delta
    burn       = error_rate / (1 - objective)      # 1.0 = exactly on budget

Alerting follows the classic multi-window rule: a page-worthy condition
requires BOTH the fast burn (is it happening *now*?) and the slow burn
(is it *sustained*?) above their thresholds — a single bad commit after
an idle hour must not page.  Crossings emit one ``slo.alert`` journal
event (latched until recovery) and bump ``slo_alerts{slo=}``; the live
values are exported as ``slo_burn_rate{slo=,window=}`` /
``slo_error_rate{slo=,window=}`` gauges, so ``GET /metrics``, the
console's ``slo`` command, and soak artifacts read one data set.

The clock is injectable (tests / chaos replay), the sample history is
pruned to the slow window, and evaluation is on-demand (console, soak
snapshot cadence, the auto loop's ``Session.slo_step``) — never on the
serving hot path.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from svoc_torch.utils.metrics import MetricsRegistry
from svoc_torch.utils.metrics import registry as _default_registry


@dataclasses.dataclass(frozen=True)
class SLODefinition:
    """One objective plus its alerting windows.

    ``sample`` returns the CUMULATIVE ``(good, total)`` pair — the
    evaluator differences consecutive samples, so sources only need
    monotone counters.  Default thresholds are the SRE-workbook pair
    for a fast page (14.4× burn over the fast window) backed by a
    sustained signal (6× over the slow window).
    """

    name: str
    description: str
    objective: float
    sample: Callable[[], Tuple[float, float]]
    fast_window_s: float = 300.0
    slow_window_s: float = 3600.0
    fast_burn_alert: float = 14.4
    slow_burn_alert: float = 6.0

    def __post_init__(self):
        if not 0.0 < self.objective < 1.0:
            raise ValueError("objective must be in (0, 1)")
        if not 0.0 < self.fast_window_s <= self.slow_window_s:
            raise ValueError("need 0 < fast_window_s <= slow_window_s")


def _bucket_ratio(h, bound_s: float) -> Tuple[float, float]:
    """Cumulative ``(count ≤ bound, total)`` over a histogram's buckets
    (bucketized: the largest bucket bound ≤ the target is the effective
    threshold)."""
    buckets = h.cumulative_buckets()
    total = buckets[-1][1] if buckets else 0
    good = 0
    for le, cumulative in buckets:
        if le <= bound_s:
            good = cumulative
        else:
            break
    return float(good), float(total)


def _histogram_le(registry: MetricsRegistry, stage: str, bound_s: float):
    """:func:`_bucket_ratio` over the stage histogram — the latency
    SLO's ratio source."""
    return _bucket_ratio(registry.stage_histogram(stage), bound_s)


def default_slos(
    registry: Optional[MetricsRegistry] = None,
    *,
    consensus_p99_target_s: float = 0.25,
) -> List[SLODefinition]:
    """The framework's shipped objectives (docs/OBSERVABILITY.md §slo):

    - ``commit_success``  — ≥ 99 % of commit cycles land without a
      recorded failure (``chain_commit_failures`` over the commit
      timer's attempt count),
    - ``consensus_latency`` — ≥ 99 % of ``consensus`` stage dispatches
      complete within the p99 target (default 250 ms),
    - ``quarantine_admission`` — ≥ 90 % of inspected fleet slots pass
      the input-integrity gate (a sustained quarantine spike means an
      upstream data problem even while consensus survives it).
    """
    reg = registry or _default_registry

    def commit_sample() -> Tuple[float, float]:
        total = float(reg.timer("commit_latency").n)
        bad = float(reg.counter("chain_commit_failures").count)
        return max(0.0, total - bad), total

    def consensus_sample() -> Tuple[float, float]:
        return _histogram_le(reg, "consensus", consensus_p99_target_s)

    def quarantine_sample() -> Tuple[float, float]:
        total = float(reg.counter("quarantine_slots_inspected").count)
        bad = float(reg.family_total("oracle_quarantine"))
        return max(0.0, total - bad), total

    return [
        SLODefinition(
            name="commit_success",
            description="commit cycles without a recorded failure",
            objective=0.99,
            sample=commit_sample,
        ),
        SLODefinition(
            name="consensus_latency",
            description=(
                f"consensus stage dispatches under "
                f"{consensus_p99_target_s * 1e3:.0f} ms"
            ),
            objective=0.99,
            sample=consensus_sample,
        ),
        SLODefinition(
            name="quarantine_admission",
            description="fleet slots admitted by the input-integrity gate",
            objective=0.90,
            sample=quarantine_sample,
        ),
    ]


def claim_slos(
    registry: Optional[MetricsRegistry] = None,
    claim: str = "",
    *,
    commit_objective: float = 0.99,
    admission_objective: float = 0.90,
) -> List[SLODefinition]:
    """Per-claim objectives for the multi-claim fabric (docs/FABRIC.md).

    The claim router maintains claim-labeled cumulative counters as it
    multiplexes commit cycles — ``claim_commit_cycles{claim=}`` /
    ``claim_commit_failures{claim=}`` and
    ``claim_slots_inspected{claim=}`` / ``claim_slots_quarantined``
    ``{claim=}`` — and each claim gets its own evaluator over them, so
    one claim's burning error budget pages for THAT market instead of
    diluting into a fleet-wide average (a thousand healthy claims
    would otherwise hide one dead one forever).  SLO names are
    claim-qualified (``commit_success@<claim>``): the burn-rate gauges
    key on the slo label, and two claims' series must not collide."""
    if not claim:
        raise ValueError("claim_slos needs a claim id")
    reg = registry or _default_registry
    labels = {"claim": claim}

    def commit_sample() -> Tuple[float, float]:
        total = float(reg.counter("claim_commit_cycles", labels=labels).count)
        bad = float(reg.counter("claim_commit_failures", labels=labels).count)
        return max(0.0, total - bad), total

    def admission_sample() -> Tuple[float, float]:
        total = float(
            reg.counter("claim_slots_inspected", labels=labels).count
        )
        bad = float(
            reg.counter("claim_slots_quarantined", labels=labels).count
        )
        return max(0.0, total - bad), total

    return [
        SLODefinition(
            name=f"commit_success@{claim}",
            description=f"claim {claim}: commit cycles without a failure",
            objective=commit_objective,
            sample=commit_sample,
        ),
        SLODefinition(
            name=f"quarantine_admission@{claim}",
            description=f"claim {claim}: fleet slots admitted by the gate",
            objective=admission_objective,
            sample=admission_sample,
        ),
    ]


#: The histogram family the serving tier observes end-to-end request
#: latency (submit → completed consensus) into: the ``request_latency``
#: SLO below reads it (``slo.py:149``).
REQUEST_LATENCY_HISTOGRAM = "request_latency_seconds"


def serving_slos(
    registry: Optional[MetricsRegistry] = None,
    *,
    latency_objective: float = 0.99,
    latency_target_s: float = 0.25,
    admission_objective: float = 0.95,
    fast_window_s: float = 300.0,
    slow_window_s: float = 3600.0,
) -> List[SLODefinition]:
    """The serving tier's objectives (``slo.py:152-218``):

    - ``request_latency``: at least 99 % of completed requests finish
      within the latency target (a cumulative-bucket ratio over
      :data:`REQUEST_LATENCY_HISTOGRAM`).  The admission controller
      reads its fast burn rate and sheds above a threshold.
    - ``serving_admission``: at least 95 % of submitted requests are
      served (admitted or answered from the cache) rather than shed;
      admitted requests that were dropped count against it.

    The windows are arguments because seeded scenarios run in virtual
    seconds and need the burn to react within the run."""
    reg = registry or _default_registry

    def latency_sample() -> Tuple[float, float]:
        return _bucket_ratio(reg.histogram(REQUEST_LATENCY_HISTOGRAM), latency_target_s)

    def admission_sample() -> Tuple[float, float]:
        served = float(reg.family_total("serving_admitted")) + float(
            reg.family_total("serving_cached")
        )
        shed = float(reg.family_total("serving_shed"))
        dropped = float(reg.family_total("serving_dropped"))
        return max(0.0, served - dropped), served + shed

    return [
        SLODefinition(
            name="request_latency",
            description=f"serving requests completed within {latency_target_s * 1e3:.0f} ms",
            objective=latency_objective,
            sample=latency_sample,
            fast_window_s=fast_window_s,
            slow_window_s=slow_window_s,
        ),
        SLODefinition(
            name="serving_admission",
            description="submitted requests served rather than shed",
            objective=admission_objective,
            sample=admission_sample,
            fast_window_s=fast_window_s,
            slow_window_s=slow_window_s,
        ),
    ]


def fleet_slos(
    merged: Callable[[], MetricsRegistry],
    *,
    commit_objective: float = 0.99,
    latency_objective: float = 0.99,
    latency_target_s: float = 0.25,
    admission_objective: float = 0.95,
    fast_window_s: float = 300.0,
    slow_window_s: float = 3600.0,
) -> List[SLODefinition]:
    """Fleet-wide objectives over MERGED telemetry (``slo.py:221-301``):
    the user experiences the FLEET, not a replica, so the burn rates
    that matter difference counters summed across every replica (live +
    retired — the fleet plane's merge keeps them monotone through a
    failover, so the window differencing here never reads a replica
    swap as recovery).

    ``merged`` is a CALLABLE returning the current fleet merge (the
    :class:`~svoc_torch.obsplane.fleet.FleetPlane` provides one that
    reuses a single merge per evaluation pass) — the samples are taken
    at evaluation time, like every other evaluator here.

    - ``commit_success`` — fleet commit cycles without a recorded
      failure (``commit_latency`` attempts vs ``chain_commit_failures``
      summed across replicas);
    - ``request_latency`` — completed requests within the target,
      cumulative-bucket ratio over the MERGED
      :data:`REQUEST_LATENCY_HISTOGRAM`;
    - ``serving_admission`` — the serving-tier admission ratio over
      fleet-summed counters (same formula as :func:`serving_slos`).
    """

    def commit_sample() -> Tuple[float, float]:
        reg = merged()
        total = float(reg.timer("commit_latency").n)
        bad = float(reg.family_total("chain_commit_failures"))
        return max(0.0, total - bad), total

    def latency_sample() -> Tuple[float, float]:
        return _bucket_ratio(merged().histogram(REQUEST_LATENCY_HISTOGRAM), latency_target_s)

    def admission_sample() -> Tuple[float, float]:
        reg = merged()
        served = float(reg.family_total("serving_admitted")) + float(
            reg.family_total("serving_cached")
        )
        shed = float(reg.family_total("serving_shed"))
        dropped = float(reg.family_total("serving_dropped"))
        return max(0.0, served - dropped), served + shed

    return [
        SLODefinition(
            name="commit_success",
            description="fleet commit cycles without a recorded failure",
            objective=commit_objective,
            sample=commit_sample,
            fast_window_s=fast_window_s,
            slow_window_s=slow_window_s,
        ),
        SLODefinition(
            name="request_latency",
            description=f"fleet requests completed within {latency_target_s * 1e3:.0f} ms",
            objective=latency_objective,
            sample=latency_sample,
            fast_window_s=fast_window_s,
            slow_window_s=slow_window_s,
        ),
        SLODefinition(
            name="serving_admission",
            description="fleet submissions served rather than shed",
            objective=admission_objective,
            sample=admission_sample,
            fast_window_s=fast_window_s,
            slow_window_s=slow_window_s,
        ),
    ]


class SLOEvaluator:
    """Samples each SLO's cumulative counters and reports fast/slow
    burn rates; thread-safe (console, soak, and the auto loop may all
    evaluate concurrently)."""

    def __init__(
        self,
        slos: Sequence[SLODefinition],
        *,
        registry: Optional[MetricsRegistry] = None,
        journal=None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.slos = tuple(slos)
        names = [s.name for s in self.slos]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {names}")
        self._registry = registry or _default_registry
        self._journal = journal
        self._clock = clock
        self._lock = threading.Lock()
        self._samples: Dict[str, deque] = {s.name: deque() for s in self.slos}
        self._alerting: Dict[str, bool] = {s.name: False for s in self.slos}

    def _emit(self, event_type: str, **data: Any) -> None:
        j = self._journal
        if j is None:
            from svoc_torch.utils.events import journal as j
        j.emit(event_type, **data)

    @staticmethod
    def _window_burn(
        samples: deque, now: float, window_s: float, objective: float
    ) -> Dict[str, float]:
        """Burn over the trailing window: difference the newest sample
        against the OLDEST one inside the window (or the last one just
        before it, so a window that started mid-interval still has a
        baseline)."""
        latest = samples[-1]
        baseline = None
        for t, good, total in samples:
            if t >= now - window_s:
                if baseline is None:
                    baseline = (t, good, total)
                break
            baseline = (t, good, total)  # newest sample BEFORE the window
        if baseline is None:
            baseline = samples[0]
        d_total = latest[2] - baseline[2]
        d_good = latest[1] - baseline[1]
        if d_total <= 0:
            return {"error_rate": 0.0, "burn": 0.0, "events": 0.0}
        error_rate = min(1.0, max(0.0, 1.0 - d_good / d_total))
        return {
            "error_rate": error_rate,
            "burn": error_rate / (1.0 - objective),
            "events": d_total,
        }

    def evaluate(self) -> Dict[str, Dict[str, Any]]:
        """One evaluation pass; returns the per-SLO snapshot and
        updates gauges / alert latches."""
        now = self._clock()
        out: Dict[str, Dict[str, Any]] = {}
        alerts: List[Dict[str, Any]] = []
        with self._lock:
            for slo in self.slos:
                good, total = slo.sample()
                dq = self._samples[slo.name]
                dq.append((now, float(good), float(total)))
                # Keep one sample older than the slow window as the
                # baseline; prune the rest.
                horizon = now - slo.slow_window_s
                while len(dq) >= 2 and dq[1][0] <= horizon:
                    dq.popleft()
                fast = self._window_burn(dq, now, slo.fast_window_s, slo.objective)
                slow = self._window_burn(dq, now, slo.slow_window_s, slo.objective)
                for window, burn in (("fast", fast), ("slow", slow)):
                    self._registry.gauge(
                        "slo_burn_rate", labels={"slo": slo.name, "window": window}
                    ).set(burn["burn"])
                    self._registry.gauge(
                        "slo_error_rate",
                        labels={"slo": slo.name, "window": window},
                    ).set(burn["error_rate"])
                alerting = (
                    fast["events"] > 0
                    and fast["burn"] >= slo.fast_burn_alert
                    and slow["burn"] >= slo.slow_burn_alert
                )
                if alerting and not self._alerting[slo.name]:
                    alerts.append(
                        {
                            "slo": slo.name,
                            "objective": slo.objective,
                            "fast_burn": round(fast["burn"], 4),
                            "slow_burn": round(slow["burn"], 4),
                        }
                    )
                self._alerting[slo.name] = alerting
                out[slo.name] = {
                    "objective": slo.objective,
                    "description": slo.description,
                    "good": good,
                    "total": total,
                    "fast": {k: round(v, 6) for k, v in fast.items()},
                    "slow": {k: round(v, 6) for k, v in slow.items()},
                    "alerting": alerting,
                }
        # Emission OUTSIDE the evaluator lock: journal subscribers (the
        # postmortem monitor) may build bundles that re-enter snapshots.
        for alert in alerts:
            self._registry.counter(
                "slo_alerts", labels={"slo": alert["slo"]}
            ).add(1)
            self._emit("slo.alert", **alert)
        return out

    def alerting(self) -> List[str]:
        """Names of SLOs currently in the alerting state."""
        with self._lock:
            return [name for name, on in self._alerting.items() if on]
