"""The cost-attribution plane: timelines, the cost ledger and the
observation channel behind one flag, wired through the serving tier and
the claim router.

Mirrors :mod:`svoc_tpu.obsplane.plane` (``plane.py:1-245``).  ``enabled``
resolves ONCE at construction: the explicit argument, then
``SVOC_COST_PLANE`` (``1/on/true/yes`` or ``0/off/false/no``), then the
committed decision, kept here as :data:`COST_PLANE_DECISION` (the
reference reads ``PERF_DECISIONS.json:8``; the port reads no file of the
JAX package, as ``resilience/retry.py::resolve_commit_mode`` pins the
commit mode).  A flag flipped mid-run would split a request's marks
across regimes.  Disabled, every hook is an attribute check and the
journal sees the same events: seeded runs give the same fingerprints
with the plane on and off.

Two clocks, on purpose:

- **timeline marks** use the tier's clock (virtual in seeded scenarios),
  so stage sums telescope to the latency the
  ``request_latency_seconds`` histogram sees;
- **ledger samples** use ``time.perf_counter``: the real host cost of a
  dispatch, which a virtual clock cannot see.

Neither reaches a fingerprint: marks go to the
``request_stage_seconds{stage=,claim=}`` histogram and the observation
channel; samples go to the ledger and ``cost.sample`` records.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from svoc_torch.obsplane.ledger import CostLedger, CostModel, group_key
from svoc_torch.obsplane.timeline import ObservationLog, RequestTimeline
from svoc_torch.utils.metrics import MetricsRegistry
from svoc_torch.utils.metrics import registry as _default_registry

#: The per-stage, per-claim latency decomposition histogram.
REQUEST_STAGE_HISTOGRAM = "request_stage_seconds"
#: The committed ``cost_plane`` routing (``PERF_DECISIONS.json:8``).
COST_PLANE_DECISION = "on"


def resolve_cost_plane_enabled(enabled: Optional[bool] = None) -> bool:
    """The explicit argument, then ``SVOC_COST_PLANE``, then
    :data:`COST_PLANE_DECISION`."""
    if enabled is not None:
        return bool(enabled)
    env = os.environ.get("SVOC_COST_PLANE", "").strip().lower()
    if env in ("1", "on", "true", "yes"):
        return True
    if env in ("0", "off", "false", "no"):
        return False
    return COST_PLANE_DECISION == "on"


class CostPlane:
    """Timeline recorder, cost ledger and observation log behind one
    ``enabled`` flag.  A request's marks happen on the tier's step
    thread; the router's per-claim marks are kept per step and folded on
    the same thread; the ledger and the log lock on their own."""

    def __init__(
        self,
        *,
        enabled: Optional[bool] = None,
        clock: Optional[Callable[[], float]] = None,
        metrics: Optional[MetricsRegistry] = None,
        trace_path: Optional[str] = None,
        alpha: Optional[float] = None,
    ):
        self.enabled = resolve_cost_plane_enabled(enabled)
        self._clock = clock if clock is not None else time.monotonic
        self._metrics = metrics or _default_registry
        self.obslog = ObservationLog(trace_path=trace_path)
        self.ledger = CostLedger(**({"alpha": alpha} if alpha else {}))
        self.model = CostModel(self.ledger)
        #: The router's per-claim marks of the current serving step
        #: ({claim_id: [(mark, t)]}), folded into each completed
        #: request's timeline by the tier and cleared every step.
        self._claim_marks: Dict[str, List[Tuple[str, float]]] = {}

    # -- timeline hooks (the tier's clock) ------------------------------------

    def timeline_for(self, lineage: str, claim: str, t_submit: float) -> Optional[RequestTimeline]:
        if not self.enabled:
            return None
        return RequestTimeline(lineage, claim, t_submit)

    def mark_requests(self, requests: Sequence, name: str) -> None:
        """Mark every request that carries a timeline, now (one clock
        read a call)."""
        if not self.enabled:
            return
        now = self._clock()
        for request in requests:
            timeline = getattr(request, "timeline", None)
            if timeline is not None:
                timeline.mark(name, now)

    def claim_mark(self, claim_ids: Sequence[str], name: str) -> None:
        """The router's per-claim marks (h2d, dispatched, synced,
        committed): it knows claims, not requests."""
        if not self.enabled:
            return
        now = self._clock()
        for cid in claim_ids:
            self._claim_marks.setdefault(cid, []).append((name, now))

    def complete(self, request, now: float, outcome: str = "completed") -> None:
        """Close one request's timeline: fold its claim's marks in,
        observe the stage histograms (completed requests only) and
        append the ``timeline.request`` observation."""
        timeline = getattr(request, "timeline", None)
        if not self.enabled or timeline is None:
            return
        timeline.extend(self._claim_marks.get(request.claim, ()))
        timeline.mark("completed", now)
        stages = timeline.stages()
        if outcome == "completed":
            for stage, seconds in stages.items():
                self._metrics.histogram(
                    REQUEST_STAGE_HISTOGRAM, labels={"stage": stage, "claim": request.claim}
                ).observe(seconds)
        self.obslog.record("timeline.request", lineage=timeline.lineage, claim=request.claim,
                           outcome=outcome, e2e_s=timeline.e2e_s(), stages=stages)

    def shed(self, lineage: str, claim: str, reason: str) -> None:
        """An admission-only timeline for a shed request (the verdict
        itself is the journal's ``serving.shed``)."""
        if not self.enabled:
            return
        self.obslog.record("timeline.request", lineage=lineage, claim=claim, outcome="shed",
                           reason=reason, e2e_s=0.0, stages={})

    def end_step(self) -> None:
        """Clear the step's claim marks."""
        if self._claim_marks:
            self._claim_marks.clear()

    # -- ledger hooks (the real host clock) -----------------------------------

    def observe_dispatch(self, key, warmth: str, seconds: float,
                         breakdown: Optional[dict] = None) -> None:
        """Fold one measured dispatch into the ledger and append its
        ``cost.sample`` observation (the same samples in the same order
        rebuild the same EMAs offline)."""
        if not self.enabled:
            return
        key_str = self.ledger.observe(key, warmth, seconds)
        self._metrics.counter("cost_samples", labels={"warmth": warmth}).add(1)
        self.obslog.record("cost.sample", key=key_str, group=group_key(key), warmth=warmth,
                           seconds=seconds, **({"breakdown": breakdown} if breakdown else {}))

    # -- persistence and views -------------------------------------------------

    def save_ledger(self, path: str) -> None:
        from svoc_torch.utils.artifacts import atomic_write_json

        atomic_write_json(path, self.ledger.to_dict())

    def restore_ledger(self, path: str) -> int:
        """Load a saved ledger; no file is a cold ledger, an unreadable
        one too, counted under ``cost_ledger_errors{op="restore"}``."""
        try:
            with open(path) as f:
                payload = json.load(f)
        except FileNotFoundError:  # svoclint: disable=SVOC014 — no sidecar on a fresh boot: the routine cold-start path, not a degrade
            return 0
        except (OSError, ValueError):
            self._metrics.counter("cost_ledger_errors", labels={"op": "restore"}).add(1)
            return 0
        return self.ledger.restore(payload)

    def snapshot(self) -> dict:
        """The ``costs`` section of ``ServingTier.snapshot()``."""
        return {
            "enabled": self.enabled,
            "ledger": self.ledger.summary(),
            "entries": self.ledger.to_dict()["entries"],
            "observations": len(self.obslog),
        }


def resolve_cost_plane(
    *,
    enabled: Optional[bool] = None,
    clock: Optional[Callable[[], float]] = None,
    metrics: Optional[MetricsRegistry] = None,
    trace_path: Optional[str] = None,
) -> CostPlane:
    """The serving tier's default plane, its routing resolved once."""
    return CostPlane(enabled=enabled, clock=clock, metrics=metrics, trace_path=trace_path)
