"""Seeded anomaly detection over fleet counter deltas.

Mirrors :mod:`svoc_tpu.obsplane.anomaly` (``anomaly.py:1-189``):
``DEFAULT_ANOMALY_FAMILIES``, :class:`AnomalyConfig` and
:class:`AnomalyDetector`, line for line — a pure function of the sampled
counter totals (pure Python, no device work).

The detector watches the fleet's DEGRADATION families — per-replica
``serving_shed``/``serving_dropped`` and the router's
``cluster_unavailable``/``cluster_quarantined`` — sampled once per
router step (:meth:`ClusterRouter.step_all` cadence).  Each
``(source, family)`` series keeps a bounded ring of per-step deltas
plus an EWMA mean/variance baseline; a step's delta breaches when its
z-score against the PRE-update baseline clears the threshold (with a
minimum-delta floor so a single stray shed after a silent warmup
cannot page), or when a static per-family guardrail is exceeded
outright.  Breaching deltas are deliberately NOT absorbed into the
baseline — an incident must not teach the detector that shedding is
normal — so a sustained degradation stays visible until traffic
recovers.

Determinism is the contract (SVOC011): every threshold is pinned at
construction in :class:`AnomalyConfig`, the detector reads nothing
from the environment or the wall clock, and its output is a pure
function of the sampled counter sequence — the same seed produces the
same alerts on every run, which ``tests/test_torch_fleet_obs.py``
holds to the reference's.
Alerts surface as ``anomaly.detected`` observation records (never
journal events: the fleet plane is replay-invisible) and, on the
SUSTAINED edge (``sustain_steps`` consecutive breaches), auto-trigger
a profile capture + postmortem bundle via the fleet plane.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Dict, List, Mapping, Optional, Tuple

#: The default watched families: all four only ever count DEGRADED
#: outcomes, so a healthy fleet's series are identically zero and the
#: detector is structurally silent until something actually breaks.
DEFAULT_ANOMALY_FAMILIES = (
    "serving_shed",
    "serving_dropped",
    "cluster_unavailable",
    "cluster_quarantined",
)


@dataclasses.dataclass(frozen=True)
class AnomalyConfig:
    """Every detector threshold, pinned at construction (SVOC011 — a
    mid-run threshold flip would split one incident across regimes).

    - ``alpha`` — EWMA weight for the mean/variance baseline.
    - ``z_threshold`` — breach when ``(delta - mean) / sigma`` clears
      this (sigma floored at ``sigma_floor`` so an all-zero warmup
      cannot divide by zero).
    - ``min_delta`` — z-breaches additionally need at least this many
      new degraded events in the step.
    - ``warmup_steps`` — clean baseline samples required before the
      z-detector arms (guardrails are static and always armed).
    - ``sustain_steps`` — consecutive breaches before the alert is
      ``sustained`` (profile capture + bundle fire on that edge).
    - ``guardrails`` — per-family absolute per-step delta ceilings,
      breached regardless of the learned baseline.
    """

    families: Tuple[str, ...] = DEFAULT_ANOMALY_FAMILIES
    alpha: float = 0.3
    z_threshold: float = 4.0
    min_delta: float = 3.0
    sigma_floor: float = 0.5
    warmup_steps: int = 3
    sustain_steps: int = 2
    guardrails: Mapping[str, float] = dataclasses.field(default_factory=dict)
    ring_size: int = 256

    def __post_init__(self):
        if not 0.0 < self.alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        if self.sigma_floor <= 0.0:
            raise ValueError("sigma_floor must be positive")
        if self.sustain_steps < 1:
            raise ValueError("sustain_steps must be >= 1")


class _SeriesState:
    """One ``(source, family)`` series: last cumulative total, EWMA
    baseline, breach streak, and the bounded delta ring."""

    __slots__ = ("last_total", "mean", "var", "n", "streak", "ring")

    def __init__(self, ring_size: int):
        self.last_total: Optional[float] = None
        self.mean = 0.0
        self.var = 0.0
        self.n = 0
        self.streak = 0
        self.ring: deque = deque(maxlen=ring_size)


class AnomalyDetector:
    """Deterministic per-series delta detector (module docstring).
    Not internally locked: the fleet plane drives it from the router's
    single step thread."""

    def __init__(self, config: Optional[AnomalyConfig] = None):
        self.config = config or AnomalyConfig()
        self._series: Dict[Tuple[str, str], _SeriesState] = {}
        self._alerts_total = 0

    def on_step(
        self, step: int, totals: Dict[Tuple[str, str], float]
    ) -> List[dict]:
        """Feed one step's cumulative family totals; returns this
        step's breach alerts (``sustained=True`` exactly on the
        ``sustain_steps``-th consecutive breach — the trigger edge)."""
        alerts: List[dict] = []
        cfg = self.config
        for key in sorted(totals):
            source, family = key
            state = self._series.get(key)
            if state is None:
                state = self._series[key] = _SeriesState(cfg.ring_size)
            total = float(totals[key])
            if state.last_total is None:
                state.last_total = total
                continue
            delta = total - state.last_total
            state.last_total = total
            state.ring.append((step, delta))
            sigma = max(math.sqrt(max(state.var, 0.0)), cfg.sigma_floor)
            z = (delta - state.mean) / sigma
            trigger = None
            if (
                state.n >= cfg.warmup_steps
                and delta >= cfg.min_delta
                and z >= cfg.z_threshold
            ):
                trigger = "z"
            rail = cfg.guardrails.get(family)
            if rail is not None and delta > rail:
                trigger = trigger or "guardrail"
            if trigger is None:
                # Clean sample: absorb into the baseline.  Breaches are
                # NOT absorbed (docstring) — the incident must not
                # become the new normal.
                diff = delta - state.mean
                incr = cfg.alpha * diff
                state.mean += incr
                state.var = (1.0 - cfg.alpha) * (state.var + diff * incr)
                state.n += 1
                state.streak = 0
                continue
            state.streak += 1
            self._alerts_total += 1
            alerts.append(
                {
                    "source": source,
                    "family": family,
                    "step": step,
                    "delta": round(delta, 6),
                    "mean": round(state.mean, 6),
                    "sigma": round(sigma, 6),
                    "z": round(z, 4),
                    "trigger": trigger,
                    "streak": state.streak,
                    "sustained": state.streak == cfg.sustain_steps,
                }
            )
        return alerts

    def drop_source(self, source: str) -> None:
        """Forget a retired source's series (its registry is frozen —
        zero deltas forever would only pad the state dict)."""
        for key in [k for k in self._series if k[0] == source]:
            del self._series[key]

    def summary(self) -> dict:
        """The console/``/api/state`` view: series count, total breach
        alerts, and the currently-streaking series."""
        streaking = {
            f"{src}/{fam}": st.streak
            for (src, fam), st in sorted(self._series.items())
            if st.streak > 0
        }
        return {
            "series": len(self._series),
            "alerts_total": self._alerts_total,
            "streaking": streaking,
        }
