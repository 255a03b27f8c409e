"""The seeded serving scenario: the serving smoke's gate.

Mirrors :mod:`svoc_tpu.serving.scenario` (``scenario.py:1-235``):
:class:`VirtualClock`, :func:`draw_arrival`, :func:`shed_by_reason` and
:func:`run_serving_scenario`, over the port's ``MultiSession`` and
``deterministic_vectorizer``.  ``device=None`` means CUDA (raising
without a card); pass ``device="cpu"`` for the plain claim-cube forms.

A deterministic, virtual-time micro-load through the whole serving tier:
open-loop arrivals over N claims in three phases, **warm** (under
capacity: nothing should shed), **overload** (arrivals far above the
step's budget: queues hit their bounds, queued requests miss the latency
target, the ``request_latency`` burn gauge crosses the admission
threshold, and the tier must shed) and **recovery** (load drops back).
A seeded fraction of arrivals repeats comments from a small hot pool, so
the dedup cache serves real hits.

Everything is a function of ``seed``: arrivals key off
:func:`~svoc_torch.sim.generators.claim_seed`, the vectorizer is the
fabric scenario's crc-of-text map, time is a virtual clock the scenario
advances itself, and each run gets a fresh journal, a fresh metrics
registry and a pinned lineage scope.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from svoc_torch.fabric.registry import ClaimSpec
from svoc_torch.fabric.scenario import _claim_names, deterministic_vectorizer
from svoc_torch.sim.generators import claim_seed

#: (arrivals a step, steps) for each phase: warm, overload, recovery.
DEFAULT_PHASES: Tuple[Tuple[int, int], ...] = ((6, 8), (60, 10), (6, 8))


class VirtualClock:
    """A monotonic clock the scenario advances explicitly."""

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def advance(self, dt: float) -> float:
        self.now += float(dt)
        return self.now

    def __call__(self) -> float:
        return self.now


def draw_arrival(rng, names, pool, hot_fraction, unique_text):
    """One seeded open-loop arrival ``(claim, text)``: the claim drawn
    uniformly, the text a hot-pool repeat or ``unique_text(claim)``.  The
    draw order (claim, hot or not, pool index) is part of every seeded
    serving fingerprint."""
    claim = names[int(rng.integers(0, len(names)))]
    if rng.random() < hot_fraction:
        return claim, pool[int(rng.integers(0, len(pool)))]
    return claim, unique_text(claim)


def shed_by_reason(metrics) -> Dict[str, float]:
    """Shed totals by reason, claims folded."""
    out: Dict[str, float] = {}
    for labels, count in metrics.family_series("serving_shed"):
        reason = labels.get("reason", "")
        out[reason] = out.get(reason, 0.0) + count
    return out


def run_serving_scenario(
    seed: int = 0,
    *,
    phases: Tuple[Tuple[int, int], ...] = DEFAULT_PHASES,
    n_claims: int = 3,
    n_oracles: int = 7,
    dimension: int = 6,
    step_period_s: float = 0.1,
    max_requests_per_step: int = 16,
    queue_capacity: int = 48,
    hot_pool: int = 10,
    hot_fraction: float = 0.35,
    journal=None,
    metrics=None,
    cost_plane: Optional[str] = None,
    cost_trace_path: Optional[str] = None,
    device=None,
) -> Dict[str, Any]:
    """One seeded serving run; returns the journal fingerprint, the
    per-claim fingerprints, the per-phase shed accounting, the cache
    stats and the latency percentiles.  ``cost_plane`` ``"on"`` or
    ``"off"`` pins the cost plane on the scenario's clock and registry
    (None: the tier's own resolution); ``cost_trace_path`` streams its
    observation records to JSONL."""
    from svoc_torch.fabric.session import MultiSession
    from svoc_torch.obsplane.plane import CostPlane
    from svoc_torch.serving.frontend import AdmissionConfig
    from svoc_torch.serving.tier import ServingTier
    from svoc_torch.utils.events import EventJournal
    from svoc_torch.utils.metrics import MetricsRegistry
    from svoc_torch.utils.slo import REQUEST_LATENCY_HISTOGRAM, serving_slos

    journal = journal if journal is not None else EventJournal()
    metrics = metrics if metrics is not None else MetricsRegistry()
    clock = VirtualClock()
    names = _claim_names(n_claims)
    multi = MultiSession(
        base_seed=seed,
        vectorizer=deterministic_vectorizer,
        journal=journal,
        metrics=metrics,
        lineage_scope="srv",
        sanitized_dispatch=True,
        # The per-claim SLO evaluators journal their alerts: on the
        # virtual clock, two runs alert alike.
        clock=clock,
        device=device,
    )
    for name in names:
        multi.add_claim(ClaimSpec(claim_id=name, n_oracles=n_oracles, dimension=dimension))
    plane = (
        CostPlane(enabled=(cost_plane == "on"), clock=clock, metrics=metrics,
                  trace_path=cost_trace_path)
        if cost_plane is not None else None
    )
    tier = ServingTier(
        multi,
        vectorizer=deterministic_vectorizer,
        cost_plane=plane,
        admission=AdmissionConfig(queue_capacity=queue_capacity, burn_threshold=4.0, seed=seed),
        max_requests_per_step=max_requests_per_step,
        clock=clock,
        # Short windows so the burn reacts within the run; a wait of 3
        # steps misses the latency target.
        slos=serving_slos(metrics, latency_target_s=2.5 * step_period_s,
                          fast_window_s=10 * step_period_s, slow_window_s=50 * step_period_s),
    )

    rng = np.random.default_rng(claim_seed(seed, "serving_arrivals"))
    pool = [f"hot comment {i} — every market has a viral take" for i in range(hot_pool)]
    phase_stats: List[Dict[str, Any]] = []
    step_no = 0
    for phase_idx, (per_step, steps) in enumerate(phases):
        shed_before = metrics.family_total("serving_shed")
        hits_before = metrics.counter("serving_cache", labels={"event": "hit"}).count
        submitted = 0
        for _ in range(steps):
            clock.advance(step_period_s)
            for i in range(per_step):
                claim, text = draw_arrival(
                    rng, names, pool, hot_fraction,
                    lambda c: f"unique comment {c} step {step_no} #{i}",
                )
                tier.submit(claim, text)
                submitted += 1
            tier.step()
            step_no += 1
        phase_stats.append({
            "phase": phase_idx,
            "arrivals_per_step": per_step,
            "steps": steps,
            "submitted": submitted,
            "shed": metrics.family_total("serving_shed") - shed_before,
            "cache_hits": metrics.counter("serving_cache", labels={"event": "hit"}).count - hits_before,
        })

    return {
        "seed": seed,
        "claims": names,
        "steps": step_no,
        "phases": phase_stats,
        "submitted": metrics.family_total("serving_submitted"),
        "admitted": metrics.family_total("serving_admitted"),
        "cached": metrics.family_total("serving_cached"),
        "shed": metrics.family_total("serving_shed"),
        "completed": metrics.family_total("serving_completed"),
        "shed_by_reason": dict(sorted(shed_by_reason(metrics).items())),
        "cache": tier.cache.stats(),
        "latency": metrics.histogram(REQUEST_LATENCY_HISTOGRAM).snapshot(),
        "snapshot": tier.snapshot(),
        "journal_fingerprint": journal.fingerprint(),
        "journal_events": journal.last_seq(),
        "per_claim_fingerprints": {name: multi.claim_fingerprint(name) for name in names},
        "cost_plane": tier.cost_plane,
        "multi": multi,
    }
