"""The seeded end-to-end chaos scenarios (replay tests + the chaos smoke).

Mirrors :mod:`svoc_tpu.resilience.chaos` (``chaos.py:1-459``):
:class:`RecordingBackend`, :func:`run_chaos_scenario` (``:113``) and
:func:`run_byzantine_scenario` (``:259``).  Both are host work (the
contract simulator, the seeded fault plan and the quarantine gate on
numpy blocks), so they take no device; their fingerprints equal the
reference's for the same seed.

:func:`run_chaos_scenario` drives the infrastructure-fault acceptance
scenario against the local chain: a 7-oracle fleet with transient
commit faults on 2 oracles and one persistent offender, committed
through the full resilience stack (retry + resume + breaker +
supervisor).  The run must:

- converge to a fully-committed, certified consensus (resume re-sends
  only stranded oracles — the recording backend proves no oracle's tx
  is ever duplicated within a cycle),
- have the supervisor vote the persistent offender out through the
  contract's replacement flow,
- be bit-identical across two replays of the same seed (the
  ``fingerprint`` digests the final contract state, the replacement
  history, and the fired-fault log).

Everything time-like is pinned: zero backoff sleeps, seeded jitter, a
virtual breaker clock — so the scenario is a pure function of its
seed and runs in milliseconds.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from svoc_torch.consensus.state import OracleConsensusContract
from svoc_torch.io.chain import ChainAdapter, LocalChainBackend
from svoc_torch.ops.fixedpoint import from_wsad
from svoc_torch.resilience.breaker import CircuitBreaker
from svoc_torch.resilience.faults import (
    FaultInjectingBackend,
    FaultPlan,
    standard_fault_specs,
)
from svoc_torch.resilience.retry import RetryPolicy, commit_fleet_with_resume
from svoc_torch.resilience.supervisor import (
    FleetHealthSupervisor,
    SupervisorConfig,
)
from svoc_torch.utils.events import EventJournal, mint_lineage
from svoc_torch.utils.metrics import MetricsRegistry


class RecordingBackend:
    """Thin passthrough that counts SUCCESSFUL ``update_prediction``
    txs per (cycle, caller) — the no-duplicate-sends witness.  Failed
    sends never reach it (the fault wrapper sits outside)."""

    def __init__(self, inner):
        self.inner = inner
        self.cycle = -1
        self.sends: Dict[Tuple[int, Any], int] = {}
        self.duplicate_txs = 0

    def begin_cycle(self, cycle: int) -> None:
        self.cycle = cycle

    def call(self, function_name: str):
        return self.inner.call(function_name)

    def call_as(self, caller, function_name: str):
        return self.inner.call_as(caller, function_name)

    def invoke(self, caller, function_name: str, /, **kwargs) -> None:
        self.inner.invoke(caller, function_name, **kwargs)
        if function_name == "update_prediction":
            key = (self.cycle, caller)
            n = self.sends.get(key, 0) + 1
            self.sends[key] = n
            if n > 1:
                self.duplicate_txs += 1


def _contract_fingerprint(
    contract: OracleConsensusContract,
    supervisor: FleetHealthSupervisor,
    plan: Optional[FaultPlan] = None,
    extra: Optional[Dict[str, Any]] = None,
) -> str:
    """Canonical digest of everything a replay must reproduce: exact
    wsad contract state, replacement history (timestamps excluded —
    wall clock is not part of the schedule), the fired-fault log, and
    any scenario-specific ``extra`` records (the Byzantine scenario's
    injection/quarantine logs)."""
    state = {
        "consensus_active": contract.consensus_active,
        "consensus_value": list(contract.consensus_value),
        "rel1": contract.reliability_first_pass,
        "rel2": contract.reliability_second_pass,
        "skewness": list(contract.skewness),
        "kurtosis": list(contract.kurtosis),
        "oracles": [
            (repr(o.address), o.enabled, o.reliable, list(o.value))
            for o in contract.oracles
        ],
        "replacements": [
            {k: r[k] for k in ("step", "slot", "old", "new")}
            for r in supervisor.replacements
        ],
        "faults": plan.history() if plan is not None else [],
        "extra": extra or {},
    }
    return hashlib.sha256(
        json.dumps(state, sort_keys=True).encode()
    ).hexdigest()


def run_chaos_scenario(
    seed: int = 4,
    *,
    cycles: int = 12,
    n_oracles: int = 7,
    n_transient: int = 2,
    dimension: int = 6,
    #: per-tx transient fault rate: high enough that retries and
    #: resumes fire every few cycles, low enough that a transient
    #: oracle does not accrue the 2-consecutive-zero-signal cycles
    #: that would (correctly, but out of scenario scope) quarantine it.
    transient_probability: float = 0.25,
    registry: Optional[MetricsRegistry] = None,
    journal: Optional[EventJournal] = None,
) -> Dict[str, Any]:
    """Run the acceptance scenario once; returns the result summary
    (``fingerprint`` is the replay witness — it also folds in the
    event-stream digest, so a replay must reproduce not just the
    final state but the whole typed event journal, block by block)."""
    admins = [0xA0 + i for i in range(3)]
    oracles = [0x10 + i for i in range(n_oracles)]
    offender = oracles[-1]
    contract = OracleConsensusContract(
        admins=admins,
        oracles=oracles,
        required_majority=2,
        n_failing_oracles=2,
        constrained=True,
        dimension=dimension,
    )
    recorder = RecordingBackend(LocalChainBackend(contract))
    plan = FaultPlan(
        seed,
        standard_fault_specs(
            transient=oracles[:n_transient],
            persistent=[offender],
            probability=transient_probability,
        ),
        registry=registry,
    )
    adapter = ChainAdapter(FaultInjectingBackend(recorder, plan))

    # Deterministic timing: zero-length backoffs, seeded jitter, a
    # virtual monotonic clock, and a threshold high enough that the
    # breaker observes without ever short-circuiting the scenario.
    ticks = iter(range(10**9))
    clock = lambda: float(next(ticks))  # noqa: E731 — tiny local clock
    no_sleep = lambda s: None  # noqa: E731
    # A FRESH journal per run (unless the caller supplies one): the
    # event stream starts at seq 1, so two replays of one seed digest
    # byte-identically — the flight-recorder acceptance criterion.
    if journal is None:
        journal = EventJournal(registry=registry)
    breaker = CircuitBreaker(
        "chaos",
        failure_threshold=10_000,
        reset_timeout_s=0.0,
        clock=clock,
        registry=registry,
        journal=journal,
    )
    policy = RetryPolicy(
        max_attempts=4, base_s=0.0, cap_s=0.0, jitter_seed=seed
    )
    supervisor = FleetHealthSupervisor(
        adapter, SupervisorConfig(), registry=registry, journal=journal
    )

    rng = np.random.default_rng(seed)
    outcomes: List[Dict[str, Any]] = []
    for cycle in range(cycles):
        # One lineage id per commit cycle — the scenario's "block".
        lineage = mint_lineage(cycle, prefix="cyc")
        predictions = rng.uniform(0.05, 0.95, size=(n_oracles, dimension))
        recorder.begin_cycle(cycle)
        outcome = commit_fleet_with_resume(
            adapter,
            predictions,
            policy,
            breaker=breaker,
            sleep=no_sleep,
            clock=clock,
            on_oracle_failure=supervisor.record_commit_failure,
            registry=registry,
            journal=journal,
            lineage=lineage,
        )
        report = supervisor.step(lineage=lineage)
        outcomes.append(
            {
                "cycle": cycle,
                "sent": outcome.sent,
                "stranded": [repr(a) for a in outcome.stranded],
                "attempts": outcome.attempts,
                "complete": outcome.complete,
                "replaced": report["replaced"],
            }
        )

    final_oracles = contract.get_oracle_list()
    journal_fingerprint = journal.fingerprint()
    return {
        "seed": seed,
        "cycles": cycles,
        "outcomes": outcomes,
        "consensus_active": contract.consensus_active,
        "final_cycle_complete": outcomes[-1]["complete"] if outcomes else False,
        "offender_replaced": offender not in final_oracles,
        "replacements": len(supervisor.replacements),
        "replacement_history": list(supervisor.replacements),
        "duplicate_txs": recorder.duplicate_txs,
        "faults_fired": len(plan.history()),
        "journal_events": journal.last_seq(),
        "journal_fingerprint": journal_fingerprint,
        "fingerprint": _contract_fingerprint(
            contract, supervisor, plan,
            extra={"journal": journal_fingerprint},
        ),
    }


# ---------------------------------------------------------------------------
# The Byzantine scenario: data-plane chaos.
# ---------------------------------------------------------------------------

#: Malformed-vector kinds the injector rotates through — one per gate
#: *check* (docs/ROBUSTNESS.md §quarantine).  Under the constrained
#: gate the codec-breaking value (1e33) is ALSO outside [0,1] and the
#: gate's fixed precedence reports it as ``range`` — the codec
#: *reason* is only reachable unconstrained (pinned in
#: tests/test_robustness.py::TestQuarantineGate), so the expected
#: reason is tracked per kind and mismatches fail the scenario.
_INJECTION_KINDS = ("nan", "inf", "range", "codec")
_EXPECTED_REASON = {"nan": "nan", "inf": "inf", "range": "range", "codec": "range"}


def _seeded_uniform(seed: int, cycle: int, addr: Any, lo: float, hi: float, dim: int):
    """Per-(seed, cycle, address) deterministic draw — keyed like the
    fault plan's decisions (crc32, not ``hash()``) so the schedule is
    identical across processes AND independent of oracle-list order."""
    import zlib

    key = (seed * 1_000_003 + cycle) * 1_000_003 + zlib.crc32(repr(addr).encode())
    return np.random.default_rng(key & 0xFFFFFFFFFFFFFFFF).uniform(lo, hi, dim)


def run_byzantine_scenario(
    #: default 0: converges with EXACTLY colluders+injector
    #: replacements — like the fault scenario's seed, some seeds (2, 3)
    #: legitimately add a fourth (an honest oracle with an unlucky
    #: consecutive-unreliable streak); changing supervisor scoring
    #: requires re-scanning seeds.
    seed: int = 0,
    *,
    cycles: int = 14,
    n_oracles: int = 7,
    n_colluders: int = 2,
    dimension: int = 6,
    injector_probability: float = 0.6,
    registry: Optional[MetricsRegistry] = None,
    journal: Optional[EventJournal] = None,
) -> Dict[str, Any]:
    """The Byzantine acceptance scenario: coordinated Byzantine values +
    a malformed-input injector against the full data-plane defense
    (quarantine gate → skip-commit → supervisor → replacement vote).

    The fleet: ``n_colluders`` oracles emit a tight collusion cluster
    at 0.9 (finite, in-range — invisible to the gate, masked by the
    consensus and penalized through the rel₂-weighted unreliable
    signal); one injector emits NaN / Inf / out-of-range / codec-range
    vectors on a seeded schedule (cycle 0 is always clean so the
    consensus activates); the rest are honest.  The run must:

    - quarantine EVERY injected malformed vector (its tx is never
      sent) with ZERO false quarantines on honest/colluder vectors —
      colluding values are *syntactically* valid and must reach the
      estimator, that is the point of the two-pass defense;
    - hold the consensus: active, certified, essence inside the honest
      band every cycle (the cluster never captures the essence);
    - vote BOTH the colluders and the injector out through the
      contract's own replacement flow;
    - replay bit-identically (fingerprint over contract state,
      replacements, injection and quarantine logs).

    The supervisor runs a slightly looser ``unhealthy_threshold`` than
    the production default: the coalition's signal is
    ``0.6·(1 − rel₂/2) ≈ 0.33`` at the scenario's rel₂ ≈ 0.9, and the
    EMA must cross the bound within the cycle budget rather than
    asymptote 0.02 above it.
    """
    from svoc_torch.robustness.sanitize import QuarantineGate, SanitizeConfig

    admins = [0xA0 + i for i in range(3)]
    oracles = [0x10 + i for i in range(n_oracles)]
    if not 0 < n_colluders <= 2:
        raise ValueError("scenario is tuned for 1-2 colluders (n_failing=2)")
    colluders = set(oracles[:n_colluders])
    injector = oracles[-1]
    contract = OracleConsensusContract(
        admins=admins,
        oracles=oracles,
        required_majority=2,
        n_failing_oracles=2,
        constrained=True,
        dimension=dimension,
    )
    recorder = RecordingBackend(LocalChainBackend(contract))
    adapter = ChainAdapter(recorder)
    # Fresh journal per run (replay identity — see run_chaos_scenario).
    if journal is None:
        journal = EventJournal(registry=registry)
    gate = QuarantineGate(
        SanitizeConfig(lo=0.0, hi=1.0), registry=registry, journal=journal
    )
    supervisor = FleetHealthSupervisor(
        adapter,
        SupervisorConfig(unhealthy_threshold=0.4),
        registry=registry,
        journal=journal,
    )
    policy = RetryPolicy(max_attempts=4, base_s=0.0, cap_s=0.0, jitter_seed=seed)
    no_sleep = lambda s: None  # noqa: E731
    ticks = iter(range(10**9))
    clock = lambda: float(next(ticks))  # noqa: E731

    inj_rng = np.random.default_rng(seed)
    injection_log: List[Dict[str, Any]] = []
    quarantine_log: List[Dict[str, Any]] = []
    false_quarantines = 0
    missed_injections = 0
    reason_mismatches = 0
    essence_in_band = True
    outcomes: List[Dict[str, Any]] = []

    for cycle in range(cycles):
        lineage = mint_lineage(cycle, prefix="cyc")
        fleet = adapter.call_oracle_list()
        predictions = np.zeros((len(fleet), dimension), dtype=np.float64)
        injected_slots: Dict[int, str] = {}
        for slot, addr in enumerate(fleet):
            if addr in colluders:
                # The collusion cluster: tight, coordinated, in-range.
                predictions[slot] = 0.9 + 0.002 * _seeded_uniform(
                    seed, cycle, addr, -1.0, 1.0, dimension
                )
            else:
                predictions[slot] = _seeded_uniform(
                    seed, cycle, addr, 0.42, 0.58, dimension
                )
            if addr == injector and cycle >= 1:
                # Seeded malformed-vector schedule (drawn every cycle
                # so the schedule is a pure function of the seed,
                # independent of earlier replacements).
                draw = inj_rng.uniform()
                if draw < injector_probability:
                    kind = _INJECTION_KINDS[cycle % len(_INJECTION_KINDS)]
                    bad = {
                        "nan": float("nan"),
                        "inf": float("inf"),
                        "range": 1.5,
                        "codec": 1e33,
                    }[kind]
                    predictions[slot, cycle % dimension] = bad
                    injected_slots[slot] = kind
                    injection_log.append(
                        {
                            "cycle": cycle,
                            "slot": slot,
                            "kind": kind,
                            "expected_reason": _EXPECTED_REASON[kind],
                        }
                    )
        report = gate.inspect(predictions, lineage=lineage)
        for slot in report.quarantined_slots:
            reason = report.reasons[slot]
            quarantine_log.append(
                {"cycle": cycle, "slot": slot, "reason": reason}
            )
            # The charge carries the cycle's lineage — the audit link
            # the obs-smoke acceptance asserts (verdict → charge →
            # replacement, one lineage id).
            supervisor.record_quarantine(fleet[slot], reason, lineage=lineage)
            if slot not in injected_slots:
                false_quarantines += 1
            elif reason != _EXPECTED_REASON[injected_slots[slot]]:
                reason_mismatches += 1
        for slot in injected_slots:
            if slot not in report.quarantined_slots:
                missed_injections += 1
        recorder.begin_cycle(cycle)
        outcome = commit_fleet_with_resume(
            adapter,
            predictions,
            policy,
            skip=tuple(report.quarantined_slots),
            sleep=no_sleep,
            clock=clock,
            on_oracle_failure=supervisor.record_commit_failure,
            registry=registry,
            journal=journal,
            lineage=lineage,
        )
        report_sup = supervisor.step(lineage=lineage)
        if contract.consensus_active:
            essence = [from_wsad(x) for x in contract.get_consensus_value()]
            if not all(0.3 <= e <= 0.7 for e in essence):
                essence_in_band = False
        outcomes.append(
            {
                "cycle": cycle,
                "sent": outcome.sent,
                "stranded": [repr(a) for a in outcome.stranded],
                "quarantined": report.quarantined_slots,
                "complete": outcome.complete,
                "replaced": report_sup["replaced"],
            }
        )

    final_oracles = contract.get_oracle_list()
    journal_fingerprint = journal.fingerprint()
    extra = {
        "injections": injection_log,
        "quarantines": quarantine_log,
        "journal": journal_fingerprint,
    }
    return {
        "seed": seed,
        "cycles": cycles,
        "outcomes": outcomes,
        "consensus_active": contract.consensus_active,
        "injections": len(injection_log),
        "quarantines": len(quarantine_log),
        "missed_injections": missed_injections,
        "false_quarantines": false_quarantines,
        "reason_mismatches": reason_mismatches,
        "essence_in_band": essence_in_band,
        "colluders_voted_out": all(c not in final_oracles for c in colluders),
        "injector_voted_out": injector not in final_oracles,
        "replacements": len(supervisor.replacements),
        "replacement_history": list(supervisor.replacements),
        "duplicate_txs": recorder.duplicate_txs,
        "journal_events": journal.last_seq(),
        "journal_fingerprint": journal_fingerprint,
        "fingerprint": _contract_fingerprint(
            contract, supervisor, extra=extra
        ),
    }
