"""The port's resilience layer and SLOs against the JAX package's, on the
CPU, under injected clocks and failures.

- ``RetryPolicy``'s decorrelated-jitter delays, number for number, and
  ``call_with_retry``'s sleeps, retries and deadline.
- ``CircuitBreaker`` over one scripted failure/success/clock sequence:
  the same states, ``retry_after_s`` and journal fingerprint.
- ``commit_fleet_with_resume`` over the port's and the reference's
  contract simulators behind the reference's seeded fault injector
  (transient and persistent signer faults), both commit modes: the same
  outcomes, sleeps, chain state and journal fingerprint.
- ``FleetHealthSupervisor`` driven by those commit cycles and by gate
  quarantines: the same health scores, quarantines, replacement votes
  and rosters.
- ``SLOEvaluator`` over the same counter histories and clock: the same
  burn rates and ``slo.alert`` events.
- The commit-plane mode and its counted, log-once fallback.
"""

import logging

import numpy as np
import pytest

pytest.importorskip("jax")

from svoc_tpu.apps.session import SessionConfig as RefSessionConfig
from svoc_tpu.apps.session import _default_contract as ref_default_contract
from svoc_tpu.io.chain import ChainAdapter as RefAdapter
from svoc_tpu.io.chain import LocalChainBackend as RefBackend
from svoc_tpu.resilience import breaker as ref_breaker
from svoc_tpu.resilience import retry as ref_retry
from svoc_tpu.resilience import supervisor as ref_supervisor
from svoc_tpu.resilience.faults import FaultInjectingBackend, FaultPlan, FaultSpec
from svoc_tpu.utils import slo as ref_slo
from svoc_tpu.utils.events import EventJournal as RefJournal
from svoc_tpu.utils.metrics import MetricsRegistry as RefRegistry

from svoc_torch.apps.session import SessionConfig, _default_contract
from svoc_torch.io.chain import ChainAdapter, ChainCommitError, LocalChainBackend
from svoc_torch.resilience import breaker, retry, supervisor
from svoc_torch.utils import slo
from svoc_torch.utils.events import EventJournal
from svoc_torch.utils.metrics import MetricsRegistry


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.sleeps.append(s)
        self.t += s

    sleeps = None


def _clock():
    c = FakeClock()
    c.sleeps = []
    return c


@pytest.mark.parametrize(
    "policy",
    [
        dict(jitter_seed=0),
        dict(jitter_seed=7, base_s=0.01, cap_s=0.5),
        dict(jitter_seed=123, base_s=0.2, cap_s=0.2),
        dict(jitter_seed=2**31 - 1, base_s=0.0, cap_s=3.0),
    ],
)
def test_retry_delays_number_for_number(policy):
    ours, ref = retry.RetryPolicy(**policy).delays(), ref_retry.RetryPolicy(**policy).delays()
    assert [next(ours) for _ in range(16)] == [next(ref) for _ in range(16)]


@pytest.mark.parametrize("failures,deadline", [(0, None), (2, None), (3, None), (5, None), (3, 0.15)])
def test_call_with_retry_matches_the_reference(failures, deadline):
    def run(mod, registry):
        clock = _clock()
        calls, retries = [0], []

        def fn():
            calls[0] += 1
            clock.t += 0.01
            if calls[0] <= failures:
                raise RuntimeError(f"fail {calls[0]}")
            return "ok"

        policy = mod.RetryPolicy(max_attempts=4, jitter_seed=3, overall_deadline_s=deadline)
        try:
            out = mod.call_with_retry(
                fn, policy, op="t", sleep=clock.sleep, clock=clock,
                on_retry=lambda a, e, d: retries.append((a, str(e), d)), registry=registry,
            )
        except RuntimeError as e:
            out = f"raised {e}"
        return out, calls[0], clock.sleeps, retries, registry.counter("retries", labels={"op": "t"}).count

    assert run(retry, MetricsRegistry()) == run(ref_retry, RefRegistry())


def test_circuit_breaker_scripted_sequence():
    script = ["f", "f", "a", "f", "a", "t5", "a", "f", "t31", "a", "a", "s", "f", "f", "f",
              "t10", "a", "t25", "a", "s", "a"]

    def run(mod, journal, registry):
        clock = _clock()
        b = mod.CircuitBreaker("chain[x]", failure_threshold=3, reset_timeout_s=30.0,
                               clock=clock, registry=registry, journal=journal)
        trace = []
        for op in script:
            if op == "f":
                b.record_failure()
            elif op == "s":
                b.record_success()
            elif op == "a":
                trace.append(("allow", b.allow()))
            else:
                clock.t += float(op[1:])
            trace.append((b.state(), round(b.retry_after_s(), 9)))
        return trace, journal.fingerprint(), registry.gauge(
            "circuit_breaker_state", labels={"backend": "chain[x]"}
        ).get()

    assert run(breaker, EventJournal(), MetricsRegistry()) == run(
        ref_breaker, RefJournal(), RefRegistry()
    )


def _contract_state(adapter):
    c = adapter.backend.backend.contract
    return (c.consensus_active, list(c.consensus_value), c.reliability_first_pass,
            c.reliability_second_pass, list(c.skewness), list(c.kurtosis),
            [(o.address, list(o.value), o.enabled, o.reliable) for o in c.oracles])


def _world(port: bool, specs, seed):
    """A 7-oracle local contract behind the seeded fault injector, with
    its journal, registry, breaker and supervisor, from one package."""
    if port:
        contract = _default_contract(SessionConfig(), device="cpu")
        adapter_cls, backend_cls, reg, jr = ChainAdapter, LocalChainBackend, MetricsRegistry(), EventJournal()
        br, sup = breaker, supervisor
    else:
        contract = ref_default_contract(RefSessionConfig())
        adapter_cls, backend_cls, reg, jr = RefAdapter, RefBackend, RefRegistry(), RefJournal()
        br, sup = ref_breaker, ref_supervisor
    clock = _clock()
    plan = FaultPlan(seed, specs, registry=RefRegistry())
    adapter = adapter_cls(FaultInjectingBackend(backend_cls(contract), plan, sleep=clock.sleep))
    b = br.CircuitBreaker("chain", failure_threshold=50, clock=clock, registry=reg, journal=jr)
    s = sup.FleetHealthSupervisor(adapter, registry=reg, journal=jr, claim="c")
    return adapter, clock, b, s, reg, jr


def _no_ts(records):
    """Replacement records without their wall-clock stamps."""
    return [{k: v for k, v in r.items() if k != "ts"} for r in records]


def _fleet(rng):
    return rng.uniform(0.05, 0.95, size=(7, 6))


@pytest.mark.parametrize("mode", ["per_tx", "batched"])
@pytest.mark.parametrize("seed", [0, 1])
def test_commit_resume_and_supervisor_match_the_reference(mode, seed):
    specs = [
        FaultSpec(op="invoke:update_prediction", kind="error", target=0x12, probability=0.5),
        FaultSpec(op="invoke:update_prediction", kind="timeout", target=0x13, probability=0.3),
        FaultSpec(op="invoke:update_prediction", kind="error", target=0x15, probability=1.0,
                  after=1),
    ]

    def run(port):
        mod = retry if port else ref_retry
        adapter, clock, b, s, reg, jr = _world(port, specs, seed)
        rng = np.random.default_rng(seed)
        log = []
        for cycle in range(6):
            lineage = f"blkt-c-{cycle:06x}"
            skip = (3,) if cycle == 4 else ()
            for slot in skip:
                s.record_quarantine(adapter.call_oracle_list()[slot], "nan", lineage=lineage)
            try:
                out = mod.commit_fleet_with_resume(
                    adapter, _fleet(rng), mod.RetryPolicy(max_attempts=3, jitter_seed=seed),
                    breaker=b, skip=skip, sleep=clock.sleep, clock=clock,
                    on_oracle_failure=s.record_commit_failure, registry=reg, journal=jr,
                    lineage=lineage, commit_mode=mode,
                )
                log.append((out.sent, out.total, out.attempts, out.stranded, out.complete))
            except Exception as e:  # noqa: BLE001 — the outcome is what is compared
                log.append(type(e).__name__)
            report = s.step(lineage=lineage)
            report["replaced"] = _no_ts(report["replaced"])
            log.append(report)
        replacements = _no_ts(s.replacements)
        return (log, clock.sleeps, _contract_state(adapter), s.health_snapshot(),
                s.quarantined_slots(), replacements, adapter.call_oracle_list(), jr.fingerprint())

    ours, ref = run(True), run(False)
    assert ours == ref
    assert ours[5], "the persistent offender should have been voted out"


def test_commit_failure_is_a_chain_commit_error_when_the_deadline_expires():
    specs = [FaultSpec(op="invoke:update_prediction", kind="error", target=0x11, probability=1.0)]
    adapter, clock, b, s, reg, jr = _world(True, specs, 0)
    policy = retry.RetryPolicy(max_attempts=3, jitter_seed=0, overall_deadline_s=0.01)
    with pytest.raises(ChainCommitError):
        retry.commit_fleet_with_resume(
            adapter, _fleet(np.random.default_rng(0)), policy, breaker=b, sleep=clock.sleep,
            clock=clock, registry=reg, journal=jr, commit_mode="per_tx",
        )


@pytest.mark.parametrize("objective", [0.99, 0.5])
def test_slo_evaluator_matches_the_reference(objective):
    def run(mod, reg, jr):
        clock = _clock()
        ev = mod.SLOEvaluator(
            mod.default_slos(reg) + mod.claim_slos(reg, "alpha", commit_objective=objective),
            registry=reg, journal=jr, clock=clock,
        )
        rng = np.random.default_rng(0)
        out = []
        for step in range(40):
            clock.t += 30.0
            bad = step in range(12, 20)
            reg.counter("claim_commit_cycles", labels={"claim": "alpha"}).add(1)
            reg.counter("claim_commit_failures", labels={"claim": "alpha"}).add(int(bad))
            reg.counter("claim_slots_inspected", labels={"claim": "alpha"}).add(7)
            reg.counter("claim_slots_quarantined", labels={"claim": "alpha"}).add(int(bad))
            reg.counter("quarantine_slots_inspected").add(7)
            reg.counter("oracle_quarantine", labels={"reason": "nan"}).add(int(rng.random() < 0.2))
            reg.counter("chain_transactions").add(7)
            reg.counter("chain_commit_failures").add(int(bad))
            out.append(ev.evaluate())
        return out, ev.alerting(), jr.fingerprint()

    assert run(slo, MetricsRegistry(), EventJournal()) == run(ref_slo, RefRegistry(), RefJournal())


def test_commit_mode_resolution(monkeypatch):
    monkeypatch.delenv(retry.COMMIT_MODE_ENV, raising=False)
    assert retry.resolve_commit_mode() == "batched"
    monkeypatch.setenv(retry.COMMIT_MODE_ENV, "per_tx")
    assert retry.resolve_commit_mode() == "per_tx"
    monkeypatch.setenv(retry.COMMIT_MODE_ENV, "sideways")
    with pytest.raises(retry.CommitModeError):
        retry.resolve_commit_mode()


def test_batch_fallback_is_counted_and_logged_once(caplog):
    reg = MetricsRegistry()
    retry.reset_batch_fallback_log()
    with caplog.at_level(logging.WARNING, logger="svoc_torch.io.chain.batch"):
        for _ in range(3):
            retry.report_batch_fallback("skip_slots", detail="1 slot", metrics=reg)
        retry.report_batch_fallback("unsupported", metrics=reg)
    assert reg.counter("commit_batch_fallback", labels={"reason": "skip_slots"}).count == 3
    assert reg.counter("commit_batch_fallback", labels={"reason": "unsupported"}).count == 1
    assert len(caplog.records) == 2
    assert "reason=skip_slots: 1 slot" in caplog.records[0].getMessage()
