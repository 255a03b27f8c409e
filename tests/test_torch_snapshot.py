"""The port's service snapshots, recovery manager, drain and shutdown
bundles against the JAX package's, on the CPU.

Twins of ``tests/test_durability.py:463-831`` and of the checkpoint
half of ``tests/test_checkpoint.py``:

- ``session_durable_dict`` and ``multi_session_to_dict`` give equal JSON
  in both packages after the same fetch/commit cycles, with a tampered
  claim, a supervisor charge and a request-fed window among them;
- a snapshot written by the reference's ``RecoveryManager`` and
  recovered by the port's continues to the reference's own per-claim
  and journal fingerprints (and the other way round);
- orphans are quarantined and reclaimable; a fingerprint discontinuity
  refuses recovery; predictions, toggles and cursors survive;
- the simulation checkpoint and the contract's dict round trip;
- the graceful drain under live serving load, and the shutdown
  bundle's classification, rate-limit exemption and signal chaining.
"""

import json
import os
import signal
import types

import numpy as np
import pytest

pytest.importorskip("jax")

import svoc_tpu.durability.recovery as ref_recovery
import svoc_tpu.fabric.registry as ref_registry
import svoc_tpu.fabric.session as ref_fabric
import svoc_tpu.io.comment_store as ref_store
import svoc_tpu.serving.frontend as ref_frontend
import svoc_tpu.serving.scenario as ref_serving_scenario
import svoc_tpu.serving.tier as ref_tier
import svoc_tpu.utils.checkpoint as ref_checkpoint
import svoc_tpu.utils.events as ref_events
import svoc_tpu.utils.metrics as ref_metrics
import svoc_tpu.utils.postmortem as ref_postmortem
import svoc_tpu.utils.slo as ref_slo
from svoc_tpu.fabric.scenario import deterministic_vectorizer

import svoc_torch.durability.recovery as recovery
import svoc_torch.fabric.registry as registry
import svoc_torch.fabric.session as fabric
import svoc_torch.io.comment_store as store
import svoc_torch.serving.frontend as frontend
import svoc_torch.serving.scenario as serving_scenario
import svoc_torch.serving.tier as tier_mod
import svoc_torch.utils.checkpoint as checkpoint
import svoc_torch.utils.events as events
import svoc_torch.utils.metrics as metrics
import svoc_torch.utils.postmortem as postmortem
import svoc_torch.utils.slo as slo
from svoc_torch.io.scraper import SyntheticSource
from svoc_torch.sim.generators import claim_seed

REF = types.SimpleNamespace(
    recovery=ref_recovery, registry=ref_registry, fabric=ref_fabric, store=ref_store,
    frontend=ref_frontend, serving_scenario=ref_serving_scenario, tier=ref_tier,
    checkpoint=ref_checkpoint, events=ref_events, metrics=ref_metrics,
    postmortem=ref_postmortem, slo=ref_slo, kw={},
)
PORT = types.SimpleNamespace(
    recovery=recovery, registry=registry, fabric=fabric, store=store,
    frontend=frontend, serving_scenario=serving_scenario, tier=tier_mod,
    checkpoint=checkpoint, events=events, metrics=metrics,
    postmortem=postmortem, slo=slo, kw={"device": "cpu"},
)
ORACLES = [0x10 + i for i in range(7)]


def _tamper(cycle, block):
    block = np.array(block, copy=True)
    if cycle % 2:
        block[6, 1] = np.nan
    return block


def make_multi(p, names, journal=None, metrics_=None, scope="t", tampered=()):
    def store_factory(claim_id):
        s = p.store.CommentStore()
        s.save(SyntheticSource(batch=80, seed=claim_seed(3, claim_id))())
        return s

    multi = p.fabric.MultiSession(
        base_seed=3,
        vectorizer=deterministic_vectorizer,
        store_factory=store_factory,
        journal=journal if journal is not None else p.events.EventJournal(
            registry=p.metrics.MetricsRegistry()),
        metrics=metrics_ if metrics_ is not None else p.metrics.MetricsRegistry(),
        lineage_scope=scope,
        max_claims_per_batch=len(names),
        commit_mode="per_tx",
        **p.kw,
    )
    for name in names:
        multi.add_claim(p.registry.ClaimSpec(
            claim_id=name, tamper=_tamper if name in tampered else None))
    return multi


def _json(payload, p):
    return json.loads(json.dumps(p.events._json_safe(payload), sort_keys=True))


def _strip_ts(payload):
    """Replacement records carry the wall clock ("ts"): not part of the
    state either package replays."""
    for claim in payload.get("claims", {}).values():
        for r in claim["session"]["supervisor"]["replacements"]:
            r.pop("ts", None)
    return payload


def _run_both(fn):
    return fn(REF), fn(PORT)


# ---------------------------------------------------------------------------
# The durable dicts, field for field
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cycles", [1, 4])
def test_multi_session_dict_equals_reference(cycles):
    def run(p):
        multi = make_multi(p, ["alpha", "beta", "gamma"], tampered=("gamma",))
        multi.run(cycles)
        sup = multi.get("alpha").session.supervisor
        sup.record_commit_failure(ORACLES[0])
        sup.step()
        multi.pause("beta")
        return _strip_ts(_json(p.checkpoint.multi_session_to_dict(multi), p))

    ref, port = _run_both(run)
    assert port == ref
    assert port["router_steps"] == cycles and port["claims"]["beta"]["paused"]
    assert len(port["claims"]["alpha"]["session"]["prng_key"]) == 2


def test_session_durable_dict_request_fed_window():
    """A request-fed claim (the serving tier's path): the rolling window,
    the block source and the key chain serialise as the reference's."""
    def run(p):
        multi = make_multi(p, ["alpha"])
        rng = np.random.default_rng(0)
        for _ in range(3):
            multi.step(feeds={"alpha": rng.uniform(0.1, 0.9, (5, 6))})
        session = multi.get("alpha").session
        return _json(p.checkpoint.session_durable_dict(session), p)

    ref, port = _run_both(run)
    assert port == ref
    assert port["block_source"] == "serving" and len(port["request_window"]) == 15


def test_contract_and_simulation_round_trip(tmp_path):
    from svoc_tpu.apps import session as ref_session
    from svoc_torch.apps import session as port_session

    def run(p, mod):
        s = mod.Session(mod.SessionConfig(seed=2, lineage_scope="t", commit_mode="per_tx"),
                        store=_store(p), vectorizer=deterministic_vectorizer,
                        journal=p.events.EventJournal(), **p.kw)
        for _ in range(2):
            s.fetch()
            s.commit_resilient()
        path = str(tmp_path / f"sim-{id(p)}.json")
        p.checkpoint.save_simulation(path, s)
        fresh = mod.Session(mod.SessionConfig(seed=9), store=_store(p),
                            vectorizer=deterministic_vectorizer,
                            journal=p.events.EventJournal(), **p.kw)
        p.checkpoint.restore_simulation(path, fresh)
        c = fresh.adapter.backend.contract
        again = p.checkpoint.contract_to_dict(p.checkpoint.contract_from_dict(
            p.checkpoint.contract_to_dict(c), **p.kw))
        return (json.load(open(path)), fresh.simulation_step, fresh.lineage_prefix,
                again == p.checkpoint.contract_to_dict(c))

    ref, port = run(REF, ref_session), run(PORT, port_session)
    assert port == ref and port[3]


def _store(p):
    s = p.store.CommentStore()
    s.save(SyntheticSource(batch=120, seed=5)())
    return s


# ---------------------------------------------------------------------------
# Recovery across the two packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_snapshot_restores_across_packages(tmp_path, writer):
    """One package snapshots after three cycles; each package recovers
    the file into a fresh fabric and runs two more: the port's
    continuation equals the reference's, fingerprint for fingerprint.
    (Neither equals the writer's uninterrupted run: the snapshot's own
    ``durability.snapshot`` event takes a journal seq the recovered
    journal never saw.)"""
    w = REF if writer == "ref" else PORT
    journal = w.events.EventJournal(registry=w.metrics.MetricsRegistry())
    multi = make_multi(w, ["alpha", "beta"], journal=journal, tampered=("beta",))
    multi.run(3)
    w.recovery.RecoveryManager(multi, out_dir=str(tmp_path)).snapshot()

    def resume(p):
        j = p.events.EventJournal(registry=p.metrics.MetricsRegistry())
        fresh = make_multi(p, ["alpha", "beta"], journal=j, tampered=("beta",))
        report = p.recovery.RecoveryManager(fresh, out_dir=str(tmp_path)).recover()
        fresh.run(2)
        return ({c: fresh.claim_fingerprint(c) for c in ("alpha", "beta")},
                {c: fresh.get(c).cycles for c in ("alpha", "beta")},
                fresh.get("alpha").session.last_lineage,
                report["membership"], report["journal_events"], j.fingerprint())

    ref, port = _run_both(resume)
    assert port == ref
    assert port[1] == {"alpha": 5, "beta": 5} and port[2] == "blkt-alpha-000005"
    assert port[3]["restored"] == ["alpha", "beta"] and port[4] == len(journal.export_ring()) - 1


def test_changed_membership_quarantines_orphans():
    def run(p):
        multi = make_multi(p, ["alpha", "beta"])
        multi.run(2)
        payload = p.checkpoint.multi_session_to_dict(multi)
        target = make_multi(p, ["beta", "gamma"])
        report = p.checkpoint.restore_multi_session(payload, target)
        target.run(1)
        return (report, sorted(payload["unclaimed"]), payload["unclaimed"]["alpha"]["cycles"],
                "session" in payload["unclaimed"]["alpha"], target.get("beta").cycles,
                target.claim_fingerprint("beta"))

    ref, port = _run_both(run)
    assert port == ref
    assert port[0] == {"restored": ["beta"], "unclaimed": ["alpha"], "fresh": ["gamma"]}
    assert port[2:5] == (2, True, 3)


def test_unclaimed_survives_later_snapshots_and_is_reclaimable(tmp_path):
    def run(p):
        d = tmp_path / ("ref" if p is REF else "port")
        d.mkdir()
        multi = make_multi(p, ["alpha", "beta"])
        multi.run(2)
        p.recovery.RecoveryManager(multi, out_dir=str(d)).snapshot()
        survivor = make_multi(p, ["beta"])
        manager = p.recovery.RecoveryManager(survivor, out_dir=str(d))
        report = manager.recover()
        survivor.run(1)
        manager.snapshot()
        payload = p.checkpoint.load_snapshot(manager.snapshot_path)
        kept = "alpha" in payload["unclaimed"]
        reborn = make_multi(p, ["alpha", "beta"])
        report2 = p.checkpoint.restore_multi_session(payload, reborn)
        return (report["membership"], kept, report2,
                reborn.get("alpha").cycles, manager.status()["snapshots_this_process"])

    ref, port = _run_both(run)
    assert port == ref
    assert port[0]["unclaimed"] == ["alpha"] and port[1]
    assert port[2]["unclaimed"] == [] and "alpha" in port[2]["restored"] and port[3] == 2


def test_fingerprint_discontinuity_refuses_recovery(tmp_path):
    for p in (REF, PORT):
        d = tmp_path / ("ref" if p is REF else "port")
        d.mkdir()
        journal = p.events.EventJournal(registry=p.metrics.MetricsRegistry())
        multi = make_multi(p, ["alpha", "beta"], journal=journal)
        multi.run(1)
        manager = p.recovery.RecoveryManager(multi, out_dir=str(d))
        manager.snapshot()
        payload = p.checkpoint.load_snapshot(manager.snapshot_path)
        payload["journal"]["events"][0]["data"]["n_comments"] = 999
        p.checkpoint.save_snapshot(manager.snapshot_path, payload)
        fresh = make_multi(p, ["alpha", "beta"])
        with pytest.raises(p.recovery.RecoveryError, match="fingerprint"):
            p.recovery.RecoveryManager(fresh, out_dir=str(d)).recover()


def test_round_trip_preserves_predictions_toggles_and_cursors(tmp_path):
    def run(p):
        multi = make_multi(p, ["alpha"])
        multi.run(2)
        session = multi.get("alpha").session
        session.auto_fetch, session.auto_commit, session.auto_resume = True, False, True
        session.state_version += 3
        path = str(tmp_path / f"snap-{id(p)}.json")
        p.checkpoint.save_snapshot(path, p.checkpoint.multi_session_to_dict(multi))
        fresh = make_multi(p, ["alpha"])
        p.checkpoint.restore_multi_session(p.checkpoint.load_snapshot(path), fresh)
        rs = fresh.get("alpha").session
        np.testing.assert_array_equal(np.asarray(rs.predictions), np.asarray(session.predictions))
        rs.fetch()
        return (rs.auto_fetch, rs.auto_commit, rs.auto_resume,
                rs.state_version >= session.state_version, rs.last_lineage,
                [int(w) for w in np.asarray(rs._key_value).tolist()])

    ref, port = _run_both(run)
    assert port == ref and port[:4] == (True, False, True, True)
    assert port[4] == "blkt-alpha-000003"


def test_recovery_refusals(tmp_path, monkeypatch):
    """An unknown cache mode still raises.  The cache mode follows
    ``SVOC_COMPILATION_CACHE`` (the tests pin it off), else the committed
    ``"persistent"``, which points the kernel builds under the durability
    directory; ``recover(prewarm=True)`` honors the router's pinned
    warmup mode and otherwise walks the primary universe."""
    from svoc_torch.compile import cache
    from svoc_torch.ops import _build

    multi = make_multi(PORT, ["alpha"])
    with pytest.raises(ValueError, match="unknown compilation_cache"):
        recovery.RecoveryManager(multi, out_dir=str(tmp_path), compilation_cache="disk")
    off = recovery.RecoveryManager(multi, out_dir=str(tmp_path / "off"))
    assert off.compilation_cache == "off"
    assert off.status()["compile_cache"] == {"entries": 0.0, "bytes": 0.0}
    previous = _build.build_dir()
    try:
        monkeypatch.delenv("SVOC_COMPILATION_CACHE", raising=False)
        manager = recovery.RecoveryManager(multi, out_dir=str(tmp_path))
        status = manager.status()
        assert manager.compilation_cache == status["compilation_cache"] == "persistent"
        assert status["compile_cache_dir"].startswith(str(tmp_path / "kernel_cache"))
        assert multi.router.warmup_mode == "none"  # SVOC_WARMUP in the tests
        assert manager.recover(prewarm=True)["prewarm"] is None
        monkeypatch.delenv("SVOC_WARMUP", raising=False)
        warm = make_multi(PORT, ["alpha"])
        assert warm.router.warmup_mode == "prewarm"
        report = recovery.RecoveryManager(warm, out_dir=str(tmp_path / "warm")).recover(prewarm=True)
        assert report["prewarm"]["report"]["outcomes"] == {"primed": 1}  # bucket 1, the router's variant
    finally:
        cache.disable_persistent_cache()
        _build.set_build_dir(previous)


# ---------------------------------------------------------------------------
# Graceful drain under live serving load
# ---------------------------------------------------------------------------


def _tier(p, names):
    m = p.metrics.MetricsRegistry()
    j = p.events.EventJournal(registry=m)
    clock = p.serving_scenario.VirtualClock()
    multi = make_multi(p, names, journal=j, metrics_=m)
    multi._clock = clock
    t = p.tier.ServingTier(
        multi,
        vectorizer=deterministic_vectorizer,
        admission=p.frontend.AdmissionConfig(queue_capacity=32, seed=0),
        clock=clock,
        slos=p.slo.serving_slos(m),
    )
    return t, multi, m, j


def test_drain_sheds_and_accounts_every_admitted_request():
    def run(p):
        t, multi, m, j = _tier(p, ["alpha", "beta"])
        for i in range(6):
            t.submit("alpha", f"drain load a{i}")
            t.submit("beta", f"drain load b{i}")
        t.step()
        for i in range(4):
            t.submit("alpha", f"second wave {i}")
        t.submit("beta", "stuck request")
        multi.pause("beta")
        report = t.drain()
        shed = t.submit("alpha", "too late")
        return (report, shed, m.family_total("serving_admitted"),
                m.family_total("serving_completed"), m.family_total("serving_dropped"),
                [e.data["reason"] for e in j.recent(type="serving.deferred")],
                any(t.frontend.depths().values()), j.fingerprint())

    ref, port = _run_both(run)
    assert port == ref
    report, shed, admitted, completed, dropped, deferred, queued, _fp = port
    assert shed["status"] == "shed" and shed["reason"] == "draining"
    assert admitted == completed + dropped and report["deferred"] >= 1
    assert deferred and set(deferred) == {"draining"} and not queued


def test_drain_is_idempotent_and_journals(tmp_path):
    def run(p):
        t, multi, m, j = _tier(p, ["alpha"])
        d = tmp_path / ("ref" if p is REF else "port")
        d.mkdir()
        manager = p.recovery.RecoveryManager(multi, out_dir=str(d), tier=t)
        monitor = p.postmortem.PostmortemMonitor(out_dir=str(d), registry=m, journal=j)
        drainer = p.recovery.GracefulDrain(manager=manager, monitor=monitor, journal=j)
        report = drainer.drain(reason="test")
        drained = j.recent(type="durability.drain")[-1].data
        # The bundle's number comes from a process-wide counter: only its
        # name's stem compares across the packages.
        return ("flush" in report, os.path.basename(report["snapshot"]),
                os.path.basename(report["bundle"]).rsplit("-", 1)[0], drained["deferred"],
                drained["snapshot"], drainer.drain())

    ref, port = _run_both(run)
    assert port == ref
    assert port[0] and port[1] == "snapshot.json" and port[2] == "postmortem-shutdown"
    assert port[5] == {"already_drained": True}


def test_drain_signal_hooks_chain(tmp_path):
    t, multi, m, j = _tier(PORT, ["alpha"])
    drainer = recovery.GracefulDrain(tier=t, journal=j)
    calls = []
    prev = signal.signal(signal.SIGUSR1, lambda s, f: calls.append(s))
    try:
        drainer.install(signals=(signal.SIGUSR1,))
        os.kill(os.getpid(), signal.SIGUSR1)
        assert calls == [signal.SIGUSR1] and j.recent(type="durability.drain")
        assert j.recent(type="durability.drain")[-1].data["reason"] == f"signal_{signal.SIGUSR1}"
    finally:
        drainer.uninstall()
        signal.signal(signal.SIGUSR1, prev)


# ---------------------------------------------------------------------------
# Shutdown bundles
# ---------------------------------------------------------------------------


def test_shutdown_bundle_classified_and_rate_limit_exempt(tmp_path):
    def run(p):
        reg = p.metrics.MetricsRegistry()
        j = p.events.EventJournal(registry=reg)
        monitor = p.postmortem.PostmortemMonitor(
            out_dir=str(tmp_path / str(id(p))), registry=reg, journal=j, min_interval_s=60.0,
        ).install()
        os.makedirs(monitor.out_dir, exist_ok=True)
        j.emit("crash", where="test")
        j.emit("crash", where="again")  # rate-limited: suppressed, latched once
        path = monitor.shutdown("sigterm")
        bundle = json.load(open(path))
        return (len(monitor.bundles), bundle["trigger"], bundle["trigger_event"],
                sorted(k for k in bundle if k != "built_at"), monitor.shutdown("atexit"),
                reg.counter("postmortem_bundles", labels={"trigger": "shutdown"}).count,
                reg.counter("postmortem_suppressed", labels={"reason": "rate_limit"}).count,
                [e.type for e in j.recent(10)])

    ref, port = _run_both(run)
    assert port == ref
    assert port[:3] == (2, "shutdown", {"reason": "sigterm"}) and port[4] is None
    assert set(postmortem.BUNDLE_KEYS) - {"built_at"} <= set(port[3]) and port[5:7] == (1, 1)


@pytest.mark.parametrize("previous", ["handler", "ignored"])
def test_signal_chain_keeps_previous_disposition(tmp_path, previous):
    monitor = postmortem.PostmortemMonitor(
        out_dir=str(tmp_path), registry=metrics.MetricsRegistry(),
        journal=events.EventJournal(registry=metrics.MetricsRegistry()),
    )
    calls = []
    sig = signal.SIGUSR1 if previous == "handler" else signal.SIGUSR2
    prev = signal.signal(sig, (lambda s, f: calls.append(s)) if previous == "handler"
                         else signal.SIG_IGN)
    try:
        monitor.install_shutdown_hooks(signals=(sig,))
        os.kill(os.getpid(), sig)  # an ignored signal must not kill the process
        assert monitor.bundles
        assert calls == ([sig] if previous == "handler" else [])
    finally:
        monitor.uninstall_shutdown_hooks()
        assert signal.getsignal(sig) is not monitor._signal_chain._on_signal
        signal.signal(sig, prev)


def test_monitor_classifies_incidents():
    monitor = postmortem.PostmortemMonitor(out_dir=".", journal=events.EventJournal())
    ref_monitor = ref_postmortem.PostmortemMonitor(out_dir=".", journal=ref_events.EventJournal())
    cases = [("breaker.transition", {"to": "open"}), ("breaker.transition", {"to": "closed"}),
             ("quarantine.verdict", {"total": 7, "admitted": 3}),
             ("quarantine.verdict", {"total": 7, "admitted": 6}),
             ("consensus.result", {"interval_valid": False}),
             ("pipeline.producer_error", {}), ("crash", {}), ("commit.sent", {})]
    got = [monitor.classify(events.EventRecord(1, 0.0, t, None, d)) for t, d in cases]
    want = [ref_monitor.classify(ref_events.EventRecord(1, 0.0, t, None, d)) for t, d in cases]
    assert got == want == ["breaker_open", None, "quarantine_spike", None, "interval_invalid",
                           "producer_error", "crash", None]
