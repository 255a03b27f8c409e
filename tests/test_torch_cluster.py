"""The port's multi-replica fleet (``svoc_torch.cluster``) against the JAX
package's, on the CPU: twins of ``tests/test_cluster.py``, each holding
the port to the reference in the same test.

- Placement: owners, epochs and fingerprints equal the reference's over
  a few hundred claim and roster sets; the explicit table, persistence
  and error paths behave alike.
- The five cluster fault points are declared with the reference's specs.
- The router's typed degraded paths (stale-epoch redirect, down-replica
  shed, the unknown-claim caller error, the breaker opening under
  injected forwarding faults, the orphan quarantine) give the same
  responses, counters and journal fingerprints.
- A migration round trip keeps the lineage cursor, as the reference's.
- ``ship_claim``'s PRNG burn after 1-3 skipped cycles is bit for bit
  ``jax.random.split``; a failover whose recovered snapshot is older
  than the chain (so it burns) keeps zero duplicate txs and the
  reference's fingerprints.
- Seeded failover scenarios (the corpus entry, read as it is, and
  ``run_cluster_scenario`` at seeds 0 and 1) give the reference's
  per-claim and fleet fingerprints, byte for byte.

The reference's ``test_corpus_entry_invisible_to_durable_fuzzer`` has
its twin in ``tests/test_torch_reconfig_smoke.py``, beside the port's
``load_corpus``.
"""

import json
import os
import types

import numpy as np
import pytest

pytest.importorskip("jax")

import jax

import svoc_tpu.cluster as ref_cluster
import svoc_tpu.cluster.scenario as ref_scenario
import svoc_tpu.durability.faultspace as ref_faultspace
import svoc_tpu.fabric.registry as ref_registry
import svoc_tpu.resilience.retry as ref_retry
import svoc_tpu.serving.scenario as ref_serving
import svoc_tpu.utils.events as ref_events
import svoc_tpu.utils.metrics as ref_metrics

import svoc_torch.cluster as cluster
import svoc_torch.cluster.replica as replica_mod
import svoc_torch.cluster.scenario as scenario
import svoc_torch.durability.faultspace as faultspace
import svoc_torch.fabric.registry as registry
import svoc_torch.resilience.retry as retry
import svoc_torch.serving.scenario as serving
import svoc_torch.utils.events as events
import svoc_torch.utils.metrics as metrics_mod

REF = types.SimpleNamespace(cluster=ref_cluster, scenario=ref_scenario, faultspace=ref_faultspace,
                            registry=ref_registry, retry=ref_retry, serving=ref_serving,
                            events=ref_events, metrics=ref_metrics, kw={})
PORT = types.SimpleNamespace(cluster=cluster, scenario=scenario, faultspace=faultspace,
                             registry=registry, retry=retry, serving=serving,
                             events=events, metrics=metrics_mod, kw={"device": "cpu"})
CORPUS = os.path.join(os.path.dirname(__file__), "fixtures", "chaos_corpus", "cluster",
                      "kill-failover-fleet.json")
CLUSTER_POINTS = (
    "cluster.forward.pre_send",
    "cluster.migrate.pre_drain",
    "cluster.migrate.post_ship",
    "cluster.migrate.pre_adopt",
    "replica.kill",
)


def both(tmp_path, fn):
    """``fn(package, directory)`` for the reference and the port."""
    return (fn(REF, tmp_path / "ref"), fn(PORT, tmp_path / "port"))


def fingerprints(result):
    return result["fleet_fingerprint"], {c: v["fingerprint"] for c, v in result["claims"].items()}


# ---------------------------------------------------------------------------
# placement directory
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_replicas", [1, 2, 3, 5, 8])
def test_placement_owners_epochs_and_fingerprint_equal_reference(tmp_path, n_replicas):
    rng = np.random.default_rng(n_replicas)
    for trial in range(60):
        roster = [f"r{int(i)}" for i in rng.choice(20, size=n_replicas, replace=False)]
        claims = [f"claim-{int(i)}" for i in rng.integers(0, 10_000, size=8)]
        ref = REF.cluster.PlacementDirectory(roster)
        port = PORT.cluster.PlacementDirectory(list(reversed(roster)))
        assert [port.owner(c) for c in claims] == [ref.owner(c) for c in claims]
        pin = roster[int(rng.integers(0, n_replicas))]
        assert port.assign(claims[0], pin) == ref.assign(claims[0], pin)
        assert port.add_replica("rNEW") == ref.add_replica("rNEW")
        assert port.remove_replica(roster[0]) == ref.remove_replica(roster[0])
        assert [port.owner(c) for c in claims] == [ref.owner(c) for c in claims]
        assert port.epoch == ref.epoch
        assert port.fingerprint() == ref.fingerprint()
        assert port.snapshot() == ref.snapshot()


def test_placement_epoch_monotone_and_explicit_wins(tmp_path):
    def run(p, d):
        d.mkdir()
        directory = p.cluster.PlacementDirectory(["r0", "r1"], path=str(d / "placement.json"))
        epochs = [directory.epoch]
        target = "r0" if directory.owner("c0") != "r0" else "r1"
        epochs.append(directory.assign("c0", target))
        owner = directory.owner("c0")
        epochs.append(directory.add_replica("r2"))
        epochs.append(directory.remove_replica(target))
        return (epochs, owner == target, directory.owner("c0") in directory.replicas(),
                "c0" in directory.assignments(), (d / "placement.json").read_bytes())

    ref, port = both(tmp_path, run)
    assert port == ref
    epochs, pinned, fell_back, kept, _ = port
    assert epochs == [0, 1, 2, 3] and pinned and fell_back and not kept


def test_placement_persist_roundtrip(tmp_path):
    def run(p, d):
        d.mkdir()
        path = str(d / "placement.json")
        directory = p.cluster.PlacementDirectory(["r0", "r1", "r2"], path=path)
        directory.assign("c3", "r1")
        loaded = p.cluster.PlacementDirectory.load(path)
        assert loaded.epoch == directory.epoch and loaded.owner("c3") == "r1"
        return loaded.fingerprint(), [loaded.owner(f"c{i}") for i in range(8)], open(path).read()

    ref, port = both(tmp_path, run)
    assert port == ref


def test_placement_error_paths():
    for p in (REF, PORT):
        with pytest.raises(p.cluster.PlacementError):
            p.cluster.PlacementDirectory([]).owner("c0")
        with pytest.raises(p.cluster.PlacementError):
            p.cluster.PlacementDirectory(["r0"]).assign("c0", "rZ")
        with pytest.raises(p.cluster.PlacementError):
            p.cluster.PlacementDirectory(["r0"], explicit={"c0": "rZ"})
        with pytest.raises(KeyError):  # PlacementError is a KeyError, as in the reference
            p.cluster.PlacementDirectory(["r0"]).remove_replica("rZ")


def test_cluster_fault_points_declared_with_the_reference_specs():
    port, ref = faultspace.load_surface(), ref_faultspace.surface()
    for point in CLUSTER_POINTS:
        spec, r = port[point], ref[point]
        assert spec.smokes == (faultspace.SMOKE_CLUSTER,) == r.smokes
        assert spec.owner == r.owner.replace("svoc_tpu/", "svoc_torch/")
        assert (spec.invariant, spec.actions, spec.modes, spec.stage) == (
            r.invariant, r.actions, r.modes, r.stage)
    reconfig = sorted(n for n in port if n.startswith("reconfig."))
    assert reconfig == sorted(n for n in ref if n.startswith("reconfig.")) and len(reconfig) == 5
    for point in reconfig:
        spec, r = port[point], ref[point]
        assert spec.smokes == (faultspace.SMOKE_RECONFIG,) and r.smokes == (ref_faultspace.SMOKE_RECONFIG,)
        assert spec.owner == r.owner.replace("svoc_tpu/", "svoc_torch/") == "svoc_torch/cluster/reconfig.py"
        assert (spec.invariant, spec.actions, spec.modes, spec.stage) == (
            r.invariant, r.actions, r.modes, r.stage)
    assert set(faultspace.SURFACE_MODULES) >= {"svoc_torch.cluster.router",
                                                "svoc_torch.cluster.scenario"}


# ---------------------------------------------------------------------------
# router: typed degraded paths
# ---------------------------------------------------------------------------


def build_fleet(p, d, *, n_replicas=2, claims=("c0",), seed=0, epochs_path=None):
    d.mkdir(exist_ok=True)
    metrics = p.metrics.MetricsRegistry()
    journal = p.events.EventJournal(registry=metrics)
    chain_dir = str(d / "chain")
    placement = p.cluster.PlacementDirectory([], path=str(d / "placement.json"))

    def replica_factory(rid):
        return p.cluster.Replica(rid, str(d / f"replica-{rid}"), chain_dir=chain_dir, seed=seed,
                                 clock=p.serving.VirtualClock(), lineage_scope="clu", **p.kw)

    router = p.cluster.ClusterRouter(
        placement, journal=journal, metrics=metrics, clock=p.serving.VirtualClock(),
        retry=p.retry.RetryPolicy(max_attempts=2, base_s=0.0, cap_s=0.0, jitter_seed=0),
        replica_factory=replica_factory, lineage_scope="clu",
        unclaimed_path=str(d / "unclaimed.json"), epochs_path=epochs_path,
    )
    for i in range(n_replicas):
        router.add_replica(replica_factory(f"r{i}"))
    for cid in claims:
        router.add_claim(p.registry.ClaimSpec(claim_id=cid, n_oracles=7, dimension=6))
    return router, placement, metrics, journal


def test_stale_epoch_submit_redirects(tmp_path):
    def run(p, d):
        router, placement, metrics, journal = build_fleet(p, d)
        response = router.submit("c0", "text", epoch=placement.epoch - 1)
        forwarded = router.submit("c0", "text", epoch=placement.epoch)
        return response, forwarded["status"], metrics.family_total("cluster_redirects"), journal.fingerprint()

    ref, port = both(tmp_path, run)
    assert port == ref
    response, status, redirects, _ = port
    assert response["status"] == "redirect" and response["reason"] == "stale_epoch"
    assert status != "redirect" and redirects == 1.0


def test_down_replica_submit_sheds_typed(tmp_path):
    def run(p, d):
        router, placement, metrics, journal = build_fleet(p, d)
        owner = placement.owner("c0")
        router.replica(owner).kill()
        with pytest.raises(p.cluster.ReplicaDeadError):
            router.replica(owner).step()
        return (router.submit("c0", "text"), owner, metrics.family_total("cluster_unavailable"),
                journal.fingerprint())

    ref, port = both(tmp_path, run)
    assert port == ref
    response, owner, sheds, _ = port
    assert (response["status"], response["reason"], response["replica"], sheds) == (
        "unavailable", "replica_down", owner, 1.0)


def test_unknown_claim_is_a_caller_error_not_a_shed(tmp_path):
    def run(p, d):
        router, _, metrics, _ = build_fleet(p, d)
        with pytest.raises(KeyError):
            router.submit("nope", "text")
        return metrics.family_total("cluster_unavailable")

    assert both(tmp_path, run) == (0.0, 0.0)


def test_forward_faults_open_the_breaker(tmp_path):
    def run(p, d):
        router, _, metrics, journal = build_fleet(p, d)
        controller = p.faultspace.arm(p.faultspace.FaultController(
            [p.faultspace.FaultEvent(point="cluster.forward.pre_send", nth=n, action="error")
             for n in range(1, 7)]))
        try:
            statuses = [router.submit("c0", "text") for _ in range(4)]
        finally:
            p.faultspace.disarm()
        return ([(s["status"], s["reason"]) for s in statuses], controller.counts(),
                metrics.family_total("cluster_unavailable"), journal.fingerprint())

    ref, port = both(tmp_path, run)
    assert port == ref
    statuses, counts, sheds, _ = port
    assert statuses == [("unavailable", "forward_error")] * 3 + [("unavailable", "breaker_open")]
    assert counts["cluster.forward.pre_send"] >= 6 and sheds == 4.0
    assert not faultspace.armed()


def test_orphan_quarantine_on_missing_target(tmp_path):
    def run(p, d):
        router, _, _, journal = build_fleet(p, d)
        report = router.migrate("c0", "rZ", reason="test")
        with open(str(d / "unclaimed.json")) as f:
            unclaimed = json.load(f)
        live = [rid for rid in router.replica_ids() if router.replica(rid).has_claim("c0")]
        entry = unclaimed["c0"]
        kept = (entry["spec"], entry["cycles"], entry["paused"], entry["session"]["fetch_claim"],
                entry["session"]["prng_key"], entry["session"]["last_lineage"])
        return report, live, kept, journal.fingerprint()

    ref, port = both(tmp_path, run)
    assert port == ref
    report, live, _, _ = port
    assert report["status"] == "quarantined" and report["reason"] == "missing_target"
    assert "c0" in report["unclaimed"] and not live


def test_migrate_roundtrip_preserves_lineage_cursor(tmp_path):
    def run(p, d):
        router, placement, _, journal = build_fleet(p, d)
        source = placement.owner("c0")
        target = next(r for r in router.replica_ids() if r != source)
        admitted = [router.submit("c0", f"comment {i}")["status"] for i in range(3)]
        router.step_all()
        before = replica_mod.lineage_cursor(router.replica(source).multi.get("c0").session)
        report = router.migrate("c0", target, reason="test")
        after_status = router.submit("c0", "after migration")["status"]
        router.step_all()
        after = replica_mod.lineage_cursor(router.replica(target).multi.get("c0").session)
        return (admitted, before, report, placement.owner("c0"), router.replica(target).has_claim("c0"),
                router.replica(source).has_claim("c0"), after_status, after,
                router.claim_fingerprint("c0"), router.fleet_fingerprint(), journal.fingerprint())

    ref, port = both(tmp_path, run)
    assert port == ref
    admitted, before, report, owner, on_target, on_source, status, after = port[:8]
    assert admitted == ["admitted"] * 3 and before >= 1
    assert report["status"] == "migrated" and report["continuity"] is True
    assert report["cursor"] >= before and owner == report["target"]
    assert on_target and not on_source and status == "admitted" and after > report["cursor"]


def test_console_hooks_wait_for_the_console(tmp_path):
    """``attach`` wires the router and its fleet plane into the console
    (``console.cluster``, ``console.fleetplane``); the router's
    ``/api/state`` view equals the reference's but for the pinned route,
    ``mesh`` and ``fingerprint_epoch`` included."""
    def run(p, d):
        router, placement, _, _ = build_fleet(p, d)
        snap = router.snapshot()
        for row in snap["replicas"].values():
            row["config"].pop("consensus_impl")
        return snap

    ref, port = both(tmp_path, run)
    assert port == ref
    router = build_fleet(PORT, tmp_path / "attach")[0]
    console = types.SimpleNamespace()
    router.attach(console)
    router.fleet_plane.attach(console)
    assert console.cluster is router and console.fleetplane is router.fleet_plane


def test_grow_retire_and_orphans_equal_reference(tmp_path):
    """The router's roster paths: ``grow`` moves exactly the claims whose
    rendezvous owner becomes the newcomer, ``retire_replica`` drains a
    live replica onto the survivors, and ``adopt_orphans`` brings a
    quarantined slice back with continuity — each as the reference."""
    def run(p, d):
        claims = tuple(f"c{i}" for i in range(6))
        router, placement, metrics, journal = build_fleet(p, d, claims=claims)
        for i, cid in enumerate(claims):
            router.submit(cid, f"comment {i}")
        router.step_all()
        grown = router.grow(p.cluster.Replica("r2", str(d / "replica-r2"), chain_dir=str(d / "chain"),
                                              seed=0, clock=p.serving.VirtualClock(), lineage_scope="clu",
                                              **p.kw))
        quarantined = router.migrate("c0", "rZ", reason="test")
        orphans = router.adopt_orphans()
        again = router.adopt_orphans()
        retired = router.retire_replica("r0")
        for i, cid in enumerate(claims):
            router.submit(cid, f"after {i}")
        router.step_all()
        return (grown, quarantined, orphans, again, retired, router.snapshot()["claims"], placement.epoch,
                {c: router.claim_fingerprint(c) for c in claims}, router.fleet_fingerprint(),
                journal.fingerprint(), metrics.family_total("cluster_migrations"))

    ref, port = both(tmp_path, run)
    assert port == ref
    grown, quarantined, orphans, again, retired, owners = port[:6]
    assert grown["status"] == "grown" and quarantined["status"] == "quarantined"
    assert orphans["adopted"]["c0"]["continuity"] is True and again == {"adopted": {}, "remaining": {}}
    assert retired["status"] == "retired" and "r0" not in owners.values()


def test_holds_defer_and_release_in_order(tmp_path):
    def run(p, d):
        router, placement, metrics, journal = build_fleet(p, d, claims=("c0", "c1"))
        owner = placement.owner("c0")
        router.hold_replica(owner)
        held = [router.submit(cid, f"held {cid}") for cid in ("c0", "c1")]
        holding, deferred = router.holding(), router.deferred_count()
        released = router.release_holds()
        return (held, holding, deferred, released, router.deferred_count(),
                metrics.family_total("reconfig_deferred"), journal.fingerprint())

    ref, port = both(tmp_path, run)
    assert port == ref
    held, holding, deferred, released = port[:4]
    assert held[0]["status"] == "deferred" and holding and deferred >= 1
    assert all(r["status"] == "admitted" for r in released)


def test_epoch_chain_folds_into_the_fleet_fingerprint(tmp_path):
    """A committed reconfiguration's entry changes the fleet fingerprint,
    persists atomically, and a router built over the file resumes it."""
    def run(p, d):
        router, _, _, _ = build_fleet(p, d, epochs_path=str(d / "epochs.json"))
        empty = router.fleet_fingerprint()
        epoch = router.record_epoch({"plan": "p0", "pre": empty})
        resumed = p.cluster.ClusterRouter(p.cluster.PlacementDirectory(["r0"]),
                                          epochs_path=str(d / "epochs.json"))
        return (empty, epoch, router.fleet_fingerprint(), router.epoch_chain(), resumed.epoch_chain(),
                resumed.reconfig_epoch, (d / "epochs.json").read_text())

    ref, port = both(tmp_path, run)
    assert port == ref
    empty, epoch, after, chain, resumed, resumed_epoch, _ = port
    assert empty != after and epoch == resumed_epoch == 1 and chain == resumed


# ---------------------------------------------------------------------------
# the PRNG burn at ship time
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("skipped", [1, 2, 3])
def test_ship_claim_burns_splits_as_jax_random(tmp_path, skipped, monkeypatch):
    router, placement, _, _ = build_fleet(PORT, tmp_path)
    owner = router.replica(placement.owner("c0"))
    for i in range(12):
        router.submit("c0", f"warm {i}")
    router.step_all()
    session = owner.multi.get("c0").session
    cursor = replica_mod.lineage_cursor(session)
    key = [int(w) for w in session._key_value.tolist()]
    prefix = "blkclu-c0-"
    done = [{"kind": "done", "lineage": f"{prefix}{cursor + skipped}"},
            {"kind": "done", "lineage": f"{prefix}{cursor + skipped + 1}", "failed": "x"}]
    records = owner.wal.records
    monkeypatch.setattr(owner.wal, "records", lambda: records() + done)
    entry = owner.ship_claim("c0")
    expected = jax.numpy.asarray(np.asarray(key, dtype=np.uint32))
    for _ in range(skipped):
        expected, _ = jax.random.split(expected)
    assert entry["session"]["fetch_claim"] == cursor + skipped  # the failed close does not advance
    assert entry["session"]["prng_key"] == np.asarray(expected).tolist()
    assert all(isinstance(w, int) for w in entry["session"]["prng_key"])


def run_both_scenarios(tmp_path, **kw):
    ref = ref_scenario.run_cluster_scenario(str(tmp_path / "ref"), **kw)
    port = scenario.run_cluster_scenario(str(tmp_path / "port"), device="cpu", **kw)
    return ref, port


@pytest.mark.parametrize("kill_at_step,snapshot_every", [(3, 2), (5, 3)])
def test_failover_that_burns_skipped_cycles(tmp_path, monkeypatch, kill_at_step, snapshot_every):
    """A kill between two snapshots: the recovered sessions are older than
    the chain, so every failed-over claim's shipped cursor is fast-
    forwarded and its key burned; no adopter re-draws a landed payload."""
    shipped = []
    ship = replica_mod.Replica.ship_claim

    def recording(self, claim_id):
        before = replica_mod.lineage_cursor(self.multi.get(claim_id).session)
        entry = ship(self, claim_id)
        shipped.append(entry["session"]["fetch_claim"] - before)
        return entry

    monkeypatch.setattr(replica_mod.Replica, "ship_claim", recording)
    ref, port = run_both_scenarios(
        tmp_path, seed=0, n_replicas=3, n_claims=4, total_steps=kill_at_step + 3,
        arrivals_per_step=6, snapshot_every=snapshot_every, kill_replica="r1",
        kill_at_step=kill_at_step)
    assert port["failover"]["claims"] and max(shipped) >= 1
    assert port["duplicate_txs"] == ref["duplicate_txs"] == 0
    assert port["requests"]["unaccounted"] == 0.0
    assert fingerprints(port) == fingerprints(ref)


# ---------------------------------------------------------------------------
# seeded failover scenarios
# ---------------------------------------------------------------------------


def load_corpus_entry():
    with open(CORPUS) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def failover_runs(tmp_path_factory):
    entry = load_corpus_entry()
    plan = entry["plan"]
    kw = dict(seed=entry["seed"], n_replicas=plan["n_replicas"], n_claims=plan["n_claims"],
              total_steps=plan["total_steps"], arrivals_per_step=plan["arrivals_per_step"],
              kill_replica=plan["kill"]["replica"], kill_at_step=plan["kill"]["at_step"],
              fail_over_at_step=plan["kill"]["fail_over_at"])
    runs = [scenario.run_cluster_scenario(str(tmp_path_factory.mktemp(f"fleet-{tag}")), device="cpu", **kw)
            for tag in ("a", "b")]
    ref = ref_scenario.run_cluster_scenario(str(tmp_path_factory.mktemp("fleet-ref")), **kw)
    return runs, ref


def test_failover_replay_identity(failover_runs):
    (first, second), ref = failover_runs
    assert fingerprints(first) == fingerprints(second) == fingerprints(ref)


def test_failover_exactly_once_and_accounted(failover_runs):
    (first, _), ref = failover_runs
    assert first["duplicate_txs"] == 0
    assert first["requests"]["unaccounted"] == 0.0
    moved = first["failover"]["claims"]
    assert moved, "the killed replica owned no claims — bad fixture"
    for report in moved.values():
        assert report["status"] == "migrated" and report["continuity"] is True
    for cid in moved:
        assert first["claims"][cid]["owner"] != "r1"
        assert first["chain"][cid]["predictions"] > 0
    for point in CLUSTER_POINTS[1:]:
        assert first["fault_points_fired"].get(point, 0) > 0, point
    for key in ("chain", "epoch", "cluster_counters", "fault_points_fired", "journal_events"):
        assert first[key] == ref[key], key
    assert {k: v for k, v in first["requests"].items() if k != "observations"} == {
        k: v for k, v in ref["requests"].items() if k != "observations"}


def test_cluster_corpus_entry_replays_pinned(tmp_path, failover_runs):
    entry = load_corpus_entry()
    (first, _), ref = failover_runs
    result = scenario.replay_corpus_entry(entry, str(tmp_path / "corpus"), device="cpu")
    assert result["duplicate_txs"] == 0 and result["requests"]["unaccounted"] == 0.0
    ref_result = ref_scenario.replay_corpus_entry(entry, str(tmp_path / "corpus-ref"))
    assert fingerprints(result) == fingerprints(ref_result) == fingerprints(first) == fingerprints(ref)
    with pytest.raises(ValueError, match="not a cluster corpus entry"):
        scenario.replay_corpus_entry({"format": "other"}, str(tmp_path / "x"), device="cpu")


@pytest.mark.parametrize("seed", [0, 1])
def test_scenario_fingerprints_equal_reference(tmp_path, seed):
    ref, port = run_both_scenarios(
        tmp_path, seed=seed, n_replicas=3, n_claims=4, total_steps=7, arrivals_per_step=6,
        kill_replica="r1", kill_at_step=2, migrate_at_step=5)
    assert fingerprints(port) == fingerprints(ref)
    assert port["duplicate_txs"] == 0 and port["requests"]["unaccounted"] == 0.0
    assert port["migration"]["status"] == "migrated" and port["migration"] == ref["migration"]
    assert port["placement"] == ref["placement"] and port["probes"] == ref["probes"]

