"""The port's live reconfiguration plane (``svoc_torch.cluster.reconfig``)
against the JAX package's, on the CPU: twins of ``tests/test_reconfig.py``,
each holding the port to the reference in the same test.

- Plans: ``to_dict``, ``fingerprint``, ``needs_repin``, ``is_noop`` and the
  ``from_dict`` round trip equal the reference's; the same bad knobs
  raise; the two plans the port cannot carry out (a ``consensus_impl``,
  a claim mesh) are refused before any phase starts.
- The plumbing the plane calls: ``Replica(mesh=, fingerprint_epoch=)``
  with its ``-e<N>`` names and ``pinned_config``,
  ``Replica.adopt_claim_fresh`` and ``ClusterRouter.replace_replica``.
- A commit under a new epoch, every abort point, the operator abort, the
  noop, growth with its bounded rebalance and the orphan adoption give
  the reference's reports, per-claim and fleet fingerprints and epoch
  chain; an abort also leaves every file of the fleet byte-identical.
- Aborts under traffic release the deferred requests into the old
  stacks as the reference's do; a fault at ``post_ship`` or ``pre_repin``
  on a replica that owns claims rolls its shipped slices back, where the
  reference loses them (the port's one departure in the rollback).
- The outcome grid: the reference generator's 7 non-noop plans (commit
  mode x re-spec x growth) at ``reconfig.prepare``, ``reconfig.post_drain``
  and ``reconfig.pre_resume``.  Each (plan, point) pair gives the
  reference's report status; where it is ``aborted`` the fleet
  fingerprint is unchanged.  A growth-only plan never re-pins, so it
  never reaches the per-replica gates (``post_drain``, ``post_ship``,
  ``pre_repin``) and commits there, in both packages: this is why the
  reference's hypothesis property ``test_property_abort_is_invisible``,
  which expects ``aborted`` for every drawn pair, fails on such a draw
  while both controllers behave alike.
"""

import json
import os
import types

import pytest

pytest.importorskip("jax")

import jax  # noqa: F401

import svoc_tpu.cluster as ref_cluster
import svoc_tpu.durability.faultspace as ref_faultspace
import svoc_tpu.fabric.registry as ref_registry
import svoc_tpu.resilience.retry as ref_retry
import svoc_tpu.serving.scenario as ref_serving
import svoc_tpu.utils.checkpoint as ref_checkpoint
import svoc_tpu.utils.events as ref_events
import svoc_tpu.utils.metrics as ref_metrics

import svoc_torch.cluster as cluster
import svoc_torch.durability.faultspace as faultspace
import svoc_torch.fabric.registry as registry
import svoc_torch.resilience.retry as retry
import svoc_torch.serving.scenario as serving
import svoc_torch.utils.checkpoint as checkpoint
import svoc_torch.utils.events as events
import svoc_torch.utils.metrics as metrics_mod

REF = types.SimpleNamespace(cluster=ref_cluster, faultspace=ref_faultspace, registry=ref_registry,
                            retry=ref_retry, serving=ref_serving, checkpoint=ref_checkpoint,
                            events=ref_events, metrics=ref_metrics, kw={})
PORT = types.SimpleNamespace(cluster=cluster, faultspace=faultspace, registry=registry, retry=retry,
                             serving=serving, checkpoint=checkpoint, events=events,
                             metrics=metrics_mod, kw={"device": "cpu"})

RECONFIG_POINTS = (
    "reconfig.prepare",
    "reconfig.post_drain",
    "reconfig.post_ship",
    "reconfig.pre_repin",
    "reconfig.pre_resume",
)


def both(tmp_path, fn):
    """``fn(package, directory)`` for the reference and the port."""
    return (fn(REF, tmp_path / "ref"), fn(PORT, tmp_path / "port"))


def build_fleet(p, d, *, n_replicas=2, claims=("c0", "c1"), seed=0):
    """The reference test's unit fleet (``test_reconfig.py:88-151``) in
    package ``p``: a few served cycles, so re-pin carries real cursors."""
    d.mkdir(exist_ok=True)
    metrics = p.metrics.MetricsRegistry()
    journal = p.events.EventJournal(registry=metrics)
    chain_dir = str(d / "chain")
    placement = p.cluster.PlacementDirectory([], path=str(d / "placement.json"))
    master_clock = p.serving.VirtualClock()

    def builder(rid, *, fingerprint_epoch=0, consensus_impl=None, mesh=None, commit_mode="per_tx"):
        return p.cluster.Replica(
            rid, str(d / f"replica-{rid}"), chain_dir=chain_dir, seed=seed,
            clock=p.serving.VirtualClock(), lineage_scope="clu", commit_mode=commit_mode,
            consensus_impl=consensus_impl, mesh=mesh, fingerprint_epoch=fingerprint_epoch,
            max_requests_per_step=64, **p.kw)

    router = p.cluster.ClusterRouter(
        placement, journal=journal, metrics=metrics, clock=master_clock,
        retry=p.retry.RetryPolicy(max_attempts=2, base_s=0.0, cap_s=0.0, jitter_seed=0),
        replica_factory=builder, lineage_scope="clu",
        unclaimed_path=str(d / "unclaimed.json"), epochs_path=str(d / "epochs.json"))
    controller = p.cluster.ReconfigController(router, builder=builder, journal=journal, metrics=metrics,
                                              clock=master_clock, prewarm_budget_s=0.5)
    for i in range(n_replicas):
        router.add_replica(builder(f"r{i}"))
    for cid in claims:
        router.add_claim(p.registry.ClaimSpec(claim_id=cid, n_oracles=7, dimension=6))
    for step in range(2):
        for cid in claims:
            router.submit(cid, f"comment {cid} step {step}")
        router.step_all()
    return router, placement, controller, metrics


def fingerprints(router):
    return router.fleet_fingerprint(), {c: router.claim_fingerprint(c) for c in router.claim_ids()}


def apply_armed(p, controller, plan, point):
    """``controller.apply(plan)`` with an ``error`` armed at ``point``."""
    p.faultspace.arm(p.faultspace.FaultController([p.faultspace.FaultEvent(point=point, nth=1, action="error")]))
    try:
        return controller.apply(plan)
    finally:
        p.faultspace.disarm()


def tree_bytes(root):
    """Every file under ``root`` with its bytes."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------


def plan_kwargs(p):
    spec = p.registry.ClaimSpec(claim_id="c0", n_oracles=9, dimension=6)
    return [
        {},
        {"commit_mode": "batched"},
        {"commit_mode": "per_tx", "mesh": "off"},
        {"mesh": "2x4"},
        {"consensus_impl": "pallas"},
        {"claims": {"c0": spec}},
        {"add_replicas": ("r9",)},
        {"remove_replicas": ("r0",), "add_replicas": ["r5", "r4"]},
        {"commit_mode": "batched", "claims": {"c0": spec}, "add_replicas": ("rG",)},
    ]


@pytest.mark.parametrize("index", range(9))
def test_plan_dict_and_fingerprint_equal_reference(index):
    def facts(p):
        plan = p.cluster.ReconfigPlan(**plan_kwargs(p)[index])
        back = p.cluster.ReconfigPlan.from_dict(json.loads(json.dumps(plan.to_dict())))
        return (plan.to_dict(), plan.fingerprint(), plan.needs_repin(), plan.is_noop(),
                back.fingerprint() == plan.fingerprint())

    ref, port = facts(REF), facts(PORT)
    assert port == ref
    assert port[4]


@pytest.mark.parametrize("kwargs,reconfig_error", [
    ({"consensus_impl": "quantum"}, False),
    ({"commit_mode": "eventually"}, False),
    ({"mesh": "2by4"}, True),
    ({"add_replicas": ("rX",), "remove_replicas": ("rX",)}, True),
])
def test_plan_rejects_the_same_bad_knobs(kwargs, reconfig_error):
    for p in (REF, PORT):
        with pytest.raises(ValueError) as err:
            p.cluster.ReconfigPlan(**kwargs)
        assert isinstance(err.value, p.cluster.ReconfigError) == reconfig_error


@pytest.mark.parametrize("kwargs,reason", [
    ({"consensus_impl": "xla"}, "one route per device"),
    ({"consensus_impl": "pallas", "commit_mode": "batched"}, "one route per device"),
    ({"mesh": "64x64"}, "needs 4096 slots"),
])
def test_port_refuses_what_it_cannot_carry_out(tmp_path, kwargs, reason):
    """A ``consensus_impl``, or a claim mesh of more slots than the
    fleet's device offers, is refused by ``validate`` with a
    ``ReconfigError`` that names why, before any phase starts: nothing to
    roll back, no transition counted, nothing changed."""
    router, _, controller, metrics = build_fleet(PORT, tmp_path, claims=("c0",))
    before = tree_bytes(tmp_path), router.fleet_fingerprint()
    plan = cluster.ReconfigPlan(**kwargs)
    with pytest.raises(cluster.ReconfigError, match=reason):
        plan.validate(router)
    with pytest.raises(cluster.ReconfigError, match=reason):
        controller.apply(plan)
    assert metrics.family_total("reconfig_transitions") == 0
    assert controller.status()["phase"] == "idle"
    assert (tree_bytes(tmp_path), router.fleet_fingerprint()) == before


def test_controller_attach_waits_for_the_console(tmp_path):
    _, _, controller, _ = build_fleet(PORT, tmp_path, claims=("c0",))
    console = types.SimpleNamespace()
    controller.attach(console)  # the console's ``reconfig`` command reads it
    assert console.reconfig is controller
    assert controller.request_abort() == {"status": "idle", "detail": "no transition in flight"}


# ---------------------------------------------------------------------------
# the plumbing the plane calls
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("epoch,mesh", [(0, None), (2, "off")])
def test_replica_epoch_names_and_pinned_config_equal_reference(tmp_path, epoch, mesh):
    def run(p, d):
        d.mkdir()
        replica = p.cluster.Replica("r0", str(d / "replica-r0"), chain_dir=str(d / "chain"), seed=0,
                                    clock=p.serving.VirtualClock(), lineage_scope="clu",
                                    commit_mode="batched", mesh=mesh, fingerprint_epoch=epoch, **p.kw)
        config = replica.pinned_config()
        config.pop("consensus_impl")
        names = [os.path.relpath(x, d) for x in (replica.trace_path, replica.wal_path, replica.obs_path)]
        return names, config, sorted(os.listdir(d / "replica-r0"))

    ref, port = both(tmp_path, run)
    assert port == ref
    suffix = f"-e{epoch}" if epoch else ""
    assert port[0] == [f"replica-r0/trace{suffix}.jsonl", f"replica-r0/wal{suffix}.jsonl",
                       f"replica-r0/obs{suffix}.jsonl"]
    assert port[1] == {"mesh": None, "commit_mode": "batched", "fingerprint_epoch": epoch}


def test_replica_claim_mesh_waits_for_a12(tmp_path):
    """A replica pinned to a claim mesh builds, pins it, and serves
    through it: its config, its dispatch count and its fingerprints equal
    the reference's replica's."""
    def run(p, d):
        d.mkdir()
        replica = p.cluster.Replica("r0", str(d / "replica-r0"), chain_dir=str(d / "chain"), seed=0,
                                    clock=p.serving.VirtualClock(), lineage_scope="clu", mesh="2x1",
                                    **p.kw)
        config = replica.pinned_config()
        config.pop("consensus_impl")
        replica.add_claim(p.registry.ClaimSpec(claim_id="c0", n_oracles=8, dimension=6))
        for step in range(2):
            replica.submit("c0", f"comment {step}")
            replica.step()
        return (config, replica.metrics.family_total("claim_shard_dispatches"),
                replica.metrics.family_total("claim_shard_fallback"),
                replica.claim_journal_fingerprint("blkclu-c0"))

    ref, port = both(tmp_path, run)
    assert port == ref
    assert port[0]["mesh"] == "2x1" and port[1] > 0 and port[2] == 0


def test_adopt_claim_fresh_and_replace_replica_equal_reference(tmp_path):
    """Ship c0 off its owner, adopt it onto a new epoch-1 stack under a
    9-oracle spec, swap that stack in, and serve: the report, the
    carried session fields, the retired ledger and every fingerprint
    equal the reference's."""
    def run(p, d):
        router, placement, _, metrics = build_fleet(p, d)
        owner = placement.owner("c0")
        old = router.replica(owner)
        entry = old.ship_claim("c0")
        new = p.cluster.Replica(owner, old.base_dir, chain_dir=old.chain_dir, seed=0,
                                clock=p.serving.VirtualClock(), lineage_scope="clu",
                                fingerprint_epoch=1, max_requests_per_step=64, **p.kw)
        spec = p.registry.ClaimSpec(claim_id="c0", n_oracles=9, dimension=6)
        report = new.adopt_claim_fresh("c0", spec, dict(entry))
        for cid in sorted(c for c in router.claim_ids() if old.has_claim(c)):
            new.adopt_claim(cid, old.ship_claim(cid))
        durable = p.checkpoint.session_durable_dict(new.multi.get("c0").session)
        carried = {k: durable[k] for k in ("fetch_claim", "fetch_published", "last_lineage",
                                           "simulation_step", "prng_key")}
        displaced = router.replace_replica(owner, new, retire_key=f"{owner}@e0")
        for step in range(2):
            for cid in router.claim_ids():
                router.submit(cid, f"after {cid} {step}")
            router.step_all()
        snap = router.snapshot()
        return (report, carried, displaced is old, router.replica(owner) is new,
                new.multi.get("c0").spec.n_oracles, snap["retired"], fingerprints(router),
                router.fleet_accounting())

    ref, port = both(tmp_path, run)
    assert port == ref
    assert port[0]["carried"] is True and port[0]["restored"] == ["c0"]
    assert port[2] and port[3] and port[4] == 9


# ---------------------------------------------------------------------------
# the transaction
# ---------------------------------------------------------------------------


def test_commit_repins_under_new_epoch_equal_reference(tmp_path):
    def run(p, d):
        router, _, controller, metrics = build_fleet(p, d)
        report = controller.apply(p.cluster.ReconfigPlan(commit_mode="batched"))
        report.pop("prewarm")
        traces = {}
        for rid in router.replica_ids():
            replica = router.replica(rid)
            config = replica.pinned_config()
            config.pop("consensus_impl")
            with open(replica.trace_path) as f:
                first = json.loads(f.readline())
            traces[rid] = (os.path.basename(replica.trace_path), config, first["event"],
                           first["data"])
        with open(d / "epochs.json") as f:
            persisted = json.load(f)
        after = router.submit("c0", "after repin")["status"]
        router.step_all()
        return (report, traces, persisted, fingerprints(router), router.epoch_chain(), after,
                metrics.gauge("reconfig_epoch").value, router.fleet_accounting())

    ref, port = both(tmp_path, run)
    assert port == ref
    report, traces, persisted = port[:3]
    assert report["status"] == "committed" and report["epoch"] == 1
    assert all(t[0] == "trace-e1.jsonl" and t[1]["commit_mode"] == "batched"
               and t[1]["fingerprint_epoch"] == 1 and t[2] == "reconfig.epoch" and t[3]["prev_fingerprint"]
               for t in traces.values())
    assert persisted["epoch"] == 1 and persisted["chain"][0]["plan"] == report["plan_fingerprint"]
    assert port[5] == "admitted" and port[6] == 1


def test_mesh_plan_repins_every_replica_equal_reference(tmp_path):
    """A plan with a claim mesh commits: every replica is rebuilt pinned
    to it, its next cycle dispatches claim-sharded, and the report,
    configs, epoch chain and fingerprints equal the reference's."""
    def run(p, d):
        router, _, controller, _ = build_fleet(p, d)
        report = controller.apply(p.cluster.ReconfigPlan(mesh="2x1"))
        report.pop("prewarm")
        configs = {}
        for rid in router.replica_ids():
            config = router.replica(rid).pinned_config()
            config.pop("consensus_impl")
            configs[rid] = config
        for cid in router.claim_ids():
            router.submit(cid, f"after repin {cid}")
        router.step_all()
        served = sum(router.replica(rid).metrics.family_total("claim_shard_dispatches")
                     for rid in router.replica_ids())
        return report, configs, fingerprints(router), router.epoch_chain(), served > 0

    ref, port = both(tmp_path, run)
    assert port == ref
    assert port[0]["status"] == "committed" and port[4]
    assert all(c["mesh"] == "2x1" and c["fingerprint_epoch"] == 1 for c in port[1].values())


@pytest.mark.parametrize("point", RECONFIG_POINTS)
def test_abort_rolls_back_byte_identical_equal_reference(tmp_path, point):
    """An ``error`` at every point: the reference's typed report, and the
    whole fleet directory — traces, WALs, snapshots, hop sidecars, chain
    logs, placement — byte-identical to before the attempt."""
    def run(p, d):
        router, _, controller, metrics = build_fleet(p, d, claims=("c0",))
        before = tree_bytes(d), fingerprints(router)
        report = apply_armed(p, controller, p.cluster.ReconfigPlan(commit_mode="batched"), point)
        after = tree_bytes(d), fingerprints(router)
        status = (router.reconfig_epoch, router.holding(), metrics.family_total("reconfig_aborts"))
        served = router.submit("c0", "after abort")["status"]
        router.step_all()
        return report, before == after, sorted(after[0]), after[1], status, served, fingerprints(router)

    ref, port = both(tmp_path, run)
    assert port == ref
    report, unchanged, files = port[:3]
    assert report["status"] == "aborted" and unchanged
    assert not any("-e1" in name for name in files)
    assert port[4] == (0, [], 1.0) and port[5] == "admitted"


def test_operator_abort_request_equal_reference(tmp_path):
    def run(p, d):
        router, _, controller, _ = build_fleet(p, d, claims=("c0",))
        idle = controller.request_abort()
        before = router.fleet_fingerprint()
        controller._abort_requested = True
        report = controller.apply(p.cluster.ReconfigPlan(commit_mode="batched"))
        return idle, report, router.fleet_fingerprint() == before, controller.status()

    ref, port = both(tmp_path, run)
    assert port == ref
    assert port[1]["status"] == "aborted" and port[1]["cause"] == "_OperatorAbort" and port[2]


def test_noop_and_fleet_validation_equal_reference(tmp_path):
    def run(p, d):
        router, _, controller, _ = build_fleet(p, d, claims=("c0",))
        before = router.fleet_fingerprint()
        noop = controller.apply(p.cluster.ReconfigPlan())
        errors = []
        for plan in (p.cluster.ReconfigPlan(claims={"nope": p.registry.ClaimSpec(claim_id="nope")}),
                     p.cluster.ReconfigPlan(add_replicas=("r0",)),
                     p.cluster.ReconfigPlan(remove_replicas=("rZ",)),
                     p.cluster.ReconfigPlan(remove_replicas=("r0", "r1"))):
            with pytest.raises(p.cluster.ReconfigError) as err:
                controller.apply(plan)
            errors.append(str(err.value))
        return noop, router.reconfig_epoch, router.fleet_fingerprint() == before, errors

    ref, port = both(tmp_path, run)
    assert port == ref
    assert port[:3] == ({"status": "noop"}, 0, True)


def test_growth_plan_bounded_rebalance_equal_reference(tmp_path):
    claims = tuple(f"c{i}" for i in range(6))

    def run(p, d):
        router, placement, controller, _ = build_fleet(p, d, claims=claims)
        old_roster = list(placement.replicas())
        probe = p.cluster.PlacementDirectory(old_roster + ["r2"])
        expected = sorted(c for c in claims if probe.owner(c) == "r2")
        report = controller.apply(p.cluster.ReconfigPlan(add_replicas=("r2",)))
        report.pop("prewarm")
        config = router.replica("r2").pinned_config()
        config.pop("consensus_impl")
        return report, expected, config, fingerprints(router), router.epoch_chain()

    ref, port = both(tmp_path, run)
    assert port == ref
    report, expected, config = port[:3]
    assert report["status"] == "committed" and sorted(report["grown"]["r2"]["moved"]) == expected
    assert config["fingerprint_epoch"] == 1


def test_adopt_orphans_with_continuity_equal_reference(tmp_path):
    def run(p, d):
        router, placement, _, metrics = build_fleet(p, d)
        quarantined = router.migrate("c0", "rZ", reason="test")
        adoption = router.adopt_orphans()
        with open(d / "unclaimed.json") as f:
            unclaimed = json.load(f)
        served = router.submit("c0", "after adoption")["status"]
        router.step_all()
        return (quarantined["status"], adoption, unclaimed, metrics.family_total("cluster_adopted"), served,
                fingerprints(router))

    ref, port = both(tmp_path, run)
    assert port == ref
    assert port[0] == "quarantined" and port[1]["adopted"]["c0"]["continuity"] is True
    assert port[2] == {} and port[3] == 1.0 and port[4] == "admitted"


# ---------------------------------------------------------------------------
# the outcome grid
# ---------------------------------------------------------------------------

#: The reference generator's plans (``test_reconfig.py:340-357``): commit
#: mode x re-spec x growth, the noop left out.
GRID_PLANS = [(mode, respec, grow) for mode in (None, "batched") for respec in (False, True)
              for grow in (False, True) if mode or respec or grow]


@pytest.mark.parametrize("point", ["reconfig.prepare", "reconfig.post_drain", "reconfig.pre_resume"])
@pytest.mark.parametrize("mode,respec,grow", GRID_PLANS)
def test_outcome_grid_equals_reference(tmp_path, mode, respec, grow, point):
    def run(p, d):
        router, _, controller, _ = build_fleet(p, d, claims=("c0",))
        before = router.fleet_fingerprint()
        plan = p.cluster.ReconfigPlan(
            commit_mode=mode,
            claims={"c0": p.registry.ClaimSpec(claim_id="c0", n_oracles=9, dimension=6)} if respec else {},
            add_replicas=("rG",) if grow else ())
        report = apply_armed(p, controller, plan, point)
        return (report["status"], router.fleet_fingerprint() == before, router.reconfig_epoch,
                router.fleet_fingerprint())

    ref, port = both(tmp_path, run)
    assert port == ref
    status, unchanged, epoch = port[:3]
    if status == "aborted":
        assert unchanged and epoch == 0
    else:
        # Only a growth-only plan commits under an armed fault: it never
        # reaches the per-replica gate.
        assert status == "committed" and grow and not (mode or respec) and point == "reconfig.post_drain"


# ---------------------------------------------------------------------------
# aborts under traffic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("point,nth", [("reconfig.prepare", 1), ("reconfig.post_drain", 2),
                                       ("reconfig.pre_resume", 1)])
def test_abort_under_traffic_equals_reference(tmp_path, point, nth):
    """The smoke's abort run with the traffic probes on: requests deferred
    during the transition are released into the old stacks by the
    rollback, and the run's statuses, accounting and fleet and per-claim
    fingerprints equal the reference's (whose smoke runs its aborts
    without probes).  ``post_drain`` aborts at its second firing, on r1,
    the replica that owns this fleet's claims, after its probes were
    deferred."""
    from svoc_tpu.cluster.reconfig_scenario import run_reconfig_scenario as ref_run

    from svoc_torch.cluster.reconfig_scenario import run_reconfig_scenario
    from svoc_torch.tools.reconfig_smoke import ABORT_RUN, plan_dict

    def run(fn, d, p, **extra):
        result = fn(str(d), seed=0, plan=plan_dict(),
                    events=[p.faultspace.FaultEvent(point=point, nth=nth, action="error")],
                    **dict(ABORT_RUN, traffic_probes=True), **extra)
        return (result["reconfig"], [(x["stage"], x["response"]["status"]) for x in result["probes"]],
                result["requests"]["unaccounted"], result["duplicate_txs"], result["cluster_counters"],
                result["fleet_fingerprint"], {c: v["fingerprint"] for c, v in result["claims"].items()})

    ref = run(ref_run, tmp_path / "ref", REF)
    port = run(run_reconfig_scenario, tmp_path / "port", PORT, device="cpu")
    assert port == ref
    report, probes = port[:2]
    assert report["status"] == "aborted" and port[2:4] == (0, 0)
    assert all(status in ("admitted", "deferred") for _, status in probes)
    assert any(status == "deferred" for _, status in probes) == (point != "reconfig.prepare")


@pytest.mark.parametrize("point", ["reconfig.post_ship", "reconfig.pre_repin"])
def test_rollback_readopts_the_faulting_replicas_slices(tmp_path, point):
    """A fault at ``post_ship`` or ``pre_repin`` on r1, the replica that
    owns the abort fleet's claims (the point's second firing): the port
    re-adopts r1's shipped slices onto r1, and the aborted run's fleet
    fingerprint equals the never-attempted baseline's, itself the
    reference's.  The reference stages a replica only when its whole
    transition returns, so r1's slices are re-adopted nowhere, and its
    run raises ``KeyError`` at the next request to one of them."""
    from svoc_tpu.cluster.reconfig_scenario import run_reconfig_scenario as ref_run

    from svoc_torch.cluster.reconfig_scenario import run_reconfig_scenario
    from svoc_torch.tools.reconfig_smoke import ABORT_RUN, plan_dict

    def run(fn, d, p, plan, **extra):
        return fn(str(d), seed=0, plan=plan, events=[p.faultspace.FaultEvent(point=point, nth=2, action="error")],
                  **ABORT_RUN, **extra)

    baseline = run(run_reconfig_scenario, tmp_path / "baseline", PORT, None, device="cpu")
    aborted = run(run_reconfig_scenario, tmp_path / "aborted", PORT, plan_dict(), device="cpu")
    assert aborted["reconfig"]["status"] == "aborted"
    assert aborted["fleet_fingerprint"] == baseline["fleet_fingerprint"]
    assert aborted["requests"]["unaccounted"] == 0 and aborted["duplicate_txs"] == 0
    assert baseline["fleet_fingerprint"] == run(ref_run, tmp_path / "ref-baseline", REF, None)["fleet_fingerprint"]
    with pytest.raises(KeyError):
        run(ref_run, tmp_path / "ref-aborted", REF, plan_dict())
