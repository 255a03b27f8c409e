"""Seeded live-reconfiguration scenario: the reconfig smoke's workload.

Mirrors :mod:`svoc_tpu.cluster.reconfig_scenario`
(``reconfig_scenario.py:1-366``): :func:`run_reconfig_scenario`
(``:74``), :func:`replay_corpus_entry` (``:344``), ``CORPUS_FORMAT`` and
``COUNTER_FAMILIES``.  It takes ``device=`` as
:mod:`svoc_torch.cluster.scenario` does: ``None`` means CUDA and raises
without a card, ``"cpu"`` runs the plain claim-cube forms; the builder
hands it to every replica, the re-pinned and grown ones too.  Every
journal event, WAL line and chain-log line is the reference's, so the
per-claim and fleet fingerprints equal the reference's for the same
seed, schedule and work directory.

The kill/failover fleet scenario's twin (same workdir layout, same
seeded arrival schedule, same per-replica virtual clocks in lockstep)
with a :class:`~svoc_torch.cluster.reconfig.ReconfigPlan` applied
mid-schedule through the
:class:`~svoc_torch.cluster.reconfig.ReconfigController`:

- ``plan=None`` is the BASELINE: the identical workload with no
  transition attempted.  An aborted run's fleet fingerprint is compared
  against this baseline byte for byte — pass the SAME ``events`` list to
  both (un-fired events are journal-invisible; ``chaos.armed`` then
  matches), so the only difference between the runs is the attempt
  itself, which abort must erase.
- a committed run exercises the full drain → ship → re-pin → resume
  transaction under traffic: the controller's ``traffic`` hook fires a
  probe submission at every stage boundary, so the DEFERRED path (the
  held replica's traffic parked at the router, replayed on release) is
  part of the replayed decision stream.
- ``events`` naming ``reconfig.*`` points (action ``error``) abort the
  transition at that boundary — the rollback gate.

Everything stays a pure function of ``seed`` + the schedule: the plan is
applied at a step boundary (queues empty, WAL reconciled), probe texts
are unique per (stage, replica), and the epoch transition's continuity
records land in the NEW epoch's journal at commit, so two same-seed
committed runs produce byte-identical fleet fingerprints INCLUDING the
transition.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Union

import numpy as np

from svoc_torch.cluster.placement import PlacementDirectory
from svoc_torch.cluster.reconfig import ReconfigController, ReconfigPlan
from svoc_torch.cluster.replica import Replica
from svoc_torch.cluster.router import ClusterRouter
from svoc_torch.cluster.scenario import LINEAGE_SCOPE, WARMUP_TEXTS
from svoc_torch.device import resolve_device
from svoc_torch.durability import faultspace
from svoc_torch.durability.chainlog import duplicate_predictions, read_chain_log
from svoc_torch.durability.faultspace import FaultEvent
from svoc_torch.fabric.registry import ClaimSpec
from svoc_torch.resilience.retry import RetryPolicy
from svoc_torch.sim.generators import claim_seed

#: Corpus format tag for reconfiguration chaos entries
#: (``tests/fixtures/chaos_corpus/reconfig/``).
CORPUS_FORMAT = "svoc-reconfig-corpus-v1"

#: Metric families the result digests (the cluster scenario's set plus
#: the reconfiguration plane's own).
COUNTER_FAMILIES = (
    "cluster_forwarded",
    "cluster_unavailable",
    "cluster_redirects",
    "cluster_migrations",
    "cluster_failovers",
    "cluster_quarantined",
    "cluster_grown",
    "cluster_retired",
    "cluster_adopted",
    "reconfig_deferred",
)


def run_reconfig_scenario(
    workdir: str,
    seed: int = 0,
    *,
    n_replicas: int = 3,
    n_claims: int = 6,
    n_oracles: int = 7,
    dimension: int = 6,
    total_steps: int = 12,
    arrivals_per_step: int = 8,
    snapshot_every: int = 2,
    step_period_s: float = 0.1,
    mesh: Optional[str] = None,
    commit_mode: str = "per_tx",
    reconfig_at_step: Optional[int] = None,
    plan: Optional[Union[ReconfigPlan, Dict[str, Any]]] = None,
    rolling: bool = True,
    traffic_probes: bool = True,
    prewarm_budget_s: float = 5.0,
    events: Optional[List[FaultEvent]] = None,
    fleet_plane: Optional[bool] = None,
    device=None,
) -> Dict[str, Any]:
    """Run the seeded reconfiguration workload; returns the result dict
    the harness asserts over.  ``mesh``/``commit_mode`` pin the INITIAL
    fleet (the port has no ``consensus_impl``: the route follows
    ``device``); ``plan`` (a :class:`ReconfigPlan` or its ``to_dict``
    payload) is applied at the ``reconfig_at_step`` step boundary.
    ``fleet_plane`` switches the fleet observability plane for the run
    (obs-channel only — the fleet fingerprint, including abort
    invisibility, is byte-identical either way).  ``device`` (``None``:
    CUDA, raising without a card) is where every replica draws fleets and
    runs its claim cube."""
    from svoc_torch.obsplane.fleet import FleetPlane
    from svoc_torch.serving.scenario import VirtualClock
    from svoc_torch.utils import events as _events
    from svoc_torch.utils.events import EventJournal
    from svoc_torch.utils.metrics import MetricsRegistry

    device = resolve_device(device)
    os.makedirs(workdir, exist_ok=True)
    chain_dir = os.path.join(workdir, "chain")
    replica_ids = [f"r{i}" for i in range(n_replicas)]
    claim_ids = [f"c{i}" for i in range(n_claims)]
    if plan is not None and reconfig_at_step is None:
        raise ValueError("plan needs reconfig_at_step")
    plan_obj: Optional[ReconfigPlan] = None
    if plan is not None:
        plan_obj = plan if isinstance(plan, ReconfigPlan) else ReconfigPlan.from_dict(plan)

    metrics = MetricsRegistry()
    journal = EventJournal(registry=metrics)
    trace_path = os.path.join(workdir, "cluster-trace.jsonl")
    writer = _events.shared_writer(trace_path)
    writer.fsync = True
    journal.set_trace_file(trace_path)
    master_clock = VirtualClock()

    placement = PlacementDirectory([], path=os.path.join(workdir, "placement.json"))

    def builder(
        rid: str,
        *,
        fingerprint_epoch: int = 0,
        consensus_impl: Optional[str] = None,
        mesh=None,
        commit_mode: str = "per_tx",
    ) -> Replica:
        clock = VirtualClock()
        # A re-pinned/grown stack joins at the fleet's CURRENT virtual
        # time — a seed-determined offset, never wall time.
        clock.advance(master_clock() - clock())
        replica = Replica(
            rid,
            os.path.join(workdir, f"replica-{rid}"),
            chain_dir=chain_dir,
            seed=seed,
            clock=clock,
            lineage_scope=LINEAGE_SCOPE,
            commit_mode=commit_mode,
            consensus_impl=consensus_impl,
            mesh=mesh,
            fingerprint_epoch=fingerprint_epoch,
            step_period_s=step_period_s,
            max_claims_per_batch=n_claims,
            max_requests_per_step=max(64, n_claims * WARMUP_TEXTS + n_claims + arrivals_per_step),
            device=device,
        )
        replica.install_cadence(snapshot_every)
        return replica

    def initial_replica(rid: str) -> Replica:
        return builder(rid, fingerprint_epoch=0, mesh=mesh, commit_mode=commit_mode)

    router = ClusterRouter(
        placement,
        journal=journal,
        metrics=metrics,
        clock=master_clock,
        retry=RetryPolicy(max_attempts=2, base_s=0.0, cap_s=0.0, jitter_seed=seed),
        replica_factory=initial_replica,
        lineage_scope=LINEAGE_SCOPE,
        unclaimed_path=os.path.join(workdir, "unclaimed.json"),
        epochs_path=os.path.join(workdir, "epochs.json"),
        fleet_plane=FleetPlane(
            enabled=fleet_plane,
            clock=master_clock,
            journal=journal,
            trace_path=os.path.join(workdir, "fleet-obs.jsonl"),
            profile_dir=os.path.join(workdir, "profiles"),
            bundle_dir=workdir,
            slo_latency_target_s=2.5 * step_period_s,
            slo_fast_window_s=10 * step_period_s,
            slo_slow_window_s=50 * step_period_s,
        ),
    )
    controller = ReconfigController(
        router,
        builder=builder,
        journal=journal,
        metrics=metrics,
        clock=master_clock,
        prewarm_budget_s=prewarm_budget_s,
    )
    for rid in replica_ids:
        router.add_replica(initial_replica(rid))
    for cid in claim_ids:
        router.add_claim(ClaimSpec(claim_id=cid, n_oracles=n_oracles, dimension=dimension))

    # Window warm-up before the fault controller arms (the cluster
    # scenario's convention — see WARMUP_TEXTS there).
    for cid in claim_ids:
        for j in range(WARMUP_TEXTS):
            router.submit(cid, f"warmup {cid} #{j}")
    master_clock.advance(step_period_s)
    for rid in router.replica_ids():
        router.replica(rid).clock.advance(step_period_s)
    router.step_all()

    fault_controller = faultspace.arm(
        faultspace.FaultController(list(events or []), log_path=os.path.join(workdir, "fired.jsonl"))
    )
    probes: List[Dict[str, Any]] = []
    reconfig_report: Optional[Dict[str, Any]] = None

    def traffic(stage: str, rid: Optional[str]) -> None:
        # One probe per stage boundary, aimed at the transitioning
        # replica's first owned claim — the DEFERRED decision is part of
        # the replayed stream (unique text per (stage, replica)).
        if rid is None:
            target = claim_ids[0]
        else:
            owned = [cid for cid in claim_ids if placement.owner(cid) == rid]
            target = owned[0] if owned else claim_ids[0]
        probes.append({
            "stage": stage,
            "replica": rid,
            "response": router.submit(target, f"reconfig probe {stage} {rid}"),
        })

    try:
        journal.emit(
            "chaos.armed",
            events=[e.as_dict() for e in (events or [])],
            reconfig={"at_step": reconfig_at_step, "rolling": rolling},
        )
        for step_no in range(total_steps):
            master_clock.advance(step_period_s)
            for rid in router.replica_ids():
                router.replica(rid).clock.advance(step_period_s)
            rng = np.random.default_rng(claim_seed(seed, f"cluster-arrivals{step_no}"))
            # Fresh unique texts every step — the duplicate-tx witness's
            # precondition (see the cluster scenario's comments).
            for claim in claim_ids:
                router.submit(claim, f"comment {claim} step {step_no} fresh")
            for i in range(arrivals_per_step):
                claim = claim_ids[int(rng.integers(0, n_claims))]
                router.submit(claim, f"comment {claim} step {step_no} #{i}")
            router.step_all()
            if plan_obj is not None and step_no == reconfig_at_step:
                reconfig_report = controller.apply(
                    plan_obj,
                    rolling=rolling,
                    traffic=traffic if traffic_probes else None,
                )

        drains = {}
        for rid in router.replica_ids():
            replica = router.replica(rid)
            if not replica.alive:
                continue
            drains[rid] = replica.tier.drain()
            replica.manager.snapshot()
    finally:
        faultspace.disarm()

    chain: Dict[str, Any] = {}
    duplicate_txs = 0
    for cid in claim_ids:
        path = os.path.join(chain_dir, f"chain-{cid}.jsonl")
        txs = read_chain_log(path)
        dups = duplicate_predictions(path)
        duplicate_txs += len(dups)
        chain[cid] = {
            "txs": len(txs),
            "predictions": sum(1 for t in txs if t["fn"] == "update_prediction"),
            "duplicates": len(dups),
        }
    return {
        "seed": seed,
        "steps": total_steps,
        "replicas": {rid: router.replica(rid).snapshot() for rid in router.replica_ids()},
        "placement": placement.snapshot(),
        "epoch": placement.epoch,
        "reconfig": reconfig_report,
        "reconfig_epoch": router.reconfig_epoch,
        "epoch_chain": router.epoch_chain(),
        "probes": probes,
        "drains": drains,
        "chain": chain,
        "duplicate_txs": duplicate_txs,
        "requests": router.fleet_accounting(),
        "cluster_counters": {family: metrics.family_total(family) for family in COUNTER_FAMILIES},
        "claims": {
            cid: {"fingerprint": router.claim_fingerprint(cid), "owner": placement.owner(cid)}
            for cid in claim_ids
        },
        "fleet_fingerprint": router.fleet_fingerprint(),
        "fault_points_fired": fault_controller.counts(),
        "journal_events": journal.last_seq(),
        "fleet_obs": router.fleet_plane.snapshot(),
    }


def replay_corpus_entry(entry: Dict[str, Any], workdir: str, device=None) -> Dict[str, Any]:
    """Replay one pinned reconfiguration corpus entry (the regression twin
    of the cluster corpus replayer, for the ``reconfig.*`` fault points)
    on ``device``."""
    if entry.get("format") != CORPUS_FORMAT:
        raise ValueError(f"not a reconfig corpus entry: {entry.get('format')!r}")
    plan = entry.get("plan") or {}
    reconfig = plan.get("reconfig") or {}
    return run_reconfig_scenario(
        workdir,
        seed=int(entry.get("seed", 0)),
        n_replicas=int(plan.get("n_replicas", 2)),
        n_claims=int(plan.get("n_claims", 3)),
        total_steps=int(plan.get("total_steps", 6)),
        arrivals_per_step=int(plan.get("arrivals_per_step", 4)),
        reconfig_at_step=reconfig.get("at_step"),
        plan=reconfig.get("plan"),
        rolling=bool(reconfig.get("rolling", True)),
        traffic_probes=bool(reconfig.get("traffic_probes", True)),
        events=[FaultEvent.from_dict(d) for d in plan.get("events", [])],
        device=device,
    )
