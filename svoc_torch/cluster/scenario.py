"""Seeded kill/failover fleet scenario: the cluster smoke's workload.

Mirrors :mod:`svoc_tpu.cluster.scenario` (``scenario.py:1-401``):
:func:`run_cluster_scenario`, :func:`replay_corpus_entry`,
``LINEAGE_SCOPE``, ``WARMUP_TEXTS`` and ``CORPUS_FORMAT``.  It takes
``device=`` as the port's other scenarios do: ``None`` means CUDA and
raises without a card, ``"cpu"`` runs the plain claim-cube forms.
Every replica draws its fleets and runs its claim cube there; every
journal event, WAL line and chain-log line is the reference's, so the
per-claim and fleet fingerprints equal the reference's for the same
seed and schedule.

N replicas × M claims under one :class:`~svoc_torch.cluster.router
.ClusterRouter`, every durable artifact under one work directory:

```
workdir/
  placement.json        # the claim→replica map, epoch-versioned
  cluster-trace.jsonl   # the router journal (redirects/sheds/migrations)
  fired.jsonl           # the fault controller's durable coverage log
  unclaimed.json        # quarantined migration slices (orphan path)
  chain/chain-<c>.jsonl # per-claim tx logs — CLUSTER-SHARED (the chain
                        # outlives any replica; dedup is fleet-wide)
  replica-<r>/          # one full durable stack per replica
    wal.jsonl  trace.jsonl  snapshot.json
```

Everything is a pure function of ``seed`` + the schedule: arrivals key
off :func:`claim_seed` PER ITERATION, time is per-replica virtual
clocks advanced in lockstep, the replica death is a seeded step number
(fired through the ``replica.kill`` registry point — the crc32
counting discipline, never wall time), and the failover decision
sequence lands in the cluster journal, so two same-seed runs must
produce byte-identical per-claim and fleet fingerprints INCLUDING the
kill, the sheds during the outage window, and every migration.

The harness (:mod:`svoc_torch.tools.cluster_smoke`) asserts the cluster-wide
invariant oracles over the result: zero duplicate txs across replicas,
exactly-once lineages through migration, 0 unaccounted admitted
requests (at-least-once), and replay identity.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np

from svoc_torch.cluster.placement import PlacementDirectory
from svoc_torch.cluster.replica import Replica
from svoc_torch.cluster.router import ClusterRouter
from svoc_torch.device import resolve_device
from svoc_torch.durability import faultspace
from svoc_torch.durability.chainlog import (
    duplicate_predictions,
    read_chain_log,
)
from svoc_torch.durability.faultspace import FaultEvent
from svoc_torch.fabric.registry import ClaimSpec
from svoc_torch.resilience.retry import RetryPolicy
from svoc_torch.sim.generators import claim_seed

#: The corpus format tag for cluster chaos entries
#: (``tests/fixtures/chaos_corpus/cluster/`` — a subdirectory, so the
#: durable-plane fuzzer's ``load_corpus`` never picks them up).
CORPUS_FORMAT = "svoc-cluster-corpus-v1"

#: One cluster-wide lineage scope: a claim's lineage prefix is the same
#: on every replica, so migration ships cursors, never rewrites ids.
LINEAGE_SCOPE = "clu"

#: Warm-up texts fed to every claim before the measured schedule —
#: 2x the serving ``bootstrap_subset`` (10), so each claim's FIRST
#: fleet cycle already bootstraps 10-of-32 rather than the degenerate
#: 1-of-1..4-of-8 subsets a near-empty pow2-tiled window produces.
#: Below that, two honest cycles can draw byte-identical payloads and
#: the chain's (caller, digest) duplicate witness cannot tell a
#: legitimate repeat from a double-send.
WARMUP_TEXTS = 20


def run_cluster_scenario(
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
    kill_replica: Optional[str] = None,
    kill_at_step: Optional[int] = None,
    fail_over_at_step: Optional[int] = None,
    migrate_at_step: Optional[int] = None,
    events: Optional[List[FaultEvent]] = None,
    stale_epoch_probe: bool = True,
    fleet_plane: Optional[bool] = None,
    device=None,
) -> Dict[str, Any]:
    """Run the seeded fleet workload; returns the result dict the
    harness asserts over.  ``kill_replica``/``kill_at_step`` schedule
    an in-process SIGKILL-equivalent at a step boundary (the replica's
    in-memory stack is discarded, its durable dirs survive);
    ``fail_over_at_step`` (default: two steps later — a deterministic
    outage window whose sheds the journal witnesses) runs the
    recover-then-migrate path.  ``migrate_at_step`` exercises one
    operator migration of the first claim to its non-owner.
    ``fleet_plane`` (tri-state, SVOC011 resolution) switches the fleet
    observability plane on/off for the run; the result's ``fleet_obs``
    section carries its snapshot, merged exposition, per-source counter
    scrapes, sidecar paths, and accounting history — all obs-channel
    derived, so the fleet fingerprint is byte-identical either way
    (the fleet-obs smoke).  ``device`` (``None``: CUDA, raising without
    a card) is where every replica draws fleets and runs its claim cube.
    """
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
    if kill_replica is not None and kill_at_step is None:
        raise ValueError("kill_replica needs kill_at_step")
    if kill_replica is not None and fail_over_at_step is None:
        fail_over_at_step = kill_at_step + 2

    metrics = MetricsRegistry()
    journal = EventJournal(registry=metrics)
    trace_path = os.path.join(workdir, "cluster-trace.jsonl")
    writer = _events.shared_writer(trace_path)
    writer.fsync = True
    journal.set_trace_file(trace_path)
    master_clock = VirtualClock()

    placement = PlacementDirectory(
        [], path=os.path.join(workdir, "placement.json")
    )
    plane = FleetPlane(
        enabled=fleet_plane,
        clock=master_clock,
        journal=journal,
        trace_path=os.path.join(workdir, "fleet-obs.jsonl"),
        profile_dir=os.path.join(workdir, "profiles"),
        bundle_dir=workdir,
        slo_latency_target_s=2.5 * step_period_s,
        slo_fast_window_s=10 * step_period_s,
        slo_slow_window_s=50 * step_period_s,
    )

    def replica_factory(rid: str) -> Replica:
        replica = Replica(
            rid,
            os.path.join(workdir, f"replica-{rid}"),
            chain_dir=chain_dir,
            seed=seed,
            clock=VirtualClock(),
            lineage_scope=LINEAGE_SCOPE,
            step_period_s=step_period_s,
            max_claims_per_batch=n_claims,
            # Wide enough to take every claim's warm-up burst in ONE
            # step (the batcher cap is a per-step total across claims),
            # so the first cycle sees the full warmed window.
            max_requests_per_step=max(
                64, n_claims * WARMUP_TEXTS + n_claims + arrivals_per_step
            ),
            device=device,
        )
        return replica

    router = ClusterRouter(
        placement,
        journal=journal,
        metrics=metrics,
        clock=master_clock,
        retry=RetryPolicy(max_attempts=2, base_s=0.0, cap_s=0.0, jitter_seed=seed),
        replica_factory=replica_factory,
        lineage_scope=LINEAGE_SCOPE,
        unclaimed_path=os.path.join(workdir, "unclaimed.json"),
        fleet_plane=plane,
    )
    obs_paths: Dict[str, str] = {
        "router": os.path.join(workdir, "fleet-obs.jsonl")
    }
    for rid in replica_ids:
        replica = replica_factory(rid)
        replica.install_cadence(snapshot_every)
        router.add_replica(replica)
        obs_paths[rid] = replica.obs_path
    for cid in claim_ids:
        router.add_claim(
            ClaimSpec(claim_id=cid, n_oracles=n_oracles, dimension=dimension)
        )

    # Window warm-up (seeded, part of the schedule): feed every claim
    # WARMUP_TEXTS unique texts and run one serving step BEFORE the
    # fault controller arms, so injected nth counters index the main
    # schedule and every claim's first measured cycle bootstraps from
    # a full-subset window (see WARMUP_TEXTS).
    for cid in claim_ids:
        for j in range(WARMUP_TEXTS):
            router.submit(cid, f"warmup {cid} #{j}")
    master_clock.advance(step_period_s)
    for rid in router.replica_ids():
        router.replica(rid).clock.advance(step_period_s)
    router.step_all()

    controller = faultspace.arm(
        faultspace.FaultController(
            list(events or []),
            log_path=os.path.join(workdir, "fired.jsonl"),
        )
    )
    kill_report: Optional[Dict[str, Any]] = None
    failover_report: Optional[Dict[str, Any]] = None
    migrate_report: Optional[Dict[str, Any]] = None
    probes: List[Dict[str, Any]] = []
    try:
        journal.emit(
            "chaos.armed",
            events=[e.as_dict() for e in (events or [])],
            kill={"replica": kill_replica, "at_step": kill_at_step}
            if kill_replica is not None
            else None,
        )
        for step_no in range(total_steps):
            master_clock.advance(step_period_s)
            for rid in router.replica_ids():
                router.replica(rid).clock.advance(step_period_s)
            rng = np.random.default_rng(
                claim_seed(seed, f"cluster-arrivals{step_no}")
            )
            # One guaranteed-fresh text per claim per step: the
            # zero-duplicates witness (``duplicate_predictions``) rests
            # on "payloads vary per cycle", but a small request window
            # degenerates the honest bootstrap to the key-independent
            # full-window mean — an UNCHANGED window could then repeat
            # a payload legitimately and read as a double-send.  Fresh
            # text every step keeps every window mean moving, so a
            # repeated (caller, digest) pair really is a duplicate tx.
            for claim in claim_ids:
                router.submit(claim, f"comment {claim} step {step_no} fresh")
            # Every text is UNIQUE (no hot pool): repeated texts put
            # identical rows in the request windows, and a bootstrap
            # subset drawn entirely from such rows can reproduce an
            # earlier cycle's mean — a legitimate payload repeat the
            # duplicate witness cannot tell from a double-send.
            for i in range(arrivals_per_step):
                claim = claim_ids[int(rng.integers(0, n_claims))]
                router.submit(claim, f"comment {claim} step {step_no} #{i}")
            if (
                kill_report is not None
                and failover_report is None
                and step_no == (kill_at_step or 0) + 1
            ):
                # One submit aimed into the outage window: the typed
                # ``cluster.unavailable`` shed is part of the replayed
                # decision stream whatever the arrival draws did.
                downed = [
                    cid
                    for cid in claim_ids
                    if placement.owner(cid) == kill_replica
                ]
                if downed:
                    probes.append(
                        router.submit(downed[0], "down-replica probe")
                    )
            if stale_epoch_probe and step_no == 1:
                # One deliberately stale caller: the typed redirect is
                # part of the replayed decision stream.
                probes.append(
                    router.submit(
                        claim_ids[0],
                        "stale-epoch probe",
                        epoch=placement.epoch - 1,
                    )
                )
            router.step_all()
            if kill_replica is not None and step_no == kill_at_step:
                faultspace.fault_point(
                    faultspace.REPLICA_KILL,
                    payload={"replica": kill_replica, "step": step_no},
                )
                router.replica(kill_replica).kill()
                kill_report = {"replica": kill_replica, "step": step_no}
            if kill_replica is not None and step_no == fail_over_at_step:
                failover_report = router.fail_over(kill_replica)
            if migrate_at_step is not None and step_no == migrate_at_step:
                cid = claim_ids[0]
                owner = placement.owner(cid)
                target = next(
                    rid for rid in router.replica_ids() if rid != owner
                )
                migrate_report = router.migrate(
                    cid, target, reason="scenario"
                )

        # Graceful end: flush every live replica and snapshot it, so a
        # later phase over the same workdir recovers serving-warm.
        drains = {}
        for rid in router.replica_ids():
            replica = router.replica(rid)
            if not replica.alive:
                continue  # durable dirs stay as the death left them
            drains[rid] = replica.tier.drain()
            replica.manager.snapshot()
    finally:
        faultspace.disarm()

    # ---- the result the harness asserts over ----
    chain: Dict[str, Any] = {}
    duplicate_txs = 0
    for cid in claim_ids:
        path = os.path.join(chain_dir, f"chain-{cid}.jsonl")
        txs = read_chain_log(path)
        dups = duplicate_predictions(path)
        duplicate_txs += len(dups)
        chain[cid] = {
            "txs": len(txs),
            "predictions": sum(
                1 for t in txs if t["fn"] == "update_prediction"
            ),
            "duplicates": len(dups),
        }
    if plane.enabled:
        fleet_obs: Dict[str, Any] = {
            **plane.snapshot(),
            "exposition": plane.render_prometheus_fleet(),
            # The live sources exactly as the merge saw them — the
            # smoke's merged-equals-sum witness (no-kill legs; kill
            # legs assert monotonicity over accounting_history instead).
            "per_source_counters": {
                "router": metrics.counters_snapshot(),
                "fleet": plane.registry.counters_snapshot(),
                **{
                    rid: router.replica(rid).metrics.counters_snapshot()
                    for rid in router.replica_ids()
                    if router.replica(rid).alive
                },
            },
            "obs_paths": obs_paths,
            "accounting_history": plane.accounting_history(),
        }
    else:
        fleet_obs = {"enabled": False}
    return {
        "seed": seed,
        "steps": total_steps,
        "replicas": {
            rid: router.replica(rid).snapshot()
            for rid in router.replica_ids()
        },
        "placement": placement.snapshot(),
        "epoch": placement.epoch,
        "kill": kill_report,
        "failover": failover_report,
        "migration": migrate_report,
        "probes": probes,
        "drains": drains,
        "chain": chain,
        "duplicate_txs": duplicate_txs,
        "requests": router.fleet_accounting(),
        "cluster_counters": {
            family: metrics.family_total(family)
            for family in (
                "cluster_forwarded",
                "cluster_unavailable",
                "cluster_redirects",
                "cluster_migrations",
                "cluster_failovers",
                "cluster_quarantined",
            )
        },
        "claims": {
            cid: {
                "fingerprint": router.claim_fingerprint(cid),
                "owner": placement.owner(cid),
            }
            for cid in claim_ids
        },
        "fleet_fingerprint": router.fleet_fingerprint(),
        "fault_points_fired": controller.counts(),
        "journal_events": journal.last_seq(),
        "fleet_obs": fleet_obs,
    }


def replay_corpus_entry(
    entry: Dict[str, Any], workdir: str, device=None
) -> Dict[str, Any]:
    """Replay one committed cluster corpus entry (the regression-pinning
    twin of the reference's ``durability.fuzz.replay_corpus_entry``, for
    the cluster fault points the durable-plane fuzzer cannot reach)."""
    if entry.get("format") != CORPUS_FORMAT:
        raise ValueError(f"not a cluster corpus entry: {entry.get('format')!r}")
    plan = entry.get("plan") or {}
    kill = plan.get("kill") or {}
    return run_cluster_scenario(
        workdir,
        seed=int(entry.get("seed", 0)),
        n_replicas=int(plan.get("n_replicas", 2)),
        n_claims=int(plan.get("n_claims", 2)),
        total_steps=int(plan.get("total_steps", 8)),
        arrivals_per_step=int(plan.get("arrivals_per_step", 4)),
        kill_replica=kill.get("replica"),
        kill_at_step=kill.get("at_step"),
        fail_over_at_step=kill.get("fail_over_at"),
        migrate_at_step=plan.get("migrate_at_step"),
        events=[FaultEvent.from_dict(d) for d in plan.get("events", [])],
        device=device,
    )
