"""Cluster router: forwards serving traffic to the owning replica.

Mirrors :mod:`svoc_tpu.cluster.router` (``router.py:1-1058``):
:class:`MigrationContinuityError` and the whole :class:`ClusterRouter` —
submit with the epoch/redirect protocol, the breaker and retry, the
holds (the reconfiguration plane's deferral), ``replace_replica`` (its
commit's stack swap), ``step_all``, migrate (drain → ship → adopt with
the continuity check), the orphan quarantine, ``fail_over`` with the
harvest, ``grow``, ``retire_replica``, ``adopt_orphans``, the epoch
chain (``:944-975``,
folded into :meth:`ClusterRouter.fleet_fingerprint` even while empty),
``fleet_accounting`` and ``snapshot``.  The router is host code: every
kernel launch happens inside a replica's ``ServingTier.step``.
:meth:`ClusterRouter.attach` wires it into the operator console
(:mod:`svoc_torch.apps.commands`).

On the forward path a broad ``except`` turns any error inside the
transport call into a typed ``forward_error`` shed (``:356-364``, the
reference's semantics); ``step_all`` has no ``try``, so an error inside a
replica's step (a CUDA error among them) propagates to the caller.

The thin plane over N :class:`~svoc_torch.cluster.replica.Replica` stacks
(a balanced multi-worker split): resolution is the
:class:`~svoc_torch.cluster.placement.PlacementDirectory`, transport
faults ride a per-replica :class:`~svoc_torch.resilience.breaker
.CircuitBreaker` + :class:`~svoc_torch.resilience.retry.RetryPolicy`, and
every degraded outcome is TYPED — a stale-epoch caller gets a
``redirect`` response, a dead/open-breaker owner gets a counted and
journaled ``cluster.unavailable`` shed.  Nothing falls back silently
(SVOC014).

Migration (:meth:`migrate`) is drain → ship → adopt, each boundary a
named fault point (:mod:`svoc_torch.durability.faultspace`):

1. **drain** — per-claim :meth:`Replica.drain_claim`: the old owner
   flushes the claim's admitted queue and journals the un-servable
   remainder as ``serving.deferred`` (the never-silent accounting).
2. **ship** — the claim's snapshot slice detaches
   (:meth:`Replica.ship_claim`); a fault between ship and adopt
   quarantines the slice through ``restore_multi_session``'s orphan
   path — never dropped, never double-owned.
3. **adopt** — the new owner replays the cluster-shared chain log
   (digest dedup ⇒ zero duplicate txs) and restores the slice; the
   lineage cursor must arrive exactly (``continuity`` check: the next
   fetch mints claim N+1 on the new owner).
4. the placement epoch bumps and the whole sequence is journaled as
   lineage-carrying ``cluster.migrate`` events.

Failover (:meth:`fail_over`) is recover-then-migrate: a fresh stack
over the dead replica's durable dirs recovers exactly like the
crash-smoke restart (its recovered counters become the accounting
authority for the dead process — the durability plane's convention), then every
owned claim migrates to the rendezvous-chosen survivor.

SVOC011: the retry policy, breakers, placement, and journal are pinned
at construction; :meth:`submit` resolves nothing from the environment.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional

from svoc_torch.cluster.placement import (
    PlacementDirectory,
    PlacementError,
    _hrw_score,
)
from svoc_torch.cluster.replica import Replica, ReplicaDeadError
from svoc_torch.durability import faultspace
from svoc_torch.obsplane.fleet import FleetPlane
from svoc_torch.resilience.breaker import CircuitBreaker, CircuitOpenError
from svoc_torch.resilience.faults import InjectedFault
from svoc_torch.resilience.retry import RetryPolicy, call_with_retry
from svoc_torch.utils.checkpoint import restore_multi_session
from svoc_torch.utils.events import resolve_journal


class MigrationContinuityError(RuntimeError):
    """The adopted lineage cursor disagrees with the shipped one — the
    new owner would re-mint or skip lineage ids.  Never expected; the
    adopt event carries the evidence either way."""


class ClusterRouter:
    """Routes submits/cycles across replicas; owns migration/failover."""

    def __init__(
        self,
        placement: PlacementDirectory,
        *,
        journal=None,
        metrics=None,
        clock: Optional[Callable[[], float]] = None,
        retry: Optional[RetryPolicy] = None,
        breaker_factory: Optional[Callable[[str], CircuitBreaker]] = None,
        replica_factory: Optional[Callable[[str], Replica]] = None,
        lineage_scope: str = "clu",
        unclaimed_path: Optional[str] = None,
        epochs_path: Optional[str] = None,
        fleet_plane: Optional[FleetPlane] = None,
    ):
        from svoc_torch.utils.metrics import registry as default_registry

        self._placement = placement
        self._journal = resolve_journal(journal)
        self._metrics = metrics if metrics is not None else default_registry
        self._clock = clock if clock is not None else time.monotonic
        # Virtual clocks advance instead of blocking; a real clock
        # sleeps for real (both pinned here — SVOC011).
        advance = getattr(self._clock, "advance", None)
        self._sleep: Callable[[float], None] = (
            advance if callable(advance) else time.sleep
        )
        self._retry = (
            retry
            if retry is not None
            else RetryPolicy(
                max_attempts=2, base_s=0.0, cap_s=0.0, jitter_seed=0
            )
        )
        self._breaker_factory = breaker_factory or (
            lambda rid: CircuitBreaker(
                f"cluster-{rid}",
                failure_threshold=3,
                reset_timeout_s=5.0,
                clock=self._clock,
                registry=self._metrics,
                journal=self._journal,
            )
        )
        #: Rebuilds a replica stack over its existing durable dirs —
        #: the failover recovery path.  The scenario that constructed
        #: the fleet pins it; without one, fail_over refuses.
        self._replica_factory = replica_factory
        self._lineage_scope = lineage_scope
        self._unclaimed_path = unclaimed_path
        self._replicas: Dict[str, Replica] = {}
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._claims: Dict[str, Any] = {}
        #: Accounting harvested from failed-over replicas: the
        #: recovered durable counters are the authority for the dead
        #: process (the durability plane's convention) — fleet totals
        #: fold these in.  Reconfiguration harvests superseded stacks
        #: here too, keyed ``<rid>@e<epoch>`` (:mod:`~svoc_torch.cluster.reconfig`).
        self._retired: Dict[str, Dict[str, Any]] = {}
        #: Replicas whose traffic is currently DEFERRED at the router
        #: (a live-reconfig transition holds the owner; requests queue
        #: here instead of shedding) plus the global FIFO of held
        #: submissions — released in original order on commit or abort.
        self._holds: set = set()
        self._deferred: List[tuple] = []
        #: The fleet's reconfiguration epoch chain (:mod:`~svoc_torch.cluster.reconfig`): one
        #: committed entry per transition — the plan fingerprint and
        #: the PRE-transition fleet fingerprint — folded into
        #: :meth:`fleet_fingerprint`, so the transition itself is part
        #: of replay identity.  Aborted transitions never append.
        #: The fleet observability plane — hop chains, merged
        #: telemetry, anomaly sampling.  SVOC011: resolved here at construction (a default
        #: plane resolves its own enabled flag); disabled, every hook
        #: is one attribute check and the journal byte stream is
        #: untouched.
        self._fleet = (
            fleet_plane
            if fleet_plane is not None
            else FleetPlane(clock=self._clock)
        )
        self._fleet.register_source("router", registry=self._metrics)
        self._epochs_path = epochs_path
        self._reconfig_epoch = 0
        self._epoch_chain: List[Dict[str, Any]] = []
        if epochs_path is not None and os.path.exists(epochs_path):
            with open(epochs_path) as f:
                payload = json.load(f)
            self._epoch_chain = list(payload.get("chain", []))
            self._reconfig_epoch = int(
                payload.get("epoch", len(self._epoch_chain))
            )

    # -- membership ----------------------------------------------------------

    def add_replica(self, replica: Replica) -> None:
        rid = replica.replica_id
        self._replicas[rid] = replica
        self._breakers[rid] = self._breaker_factory(rid)
        self._placement.add_replica(rid)
        self._register_obs_source(replica)

    def _register_obs_source(self, replica: Replica) -> None:
        """Register a replica stack as a fleet-plane telemetry source:
        its registry joins the merge and its ``obs*.jsonl`` sidecar
        (non-fsynced — derived telemetry) receives its side of each
        hop."""
        self._fleet.register_source(
            replica.replica_id,
            registry=replica.metrics,
            trace_path=getattr(replica, "obs_path", None),
        )

    @property
    def fleet_plane(self) -> FleetPlane:
        return self._fleet

    def replace_replica(
        self,
        replica_id: str,
        replica: Replica,
        *,
        retire_key: Optional[str] = None,
    ) -> Replica:
        """Swap a NEW stack in under an existing roster slot — the
        reconfiguration commit.  The old stack is harvested under
        ``retire_key`` (its recovered durable counters and journal
        fingerprints stay authoritative for the superseded epoch); the
        slot's breaker survives — transport health is a property of the
        slot, not the stack behind it."""
        old = self._replicas[replica_id]
        if retire_key is not None:
            self._harvest(retire_key, old)
        self._replicas[replica_id] = replica
        self._register_obs_source(replica)
        return old

    def replica(self, replica_id: str) -> Replica:
        return self._replicas[replica_id]

    def replica_ids(self) -> List[str]:
        return sorted(self._replicas)

    def add_claim(self, spec) -> str:
        """Register a claim fleet-wide: placement decides the owner."""
        cid = spec.claim_id
        self._claims[cid] = spec
        owner = self._placement.owner(cid)
        self._replicas[owner].add_claim(spec)
        return owner

    def claim_ids(self) -> List[str]:
        return sorted(self._claims)

    def claim_spec(self, claim_id: str):
        return self._claims[claim_id]

    def _lineage_prefix(self, claim_id: str) -> str:
        return f"blk{self._lineage_scope}-{claim_id}"

    # -- the forwarding plane ------------------------------------------------

    def submit(
        self, claim_id: str, text: str, *, epoch: Optional[int] = None
    ) -> Dict[str, Any]:
        """Forward one ``/api/submit`` to the owning replica.

        ``epoch`` is the placement epoch the caller resolved under
        (None = trust the router).  A stale epoch returns a typed
        ``redirect`` carrying the current owner — the caller re-resolves
        instead of the router silently re-routing a request the caller
        addressed to somebody else."""
        current = self._placement.epoch
        if epoch is not None and int(epoch) != current:
            owner = self._placement.owner(claim_id)
            self._metrics.counter(
                "cluster_redirects", labels={"claim": claim_id}
            ).add(1)
            self._journal.emit(
                "cluster.redirect",
                lineage=self._lineage_prefix(claim_id),
                claim=claim_id,
                presented_epoch=int(epoch),
                epoch=current,
                owner=owner,
            )
            self._fleet.hop_refused(
                claim_id,
                lineage=self._lineage_prefix(claim_id),
                reason="redirect",
                outcome="redirect",
                target=owner,
                presented_epoch=int(epoch),
                epoch=current,
            )
            return {
                "status": "redirect",
                "claim": claim_id,
                "reason": "stale_epoch",
                "epoch": current,
                "owner": owner,
            }
        owner = self._placement.owner(claim_id)
        if owner in self._holds:
            # Live-reconfig transition in flight on the owner: DEFER,
            # never shed (the reconfiguration plane's hold).  Deliberately NOT journaled — an aborted transition must leave every
            # fingerprint byte-identical to never-attempted, and the
            # held request replays through this very method on release,
            # producing exactly the journal the direct path would have.
            # The counter is the SVOC014 witness (metrics are not
            # replay-relevant).
            self._metrics.counter(
                "reconfig_deferred", labels={"replica": owner}
            ).add(1)
            self._deferred.append((claim_id, text))
            # Obs-channel only, like the counter: the released request
            # replays through submit and mints its own forward chain.
            self._fleet.hop_refused(
                claim_id,
                lineage=self._lineage_prefix(claim_id),
                reason="reconfig-defer",
                outcome="deferred",
                target=owner,
                epoch=current,
            )
            return {
                "status": "deferred",
                "claim": claim_id,
                "replica": owner,
                "reason": "reconfig",
                "epoch": current,
            }
        replica = self._replicas.get(owner)
        if replica is None or not replica.alive:
            self._fleet.hop_refused(
                claim_id,
                lineage=self._lineage_prefix(claim_id),
                reason="forward",
                outcome="unavailable",
                target=owner,
                cause="replica_down",
            )
            return self._shed(claim_id, owner, "replica_down")
        if not replica.has_claim(claim_id):
            # The HTTP 404 contract (unknown claim), kept OUTSIDE the
            # breaker guard — a caller's typo is not replica failure.
            raise KeyError(claim_id)
        breaker = self._breakers[owner]
        hop = self._fleet.hop_begin(
            claim_id,
            lineage=self._lineage_prefix(claim_id),
            origin="router",
            target=owner,
            reason="forward",
        )

        def send() -> Dict[str, Any]:
            # The send record lands BEFORE the fault point: a request
            # cut down inside the transport call leaves the unanswered
            # send as its mid-hop-death evidence.
            self._fleet.hop_send(hop)
            faultspace.fault_point(
                faultspace.CLUSTER_FORWARD_PRE_SEND,
                payload={"claim": claim_id, "replica": owner},
            )
            return replica.submit(claim_id, text)

        try:
            with breaker.guard():
                response = call_with_retry(
                    send,
                    self._retry,
                    op="cluster.forward",
                    retry_on=(InjectedFault, ReplicaDeadError),
                    sleep=self._sleep,
                    clock=self._clock,
                    registry=self._metrics,
                )
        except CircuitOpenError:
            self._fleet.hop_end(
                hop, outcome="unavailable", cause="breaker_open"
            )
            return self._shed(claim_id, owner, "breaker_open")
        except Exception as err:
            # Retry budget exhausted (injected fault, replica died
            # mid-call): a counted, journaled shed — never silent.
            self._fleet.hop_end(
                hop, outcome="unavailable", cause=type(err).__name__
            )
            return self._shed(
                claim_id, owner, "forward_error", error=type(err).__name__
            )
        self._fleet.hop_recv(
            hop,
            status=response.get("status"),
            request=response.get("request_id"),
        )
        self._metrics.counter(
            "cluster_forwarded", labels={"claim": claim_id, "replica": owner}
        ).add(1)
        response = dict(response)
        response["replica"] = owner
        response["epoch"] = current
        return response

    def _shed(
        self,
        claim_id: str,
        replica_id: Optional[str],
        reason: str,
        error: Optional[str] = None,
    ) -> Dict[str, Any]:
        """The explicit degraded path: count + journal, then answer."""
        self._metrics.counter(
            "cluster_unavailable",
            labels={"claim": claim_id, "replica": replica_id or "none"},
        ).add(1)
        data: Dict[str, Any] = {
            "claim": claim_id,
            "replica": replica_id,
            "reason": reason,
        }
        if error is not None:
            data["error"] = error
        self._journal.emit(
            "cluster.unavailable",
            lineage=self._lineage_prefix(claim_id),
            **data,
        )
        return {"status": "unavailable", "epoch": self._placement.epoch, **data}

    def hold_replica(self, replica_id: str) -> None:
        """Start deferring this replica's traffic (transition begin)."""
        self._holds.add(replica_id)

    def holding(self) -> List[str]:
        return sorted(self._holds)

    def deferred_count(self) -> int:
        return len(self._deferred)

    def release_holds(self) -> List[Dict[str, Any]]:
        """End every hold and replay the deferred submissions in their
        original arrival order through the normal forwarding path —
        the single release point for both commit (requests land on the
        re-pinned stacks) and abort (requests land on the old stacks,
        producing the exact journal a never-attempted run would)."""
        self._holds.clear()
        deferred, self._deferred = self._deferred, []
        return [self.submit(cid, text) for cid, text in deferred]

    def step_all(self) -> Dict[str, Any]:
        """One pull-mode serving cycle on every live replica, roster
        order — the cluster twin of ``ServingTier.step``."""
        reports: Dict[str, Any] = {}
        live: Dict[str, Any] = {"router": self._metrics}
        for rid in sorted(self._replicas):
            replica = self._replicas[rid]
            if not replica.alive:
                continue
            replica.step()
            reports[rid] = {"steps": replica.tier.steps}
            live[rid] = replica.metrics
        # The fleet plane samples on this cadence: SLO evaluation over
        # one merge, accounting history, anomaly detection over the
        # LIVE sources only (a dead stack's frozen registry is not a
        # signal — its last scrape already is).
        self._fleet.on_step(live)
        return reports

    # -- migration -----------------------------------------------------------

    def migrate(
        self, claim_id: str, target_id: str, *, reason: str = "operator"
    ) -> Dict[str, Any]:
        """Move ``claim_id`` to ``target_id``: drain → ship → adopt →
        epoch bump, journaled as a ``cluster.migrate`` sequence."""
        if claim_id not in self._claims:
            raise KeyError(claim_id)
        source_id = self._placement.owner(claim_id)
        source = self._replicas.get(source_id)
        if source is None or not source.alive:
            raise PlacementError(
                f"claim {claim_id!r} owner {source_id!r} is down — "
                "use fail_over, not migrate"
            )
        if source_id == target_id:
            raise ValueError(f"claim {claim_id!r} already on {target_id!r}")
        return self._migrate_from(source, claim_id, target_id, reason)

    def _migrate_from(
        self, source: Replica, claim_id: str, target_id: str, reason: str
    ) -> Dict[str, Any]:
        prefix = self._lineage_prefix(claim_id)
        source_id = source.replica_id
        payload = {"claim": claim_id, "source": source_id, "target": target_id}
        self._journal.emit(
            "cluster.migrate",
            lineage=prefix,
            phase="drain",
            reason=reason,
            epoch=self._placement.epoch,
            **payload,
        )
        faultspace.fault_point(
            faultspace.CLUSTER_MIGRATE_PRE_DRAIN, payload=payload
        )
        drain_report = source.drain_claim(claim_id)
        entry = source.ship_claim(claim_id)
        shipped_cursor = int(entry["session"]["fetch_claim"])
        self._journal.emit(
            "cluster.migrate",
            lineage=prefix,
            phase="ship",
            cycles=entry["cycles"],
            cursor=shipped_cursor,
            deferred=drain_report["deferred"],
            **payload,
        )
        hop = self._fleet.hop_begin(
            claim_id,
            lineage=prefix,
            origin=source_id,
            target=target_id,
            reason="failover" if reason == "failover" else "migrate",
        )
        self._fleet.hop_send(
            hop,
            cursor=shipped_cursor,
            cycles=entry["cycles"],
            deferred=drain_report["deferred"],
            cause=reason,
        )
        target = self._replicas.get(target_id)
        if (
            target is None
            or not target.alive
            or target_id not in self._placement.replicas()
        ):
            self._fleet.hop_end(
                hop, outcome="quarantined", cause="missing_target"
            )
            return self._quarantine(
                source, claim_id, entry, target_id, prefix, "missing_target"
            )
        try:
            faultspace.fault_point(
                faultspace.CLUSTER_MIGRATE_POST_SHIP, payload=payload
            )
            faultspace.fault_point(
                faultspace.CLUSTER_MIGRATE_PRE_ADOPT, payload=payload
            )
            adopt_report = target.adopt_claim(claim_id, entry)
        except InjectedFault as err:
            # The slice is detached but not adopted — quarantine it
            # (orphan path), never drop it or leave two live owners.
            self._fleet.hop_end(
                hop, outcome="quarantined", cause=type(err).__name__
            )
            return self._quarantine(
                source, claim_id, entry, target_id, prefix, type(err).__name__
            )
        continuity = (
            claim_id in adopt_report["restored"]
            and adopt_report["cursor"] == shipped_cursor
        )
        self._fleet.hop_recv(
            hop, cursor=adopt_report["cursor"], continuity=continuity
        )
        epoch = self._placement.assign(claim_id, target_id)
        self._metrics.counter(
            "cluster_migrations",
            labels={"claim": claim_id, "replica": target_id},
        ).add(1)
        self._journal.emit(
            "cluster.migrate",
            lineage=prefix,
            phase="adopt",
            cursor=adopt_report["cursor"],
            continuity=continuity,
            epoch=epoch,
            **payload,
        )
        if not continuity:
            raise MigrationContinuityError(
                f"claim {claim_id!r}: shipped cursor {shipped_cursor} != "
                f"adopted {adopt_report['cursor']} "
                f"(restored={adopt_report['restored']})"
            )
        return {
            "status": "migrated",
            "claim": claim_id,
            "source": source_id,
            "target": target_id,
            "epoch": epoch,
            "cursor": shipped_cursor,
            "drain": drain_report,
            "continuity": continuity,
        }

    def _quarantine(
        self,
        source: Replica,
        claim_id: str,
        entry: Dict[str, Any],
        target_id: str,
        prefix: str,
        cause: str,
    ) -> Dict[str, Any]:
        """Route the detached slice through ``restore_multi_session``'s
        orphan path (the claim is no longer live on the source, so the
        restore quarantines it) and persist the quarantine durable."""
        payload = {
            "version": 1,
            "router_steps": source.multi.router.steps,
            "claims": {claim_id: dict(entry)},
            "unclaimed": {},
        }
        membership = restore_multi_session(payload, source.multi)
        merged: Dict[str, Any] = {}
        if self._unclaimed_path is not None:
            if os.path.exists(self._unclaimed_path):
                with open(self._unclaimed_path) as f:
                    merged = json.load(f)
            merged.update(payload["unclaimed"])
            tmp = self._unclaimed_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(merged, f, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._unclaimed_path)
        else:
            merged = payload["unclaimed"]
        self._metrics.counter(
            "cluster_quarantined", labels={"claim": claim_id}
        ).add(1)
        self._journal.emit(
            "cluster.migrate",
            lineage=prefix,
            phase="quarantine",
            claim=claim_id,
            source=source.replica_id,
            target=target_id,
            reason=cause,
            unclaimed=membership["unclaimed"],
        )
        return {
            "status": "quarantined",
            "claim": claim_id,
            "target": target_id,
            "reason": cause,
            "unclaimed": sorted(merged),
        }

    # -- failover ------------------------------------------------------------

    def fail_over(self, dead_id: str) -> Dict[str, Any]:
        """Recover-then-migrate a dead replica's claims to survivors.

        A fresh stack over the dead replica's durable dirs recovers the
        pre-death state (snapshot + journal tail + WAL reconcile — the
        crash-smoke restart), its recovered counters are harvested as
        the dead process's accounting authority, and every owned claim
        drains/ships/adopts onto its rendezvous-chosen survivor."""
        dead = self._replicas.get(dead_id)
        if dead is None:
            raise PlacementError(f"unknown replica {dead_id!r}")
        if dead.alive:
            raise ValueError(
                f"replica {dead_id!r} is alive — drain/migrate instead"
            )
        if self._replica_factory is None:
            raise RuntimeError(
                "fail_over needs the replica_factory pinned at construction"
            )
        survivors = [
            rid
            for rid in sorted(self._replicas)
            if rid != dead_id and self._replicas[rid].alive
        ]
        if not survivors:
            raise PlacementError("no surviving replica to fail over onto")
        owned = sorted(
            cid
            for cid in self._claims
            if self._placement.owner(cid) == dead_id
        )
        self._journal.emit(
            "cluster.failover",
            replica=dead_id,
            phase="start",
            claims=owned,
            epoch=self._placement.epoch,
        )
        recovery = self._replica_factory(dead_id)
        for cid in owned:
            recovery.add_claim(self._claims[cid])
        recovery_report = recovery.recover()
        moved: Dict[str, Any] = {}
        for cid in owned:
            target_id = max(
                survivors, key=lambda rid: (_hrw_score(cid, rid), rid)
            )
            moved[cid] = self._migrate_from(
                recovery, cid, target_id, reason="failover"
            )
        # Harvest BEFORE discarding: the recovered durable counters and
        # the recovered journal are the dead process's accounting and
        # replay identity.
        self._harvest(dead_id, recovery)
        del self._replicas[dead_id]
        del self._breakers[dead_id]
        epoch = self._placement.remove_replica(dead_id)
        self._metrics.counter(
            "cluster_failovers", labels={"replica": dead_id}
        ).add(1)
        self._journal.emit(
            "cluster.failover",
            replica=dead_id,
            phase="done",
            claims=owned,
            targets={cid: moved[cid].get("target") for cid in owned},
            epoch=epoch,
        )
        return {
            "replica": dead_id,
            "claims": moved,
            "epoch": epoch,
            "recovery": recovery_report,
        }

    def _harvest(self, key: str, replica: Replica) -> None:
        """Fold a stack's durable counters + journal fingerprints into
        the retired ledger before it stops serving (failover, retire,
        reconfig epoch supersession — one discipline for all three).
        The counters snapshot also retires the stack's fleet-merge
        entry under ``replica="<key>@retired"`` so fleet totals never
        step backward across a failover."""
        counters = replica.metrics.counters_snapshot()
        observations = self._fleet.retire_source(
            key, replica.replica_id, counters
        )
        self._retired[key] = {
            "requests": replica.request_accounting(),
            "journal_fingerprint": replica.journal.fingerprint(),
            "journal_events": replica.journal.last_seq(),
            "counters": counters,
            "observations": observations,
            "claims": {
                cid: replica.claim_journal_fingerprint(
                    self._lineage_prefix(cid) + "-"
                )
                for cid in sorted(self._claims)
            },
        }

    # -- roster growth / retirement -------------------------------------------

    def grow(self, replica: Replica) -> Dict[str, Any]:
        """Add a replica to a LIVE fleet with bounded rendezvous
        rebalance: only claims whose HRW owner becomes the newcomer
        migrate (adding a replica never changes the relative order of
        the incumbents' scores); explicitly pinned claims stay put.
        Each move rides the full drain → ship → adopt migration path
        with its continuity check."""
        rid = replica.replica_id
        if rid in self._replicas:
            raise ValueError(f"replica {rid!r} already in the roster")
        old_roster = self._placement.replicas()
        explicit = self._placement.assignments()
        new_roster = sorted(old_roster + [rid])
        moves: List[tuple] = []
        for cid in sorted(self._claims):
            if cid in explicit:
                continue
            old_owner = max(
                old_roster, key=lambda r: (_hrw_score(cid, r), r)
            )
            new_owner = max(
                new_roster, key=lambda r: (_hrw_score(cid, r), r)
            )
            if new_owner != old_owner:
                moves.append((cid, old_owner))
        self._replicas[rid] = replica
        self._breakers[rid] = self._breaker_factory(rid)
        self._register_obs_source(replica)
        epoch = self._placement.add_replica(rid)
        self._journal.emit(
            "cluster.grow",
            replica=rid,
            phase="start",
            moves=[cid for cid, _ in moves],
            epoch=epoch,
        )
        moved: Dict[str, Any] = {}
        for cid, source_id in moves:
            moved[cid] = self._migrate_from(
                self._replicas[source_id], cid, rid, reason="growth"
            )
        self._metrics.counter(
            "cluster_grown", labels={"replica": rid}
        ).add(1)
        epoch = self._placement.epoch
        self._journal.emit(
            "cluster.grow",
            replica=rid,
            phase="done",
            moves=[cid for cid, _ in moves],
            epoch=epoch,
        )
        return {
            "status": "grown",
            "replica": rid,
            "moved": moved,
            "epoch": epoch,
        }

    def retire_replica(
        self, replica_id: str, *, retire_key: Optional[str] = None
    ) -> Dict[str, Any]:
        """Drain a LIVE replica out of the roster: every owned claim
        migrates to its rendezvous-best survivor (full continuity
        checks), the stack's accounting is harvested, and the roster
        shrinks — the graceful twin of :meth:`fail_over`."""
        replica = self._replicas.get(replica_id)
        if replica is None:
            raise PlacementError(f"unknown replica {replica_id!r}")
        if not replica.alive:
            raise ValueError(
                f"replica {replica_id!r} is dead — fail_over, not retire"
            )
        survivors = [
            rid
            for rid in sorted(self._replicas)
            if rid != replica_id and self._replicas[rid].alive
        ]
        if not survivors:
            raise PlacementError("cannot retire the last live replica")
        owned = sorted(
            cid
            for cid in self._claims
            if self._placement.owner(cid) == replica_id
        )
        moved: Dict[str, Any] = {}
        for cid in owned:
            target_id = max(
                survivors, key=lambda rid: (_hrw_score(cid, rid), rid)
            )
            moved[cid] = self._migrate_from(
                replica, cid, target_id, reason="retire"
            )
        self._harvest(retire_key or replica_id, replica)
        del self._replicas[replica_id]
        del self._breakers[replica_id]
        epoch = self._placement.remove_replica(replica_id)
        self._metrics.counter(
            "cluster_retired", labels={"replica": replica_id}
        ).add(1)
        self._journal.emit(
            "cluster.retire",
            replica=replica_id,
            claims=owned,
            targets={cid: moved[cid].get("target") for cid in owned},
            epoch=epoch,
        )
        return {
            "status": "retired",
            "replica": replica_id,
            "claims": moved,
            "epoch": epoch,
        }

    # -- orphan re-adoption ---------------------------------------------------

    def adopt_orphans(self) -> Dict[str, Any]:
        """Re-adopt quarantined migration slices from ``unclaimed.json``
        back into the fleet — the way back from the orphan path, so a
        quarantine is recoverable rather than terminal.  Each slice
        adopts onto the claim's CURRENT placement owner through the
        documented :meth:`Replica.adopt_claim` path (shared-chain
        replay + restore), with the same lineage-continuity check a
        migration gets; slices that cannot adopt (unknown claim, owner
        down, claim already live) stay quarantined with a typed
        reason."""
        if self._unclaimed_path is None or not os.path.exists(
            self._unclaimed_path
        ):
            return {"adopted": {}, "remaining": {}}
        with open(self._unclaimed_path) as f:
            unclaimed: Dict[str, Any] = json.load(f)
        adopted: Dict[str, Any] = {}
        remaining: Dict[str, Any] = {}
        skipped: Dict[str, str] = {}
        for cid in sorted(unclaimed):
            entry = unclaimed[cid]
            if cid not in self._claims:
                remaining[cid] = entry
                skipped[cid] = "unknown_claim"
                continue
            owner = self._placement.owner(cid)
            replica = self._replicas.get(owner)
            if replica is None or not replica.alive:
                remaining[cid] = entry
                skipped[cid] = "owner_down"
                continue
            if replica.has_claim(cid):
                # A live owner already serves this claim — adopting the
                # stale slice would fork its lineage.  Never silent.
                remaining[cid] = entry
                skipped[cid] = "claim_live"
                continue
            shipped_cursor = int(entry["session"]["fetch_claim"])
            report = replica.adopt_claim(cid, dict(entry))
            continuity = (
                cid in report["restored"]
                and report["cursor"] == shipped_cursor
            )
            if not continuity:
                raise MigrationContinuityError(
                    f"orphan {cid!r}: quarantined cursor {shipped_cursor} "
                    f"!= adopted {report['cursor']}"
                )
            epoch = self._placement.assign(cid, owner)
            self._metrics.counter(
                "cluster_adopted", labels={"claim": cid}
            ).add(1)
            self._journal.emit(
                "cluster.adopt",
                lineage=self._lineage_prefix(cid),
                claim=cid,
                replica=owner,
                cursor=report["cursor"],
                epoch=epoch,
            )
            adopted[cid] = {
                "replica": owner,
                "cursor": report["cursor"],
                "continuity": True,
            }
        tmp = self._unclaimed_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(remaining, f, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._unclaimed_path)
        return {
            "adopted": adopted,
            "remaining": {cid: skipped[cid] for cid in sorted(remaining)},
        }

    # -- identity / operator plane -------------------------------------------

    def claim_fingerprint(self, claim_id: str) -> str:
        """Fold the claim's lineage-family journal slice across every
        replica that ever served it (live + retired) — byte-identical
        across same-seed replays iff every forwarding and failover
        decision replayed identically."""
        prefix = self._lineage_prefix(claim_id) + "-"
        parts: Dict[str, str] = {
            rid: self._replicas[rid].claim_journal_fingerprint(prefix)
            for rid in sorted(self._replicas)
        }
        for rid in sorted(self._retired):
            parts[f"retired:{rid}"] = self._retired[rid]["claims"].get(
                claim_id, ""
            )
        return hashlib.sha256(
            json.dumps(sorted(parts.items())).encode()
        ).hexdigest()

    @property
    def reconfig_epoch(self) -> int:
        return self._reconfig_epoch

    def epoch_chain(self) -> List[Dict[str, Any]]:
        return [dict(e) for e in self._epoch_chain]

    def record_epoch(self, entry: Dict[str, Any]) -> int:
        """Append one COMMITTED reconfiguration to the fleet epoch
        chain (plan fingerprint + pre-transition fleet fingerprint) and
        persist it atomically.  Called exactly once per committed
        transition, after the pre_resume fault point — an aborted
        transition never reaches this, which is what keeps abort
        invisible to :meth:`fleet_fingerprint`."""
        self._reconfig_epoch += 1
        self._epoch_chain.append(
            {"epoch": self._reconfig_epoch, **dict(entry)}
        )
        if self._epochs_path is not None:
            payload = {
                "version": 1,
                "epoch": self._reconfig_epoch,
                "chain": self._epoch_chain,
            }
            tmp = self._epochs_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(payload, f, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._epochs_path)
        return self._reconfig_epoch

    def fleet_fingerprint(self) -> str:
        """The whole-fleet replay digest: per-claim fingerprints, the
        cluster journal (every redirect/shed/migrate/failover), the
        placement content, the epoch, and the reconfiguration epoch
        chain (every committed transition's plan + pre-state)."""
        payload = {
            "claims": {
                cid: self.claim_fingerprint(cid) for cid in sorted(self._claims)
            },
            "cluster_journal": self._journal.fingerprint(),
            "placement": self._placement.fingerprint(),
            "epoch": self._placement.epoch,
            "retired": {
                rid: self._retired[rid]["journal_fingerprint"]
                for rid in sorted(self._retired)
            },
            "reconfig": {
                "epoch": self._reconfig_epoch,
                "chain": self._epoch_chain,
            },
        }
        return hashlib.sha256(
            json.dumps(payload, sort_keys=True).encode()
        ).hexdigest()

    def fleet_accounting(self) -> Dict[str, Any]:
        """At-least-once accounting across live AND retired replicas
        (recovered durable counts are the authority for the dead),
        plus the observation-channel ledger: per-source record counts,
        last obs seq, and writer-error drops — a truncated sidecar
        must show up here, not as a diff of missing lines."""
        totals: Dict[str, Any] = {
            "admitted": 0.0,
            "completed": 0.0,
            "dropped": 0.0,
            "cached": 0.0,
        }
        for rid in sorted(self._replicas):
            for key, value in self._replicas[rid].request_accounting().items():
                totals[key] += value
        for rid in sorted(self._retired):
            for key, value in self._retired[rid]["requests"].items():
                totals[key] += value
        totals["unaccounted"] = max(
            0.0, totals["admitted"] - totals["completed"] - totals["dropped"]
        )
        totals["observations"] = {
            "live": self._fleet.obs_accounting(),
            "retired": {
                rid: self._retired[rid].get("observations")
                for rid in sorted(self._retired)
            },
        }
        return totals

    def snapshot(self) -> Dict[str, Any]:
        """The ``/api/state`` cluster section: roster, epoch, per-
        replica health + breaker state."""
        return {
            "epoch": self._placement.epoch,
            "placement": self._placement.snapshot(),
            "claims": {
                cid: self._placement.owner(cid) for cid in sorted(self._claims)
            },
            "replicas": {
                rid: {
                    **self._replicas[rid].snapshot(),
                    "breaker": self._breakers[rid].state(),
                }
                for rid in sorted(self._replicas)
            },
            "retired": sorted(self._retired),
            "reconfig": {
                "epoch": self._reconfig_epoch,
                "transitions": len(self._epoch_chain),
                "holding": self.holding(),
                "deferred": len(self._deferred),
            },
        }

    def attach(self, console) -> None:
        """Wire into the operator console (the ``cluster`` command and
        the ``/api/state`` cluster section; ``router.py:1055``)."""
        console.cluster = self
