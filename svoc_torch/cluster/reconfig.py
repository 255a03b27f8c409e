"""Live reconfiguration plane: transactional re-pin of a serving fleet.

Mirrors :mod:`svoc_tpu.cluster.reconfig` (``reconfig.py:1-714``):
:class:`ReconfigError`, :class:`ReconfigPlan` (``:106``) and
:class:`ReconfigController` (``:229``) with its ``apply`` (``:310``),
``_prepare`` (``:389``), ``_transition_one`` (``:438``), ``_drain``
(``:524``), ``_rollback`` (``:548``) and ``_commit`` (``:584``): the same
gates at the same boundaries, the same journal events
(``reconfig.epoch``, ``cluster.reconfig``) and the same report keys.
Where the port departs:

- the plan's knob names are checked against the reference's own lists
  (:data:`REFERENCE_CONSENSUS_IMPLS`, the commit modes), so a plan's
  :meth:`~ReconfigPlan.to_dict` and :meth:`~ReconfigPlan.fingerprint`
  equal the reference's byte for byte; but :meth:`ReconfigPlan.validate`
  refuses, before any phase starts, a ``consensus_impl`` (the port has
  one route per device, so there is nothing to re-pin) and a claim
  ``mesh`` the fleet's device cannot hold (more slots than
  :func:`svoc_torch.parallel.mesh.mesh_devices` lists), which the
  reference finds only when the re-pin builds a stack;
- the builder is always handed ``consensus_impl=None``: a replica's
  pinned ``consensus_impl`` is its route (``"cuda"`` or ``"plain"``),
  which its device decides;
- PREPARE warms the pending configuration's universe
  (:func:`svoc_torch.compile.universe.pending_universe` with the route
  as the impl, the pending mesh, and the fleet's donate flag) through
  :func:`svoc_torch.compile.prewarm.warm_keys`: on CUDA that builds or
  loads the serving libraries (B3, flash, threefry, the fleet draws),
  then primes one all-padding B3 launch for each dispatch group the plan
  brings that the fleet does not serve yet (a re-spec to 9 oracles adds ``(9, 6)``).
  Every stack the transition builds gets those keys marked warm, so its
  first dispatch of them counts ``prewarmed``.  On the CPU there is
  nothing to build, nothing is primed, and the first dispatches count
  ``cold``, as the reference's do;
- a replica's staged state joins the rollback list before its slices
  ship.  The reference appends it only when the replica's whole
  transition returns (``reconfig.py:353-357``), so a fault at
  ``reconfig.post_ship`` or ``reconfig.pre_repin``, or in the re-pin, on
  a replica that owns claims never re-adopts that replica's shipped
  slices: the claims are gone from every stack, and its rollback's
  release of held requests raises ``KeyError`` there, against the
  invariant the two points declare.  Where the reference rolls back,
  the port gives its result;
- the rollback re-adopts a replica's shipped claims in the order they
  sat in its registry and with their own spec objects, where the
  reference re-adopts them sorted (``reconfig.py:568``) and rebuilds
  each spec from the slice's dict.  The registry's order is the order a
  stack serves its claims in, and journal seqs are global to a stack, so
  after the reference's rollback a replica whose claims were not
  registered in sorted order serves them in another order than before;
  and a spec's ``tamper`` hook (a callable, which the dict cannot carry)
  is gone.  Either way every per-claim fingerprint (which carries the
  seqs) leaves the never-attempted run's at the next step; the port's
  equal it.  Where the orders agree and no claim has a hook (the
  reconfig smoke's fleets), so do the results;
- :meth:`ReconfigController.attach` wires it into the operator console
  (:mod:`svoc_torch.apps.commands`).

Every knob a stack replays under (commit mode, per-claim
:class:`~svoc_torch.fabric.registry.ClaimSpec`) is pinned at
construction, so changing one on a RUNNING fleet means constructing a new
stack and moving the claims across, transactionally:

========  ==============================================================
phase     what happens (fault point fired at its exit boundary)
========  ==============================================================
PREPARE   validate the plan; prewarm the PENDING config's universe so
          the post-transition fleet dispatches warm (``reconfig.prepare``)
DRAIN     per replica: hold its traffic at the router (DEFERRED, not
          shed — no journal record) and flush the serving queues empty
          (``reconfig.post_drain``)
SHIP      per replica: detach every owned claim's migration slice with
          WAL-reconciled lineage cursors (``reconfig.post_ship``)
RE-PIN    per replica: construct the new stack under the NEXT
          fingerprint epoch (fresh ``trace-e<N>.jsonl`` /
          ``wal-e<N>.jsonl``) and adopt the slices onto it,
          continuity-checked (``reconfig.pre_repin`` fires before the
          build)
RESUME    commit: swap the new stacks in, harvest the old ones into the
          retired ledger, emit the epoch-0 continuity records, apply
          roster growth / retirement, append the fleet epoch-chain
          entry, and release every held request in arrival order
          (``reconfig.pre_resume`` fires before any of it)
========  ==============================================================

**Abort is invisible.**  A fault (injected or operator
:meth:`~ReconfigController.request_abort`) at ANY phase rolls back to a
fleet fingerprint byte-identical to never having attempted the plan: no
phase before RESUME emits a journal event, touches the placement, or
advances the epoch chain; rollback discards the new stacks (their epoch
files were never referenced), re-adopts every slice onto its old stack
and releases the holds, whose replayed submissions produce exactly the
journal the direct path would have.

A plan that grows or shrinks the roster and changes no knob never
re-pins: it reaches only ``reconfig.prepare`` and ``reconfig.pre_resume``
(the per-replica gates sit inside the re-pin), in both packages.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from svoc_torch.cluster.replica import Replica
from svoc_torch.cluster.router import ClusterRouter, MigrationContinuityError
from svoc_torch.durability import faultspace
from svoc_torch.resilience.faults import InjectedFault
from svoc_torch.resilience.retry import validate_commit_mode
from svoc_torch.utils.checkpoint import claim_spec_from_dict, claim_spec_to_dict
from svoc_torch.utils.events import resolve_journal

_MESH_RE = re.compile(r"^\d+x\d+$")

#: The reference's consensus implementations
#: (``svoc_tpu/consensus/dispatch.py:48``): a plan may name one (its
#: fingerprint is the reference's), and the port refuses to carry it out.
REFERENCE_CONSENSUS_IMPLS = ("xla", "pallas")


class ReconfigError(ValueError):
    """The plan cannot be applied as stated (validation failure)."""


class _OperatorAbort(RuntimeError):
    """Raised at the next gate after :meth:`request_abort` — handled
    like an injected fault (full rollback, typed abort report)."""


def _validate_consensus_impl(impl: str) -> None:
    if impl not in REFERENCE_CONSENSUS_IMPLS:
        allowed = ", ".join(repr(v) for v in REFERENCE_CONSENSUS_IMPLS)
        raise ValueError(
            f"consensus_impl {impl!r} (from plan) is not a known consensus "
            f"implementation: allowed values are {allowed}"
        )


def _validate_mesh(spec: Optional[str]) -> Optional[str]:
    if spec is None or spec == "off" or _MESH_RE.match(spec):
        return spec
    raise ReconfigError(f"mesh {spec!r} is not '<claims>x<oracles>' or 'off'")


@dataclasses.dataclass(frozen=True)
class ReconfigPlan:
    """A typed diff of the fleet's pinned knobs.  ``None``/empty means
    "carry the current value"; :meth:`is_noop` plans are rejected by the
    controller rather than minting an empty epoch."""

    consensus_impl: Optional[str] = None
    mesh: Optional[str] = None
    commit_mode: Optional[str] = None
    #: Per-claim spec replacements, ``claim_id -> ClaimSpec``.
    claims: Dict[str, Any] = dataclasses.field(default_factory=dict)
    add_replicas: Tuple[str, ...] = ()
    remove_replicas: Tuple[str, ...] = ()

    def __post_init__(self):
        if self.consensus_impl is not None:
            _validate_consensus_impl(self.consensus_impl)
        if self.commit_mode is not None:
            validate_commit_mode(self.commit_mode, source="plan")
        _validate_mesh(self.mesh)
        object.__setattr__(self, "add_replicas", tuple(self.add_replicas))
        object.__setattr__(self, "remove_replicas", tuple(self.remove_replicas))
        overlap = set(self.add_replicas) & set(self.remove_replicas)
        if overlap:
            raise ReconfigError(f"replicas both added and removed: {sorted(overlap)}")

    def needs_repin(self) -> bool:
        """True when existing stacks must be reconstructed (knob or spec
        changes); pure roster growth/shrink does not re-pin."""
        return (
            self.consensus_impl is not None
            or self.mesh is not None
            or self.commit_mode is not None
            or bool(self.claims)
        )

    def is_noop(self) -> bool:
        return not (self.needs_repin() or self.add_replicas or self.remove_replicas)

    def validate(self, router: ClusterRouter) -> None:
        """What the port cannot carry out, then the fleet-shape checks
        the dataclass alone cannot make."""
        if self.consensus_impl is not None:
            raise ReconfigError(
                f"plan sets consensus_impl={self.consensus_impl!r}: the port has one "
                "route per device (the kernel on CUDA, the plain version on the CPU), "
                "so there is no implementation to re-pin"
            )
        roster = set(router.replica_ids())
        if self.mesh not in (None, "off") and roster:
            from svoc_torch.parallel.mesh import MeshConfigError, claim_mesh

            device = router.replica(sorted(roster)[0]).device
            try:
                claim_mesh(self.mesh, device=device)
            except MeshConfigError as e:
                raise ReconfigError(f"plan sets mesh={self.mesh!r}: {e}") from None
        for cid in self.claims:
            if cid not in router.claim_ids():
                raise ReconfigError(f"plan names unknown claim {cid!r}")
        for rid in self.add_replicas:
            if rid in roster:
                raise ReconfigError(f"plan adds replica {rid!r} already in the roster")
        for rid in self.remove_replicas:
            if rid not in roster:
                raise ReconfigError(f"plan removes unknown replica {rid!r}")
        survivors = roster - set(self.remove_replicas)
        if not survivors and not self.add_replicas:
            raise ReconfigError("plan removes every replica")

    def to_dict(self) -> Dict[str, Any]:
        return {
            "consensus_impl": self.consensus_impl,
            "mesh": self.mesh,
            "commit_mode": self.commit_mode,
            "claims": {
                cid: claim_spec_to_dict(spec)
                for cid, spec in sorted(self.claims.items())
            },
            "add_replicas": list(self.add_replicas),
            "remove_replicas": list(self.remove_replicas),
        }

    @classmethod
    def from_dict(cls, payload: Dict[str, Any]) -> "ReconfigPlan":
        return cls(
            consensus_impl=payload.get("consensus_impl"),
            mesh=payload.get("mesh"),
            commit_mode=payload.get("commit_mode"),
            claims={
                cid: claim_spec_from_dict(d)
                for cid, d in (payload.get("claims") or {}).items()
            },
            add_replicas=tuple(payload.get("add_replicas") or ()),
            remove_replicas=tuple(payload.get("remove_replicas") or ()),
        )

    def fingerprint(self) -> str:
        """Canonical digest of the diff — the epoch-chain entry's plan
        identity (two replays committed the same transition iff these
        agree)."""
        return hashlib.sha256(json.dumps(self.to_dict(), sort_keys=True).encode()).hexdigest()


@dataclasses.dataclass
class _Staged:
    """One replica's in-flight transition state (pre-commit)."""

    replica_id: str
    old: Replica
    entries: Dict[str, Dict[str, Any]]
    new: Optional[Replica] = None
    claims: Dict[str, Dict[str, Any]] = dataclasses.field(default_factory=dict)
    #: The shipped claims in the old stack's registry order (its serving
    #: order) and their spec objects, which the rollback restores.
    order: List[str] = dataclasses.field(default_factory=list)
    specs: Dict[str, Any] = dataclasses.field(default_factory=dict)


#: Builder protocol: ``builder(replica_id, *, fingerprint_epoch,
#: consensus_impl, mesh, commit_mode) -> Replica`` — constructs a stack
#: over the replica's (possibly pre-existing) durable dirs under the given
#: pinned knobs.  The scenario that built the fleet supplies it, exactly
#: like the router's ``replica_factory``.
ReplicaBuilder = Callable[..., Replica]


class ReconfigController:
    """Executes :class:`ReconfigPlan`\\ s against a live fleet."""

    def __init__(
        self,
        router: ClusterRouter,
        *,
        builder: ReplicaBuilder,
        journal=None,
        metrics=None,
        clock: Optional[Callable[[], float]] = None,
        prewarm_budget_s: float = 30.0,
        drain_max_steps: int = 8,
    ):
        from svoc_torch.utils.metrics import registry as default_registry

        self._router = router
        self._builder = builder
        self._journal = resolve_journal(journal)
        self._metrics = metrics if metrics is not None else default_registry
        self._clock = clock if clock is not None else time.monotonic
        self._prewarm_budget_s = prewarm_budget_s
        self._drain_max_steps = drain_max_steps
        self._phase = "idle"
        self._abort_requested = False
        self._last_report: Optional[Dict[str, Any]] = None
        #: The keys the current transition's PREPARE warmed (CUDA only).
        self._warmed: set = set()

    # -- operator surface ----------------------------------------------------

    def status(self) -> Dict[str, Any]:
        """The ``reconfig status`` / ``/api/state`` section."""
        return {
            "phase": self._phase,
            "epoch": self._router.reconfig_epoch,
            "holding": self._router.holding(),
            "deferred": self._router.deferred_count(),
            "chain": self._router.epoch_chain()[-3:],
            "last": self._last_report,
        }

    def request_abort(self) -> Dict[str, Any]:
        """Ask the in-flight transition to abort at its next gate.  A
        no-op (typed) when nothing is in flight."""
        if self._phase == "idle":
            return {"status": "idle", "detail": "no transition in flight"}
        self._abort_requested = True
        return {"status": "abort_requested", "phase": self._phase}

    def attach(self, console) -> None:
        """Expose through a CommandConsole: the ``reconfig`` command and
        ``/api/state``'s reconfig section read ``console.reconfig``."""
        console.reconfig = self

    # -- gates ---------------------------------------------------------------

    def _enter(self, phase: str) -> None:
        self._phase = phase
        self._metrics.counter("reconfig_transitions", labels={"phase": phase}).add(1)
        self._obs("reconfig.phase", phase=phase)

    def _obs(self, kind: str, **data) -> None:
        """Phase breadcrumbs on the fleet plane's observation channel —
        obs-only by design: abort invisibility forbids journaling any
        pre-RESUME phase, but the operator timeline still wants to see
        the attempt."""
        plane = getattr(self._router, "fleet_plane", None)
        if plane is not None and plane.enabled:
            plane.obslog.record(kind, scope="fleet", epoch=self._router.reconfig_epoch, **data)

    def _gate(self, point: str, payload: Dict[str, Any]) -> None:
        if self._abort_requested:
            self._abort_requested = False
            raise _OperatorAbort(point)
        faultspace.fault_point(point, payload=payload)

    # -- the transaction -----------------------------------------------------

    def apply(
        self,
        plan: ReconfigPlan,
        *,
        rolling: bool = True,
        traffic: Optional[Callable[[str, Optional[str]], None]] = None,
    ) -> Dict[str, Any]:
        """Run the full PREPARE → DRAIN → SHIP → RE-PIN → RESUME
        transaction.  ``traffic(stage, replica_id)`` is a test hook fired
        as each stage completes — the scenario injects arrivals through it
        to exercise the defer/release path deterministically.  Any
        exception rolls the fleet back to the pre-plan state; injected
        faults and operator aborts return a typed ``aborted`` report,
        everything else re-raises after the rollback."""
        plan.validate(self._router)
        if plan.is_noop():
            return {"status": "noop"}
        router = self._router
        pre_fleet = router.fleet_fingerprint()
        plan_fp = plan.fingerprint()
        target_epoch = router.reconfig_epoch + 1
        staged: List[_Staged] = []
        prewarm: Dict[str, Any] = {}
        self._warmed = set()
        try:
            self._enter("prepare")
            self._gate(faultspace.RECONFIG_PREPARE, {"plan": plan_fp[:16]})
            prewarm = self._prepare(plan)
            if traffic is not None:
                traffic("prepare", None)
            if plan.needs_repin():
                transition = [
                    rid
                    for rid in router.replica_ids()
                    if router.replica(rid).alive and rid not in plan.remove_replicas
                ]
                if not rolling:
                    for rid in transition:
                        router.hold_replica(rid)
                for rid in transition:
                    self._transition_one(rid, plan, target_epoch, rolling, traffic, staged)
            self._enter("resume")
            if traffic is not None:
                traffic("resume", None)
            self._gate(faultspace.RECONFIG_PRE_RESUME, {"plan": plan_fp[:16]})
        except BaseException as err:
            phase = self._phase
            self._rollback(staged)
            self._phase = "idle"
            self._metrics.counter("reconfig_aborts", labels={"phase": phase}).add(1)
            self._obs("reconfig.aborted", phase=phase, cause=type(err).__name__)
            if isinstance(err, (InjectedFault, _OperatorAbort)):
                self._last_report = {
                    "status": "aborted",
                    "phase": phase,
                    "cause": type(err).__name__,
                    "plan_fingerprint": plan_fp,
                }
                return self._last_report
            raise
        return self._commit(plan, staged, target_epoch, pre_fleet, plan_fp, prewarm)

    # -- phases --------------------------------------------------------------

    def _prepare(self, plan: ReconfigPlan) -> Dict[str, Any]:
        """Prewarm the PENDING config's universe — never journals, and on
        the CPU never dispatches, so an abort after it is still invisible
        (the kernel build directory is not replay state).  On CUDA it
        builds or loads the serving libraries and primes one launch of
        each dispatch group the plan adds."""
        from svoc_torch.compile.prewarm import prime_key, warm_keys
        from svoc_torch.compile.universe import pending_universe
        from svoc_torch.utils.metrics import install_compile_listener
        from svoc_torch.utils.metrics import registry as process_registry

        router = self._router
        live = [rid for rid in router.replica_ids() if router.replica(rid).alive]
        if not live:
            return {"compiled": 0, "skipped": 0, "deferred": 0, "keys": 0,
                    "primed": 0, "builds": 0, "hits": 0}
        ref = router.replica(live[0])
        fabric = ref.multi.router
        current = [router.claim_spec(cid) for cid in router.claim_ids()]
        specs = [plan.claims.get(cid, router.claim_spec(cid)) for cid in router.claim_ids()]
        mesh = plan.mesh if plan.mesh is not None else fabric.mesh_spec
        mesh = None if mesh in (None, "off") else mesh
        keys = pending_universe(
            specs,
            max_claims_per_batch=fabric.max_claims_per_batch,
            sanitized_dispatch=True,
            impl=fabric.consensus_impl,
            donate=fabric.device_resident,
            mesh=mesh,
            mesh_claim_size=int(mesh.split("x", 1)[0]) if mesh is not None else 1,
        )
        install_compile_listener()

        def cache_events() -> Tuple[float, float]:
            return tuple(
                process_registry.counter("kernel_cache_events", labels={"event": e}).count
                for e in ("miss", "hit")
            )

        before = cache_events()
        report = warm_keys(keys, budget_s=self._prewarm_budget_s, clock=self._clock,
                           metrics=self._metrics)
        walked = keys[: len(keys) - report["deferred"]]
        self._warmed = {k for k in walked if k.impl == "cuda"}
        live_groups = {(s.n_oracles, s.dimension, s.consensus_config()) for s in current}
        primed = set()
        for key in keys:
            group = key.group()
            if key in self._warmed and group not in live_groups and group not in primed:
                prime_key(key, fabric.device)
                primed.add(group)
        after = cache_events()
        report.update(keys=len(keys), primed=len(primed), builds=int(after[0] - before[0]),
                      hits=int(after[1] - before[1]))
        return report

    def _mark_warm(self, replica: Replica) -> None:
        """Hand the keys PREPARE warmed to a stack it built: their first
        dispatch there counts ``prewarmed``."""
        if not self._warmed:
            return
        from svoc_torch.compile.prewarm import PrewarmWorker

        fabric = replica.multi.router
        worker = fabric.prewarmer
        if worker is None:
            worker = PrewarmWorker(fabric, replica.multi.registry, metrics=replica.metrics,
                                   clock=self._clock)
            fabric.attach_prewarmer(worker)
        worker.mark_warm(self._warmed)

    def _transition_one(
        self,
        rid: str,
        plan: ReconfigPlan,
        target_epoch: int,
        rolling: bool,
        traffic,
        staged: List[_Staged],
    ) -> _Staged:
        """DRAIN → SHIP → RE-PIN for one replica.  Its staged state joins
        ``staged`` before anything is shipped, so a fault anywhere in the
        replica's own transition rolls its shipped slices back too; the
        stack swap itself waits for the fleet-wide RESUME."""
        router = self._router
        replica = router.replica(rid)
        if rolling:
            router.hold_replica(rid)
        st = _Staged(replica_id=rid, old=replica, entries={})
        staged.append(st)
        self._enter("drain")
        if traffic is not None:
            traffic("drain", rid)
        flushed = self._drain(replica)
        self._gate(faultspace.RECONFIG_POST_DRAIN, {"replica": rid, "flushed": flushed})
        self._enter("ship")
        owned = sorted(cid for cid in router.claim_ids() if replica.has_claim(cid))
        st.order = [cid for cid in replica.multi.claim_ids() if cid in set(owned)]
        st.specs = {cid: replica.multi.get(cid).spec for cid in owned}
        for cid in owned:
            st.entries[cid] = replica.ship_claim(cid)
        if traffic is not None:
            traffic("ship", rid)
        self._gate(faultspace.RECONFIG_POST_SHIP, {"replica": rid, "claims": len(owned)})
        self._enter("repin")
        self._gate(faultspace.RECONFIG_PRE_REPIN, {"replica": rid})
        old_cfg = replica.pinned_config()
        st.new = self._builder(
            rid,
            fingerprint_epoch=target_epoch,
            consensus_impl=None,
            mesh=plan.mesh if plan.mesh is not None else old_cfg["mesh"],
            commit_mode=(
                plan.commit_mode if plan.commit_mode is not None else old_cfg["commit_mode"]
            ),
        )
        self._mark_warm(st.new)
        for cid in owned:
            entry = st.entries[cid]
            shipped_cursor = int(entry["session"]["fetch_claim"])
            new_spec = plan.claims.get(cid)
            if new_spec is not None and claim_spec_to_dict(new_spec) != entry["spec"]:
                report = st.new.adopt_claim_fresh(cid, new_spec, dict(entry))
            else:
                report = st.new.adopt_claim(cid, dict(entry))
            if cid not in report["restored"] or report["cursor"] != shipped_cursor:
                raise MigrationContinuityError(
                    f"re-pin {rid!r}/{cid!r}: shipped cursor "
                    f"{shipped_cursor} != adopted {report['cursor']}"
                )
            st.claims[cid] = {
                "cursor": report["cursor"],
                "continuity": True,
                "carried": bool(report.get("carried", False)),
            }
        if traffic is not None:
            traffic("repin", rid)
        return st

    def _drain(self, replica: Replica) -> int:
        """Flush the replica's admitted queues through the fabric.  At a
        step boundary the queues are normally already empty, so this is
        usually zero steps — abort invisibility is certified for exactly
        that case (a mid-queue call's flush steps are legitimate serving
        work and stay either way)."""
        flushed = 0
        depths = replica.tier.frontend.depths()
        while flushed < self._drain_max_steps and sum(depths.values()) > 0:
            replica.step()
            flushed += 1
            depths = replica.tier.frontend.depths()
        if sum(depths.values()) > 0:
            raise ReconfigError(
                f"replica {replica.replica_id!r} queues not drained "
                f"after {flushed} steps: {depths}"
            )
        return flushed

    # -- rollback ------------------------------------------------------------

    def _rollback(self, staged: List[_Staged]) -> None:
        """Undo every staged transition, newest first: discard the
        never-resumed new stacks (their epoch files were never referenced
        by anything durable), re-adopt every shipped slice onto its old
        stack (continuity-checked), then release the holds — the replayed
        submissions land exactly where and in the order they would have
        without the attempt."""
        from svoc_torch.utils import events as _events

        for st in reversed(staged):
            if st.new is not None:
                st.new.journal.set_trace_file(None)
                for path in (st.new.trace_path, st.new.wal_path):
                    if path not in (st.old.trace_path, st.old.wal_path) and os.path.exists(path):
                        _events.release_writer(path)
                        os.unlink(path)
                st.new = None
            # In the old registry's order, where the reference re-adopts
            # sorted: the old stack then serves its claims in the order it
            # did before the attempt (ROADMAP C5).  A fault mid-ship leaves
            # in ``entries`` only the claims shipped so far.
            for cid in (c for c in st.order if c in st.entries):
                entry = st.entries[cid]
                shipped_cursor = int(entry["session"]["fetch_claim"])
                report = st.old.adopt_claim(cid, dict(entry), spec=st.specs.get(cid))
                if cid not in report["restored"] or report["cursor"] != shipped_cursor:
                    raise MigrationContinuityError(
                        f"rollback {st.replica_id!r}/{cid!r}: cursor "
                        f"{shipped_cursor} != {report['cursor']}"
                    )
        self._router.release_holds()

    # -- commit --------------------------------------------------------------

    def _commit(
        self,
        plan: ReconfigPlan,
        staged: List[_Staged],
        target_epoch: int,
        pre_fleet: str,
        plan_fp: str,
        prewarm: Dict[str, Any],
    ) -> Dict[str, Any]:
        router = self._router
        replicas_report: Dict[str, Any] = {}
        for st in staged:
            rid = st.replica_id
            old_epoch = st.old.fingerprint_epoch
            old_journal_fp = st.old.journal.fingerprint()
            claim_fps = {
                cid: st.old.claim_journal_fingerprint(f"blk{st.old.lineage_scope}-{cid}-")
                for cid in sorted(st.entries)
            }
            router.replace_replica(rid, st.new, retire_key=f"{rid}@e{old_epoch}")
            # The epoch-0 continuity records: the FIRST events of the new
            # lineage fold the pre-transition fingerprints in, so the
            # epoch boundary is itself replay-checked — a replay that
            # diverged anywhere in the old epoch cannot mint an identical
            # new-epoch journal.
            st.new.journal.emit(
                "reconfig.epoch",
                replica=rid,
                epoch=target_epoch,
                prev_epoch=old_epoch,
                prev_fingerprint=old_journal_fp,
            )
            for cid in sorted(st.entries):
                st.new.journal.emit(
                    "reconfig.epoch",
                    lineage=f"blk{st.new.lineage_scope}-{cid}",
                    claim=cid,
                    epoch=target_epoch,
                    prev_fingerprint=claim_fps[cid],
                    cursor=st.claims[cid]["cursor"],
                )
            replicas_report[rid] = {"old_epoch": old_epoch, "claims": st.claims}
        grown: Dict[str, Any] = {}
        for rid in plan.add_replicas:
            live = [r for r in router.replica_ids() if router.replica(r).alive]
            ref_cfg = (
                router.replica(live[0]).pinned_config()
                if live
                else {"mesh": None, "commit_mode": "per_tx"}
            )
            newcomer = self._builder(
                rid,
                fingerprint_epoch=target_epoch,
                consensus_impl=None,
                mesh=plan.mesh if plan.mesh is not None else ref_cfg["mesh"],
                commit_mode=(
                    plan.commit_mode if plan.commit_mode is not None else ref_cfg["commit_mode"]
                ),
            )
            self._mark_warm(newcomer)
            grown[rid] = router.grow(newcomer)
        retired: Dict[str, Any] = {}
        for rid in plan.remove_replicas:
            retired[rid] = router.retire_replica(rid)
        epoch = router.record_epoch(
            {
                "plan": plan_fp,
                "pre_fleet": pre_fleet,
                "replicas": sorted(replicas_report),
                "added": list(plan.add_replicas),
                "removed": list(plan.remove_replicas),
            }
        )
        deferred = router.deferred_count()
        self._journal.emit(
            "cluster.reconfig",
            epoch=epoch,
            plan=plan.to_dict(),
            plan_fingerprint=plan_fp,
            pre_fleet_fingerprint=pre_fleet,
            replicas=sorted(replicas_report),
            deferred=deferred,
        )
        released = router.release_holds()
        self._metrics.gauge("reconfig_epoch").set(epoch)
        self._obs(
            "reconfig.committed",
            plan=plan_fp[:16],
            replicas=sorted(replicas_report),
            deferred_released=deferred,
        )
        self._phase = "idle"
        self._last_report = {
            "status": "committed",
            "epoch": epoch,
            "plan_fingerprint": plan_fp,
            "pre_fleet_fingerprint": pre_fleet,
            "replicas": replicas_report,
            "grown": grown,
            "retired": retired,
            "prewarm": prewarm,
            "deferred_released": deferred,
            "released_statuses": sorted({r.get("status", "ok") for r in released}),
        }
        return self._last_report
