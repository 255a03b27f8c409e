"""One serving replica: a full single-process stack under its own dirs.

Mirrors :mod:`svoc_tpu.cluster.replica` (``replica.py:1-463``):
:func:`lineage_cursor`, :class:`Replica` and :class:`ReplicaDeadError`.
Where the port departs:

- ``device=`` (``None``: CUDA, raising without a card) goes to the
  replica's ``MultiSession`` (its fleets' draws, one fleet-draws launch a fetch, and its claim
  cube, B3) and to every claim's contract (the batched commit's sweep);
- :meth:`Replica.ship_claim`'s PRNG burn (``:309-330``) runs
  :func:`svoc_torch.sim.prng.split` on the serialised uint32 key, bit
  for bit ``jax.random.split``; the key is host data there, so the few
  hashes run on the CPU and launch nothing;
- ``compilation_cache`` stays pinned ``"off"``, as at ``:178-186``;
- ``mesh=`` pins the fabric router's claim mesh, its slots on the
  replica's device (:mod:`svoc_torch.parallel.mesh`).

A replica is exactly the stack ``run_durable_scenario`` builds — one
:class:`~svoc_torch.fabric.session.MultiSession` under one
:class:`~svoc_torch.serving.tier.ServingTier`, with its OWN commit-intent
WAL, snapshot cadence, fsynced journal trace, metrics registry, and
event journal — rooted at ``<base>/replica-<id>/``.  What is NOT per
replica is the chain: the per-claim tx logs (the external-chain
stand-in, :mod:`svoc_torch.durability.chainlog`) live in a cluster-shared
``chain/`` directory, because the chain outlives any one replica — a
claim's new owner replays the SAME log the old owner appended to, and
the digest dedup there is what makes "zero duplicate txs" a
cluster-wide invariant rather than a per-process one.

Death and rebirth (the failover):

- :meth:`kill` models SIGKILL at a step boundary — the in-memory stack
  is discarded mid-flight, nothing is flushed or drained.  Everything
  already fsynced (WAL records, chain txs, snapshots, the journal
  trace) is durable; everything else is what recovery must reconstruct.
- A fresh ``Replica`` over the same directories + :meth:`recover`
  brings the pre-death state back exactly like the crash-smoke restart:
  snapshot restore → journal-tail roll-forward → counter re-seed →
  serving-queue re-enqueue → WAL reconcile.  The failover path
  (:meth:`svoc_torch.cluster.router.ClusterRouter.fail_over`) then drains
  and ships each recovered claim to a survivor.

Lineage discipline: every replica in a cluster shares ONE
``lineage_scope``, so a claim's lineage prefix (``blk<scope>-<claim>``)
is identical no matter which replica serves it — migration preserves
lineage continuity by shipping the fetch cursors, not by rewriting ids.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from svoc_torch.device import resolve_device
from svoc_torch.durability.chainlog import (
    DurableLocalBackend,
    duplicate_predictions,
    read_chain_log,
    replay_chain_log,
)
from svoc_torch.durability.recovery import RecoveryManager
from svoc_torch.durability.scenario import _spec_contract
from svoc_torch.durability.wal import CommitIntentWAL
from svoc_torch.fabric.registry import ClaimSpec
from svoc_torch.fabric.scenario import deterministic_vectorizer
from svoc_torch.sim import prng
from svoc_torch.utils.checkpoint import (
    claim_spec_from_dict,
    claim_spec_to_dict,
    restore_durable_session,
    restore_multi_session,
    session_durable_dict,
)


def lineage_cursor(session) -> int:
    """The claim's minted-lineage cursor — what migration's continuity
    check compares across the ship/adopt boundary (the next fetch must
    mint claim N+1 on the NEW owner)."""
    with session.lock:
        return int(session._fetch_claim)


class Replica:
    """One serving replica rooted at ``base_dir`` (chain logs shared)."""

    def __init__(
        self,
        replica_id: str,
        base_dir: str,
        *,
        chain_dir: str,
        seed: int,
        clock,
        lineage_scope: str = "clu",
        commit_mode: str = "per_tx",
        consensus_impl: Optional[str] = None,
        step_period_s: float = 0.1,
        queue_capacity: int = 32,
        max_requests_per_step: int = 16,
        max_claims_per_batch: int = 8,
        mesh=None,
        fingerprint_epoch: int = 0,
        device=None,
    ):
        from svoc_torch.fabric.session import MultiSession
        from svoc_torch.serving.frontend import AdmissionConfig
        from svoc_torch.serving.tier import ServingTier
        from svoc_torch.utils import events as _events
        from svoc_torch.utils.events import EventJournal
        from svoc_torch.utils.metrics import MetricsRegistry
        from svoc_torch.utils.slo import serving_slos

        self.replica_id = replica_id
        self.base_dir = base_dir
        self.chain_dir = chain_dir
        self.seed = seed
        self.clock = clock
        self.lineage_scope = lineage_scope
        self.step_period_s = step_period_s
        self.commit_mode = commit_mode
        self.consensus_impl = consensus_impl
        #: Fingerprint epoch (the reconfiguration plane's): a re-pinned
        #: stack over the same durable dirs starts a NEW journal/WAL
        #: lineage — ``trace-e<N>.jsonl``/``wal-e<N>.jsonl`` — so the old
        #: epoch's durable history is immutable and the epoch-0
        #: continuity record is literally the first event of the new
        #: trace.  Epoch 0 keeps the plain names.
        self.fingerprint_epoch = int(fingerprint_epoch)
        #: Where the stack draws its fleets, runs its claim cube and
        #: sweeps its contracts' batched commits.
        self.device = resolve_device(device)
        self.alive = True
        os.makedirs(base_dir, exist_ok=True)
        os.makedirs(chain_dir, exist_ok=True)

        suffix = "" if self.fingerprint_epoch == 0 else f"-e{self.fingerprint_epoch}"
        self.trace_path = os.path.join(base_dir, f"trace{suffix}.jsonl")
        self.wal_path = os.path.join(base_dir, f"wal{suffix}.jsonl")
        #: Observation-channel sidecar (the fleet plane's).  Deliberately NOT the fsynced trace file: hop
        #: records are derived telemetry with no durability contract,
        #: and the trace writer fsyncs per line.
        self.obs_path = os.path.join(base_dir, f"obs{suffix}.jsonl")
        self.metrics = MetricsRegistry()
        self.journal = EventJournal(registry=self.metrics)
        # The trace is a durability artifact (the failover replays its
        # tail), so fsync like the crash scenario does.
        writer = _events.shared_writer(self.trace_path)
        writer.fsync = True
        self.journal.set_trace_file(self.trace_path)

        self._backends: Dict[str, DurableLocalBackend] = {}

        def adapter_factory(spec: ClaimSpec):
            from svoc_torch.io.chain import ChainAdapter

            contract = _spec_contract(spec, device=self.device)
            path = self.chain_log_path(spec.claim_id)
            # No-op on a fresh chain; on adoption this replays every tx
            # the previous owner committed — the dedup witness.
            replay_chain_log(path, contract)
            backend = DurableLocalBackend(contract, path)
            self._backends[spec.claim_id] = backend
            return ChainAdapter(backend)

        self.wal = CommitIntentWAL(self.wal_path)
        self.multi = MultiSession(
            base_seed=seed,
            vectorizer=deterministic_vectorizer,
            journal=self.journal,
            metrics=self.metrics,
            lineage_scope=lineage_scope,
            max_claims_per_batch=max_claims_per_batch,
            sanitized_dispatch=True,
            clock=clock,
            adapter_factory=adapter_factory,
            commit_mode=commit_mode,
            consensus_impl=consensus_impl,
            mesh=mesh,
            device=self.device,
        )
        self.multi.attach_wal(self.wal)
        self.tier = ServingTier(
            self.multi,
            vectorizer=deterministic_vectorizer,
            admission=AdmissionConfig(queue_capacity=queue_capacity, seed=seed),
            max_requests_per_step=max_requests_per_step,
            clock=clock,
            slos=serving_slos(
                self.metrics,
                latency_target_s=2.5 * step_period_s,
                fast_window_s=10 * step_period_s,
                slow_window_s=50 * step_period_s,
            ),
        )
        # compilation_cache pinned "off" like the crash matrix: seeded
        # cluster replays must not depend on a process-global cache dir.
        self.manager = RecoveryManager(
            self.multi,
            out_dir=base_dir,
            wal=self.wal,
            tier=self.tier,
            clock=clock,
            compilation_cache="off",
        )

    # -- paths ---------------------------------------------------------------

    def chain_log_path(self, claim_id: str) -> str:
        return os.path.join(self.chain_dir, f"chain-{claim_id}.jsonl")

    # -- serving -------------------------------------------------------------

    def has_claim(self, claim_id: str) -> bool:
        return claim_id in self.multi.claim_ids()

    def add_claim(self, spec: ClaimSpec):
        return self.multi.add_claim(spec)

    def submit(self, claim_id: str, text: str) -> Dict[str, Any]:
        if not self.alive:
            raise ReplicaDeadError(self.replica_id)
        return self.tier.submit(claim_id, text)

    def step(self) -> Dict[str, Any]:
        if not self.alive:
            raise ReplicaDeadError(self.replica_id)
        return self.tier.step()

    def install_cadence(self, every_n_steps: int) -> None:
        self.manager.install_cadence(every_n_steps)

    # -- death / recovery ----------------------------------------------------

    def kill(self) -> None:
        """SIGKILL semantics at a step boundary: mark the stack dead and
        stop touching it.  Nothing is flushed — the durable dirs hold
        exactly what fsync already made durable."""
        self.alive = False

    def recover(self) -> Optional[Dict[str, Any]]:
        """The crash-smoke restart: auto-detect durable state and bring
        this (freshly constructed) replica back to it.  Returns the
        recovery report, or None when the directories were fresh."""
        recovered = os.path.exists(self.manager.snapshot_path) or bool(
            self.wal.records()
        )
        if not recovered:
            return None
        report = self.manager.recover(
            adapters={
                cid: self.multi.get(cid).session.adapter
                for cid in self.multi.claim_ids()
            },
            trace_path=self.trace_path,
        )
        if report["restored_clock"] is not None:
            self.clock.now = report["restored_clock"]
        return report

    # -- migration plumbing (driven by the cluster router) -------------------

    def drain_claim(self, claim_id: str, max_steps: int = 8) -> Dict[str, Any]:
        """Per-claim drain: flush the claim's admitted queue through
        the fabric, then pause it and journal whatever could not
        complete as ``serving.deferred{reason="draining"}`` — the
        tier-wide :meth:`ServingTier.drain` accounting, scoped to one
        claim.  Every admitted request ends ANSWERED or DEFERRED."""
        flushed = 0
        while (
            flushed < max_steps
            and self.tier.frontend.depths().get(claim_id, 0) > 0
        ):
            self.step()
            flushed += 1
        self.multi.pause(claim_id)
        deferred = 0
        for request in self.tier.frontend.purge(claim_id):
            self.metrics.counter(
                "serving_dropped", labels={"claim": request.claim}
            ).add(1)
            self.journal.emit(
                "serving.deferred",
                lineage=request.lineage,
                claim=request.claim,
                seq=request.seq,
                reason="draining",
            )
            deferred += 1
        return {"flush_steps": flushed, "deferred": deferred}

    def ship_claim(self, claim_id: str) -> Dict[str, Any]:
        """Detach ``claim_id`` and return its migration slice — the
        same per-claim entry a fleet snapshot embeds
        (:func:`multi_session_to_dict` shape), so adoption rides the
        documented :func:`restore_multi_session` path.  ``paused`` is
        cleared: the claim resumes serving on the adopter.

        The lineage cursor ships RECONCILED against this WAL's commit
        witness: the session state above may be one snapshot-cadence
        OLDER than the chain (a failover recovers from the last
        snapshot), and on a same-process restart the surviving WAL's
        ``completed_lineages`` set is what makes the re-executed
        commits skip the chain writes — but migration moves the claim
        to a DIFFERENT WAL, whose rotation cadence is not synchronized
        with the adopted cursor (a snapshot on the adopter between
        adoption and the claim's next cycle would archive any imported
        dedup record).  So instead of shipping dedup records, the
        cursor itself is fast-forwarded past every lineage this WAL
        closed successfully: the adopter mints strictly NEW lineage ids
        and can never re-send a landed tx.  Failure-closed cycles
        (``done`` with ``failed=``) deliberately do NOT advance the
        cursor — their retry is legitimate, exactly as on restart."""
        state = self.multi.get(claim_id)
        session = session_durable_dict(state.session)
        prefix = f"blk{self.lineage_scope}-{claim_id}-"
        committed = max(
            (
                int(str(r["lineage"]).rsplit("-", 1)[1])
                for r in self.wal.records()
                if r.get("kind") == "done"
                and "failed" not in r
                and str(r.get("lineage", "")).startswith(prefix)
            ),
            default=0,
        )
        skipped = committed - int(session["fetch_claim"])
        if skipped > 0:
            session["fetch_claim"] = committed
            if session.get("prng_key") is not None:
                # Each landed-but-skipped cycle consumed one PRNG split
                # in the life that committed it; burn the same splits so
                # the adopter's next draw CONTINUES the stream (a stale
                # key would re-draw the landed cycle's bootstrap noise
                # and, for oracles whose windows the interim arrivals
                # never touched, re-produce byte-identical payloads —
                # a (caller, digest) duplicate on the shared chain).
                # ``split(key)[0]`` is ``jax.random.split``'s new key.
                key = torch.tensor(
                    np.asarray(session["prng_key"], dtype=np.uint32).astype(np.int64)
                )
                for _ in range(skipped):
                    key = prng.split(key)[0]
                session["prng_key"] = [int(w) for w in key.tolist()]
        entry = {
            "spec": claim_spec_to_dict(state.spec),
            "cycles": state.cycles,
            "paused": False,
            "session": session,
        }
        self.multi.remove_claim(claim_id)
        self._backends.pop(claim_id, None)
        return entry

    def adopt_claim(self, claim_id: str, entry: Dict[str, Any], spec: Optional[ClaimSpec] = None) -> Dict[str, Any]:
        """Adopt a shipped slice: register the claim (the adapter
        factory replays the shared chain log — strictly newer than the
        slice's embedded contract), then restore through
        :func:`restore_multi_session` so membership-change handling is
        the one documented code path, not a fork of it.  ``spec`` (a
        rollback's: the claim's own spec object before it shipped) keeps
        what the slice's dict cannot carry, its ``tamper`` hook."""
        if spec is None:
            spec = claim_spec_from_dict(entry["spec"])
        state = self.multi.add_claim(spec)
        payload = {
            "version": 1,
            # Preserve OUR router cursor: restore_multi_session writes
            # payload["router_steps"] back into the router, and adoption
            # must not rewind this replica's scheduler.
            "router_steps": self.multi.router.steps,
            "claims": {claim_id: dict(entry)},
            "unclaimed": {},
        }
        report = restore_multi_session(
            payload, self.multi, adapters={claim_id: state.session.adapter}
        )
        report["cursor"] = lineage_cursor(state.session)
        return report

    def adopt_claim_fresh(
        self, claim_id: str, spec: ClaimSpec, entry: Dict[str, Any]
    ) -> Dict[str, Any]:
        """Adopt a shipped slice under a DIFFERENT :class:`ClaimSpec`
        (the reconfiguration plane's per-claim spec diff): state whose
        shape depends on the fleet (supervisor scores sized
        ``n_oracles``, the request window's vector dimension) cannot
        restore across an N/M change, so the session is built FRESH from
        the new spec and only the lineage continuity fields carry over —
        the minted-lineage cursors, the last lineage id, the simulation
        step, and the PRNG key (the stream continues; a reset key could
        re-draw a landed cycle's bootstrap noise and mint a chain
        duplicate).  The shared chain log replays through the adapter
        factory as usual — dedup is contract state, not session state."""
        state = self.multi.add_claim(spec)
        shipped = entry["session"]
        fresh = session_durable_dict(state.session)
        for field in (
            "fetch_claim",
            "fetch_published",
            "last_lineage",
            "simulation_step",
            "prng_key",
        ):
            fresh[field] = shipped.get(field, fresh.get(field))
        restore_durable_session(fresh, state.session, adapter=state.session.adapter)
        return {
            "restored": [claim_id],
            "unclaimed": [],
            "fresh": [],
            "cursor": lineage_cursor(state.session),
            "carried": True,
        }

    # -- accounting / identity ----------------------------------------------

    def request_accounting(self) -> Dict[str, float]:
        admitted = self.metrics.family_total("serving_admitted")
        completed = self.metrics.family_total("serving_completed")
        dropped = self.metrics.family_total("serving_dropped")
        return {
            "admitted": admitted,
            "completed": completed,
            "dropped": dropped,
            "cached": self.metrics.family_total("serving_cached"),
        }

    def chain_accounting(self) -> Dict[str, Dict[str, int]]:
        out: Dict[str, Dict[str, int]] = {}
        for cid in self.multi.claim_ids():
            path = self.chain_log_path(cid)
            txs = read_chain_log(path)
            out[cid] = {
                "txs": len(txs),
                "predictions": sum(
                    1 for t in txs if t["fn"] == "update_prediction"
                ),
                "duplicates": len(duplicate_predictions(path)),
            }
        return out

    def claim_journal_fingerprint(self, lineage_prefix: str) -> str:
        """This replica's journal slice for one claim's lineage family
        — the per-replica factor of the fleet's per-claim fingerprint."""
        return self.journal.fingerprint(lineage_prefix=lineage_prefix)

    def pinned_config(self) -> Dict[str, Any]:
        """The replay-relevant knobs this stack was constructed under
        (SVOC011: resolved once, never re-read) — what a
        :class:`~svoc_torch.cluster.reconfig.ReconfigPlan` diffs against.
        The port's ``consensus_impl`` is the route its device gives
        (``"cuda"`` or ``"plain"``)."""
        return {
            "consensus_impl": self.multi.router.consensus_impl,
            "mesh": self.multi.router.mesh_spec,
            "commit_mode": self.commit_mode,
            "fingerprint_epoch": self.fingerprint_epoch,
        }

    def snapshot(self) -> Dict[str, Any]:
        """The ``/api/state`` per-replica row."""
        return {
            "replica": self.replica_id,
            "alive": self.alive,
            "claims": sorted(self.multi.claim_ids()),
            "steps": self.tier.steps,
            "requests": self.request_accounting(),
            "journal_events": self.journal.last_seq(),
            "config": self.pinned_config(),
        }


class ReplicaDeadError(RuntimeError):
    """The replica was killed — the router sheds instead of forwarding."""

    def __init__(self, replica_id: str):
        super().__init__(f"replica {replica_id!r} is dead")
        self.replica_id = replica_id
