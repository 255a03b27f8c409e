"""Seeded kill/restart scenario: the crash smoke's workload.

Mirrors :mod:`svoc_tpu.durability.scenario` (``scenario.py:1-401``):
:func:`run_durable_scenario` (``:142``), ``CRASH_EVENTS``,
``DEFAULT_CRASH_AT``, ``CRASH_COMMIT_MODE`` and :func:`_spec_contract`.
It takes ``device=`` as the port's ``run_serving_scenario`` does: ``None`` means CUDA and raises without a
card, ``"cpu"`` runs the plain claim-cube forms.  The ``MultiSession``
draws its fleets (the fleet-draws kernel) and runs its gated claim cube on that
device, and each claim's contract sweeps its batched commit there.
Every journal event, WAL line and chain-log line is the reference's, so
the recovered per-claim fingerprints equal the reference's for the same
seed and crash point.

A serving-driven multi-claim run whose EVERY durable artifact lives in
one work directory: per-claim chain tx logs (the external-chain
stand-in, :mod:`~svoc_torch.durability.chainlog`), the commit-intent WAL,
periodic snapshots, and an fsynced journal trace.  The harness
(:mod:`svoc_torch.tools.crash_smoke`) runs it in a subprocess, SIGKILLs it at a
seeded fault point, re-runs it in the same directory — the scenario
auto-detects the durable state and recovers (snapshot restore → journal
tail replay → WAL reconcile → resume serving) — and asserts the
durability contract over the artifacts:

- **zero duplicate txs** — no ``(caller, digest)`` pair appears twice
  in any chain log, at ANY kill point;
- **zero unaccounted slots/requests** — every WAL intent classifies
  landed/stranded/unknown, every admitted request ends completed or
  journaled deferred;
- **replay identity** — two runs of the full kill/restart matrix
  produce byte-identical recovered per-claim journal fingerprints.

Everything is a pure function of ``seed`` + the crash point: arrivals
key off :func:`claim_seed` PER ITERATION (so a re-run of a half-dead
cycle redraws identically), time is a virtual clock persisted in the
snapshot, and the fault points are NAMED registry points fired at the
Nth matching firing (:mod:`svoc_torch.durability.faultspace` — the crc32
counting discipline), never timing-based.

Crash points (``crash_point=``; each maps onto one named fault point):

- ``"mid_wal_append"`` — ``torn`` at ``wal.intent.pre_fsync``: the Nth
  intent record torn in half (half the JSON line, fsynced, SIGKILL);
  the restart must ignore the torn tail and classify the slot by chain
  digest.
- ``"inter_tx"`` — ``kill`` at ``chainlog.tx.post_fsync`` (matched on
  ``fn="update_prediction"``): SIGKILL right after the Nth prediction
  tx hit the chain log (tx durably on chain, WAL ``landed`` record
  never written); the restart must classify it landed via the chain
  witness and NOT resend.
- ``"pre_snapshot"`` — ``kill`` at ``serving.step.post``: SIGKILL at
  the end of serving step N, after the commits but before the cadence
  snapshot; the restart rolls forward from an older snapshot purely on
  the journal tail + WAL.
- ``"batch_mid_fleet"`` — ``kill`` at ``chain.batch.mid_fleet`` with
  ``commit_mode="batched"``: SIGKILL while the one-RPC batched commit
  logs its txs — the reconciler must classify the durable prefix via
  its ``landed_batch``/chain-digest columns and resend only the
  suffix.
- ``"recovery_storm"`` — ``kill`` at ``recovery.post_restore``: a
  SECOND SIGKILL during :meth:`RecoveryManager.recover` (journal ring
  restored, counters not re-seeded, WAL not reconciled); the next
  recovery must be idempotent.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np

from svoc_torch.consensus.state import OracleConsensusContract
from svoc_torch.device import resolve_device
from svoc_torch.durability import faultspace
from svoc_torch.durability.chainlog import (
    DurableLocalBackend,
    duplicate_predictions,
    read_chain_log,
    replay_chain_log,
)
from svoc_torch.durability.faultspace import FaultEvent
from svoc_torch.durability.recovery import GracefulDrain, RecoveryManager
from svoc_torch.durability.wal import CommitIntentWAL
from svoc_torch.fabric.registry import ClaimSpec
from svoc_torch.fabric.scenario import _claim_names, deterministic_vectorizer
from svoc_torch.sim.generators import claim_seed

#: The single-kill crash points (STORM_POINT is the two-kill leg's
#: second phase) — derived from CRASH_EVENTS below so the two can
#: never drift.
STORM_POINT = "recovery_storm"

#: Default counter thresholds per crash point — deep enough into the
#: run that several cycles committed and at least one snapshot landed
#: (``batch_mid_fleet``'s 10 lands mid-way through the second claim's
#: 7-record batch; ``recovery_storm`` fires on the recovery child's one
#: and only restore).
DEFAULT_CRASH_AT = {
    "mid_wal_append": 12,
    "inter_tx": 10,
    "pre_snapshot": 5,
    "batch_mid_fleet": 10,
    "recovery_storm": 1,
}

#: Crash point → named registry event (the refactor off the ad-hoc
#: counter hooks: the three original points remain reachable by name,
#: with identical counting semantics).
CRASH_EVENTS = {
    "mid_wal_append": lambda n: FaultEvent(
        point="wal.intent.pre_fsync", nth=n, action="torn"
    ),
    "inter_tx": lambda n: FaultEvent(
        point="chainlog.tx.post_fsync", nth=n, action="kill",
        match={"fn": "update_prediction"},
    ),
    "pre_snapshot": lambda n: FaultEvent(
        point="serving.step.post", nth=n, action="kill"
    ),
    "batch_mid_fleet": lambda n: FaultEvent(
        point="chain.batch.mid_fleet", nth=n, action="kill"
    ),
    "recovery_storm": lambda n: FaultEvent(
        point="recovery.post_restore", nth=n, action="kill"
    ),
}

CRASH_POINTS = tuple(p for p in CRASH_EVENTS if p != STORM_POINT)

#: Commit plane per crash point: the original matrix targets the
#: PER-TX WAL record family; ``batch_mid_fleet`` exists precisely to
#: kill the batched family mid-RPC.  Pinned like the impl/mesh — the
#: WAL record family is replay-relevant (docs/RESILIENCE.md
#: §batched-commits).
CRASH_COMMIT_MODE = {"batch_mid_fleet": "batched"}


def _spec_contract(
    spec: ClaimSpec, n_admins: int = 3, device=None
) -> OracleConsensusContract:
    """The claim's deployment (mirrors ``apps.session._default_contract``:
    admins 0xA0…, oracles 0x10…) — reconstructed identically on every
    restart so the replayed tx log lands on the same genesis.  Its
    batched commit's sweep runs on ``device``."""
    return OracleConsensusContract(
        admins=[0xA0 + i for i in range(n_admins)],
        oracles=[0x10 + i for i in range(spec.n_oracles)],
        required_majority=2,
        n_failing_oracles=spec.n_failing,
        constrained=spec.constrained,
        unconstrained_max_spread=spec.max_spread if not spec.constrained else 0.0,
        dimension=spec.dimension,
        device=device,
    )


def run_durable_scenario(
    workdir: str,
    seed: int = 0,
    *,
    total_steps: int = 10,
    n_claims: int = 2,
    n_oracles: int = 7,
    dimension: int = 6,
    arrivals_per_step: int = 6,
    snapshot_every: int = 2,
    step_period_s: float = 0.1,
    crash_point: Optional[str] = None,
    crash_at: Optional[int] = None,
    commit_mode: Optional[str] = None,
    device=None,
) -> Dict[str, Any]:
    """One scenario phase in ``workdir`` — fresh when the directory has
    no durable state, recovery otherwise.  With ``crash_point`` set the
    process SIGKILLs itself at the named fault point's Nth firing (the
    call never returns); without it the phase runs to ``total_steps``,
    drains gracefully, and returns the result dict the harness asserts
    over.  ``commit_mode`` (default ``per_tx``, or the crash point's
    pinned plane) must be passed identically to every phase sharing a
    work directory — the WAL record family is replay-relevant.
    ``device`` (``None``: CUDA, raising without a card) is where the
    fabric draws fleets and runs its claim cube (module docstring).
    """
    from svoc_torch.fabric.session import MultiSession
    from svoc_torch.serving.frontend import AdmissionConfig
    from svoc_torch.serving.scenario import VirtualClock
    from svoc_torch.serving.tier import ServingTier
    from svoc_torch.utils.events import EventJournal
    from svoc_torch.utils.metrics import MetricsRegistry
    from svoc_torch.utils.postmortem import PostmortemMonitor
    from svoc_torch.utils.slo import serving_slos

    if crash_point is not None and crash_point not in CRASH_EVENTS:
        raise ValueError(f"unknown crash_point {crash_point!r}")
    crash_at = (
        crash_at
        if crash_at is not None
        else DEFAULT_CRASH_AT.get(crash_point or "", 0)
    )
    commit_mode = commit_mode or CRASH_COMMIT_MODE.get(
        crash_point or "", "per_tx"
    )
    device = resolve_device(device)
    os.makedirs(workdir, exist_ok=True)
    # The journal trace is a durability artifact here — every emit must
    # be on the platter before the next instruction (SVOC_TRACE_FSYNC
    # semantics, forced programmatically so the child needs no env).
    trace_path = os.path.join(workdir, "trace.jsonl")
    wal_path = os.path.join(workdir, "wal.jsonl")

    metrics = MetricsRegistry()
    journal = EventJournal(registry=metrics)
    from svoc_torch.utils import events as _events

    writer = _events.shared_writer(trace_path)
    writer.fsync = True
    journal.set_trace_file(trace_path)
    clock = VirtualClock()
    names = _claim_names(n_claims)
    specs = {
        name: ClaimSpec(
            claim_id=name, n_oracles=n_oracles, dimension=dimension
        )
        for name in names
    }

    def chain_log_path(claim_id: str) -> str:
        return os.path.join(workdir, f"chain-{claim_id}.jsonl")

    backends: Dict[str, DurableLocalBackend] = {}

    def adapter_factory(spec: ClaimSpec):
        from svoc_torch.io.chain import ChainAdapter

        contract = _spec_contract(spec, device=device)
        path = chain_log_path(spec.claim_id)
        replay_chain_log(path, contract)  # no-op on a fresh directory
        backend = DurableLocalBackend(contract, path)
        backends[spec.claim_id] = backend
        return ChainAdapter(backend)

    wal = CommitIntentWAL(wal_path)
    multi = MultiSession(
        base_seed=seed,
        vectorizer=deterministic_vectorizer,
        journal=journal,
        metrics=metrics,
        lineage_scope="dur",
        max_claims_per_batch=n_claims,
        sanitized_dispatch=True,
        clock=clock,
        adapter_factory=adapter_factory,
        # Pinned per leg like the impl/mesh (CRASH_COMMIT_MODE): a
        # committed ``commit_mode: "batched"`` record must not change
        # which instruction the Nth fault fires at.  The original three
        # points target the per-tx family; ``batch_mid_fleet`` kills
        # the batched plane end-to-end (docs/RESILIENCE.md
        # §batched-commits).
        commit_mode=commit_mode,
        device=device,
    )
    for name in names:
        multi.add_claim(specs[name])
    multi.attach_wal(wal)
    tier = ServingTier(
        multi,
        vectorizer=deterministic_vectorizer,
        admission=AdmissionConfig(queue_capacity=32, seed=seed),
        max_requests_per_step=16,
        clock=clock,
        slos=serving_slos(
            metrics,
            latency_target_s=2.5 * step_period_s,
            fast_window_s=10 * step_period_s,
            slow_window_s=50 * step_period_s,
        ),
    )
    # compilation_cache pinned OFF like commit_mode above, as the
    # reference pins it: the seeded kill matrix must not change behavior
    # with a decision record.
    manager = RecoveryManager(
        multi,
        out_dir=workdir,
        wal=wal,
        tier=tier,
        clock=clock,
        compilation_cache="off",
    )

    # ---- arm the named fault point (BEFORE recovery: recovery_storm
    # kills inside manager.recover itself) ----
    events = (
        [CRASH_EVENTS[crash_point](crash_at)]
        if crash_point is not None
        else []
    )
    controller = faultspace.arm(
        faultspace.FaultController(
            events, log_path=os.path.join(workdir, "fired.jsonl")
        )
    )
    try:
        # The serving-step boundary fires unconditionally (the armed
        # controller decides); registered BEFORE the cadence hook so a
        # ``pre_snapshot`` kill lands after the step's commits but
        # before its snapshot.
        tier.post_step_hooks.append(
            lambda _report: faultspace.fault_point(
                faultspace.SERVING_STEP_POST
            )
        )

        # ---- recovery (auto-detected from the durable artifacts) ----
        recovered = (
            os.path.exists(manager.snapshot_path) or bool(wal.records())
        )
        recovery_report = None
        if recovered:
            recovery_report = manager.recover(
                adapters={
                    cid: multi.get(cid).session.adapter for cid in names
                },
                trace_path=trace_path,
            )
            if recovery_report["restored_clock"] is not None:
                clock.now = recovery_report["restored_clock"]
        journal.emit(
            "chaos.armed",
            commit_mode=commit_mode,
            events=[e.as_dict() for e in events],
        )

        manager.install_cadence(snapshot_every)
        monitor = PostmortemMonitor(
            out_dir=workdir, registry=metrics, journal=journal
        ).install()
        drainer = GracefulDrain(
            manager=manager, monitor=monitor, journal=journal
        )

        # ---- the serving loop (iteration-keyed seeded arrivals) ----
        pool = [f"hot take {i} on the claim economy" for i in range(8)]
        while tier.steps < total_steps:
            step_no = tier.steps  # continues across restarts (restored)
            clock.advance(step_period_s)
            rng = np.random.default_rng(
                claim_seed(seed, f"arrivals{step_no}")
            )
            for i in range(arrivals_per_step):
                claim = names[int(rng.integers(0, len(names)))]
                if rng.random() < 0.3:
                    text = pool[int(rng.integers(0, len(pool)))]
                else:
                    text = f"comment {claim} step {step_no} #{i}"
                tier.submit(claim, text)
            tier.step()

        drain_report = drainer.drain(reason="scenario_end")
    finally:
        faultspace.disarm()

    # ---- the result the harness asserts over ----
    chain: Dict[str, Any] = {}
    total_dups: List[Dict[str, Any]] = []
    for name in names:
        path = chain_log_path(name)
        txs = read_chain_log(path)
        dups = duplicate_predictions(path)
        total_dups.extend(dups)
        chain[name] = {
            "txs": len(txs),
            "predictions": sum(
                1 for t in txs if t["fn"] == "update_prediction"
            ),
            "duplicates": len(dups),
        }
    from svoc_torch.durability.reconcile import wal_cycles

    open_cycles = [
        lin for lin, c in wal_cycles(wal.records()).items() if not c["done"]
    ]
    admitted = metrics.family_total("serving_admitted")
    completed = metrics.family_total("serving_completed")
    dropped = metrics.family_total("serving_dropped")
    return {
        "seed": seed,
        "recovered": recovered,
        "recovery": recovery_report,
        "commit_mode": commit_mode,
        "fault_points_fired": controller.counts(),
        "steps": tier.steps,
        "drain": drain_report,
        "chain": chain,
        "duplicate_txs": len(total_dups),
        "wal_open_cycles": open_cycles,
        "requests": {
            "admitted": admitted,
            "completed": completed,
            "dropped": dropped,
            "cached": metrics.family_total("serving_cached"),
            # Nothing admitted may vanish: completed + dropped covers
            # admitted (re-served snapshot requests can push the sum
            # ABOVE admitted — at-least-once, never silent loss).
            "unaccounted": max(0.0, admitted - completed - dropped),
        },
        "claims": {
            name: {
                "fingerprint": multi.claim_fingerprint(name),
                "cycles": multi.get(name).cycles,
                "oracle_list": [
                    hex(a)
                    for a in multi.get(name).session.adapter.call_oracle_list()
                ],
            }
            for name in names
        },
        "journal_fingerprint": journal.fingerprint(),
        "journal_events": journal.last_seq(),
    }
