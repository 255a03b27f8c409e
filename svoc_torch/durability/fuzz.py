"""Seed-driven fault-space exploration over the durable plane.

Mirrors :mod:`svoc_tpu.durability.fuzz` (``fuzz.py:1-984``):
:class:`FuzzPlan` (``:101``), :func:`fuzz_points` (``:142``),
:func:`draw_plan` (``:178``, on the port's
:func:`~svoc_torch.resilience.faults.crc_key`/``mix_key``, so the same
seed draws the same plan), the child workload :func:`run_fuzz_child`
(``:349``), :func:`run_plan` (``:675``), :func:`check_invariants`
(``:778``), :func:`run_and_check`, :func:`shrink_plan` (``:891``),
:func:`write_corpus_entry`, :func:`load_corpus` (``:960``) and
:func:`replay_corpus_entry` (``:974``).  Where the port departs:

- the child is ``python -m svoc_torch.tools.chaos_fuzz --child ...``
  (:func:`default_child_argv`), run from the directory that holds the
  package, never the reference's ``tools/chaos_fuzz.py``;
- the child takes a device (``--device``; CUDA unless told otherwise):
  every claim's contract sweeps its batched commits there.  A child pays
  torch's import (a few seconds) where the reference's jax-free child
  costs about one; the 120 s child timeout covers both.

The deterministic-simulation half of the chaos fuzzer
(:mod:`svoc_torch.tools.chaos_fuzz` is the CLI/parent harness).  Per
seed it:

1. **draws a schedule** (:func:`draw_plan`) over the declared fault
   surface with the crc32-keyed discipline of
   :class:`svoc_torch.resilience.faults.FaultPlan` — SIGKILL at the Nth
   firing of an arbitrary point, torn writes, injected chain faults,
   ``per_tx`` vs ``batched`` commit mode, and restart storms (a second
   kill DURING recovery, ``phase=1`` events).  The first
   ``len(fuzz points)`` seeds are **directed** — seed *i* targets point
   *i* of the sorted surface — so 100 % declared-point coverage is a
   property of the drawing function; later seeds free-draw.

2. **runs crash+recover subprocess children** (:func:`run_plan` /
   :func:`run_fuzz_child`) in one work directory: per-claim
   :class:`~svoc_torch.durability.chainlog.DurableLocalBackend` chains
   behind real :class:`~svoc_torch.io.chain.ChainAdapter`\\ s, one
   :class:`~svoc_torch.durability.wal.CommitIntentWAL`, commits through
   the REAL :func:`~svoc_torch.resilience.retry.commit_fleet_with_resume`,
   snapshots through the REAL :func:`~svoc_torch.utils.checkpoint
   .save_snapshot`, recovery through the REAL
   :func:`~svoc_torch.durability.recovery.roll_forward_journal` +
   :func:`~svoc_torch.durability.reconcile.reconcile_wal`.  The full
   fabric/serving stack keeps its own kill matrix (the crash smoke); the
   two harnesses divide the surface by each point's ``smokes``.

3. **checks invariant oracles** (:func:`check_invariants`) after the
   final recovery: zero duplicate txs (the ``(caller, digest)`` chain
   witness), exactly-once per completed lineage, every started cycle
   terminally accounted, zero unknown/unaccounted reconcile slots, zero
   felt-codec divergences on the wire, and same-seed rerun fingerprints
   byte-identical.

4. **auto-shrinks** any failing plan (:func:`shrink_plan` — drop fault
   events, halve cycles, lower ``nth``) to a minimal repro for the
   regression corpus.

Determinism rules: plans derive from ``(seed, surface)`` via
``crc_key``/``mix_key`` — never ``hash()``; payloads derive from
``(seed, claim, cycle)``; retry jitter is seed-pinned and sleeps are
no-ops; nothing reads the wall clock.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import random
import shutil
import signal
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from svoc_torch.durability import faultspace, forked
from svoc_torch.durability.chainlog import (
    DurableLocalBackend,
    duplicate_predictions,
    read_chain_log,
    replay_chain_log,
)
from svoc_torch.durability.faultspace import FaultEvent, FaultPointSpec
from svoc_torch.durability.recovery import roll_forward_journal
from svoc_torch.durability.wal import CommitIntentWAL, payload_digest, read_wal
from svoc_torch.resilience.faults import crc_key, mix_key

#: Result-file names inside a plan's work directory.
RESULT_NAME = "result.json"
FIRED_LOG_NAME = "fired.jsonl"
PLAN_NAME = "plan.json"

#: Cap on crash/recover phases per plan run: phase 0 + storm + the
#: clean tail, plus slack for multi-kill draws.
MAX_PHASES = 5

_CLAIM_NAMES = ("alpha", "beta", "gamma", "delta")


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FuzzPlan:
    """One fully-explicit exploration schedule.  Drawn from a seed by
    :func:`draw_plan`; stored verbatim in corpus entries so a shrunk
    repro replays without re-deriving anything."""

    seed: int
    commit_mode: str = "per_tx"
    cycles: int = 6
    n_claims: int = 2
    n_oracles: int = 5
    dimension: int = 4
    snapshot_every: int = 2
    events: Tuple[FaultEvent, ...] = ()
    label: Optional[str] = None

    def __post_init__(self):
        if self.commit_mode not in ("per_tx", "batched"):
            raise ValueError(f"unknown commit_mode {self.commit_mode!r}")
        if not 1 <= self.n_claims <= len(_CLAIM_NAMES):
            raise ValueError(f"n_claims outside [1, {len(_CLAIM_NAMES)}]")
        if self.cycles < 1 or self.n_oracles < 3 or self.snapshot_every < 1:
            raise ValueError("degenerate plan dimensions")

    @property
    def claims(self) -> Tuple[str, ...]:
        return _CLAIM_NAMES[: self.n_claims]

    def as_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["events"] = [e.as_dict() for e in self.events]
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FuzzPlan":
        d = dict(d)
        d["events"] = tuple(
            FaultEvent.from_dict(e) for e in d.get("events", [])
        )
        return cls(**d)


def fuzz_points(
    surface: Optional[Dict[str, FaultPointSpec]] = None,
) -> Dict[str, FaultPointSpec]:
    """The fuzz harness's slice of the surface, name-sorted (the
    coverage gate's denominator)."""
    surface = surface if surface is not None else faultspace.surface()
    return {
        name: spec
        for name, spec in sorted(surface.items())
        if faultspace.SMOKE_FUZZ in spec.smokes
    }


#: Storm targets: points that fire during RECOVERY — a phase-1 kill at
#: one of these is a restart storm (kill during the recovery of a kill).
_STORM_POINTS = ("reconcile.mid_cycle", "reconcile.pre_resend",
                 "recovery.post_restore")

#: Per-mode "reliable stranding" kill: guarantees the restart has an
#: open cycle with stranded slots, so recovery-stage points fire.
_STRAND_KILL = {
    "per_tx": "chainlog.tx.post_apply",
    "batched": "chain.batch.mid_fleet",
}


def _draw_action(rng: random.Random, spec: FaultPointSpec) -> str:
    """kill-biased action draw from the point's allowed set."""
    actions = [a for a in ("kill", "torn", "error") if a in spec.actions]
    if len(actions) == 1:
        return actions[0]
    if "kill" in actions and rng.random() < 0.6:
        return "kill"
    return rng.choice(sorted(a for a in actions if a != "kill") or actions)


def draw_plan(
    seed: int,
    surface: Optional[Dict[str, FaultPointSpec]] = None,
) -> FuzzPlan:
    """Deterministically draw seed → schedule (module docstring)."""
    points = fuzz_points(surface)
    names = list(points)
    rng = random.Random(mix_key(seed, crc_key("chaos-fuzz-plan")))
    events: List[FaultEvent] = []
    if seed < len(names):
        # Directed pass: target point ``seed`` of the sorted surface.
        target = points[names[seed]]
        commit_mode = (
            target.modes[0]
            if len(target.modes) == 1
            else rng.choice(sorted(target.modes))
        )
        action = _draw_action(rng, target)
        if target.stage == "recovery":
            # The target only fires during recovery: phase 0 plants a
            # kill that strands slots, phase 1 hits the target.
            events.append(
                FaultEvent(
                    point=_STRAND_KILL[commit_mode],
                    nth=rng.randint(2, 4),
                    action="kill",
                    phase=0,
                )
            )
            events.append(
                FaultEvent(
                    point=target.name,
                    # post_restore fires once per recovery child —
                    # nth>1 there would never fire.
                    nth=1 if target.name == "recovery.post_restore"
                    else rng.randint(1, 2),
                    action=action, phase=1,
                )
            )
        else:
            events.append(
                FaultEvent(
                    point=target.name, nth=rng.randint(1, 4),
                    action=action, phase=0,
                )
            )
    else:
        # Free exploration: mode, 1–2 phase-0 events, optional storm.
        commit_mode = rng.choice(("per_tx", "batched"))
        eligible = [
            s for s in points.values()
            if s.stage == "run" and commit_mode in s.modes
        ]
        for _ in range(rng.randint(1, 2)):
            spec = rng.choice(sorted(eligible, key=lambda s: s.name))
            events.append(
                FaultEvent(
                    point=spec.name, nth=rng.randint(1, 6),
                    action=_draw_action(rng, spec), phase=0,
                )
            )
        if rng.random() < 0.35:
            storm = rng.choice(_STORM_POINTS)
            events.append(
                FaultEvent(
                    point=storm, nth=rng.randint(1, 2),
                    action="kill", phase=1,
                )
            )
    return FuzzPlan(
        seed=seed,
        commit_mode=commit_mode,
        cycles=5 + seed % 3,
        events=tuple(events),
    )


# ---------------------------------------------------------------------------
# The child workload: the light durable-plane harness
# ---------------------------------------------------------------------------


def _contract(plan: FuzzPlan, device=None):
    """One claim's deployment — reconstructed identically each restart
    so the replayed tx log lands on the same genesis (mirrors
    ``durability.scenario._spec_contract``).  Its batched commit's
    certification sweep runs on ``device``."""
    from svoc_torch.consensus.state import OracleConsensusContract

    return OracleConsensusContract(
        admins=[0xA0 + i for i in range(3)],
        oracles=[0x10 + i for i in range(plan.n_oracles)],
        required_majority=2,
        n_failing_oracles=1,
        constrained=True,
        dimension=plan.dimension,
        device=device,
    )


def _payloads(plan: FuzzPlan, claim: str, cycle: int) -> np.ndarray:
    """The fleet's prediction matrix for one (claim, cycle) — a pure
    function of (seed, claim, cycle), values inside the constrained
    [0, 1] interval, 6-decimal-rounded like the production write-back
    (``utils.rounding.round6``)."""
    from svoc_torch.utils.rounding import round6

    gen = np.random.default_rng(
        mix_key(plan.seed, crc_key(claim), crc_key("payload"), cycle)
    )
    return round6(
        gen.uniform(0.05, 0.95, size=(plan.n_oracles, plan.dimension))
    )


def _archive_rotated(workdir: str, wal_path: str) -> None:
    """Preserve a just-rotated WAL archive (``wal.jsonl.1`` would be
    clobbered by the next rotation) so the exactly-once checker can
    union EVERY cycle ever opened, not just the still-active window."""
    src = wal_path + ".1"
    if not os.path.exists(src):
        return
    from svoc_torch.utils.events import fsync_dir

    arch_dir = os.path.join(workdir, "wal-archive")
    os.makedirs(arch_dir, exist_ok=True)
    n = len(os.listdir(arch_dir))
    dst = os.path.join(arch_dir, f"rot-{n:03d}.jsonl")
    # The records inside were fsynced at append time; the renames are
    # directory metadata — make both entries durable before the next
    # rotation can clobber `.1` (SVOC012 discipline).
    os.replace(src, dst)
    fsync_dir(dst)
    fsync_dir(src)


def all_wal_records(workdir: str) -> List[Dict[str, Any]]:
    """Active WAL + the archived rotations, in rotation order."""
    wal_path = os.path.join(workdir, "wal.jsonl")
    records: List[Dict[str, Any]] = []
    arch_dir = os.path.join(workdir, "wal-archive")
    if os.path.isdir(arch_dir):
        for name in sorted(os.listdir(arch_dir)):
            records.extend(read_wal(os.path.join(arch_dir, name)))
    records.extend(read_wal(wal_path + ".1"))
    records.extend(read_wal(wal_path))
    return records


def _codec_divergences(chain_path: str) -> int:
    """The zero-codec-divergence witness: every felt on
    the wire must round-trip EXACTLY through the wsad codec
    (felt → wsad int → felt; no float leg — ~28 % of wsad values lose
    an ulp through float-and-back, which is display noise, not a wire
    divergence)."""
    from svoc_torch.ops.fixedpoint import felt_to_wsad, wsad_to_felt

    divergences = 0
    for record in read_chain_log(chain_path):
        if record.get("fn") != "update_prediction":
            continue
        for felt in record["prediction"]:
            try:
                ok = wsad_to_felt(felt_to_wsad(int(felt))) == int(felt)
            except Exception:  # noqa: BLE001 — FeltRangeError et al.
                # A wire value the codec refuses to decode (dead zone,
                # >= prime) should never have been committed.
                ok = False
            if not ok:
                divergences += 1
    return divergences


def run_fuzz_child(
    workdir: str, plan: FuzzPlan, phase: int, device=None
) -> Dict[str, Any]:
    """ONE phase of the plan in ``workdir`` — fresh when the directory
    has no durable state, recovery otherwise.  Arms the phase's fault
    events; a kill/torn event never returns.  Returns (and the CLI
    child persists) the result dict the invariant oracles check — only
    the phase that survives to the end produces one.  Every claim's
    contract sweeps its batched commits on ``device`` (``None``: CUDA,
    raising without a card)."""
    from svoc_torch.device import resolve_device
    from svoc_torch.io.chain import ChainAdapter
    from svoc_torch.resilience.retry import RetryPolicy, commit_fleet_with_resume
    from svoc_torch.utils import events as events_mod
    from svoc_torch.utils.checkpoint import load_snapshot, save_snapshot
    from svoc_torch.utils.events import EventJournal
    from svoc_torch.utils.metrics import MetricsRegistry

    device = resolve_device(device)
    os.makedirs(workdir, exist_ok=True)
    wal_path = os.path.join(workdir, "wal.jsonl")
    trace_path = os.path.join(workdir, "trace.jsonl")
    snapshot_path = os.path.join(workdir, "snapshot.json")

    controller = faultspace.FaultController(
        [e for e in plan.events if e.phase == phase],
        log_path=os.path.join(workdir, FIRED_LOG_NAME),
    )
    faultspace.arm(controller)
    try:
        metrics = MetricsRegistry()
        journal = EventJournal(registry=metrics)
        writer = events_mod.shared_writer(trace_path)
        writer.fsync = True  # the trace is a durability artifact here
        journal.set_trace_file(trace_path)

        backends: Dict[str, DurableLocalBackend] = {}
        adapters: Dict[str, ChainAdapter] = {}
        for claim in plan.claims:
            contract = _contract(plan, device)
            path = os.path.join(workdir, f"chain-{claim}.jsonl")
            replay_chain_log(path, contract)  # no-op on a fresh directory
            backends[claim] = DurableLocalBackend(contract, path)
            adapters[claim] = ChainAdapter(backends[claim])

        wal = CommitIntentWAL(wal_path)

        def adapter_for(claim: Optional[str]) -> ChainAdapter:
            return adapters[claim if claim is not None else plan.claims[0]]

        # -- recovery (auto-detected, mirrors RecoveryManager.recover) --
        from svoc_torch.durability.reconcile import reconcile_wal

        recovered = os.path.exists(snapshot_path) or bool(wal.records())
        cursor = 0
        reconcile_reports: List[Dict[str, Any]] = []
        if recovered:
            payload = (
                load_snapshot(snapshot_path)
                if os.path.exists(snapshot_path)
                else None
            )
            # Ring restore + fingerprint continuity + trace-tail roll
            # (the REAL recovery code; fires recovery.post_restore).
            roll_forward_journal(journal, payload, trace_path)
            if payload is not None:
                cursor = int(payload.get("cursor", 0))
                metrics.restore_counters(payload.get("counters", []))
            report = reconcile_wal(
                wal, adapter_for, resend=True,
                journal=journal, registry=metrics,
            )
            reconcile_reports.append(report.as_dict())
            journal.emit(
                "chaos.recovered",
                phase=phase,
                cursor=cursor,
                open_cycles=report.open_cycles,
                resent=report.resent,
                unknown=report.unknown,
            )
        journal.emit(
            "chaos.armed",
            phase=phase,
            commit_mode=plan.commit_mode,
            events=[e.as_dict() for e in controller.events],
        )

        completed = wal.completed_lineages()
        # Lineages with a cycle record but no clean done record belong
        # to the RECONCILER, never to blind re-execution: a cycle the
        # recovery reconcile could not close (a faulted resend, missing
        # evidence) still has txs durably on chain, and re-running it
        # through commit_fleet_with_resume would double-send that
        # prefix — exactly the duplicate the WAL exists to prevent
        # (the corpus entry tests/fixtures/chaos_corpus/
        # duplicate-txs-reconcile-error.json).  The final reconcile
        # pass below resolves them from the WAL payloads instead.
        reconciler_owned = {
            r["lineage"]
            for r in wal.records()
            if r.get("kind") == "cycle"
        } - completed

        def snapshot() -> None:
            save_snapshot(
                snapshot_path,
                {
                    "cursor": cursor,
                    "journal": {
                        "events": journal.export_ring(),
                        "last_seq": journal.last_seq(),
                        "fingerprint": journal.fingerprint(),
                    },
                    "counters": metrics.counters_snapshot(),
                },
            )
            try:
                wal.rotate()
            except RuntimeError:
                metrics.counter("wal_rotate_deferred").add(1)
            else:
                _archive_rotated(workdir, wal_path)

        # -- the committed-cycle loop (seed-pure, no wall clock) ------------
        from svoc_torch.ops.fixedpoint import encode_matrix

        policy = RetryPolicy(
            max_attempts=3, base_s=0.0, cap_s=0.0, jitter_seed=plan.seed
        )
        no_sleep = lambda _s: None  # noqa: E731 — injected determinism
        while cursor < plan.cycles:
            cycle = cursor
            for claim in plan.claims:
                lineage = f"fz-{claim}-c{cycle:03d}"
                if lineage in completed:
                    # Snapshot-replay re-execution of a cycle whose txs
                    # landed in a previous life: exactly-once dedup.
                    journal.emit(
                        "chaos.cycle", lineage=lineage, claim=claim,
                        cycle=cycle, outcome="replayed",
                    )
                    continue
                if lineage in reconciler_owned:
                    journal.emit(
                        "chaos.cycle", lineage=lineage, claim=claim,
                        cycle=cycle, outcome="deferred_to_reconcile",
                    )
                    continue
                predictions = _payloads(plan, claim, cycle)
                payloads = encode_matrix(
                    np.asarray(predictions, dtype=np.float64),
                    on_error="none",
                )
                wal_cycle = wal.cycle(
                    lineage,
                    claim=claim,
                    oracles=adapters[claim].call_oracle_list(),
                    payloads=payloads,
                )
                try:
                    outcome = commit_fleet_with_resume(
                        adapters[claim],
                        predictions,
                        policy,
                        sleep=no_sleep,
                        journal=journal,
                        lineage=lineage,
                        wal=wal_cycle,
                        commit_mode=plan.commit_mode,
                        registry=metrics,
                    )
                except Exception as e:  # noqa: BLE001 — injected faults land here
                    # The WAL closed the cycle failed=...; the next
                    # reconcile pass (restart or final) resolves it.
                    journal.emit(
                        "chaos.cycle", lineage=lineage, claim=claim,
                        cycle=cycle, outcome="failed",
                        error=type(e).__name__,
                    )
                else:
                    journal.emit(
                        "chaos.cycle", lineage=lineage, claim=claim,
                        cycle=cycle, outcome="committed",
                        sent=outcome.sent, attempts=outcome.attempts,
                    )
            cursor = cycle + 1
            if cursor % plan.snapshot_every == 0:
                snapshot()

        # -- final pass: resolve failure-closed cycles, then seal -----------
        report = reconcile_wal(
            wal, adapter_for, resend=True, journal=journal, registry=metrics
        )
        reconcile_reports.append(report.as_dict())
        snapshot()
        return _child_result(
            workdir, plan, phase, journal, metrics, controller,
            reconcile_reports,
        )
    finally:
        faultspace.disarm()


def _child_result(
    workdir, plan, phase, journal, metrics, controller, reconcile_reports
) -> Dict[str, Any]:
    chain: Dict[str, Any] = {}
    chain_digests: Dict[str, str] = {}
    total_dups = 0
    codec_divergences = 0
    for claim in plan.claims:
        path = os.path.join(workdir, f"chain-{claim}.jsonl")
        txs = read_chain_log(path)
        dups = duplicate_predictions(path)
        total_dups += len(dups)
        codec_divergences += _codec_divergences(path)
        with open(path, "rb") as f:
            chain_digests[claim] = hashlib.sha256(f.read()).hexdigest()
        chain[claim] = {
            "txs": len(txs),
            "predictions": sum(
                1 for t in txs if t["fn"] == "update_prediction"
            ),
            "duplicates": len(dups),
        }

    # Exactly-once per completed lineage + terminal accounting, over
    # EVERY cycle ever opened (active + archived WAL records).
    from svoc_torch.durability.reconcile import wal_cycles

    records = all_wal_records(workdir)
    cycles = wal_cycles(records)
    # "Open" means NO done record at all — a kill left the cycle for
    # the reconciler.  A failure-closed cycle (``done{failed=...}``) is
    # terminally ACCOUNTED: its outcome was reported to the caller, who
    # owns the retry; rotation archives it by design, and the
    # reconciler resolves it only while it is still in the active log.
    open_cycles = [
        lin
        for lin, c in cycles.items()
        if not c["done"] and c["failed"] is None
    ]
    lost_commits: List[Dict[str, Any]] = []
    per_claim_digests = {
        claim: [
            r["digest"]
            for r in read_chain_log(
                os.path.join(workdir, f"chain-{claim}.jsonl")
            )
            if r["fn"] == "update_prediction"
        ]
        for claim in plan.claims
    }
    for lineage, cyc in cycles.items():
        if not cyc["done"]:
            continue
        digests = per_claim_digests.get(cyc["claim"], [])
        for slot in range(cyc["total"]):
            payload = (
                cyc["payloads"][slot]
                if slot < len(cyc["payloads"])
                else None
            )
            if slot in cyc["skip"] or payload is None:
                continue
            if slot in cyc.get("superseded", ()):
                # A newer cycle owns the slot (the reconciler's
                # supersession verdict, recorded in the done record) —
                # this payload was deliberately never sent.
                continue
            if payload_digest(payload) not in digests:
                lost_commits.append({"lineage": lineage, "slot": slot})

    fingerprint = hashlib.sha256(
        json.dumps(
            {
                "journal": journal.fingerprint(),
                "chain": chain_digests,
                "completed": sorted(
                    lin for lin, c in cycles.items() if c["done"]
                ),
            },
            sort_keys=True,
        ).encode()
    ).hexdigest()
    final_reconcile = reconcile_reports[-1] if reconcile_reports else {}
    return {
        "plan": plan.as_dict(),
        "phase": phase,
        "cycles_run": plan.cycles,
        "chain": chain,
        "duplicate_txs": total_dups,
        "codec_divergences": codec_divergences,
        "wal_open_cycles": open_cycles,
        "lost_commits": lost_commits,
        "reconcile": reconcile_reports,
        "final_unknown": final_reconcile.get("unknown", 0),
        "final_unaccounted": final_reconcile.get("unaccounted", 0),
        "fingerprint": fingerprint,
        "fired": controller.counts(),
        "unfired_events": [
            e.as_dict() for e in controller.unfired_events()
        ],
        "journal_events": journal.last_seq(),
    }


# ---------------------------------------------------------------------------
# Parent-side execution + invariant oracles
# ---------------------------------------------------------------------------


#: The root the child's ``python -m svoc_torch.tools.chaos_fuzz`` runs
#: from: the directory that holds the ``svoc_torch`` package.
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


#: The module every child runs (``python -m``).
CHILD_MODULE = "svoc_torch.tools.chaos_fuzz"


def default_child_argv(
    plan_path: str, workdir: str, phase: int, device=None
) -> List[str]:
    """``python -m svoc_torch.tools.chaos_fuzz --child ...``, with
    ``--device`` when one is named (the child's default is CUDA)."""
    argv = [
        sys.executable, "-m", CHILD_MODULE,
        "--child", workdir, "--plan", plan_path, "--phase", str(phase),
    ]
    if device is not None:
        argv += ["--device", str(device)]
    return argv


#: The parent's wall-clock time at a child's spawn, for the child's
#: start-up seconds.
SPAWNED_ENV = "SVOC_FUZZ_SPAWNED_AT"


def _child_env() -> Dict[str, str]:
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, PYTHONPATH=_ROOT + (os.pathsep + path if path else ""),
                **{SPAWNED_ENV: repr(time.time())})


def spawn_child(argv: List[str], timeout_s: float) -> Tuple[int, str, str]:
    """A child in a fresh interpreter, stamped with its spawn time
    (:data:`SPAWNED_ENV`): ``(returncode, stdout, stderr)``."""
    proc = subprocess.run(argv, capture_output=True, text=True, timeout=timeout_s, env=_child_env(), cwd=_ROOT)
    return proc.returncode, proc.stdout, proc.stderr


def fork_child(argv: List[str], timeout_s: float) -> Tuple[int, str, str]:
    """A child forked from the fork server (:mod:`svoc_torch.durability.forked`,
    torch and the child's modules imported, CUDA never initialised), stamped
    with its fork time (:data:`SPAWNED_ENV`): ``(returncode, stdout,
    stderr)``.  ``argv`` is a :data:`CHILD_MODULE` child's, as
    :func:`spawn_child` takes it."""
    if argv[1:3] != ["-m", CHILD_MODULE]:
        raise ValueError(f"the fork server runs {CHILD_MODULE} children only, got {argv[:3]}")
    return forked.run(CHILD_MODULE, argv[3:], timeout_s, env={SPAWNED_ENV: repr(time.time())})


def run_plan(
    plan: FuzzPlan,
    workdir: str,
    *,
    child_argv: Optional[Callable[[str, str, int], List[str]]] = None,
    timeout_s: float = 120.0,
    device=None,
    launcher: Optional[Callable[[List[str], float], Tuple[int, str, str]]] = None,
) -> Dict[str, Any]:
    """Execute one plan: crash+recover child phases in ``workdir``
    until a child survives to the end (or :data:`MAX_PHASES`).  Returns
    ``{"result", "phases", "violations", "fired", ...}`` — violations
    here cover the EXECUTION (a child that died of something other than
    its scheduled SIGKILL, or never produced a result); the durable
    invariants are layered on by :func:`check_invariants`.

    The work directory is cleared first: a reused ``--base-dir`` (the
    deep mode's resumable work area) must not hand phase 0 a previous
    run's snapshot/WAL/chain logs (spurious recovery) or let a stale
    fired log grant coverage credit for points that no longer fire.

    ``child_argv`` defaults to :func:`default_child_argv` on ``device``
    (``None``: the child's CUDA).  Each child is its own process:
    ``launcher(argv, timeout_s) -> (returncode, stdout, stderr)`` runs it
    (raising ``subprocess.TimeoutExpired``); the default,
    :func:`spawn_child`, starts a fresh interpreter from the package's
    parent directory, and :func:`fork_child` forks one from a fork server
    that has imported everything already.  The timeout
    covers the child's start."""
    if child_argv is None:
        def child_argv(plan_path, workdir, phase):
            return default_child_argv(plan_path, workdir, phase, device)
    if os.path.isdir(workdir):
        shutil.rmtree(workdir)
    os.makedirs(workdir, exist_ok=True)
    plan_path = os.path.join(workdir, PLAN_NAME)
    from svoc_torch.utils.artifacts import atomic_write_json

    atomic_write_json(plan_path, plan.as_dict())
    phases: List[Dict[str, Any]] = []
    violations: List[str] = []
    result: Optional[Dict[str, Any]] = None
    for phase in range(MAX_PHASES):
        result_path = os.path.join(workdir, RESULT_NAME)
        if os.path.exists(result_path):
            os.remove(result_path)
        try:
            returncode, _, stderr = (launcher or spawn_child)(child_argv(plan_path, workdir, phase), timeout_s)
        except subprocess.TimeoutExpired:
            # A hung child is the fuzzer's own finding class — record
            # it as this plan's violation, never abort the whole gate.
            phases.append({"phase": phase, "returncode": None,
                           "killed": False, "timeout": True})
            violations.append(
                f"harness_error: phase {phase} hung past {timeout_s}s"
            )
            break
        killed = returncode == -signal.SIGKILL
        entry: Dict[str, Any] = {
            "phase": phase,
            "returncode": returncode,
            "killed": killed,
        }
        phases.append(entry)
        if killed:
            continue  # the scheduled fault fired — next phase recovers
        if returncode != 0:
            violations.append(
                f"harness_error: phase {phase} exited "
                f"{returncode}; stderr tail: {stderr[-400:]}"
            )
            break
        if not os.path.exists(result_path):
            violations.append(
                f"harness_error: phase {phase} exited cleanly without "
                f"a result"
            )
            break
        with open(result_path) as f:
            result = json.load(f)
        break
    else:
        violations.append(
            f"harness_error: no phase completed within {MAX_PHASES}"
        )
    fired = faultspace.read_fired_log(
        os.path.join(workdir, FIRED_LOG_NAME)
    )
    # Scheduled events that never EXECUTED, reconstructed from the
    # durable action log rather than any one child's in-memory view —
    # a phase killed by its first event takes its remaining events
    # down with it, and they must be reported, never silently dropped.
    unmatched = list(fired["actions"])
    unexecuted: List[Dict[str, Any]] = []
    for ev in plan.events:
        for i, action in enumerate(unmatched):
            if (
                action["point"] == ev.point
                and action["action"] == ev.action
            ):
                unmatched.pop(i)
                break
        else:
            unexecuted.append(ev.as_dict())
    return {
        "plan": plan.as_dict(),
        "phases": phases,
        "result": result,
        "violations": violations,
        "fired": fired,
        "unexecuted_events": unexecuted,
    }


def check_invariants(run: Dict[str, Any]) -> List[str]:
    """The invariant oracles over one completed :func:`run_plan`."""
    violations = list(run.get("violations", []))
    result = run.get("result")
    if result is None:
        return violations or ["harness_error: no result"]
    if result["duplicate_txs"]:
        violations.append(
            f"duplicate_txs: {result['duplicate_txs']} (caller,digest) "
            f"pairs sent twice"
        )
    if result["wal_open_cycles"]:
        violations.append(
            f"open_cycles: {sorted(result['wal_open_cycles'])} never "
            f"closed nor conservatively held on missing evidence"
        )
    if result["lost_commits"]:
        violations.append(
            f"lost_commits: {result['lost_commits'][:4]} — completed "
            f"lineage with a non-skipped slot missing from the chain"
        )
    if result["final_unknown"]:
        violations.append(
            f"unknown_slots: {result['final_unknown']} with the "
            f"backend reachable"
        )
    if result["final_unaccounted"]:
        violations.append(
            f"unaccounted_slots: {result['final_unaccounted']}"
        )
    if result["codec_divergences"]:
        violations.append(
            f"codec_divergences: {result['codec_divergences']} felt "
            f"wire values fail exact round-trip"
        )
    return violations


def run_and_check(
    plan: FuzzPlan,
    base_dir: str,
    *,
    replay: bool = True,
    child_argv: Optional[Callable[[str, str, int], List[str]]] = None,
    device=None,
    launcher: Optional[Callable[[List[str], float], Tuple[int, str, str]]] = None,
) -> Dict[str, Any]:
    """One plan end-to-end: execute, check invariants, and (default)
    re-execute in a fresh directory asserting byte-identical recovered
    fingerprints — the same-seed-rerun oracle.  The children run on
    ``device`` (``None``: CUDA), started by ``launcher`` (see
    :func:`run_plan`)."""
    first = run_plan(plan, os.path.join(base_dir, "run1"),
                     child_argv=child_argv, device=device, launcher=launcher)
    violations = check_invariants(first)
    replay_identical = None
    if replay and first.get("result") is not None:
        second = run_plan(plan, os.path.join(base_dir, "run2"),
                          child_argv=child_argv, device=device, launcher=launcher)
        if second.get("result") is None:
            violations.append(
                "replay_divergence: rerun failed to complete: "
                + "; ".join(second["violations"])[:300]
            )
            replay_identical = False
        else:
            replay_identical = (
                second["result"]["fingerprint"]
                == first["result"]["fingerprint"]
            )
            if not replay_identical:
                violations.append(
                    "replay_divergence: same-seed rerun produced a "
                    "different recovered fingerprint"
                )
    return {
        "plan": plan.as_dict(),
        "run": first,
        "violations": violations,
        "replay_identical": replay_identical,
        "fired": first["fired"],
    }


# ---------------------------------------------------------------------------
# Shrinking + the regression corpus
# ---------------------------------------------------------------------------


def _candidates(plan: FuzzPlan) -> List[FuzzPlan]:
    """Smaller neighbors, most-aggressive first: drop a fault event,
    halve the cycle count, halve an event's nth."""
    out: List[FuzzPlan] = []
    for i in range(len(plan.events)):
        out.append(
            dataclasses.replace(
                plan, events=plan.events[:i] + plan.events[i + 1:],
            )
        )
    if plan.cycles > 2:
        out.append(
            dataclasses.replace(plan, cycles=max(2, plan.cycles // 2))
        )
        out.append(dataclasses.replace(plan, cycles=plan.cycles - 1))
    for i, ev in enumerate(plan.events):
        if ev.nth > 1:
            out.append(
                dataclasses.replace(
                    plan,
                    events=plan.events[:i]
                    + (dataclasses.replace(ev, nth=max(1, ev.nth // 2)),)
                    + plan.events[i + 1:],
                )
            )
    return out


def shrink_plan(
    plan: FuzzPlan,
    fails: Callable[[FuzzPlan], bool],
    *,
    budget: int = 16,
) -> Dict[str, Any]:
    """Greedy shrink: accept any smaller neighbor that still fails,
    until the budget is spent or no neighbor fails.  ``fails(plan)``
    must be deterministic (it is: plans are explicit and runs are
    seed-pure)."""
    current = plan
    trials = 0
    improved = True
    while improved and trials < budget:
        improved = False
        for candidate in _candidates(current):
            if trials >= budget:
                break
            trials += 1
            if fails(candidate):
                current = candidate
                improved = True
                break
    return {"plan": current, "trials": trials}


def corpus_entry_name(violation: str, plan: FuzzPlan) -> str:
    kind = violation.split(":", 1)[0].strip().replace("_", "-")
    return f"{kind}-s{plan.seed}.json"


def write_corpus_entry(
    corpus_dir: str,
    plan: FuzzPlan,
    violations: Sequence[str],
    *,
    shrunk_from: Optional[FuzzPlan] = None,
    name: Optional[str] = None,
    expect: str = "pass",
    tier1: bool = True,
    notes: str = "",
) -> str:
    """Write one corpus entry (atomic+fsynced).  ``expect="pass"`` is
    the REGRESSION contract: the entry is committed once its bug is
    fixed, and tier-1 replays it green forever after."""
    from svoc_torch.utils.artifacts import atomic_write_json

    os.makedirs(corpus_dir, exist_ok=True)
    fname = name or corpus_entry_name(
        violations[0] if violations else "pass", plan
    )
    path = os.path.join(corpus_dir, fname)
    atomic_write_json(
        path,
        {
            "format": "svoc-chaos-corpus-v1",
            "plan": plan.as_dict(),
            "violations_at_capture": list(violations),
            "shrunk_from": (
                shrunk_from.as_dict() if shrunk_from is not None else None
            ),
            "expect": expect,
            "tier1": bool(tier1),
            "notes": notes,
        },
    )
    return path


def load_corpus(corpus_dir: str) -> List[Dict[str, Any]]:
    """The durable-plane entries of ``corpus_dir``, name-sorted: its
    top-level ``*.json`` files only, so the ``cluster/`` and
    ``reconfig/`` subdirectories' formats never load here."""
    if not os.path.isdir(corpus_dir):
        return []
    entries = []
    for fname in sorted(os.listdir(corpus_dir)):
        if not fname.endswith(".json"):
            continue
        with open(os.path.join(corpus_dir, fname)) as f:
            entry = json.load(f)
        entry["name"] = fname
        entries.append(entry)
    return entries


def replay_corpus_entry(
    entry: Dict[str, Any],
    base_dir: str,
    *,
    child_argv: Optional[Callable[[str, str, int], List[str]]] = None,
    device=None,
) -> List[str]:
    """Replay one corpus entry on ``device``; returns the violations
    (empty = green, the committed contract)."""
    plan = FuzzPlan.from_dict(entry["plan"])
    checked = run_and_check(plan, base_dir, child_argv=child_argv,
                            device=device)
    return checked["violations"]
