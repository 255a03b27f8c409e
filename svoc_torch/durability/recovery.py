"""Snapshot + journal-replay recovery, and the graceful-drain handler.

Mirrors :mod:`svoc_tpu.durability.recovery` (``recovery.py:1-570``):
:func:`roll_forward_journal`, :class:`RecoveryManager` (``snapshot``
``:203``, ``install_cadence`` ``:267``, ``recover`` ``:291``) and
:class:`GracefulDrain` (``:481``), with the ``recovery.post_restore``
fault point.  Snapshots, reports and journal events are the
reference's, field for field.

``compilation_cache`` resolves once at construction
(:func:`svoc_torch.compile.modes.resolve_compilation_cache`:
``SVOC_COMPILATION_CACHE``, then the committed ``"persistent"``,
``recovery.py:132-170``).  ``"persistent"`` points the process's kernel
builds under ``<out_dir>/kernel_cache/<salt>``
(:func:`svoc_torch.compile.cache.enable_persistent_cache`), where the
reference points JAX's compilation cache under ``xla_cache``.  The
reference's snapshot-cadence eviction and its ``compile_cache_max_bytes``
are left out: a salt directory holds one library per source, so its cap
is never reached (:mod:`svoc_torch.compile.cache`).  ``recover(prewarm=True)``
walks the primary universe synchronously after the restore
(``recovery.py:361-388``); a prewarm defect is counted in
``compile_cache_errors{op="prewarm"}`` and does not fail the recovery.
Both classes attach to the operator console
(:class:`svoc_torch.apps.commands.CommandConsole`) as the reference's
do (``recovery.py:432, 551``).

The WAL (:mod:`svoc_torch.durability.wal`) makes the CHAIN side of a
crash exact; this module recovers everything else the long-lived
service holds in memory (docs/RESILIENCE.md §durability):

- :class:`RecoveryManager` — periodic atomic snapshots
  (:func:`svoc_torch.utils.checkpoint.multi_session_to_dict` + the
  journal ring + cumulative counters + serving queues + the virtual
  clock), on a router post-step cadence.  Recovery =
  **snapshot ∘ journal-tail replay ∘ WAL reconcile**: restore the
  snapshot, roll the event journal forward from the fsynced trace file
  (fingerprint continuity asserted before the roll), re-seed counters,
  then reconcile the WAL against the (replayed or real) chain —
  HybridFlow's single-controller-recovers-the-dataflow discipline
  applied to our fabric.
- :class:`GracefulDrain` — the SIGTERM/SIGINT path (G-Core's
  drain-and-handoff): stop admission (``serving.shed{reason=
  draining}``), flush in-flight micro-batches, defer what cannot
  complete, snapshot, and leave a ``shutdown``-classified postmortem
  bundle.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, List, Optional

from svoc_torch.durability.faultspace import (
    SMOKE_CRASH,
    SMOKE_FUZZ,
    declare,
    fault_point,
)
from svoc_torch.durability.reconcile import ReconcileReport, reconcile_wal, wal_cycles
from svoc_torch.utils.checkpoint import (
    load_snapshot,
    multi_session_to_dict,
    restore_multi_session,
    save_snapshot,
)

SNAPSHOT_NAME = "snapshot.json"
COST_LEDGER_NAME = "cost_ledger.json"

#: The recovery path's own kill window (the restart-storm class): the
#: journal ring is restored and fingerprint-checked, but counters are
#: not re-seeded and the WAL is not reconciled — a second recovery must
#: start over idempotently.
RECOVERY_POST_RESTORE = declare(
    "recovery.post_restore",
    owner="svoc_torch/durability/recovery.py",
    invariant="a kill mid-recovery (ring restored, counters not "
    "re-seeded, WAL not reconciled) must leave a state a second "
    "recovery brings to the identical fixpoint",
    actions=("kill",),
    smokes=(SMOKE_FUZZ, SMOKE_CRASH),
    stage="recovery",
)


class RecoveryError(RuntimeError):
    """Recovery found torn/contradictory durable state (a fingerprint
    discontinuity between the snapshot's journal ring and its recorded
    digest) — refusing to roll forward on corrupt history."""


def roll_forward_journal(
    journal,
    payload: Optional[Dict[str, Any]],
    trace_path: Optional[str],
) -> Dict[str, int]:
    """Restore the journal from a snapshot's recorded ring and roll it
    forward from the fsynced trace tail — the journal half of
    :meth:`RecoveryManager.recover`, shared with the chaos-fuzz child
    harness (``svoc_torch/durability/fuzz.py``) so the fuzzer exercises
    the REAL restore/continuity code, not a reimplementation.

    Asserts fingerprint continuity (the ring must re-digest to the
    snapshot's recorded fingerprint — :class:`RecoveryError` otherwise)
    and fires ``recovery.post_restore`` between the restore and
    whatever the caller does next (counter re-seed, WAL reconcile).
    Returns ``{"journal_events": ..., "tail_events": ...}``.
    """
    from svoc_torch.utils.events import read_trace_events

    snap_seq = 0
    ring: List[Dict[str, Any]] = []
    if payload is not None:
        ring = payload.get("journal", {}).get("events", [])
        recorded_fp = payload.get("journal", {}).get("fingerprint")
        snap_seq = int(payload.get("journal", {}).get("last_seq", 0))
        journal.restore(ring)
        if recorded_fp is not None and journal.fingerprint() != recorded_fp:
            raise RecoveryError(
                "journal ring fingerprint diverges from the snapshot's "
                "recorded digest — refusing to roll forward on corrupt "
                "history"
            )
    fault_point(RECOVERY_POST_RESTORE)
    tail: List[Dict[str, Any]] = []
    if trace_path is not None and os.path.exists(trace_path):
        tail = read_trace_events(trace_path, since_seq=snap_seq)
        if tail:
            journal.restore(
                (journal.export_ring() if snap_seq else []) + tail
            )
    return {
        "journal_events": len(ring),
        "tail_events": len(tail),
        "tail": tail,
    }


class RecoveryManager:
    """Owns the durable artifacts of one fabric/serving deployment."""

    def __init__(
        self,
        multi,
        *,
        out_dir: str,
        wal=None,
        tier=None,
        clock: Optional[Callable[[], float]] = None,
        compilation_cache: Optional[str] = None,
    ):
        self.multi = multi
        self.out_dir = out_dir
        self.wal = wal
        self.tier = tier
        self._clock = clock
        self._metrics = multi.metrics
        self._lock = threading.Lock()
        self.snapshots = 0
        #: The persistent kernel cache under the durability directory,
        #: resolved once here (the one constructor that knows the
        #: directory).  Durable state, not journal state: WAL and trace
        #: rotation never touch it.
        from svoc_torch.compile.modes import ALLOWED_COMPILATION_CACHES, resolve_compilation_cache

        mode = compilation_cache if compilation_cache is not None else resolve_compilation_cache()
        if mode not in ALLOWED_COMPILATION_CACHES:
            raise ValueError(f"unknown compilation_cache {mode!r}")
        self.compilation_cache = mode
        self.compile_cache_dir: Optional[str] = None
        if mode == "persistent":
            from svoc_torch.compile.cache import enable_persistent_cache

            self.compile_cache_dir = enable_persistent_cache(out_dir, metrics=self._metrics)
        #: Orphan claim state quarantined by a restore (membership
        #: changed between snapshot and recovery).  Carried forward
        #: into every subsequent snapshot — the "never silently
        #: dropped" contract would otherwise only last until the next
        #: cadence tick overwrote snapshot.json.
        self._unclaimed: Dict[str, Any] = {}

    @property
    def snapshot_path(self) -> str:
        return os.path.join(self.out_dir, SNAPSHOT_NAME)

    @property
    def cost_ledger_path(self) -> str:
        return os.path.join(self.out_dir, COST_LEDGER_NAME)

    def _cost_plane(self):
        """The stack's cost-attribution plane, if one is wired: the
        tier owns it; the router carries the tier's reference for the
        dispatch hooks (docs/OBSERVABILITY.md §cost-attribution)."""
        if self.tier is not None:
            plane = getattr(self.tier, "cost_plane", None)
            if plane is not None:
                return plane
        return getattr(self.multi.router, "cost_plane", None)

    def _journal(self):
        from svoc_torch.utils.events import resolve_journal

        return resolve_journal(self.multi.journal)

    # -- the snapshot side --------------------------------------------------

    def snapshot(self) -> str:
        """One atomic snapshot; rotates the WAL afterwards (every cycle
        the snapshot covers is closed, so the archived log is pure
        history).  Returns the snapshot path."""
        journal = self._journal()
        with self._lock:
            payload = multi_session_to_dict(self.multi)
            if self._unclaimed:
                payload["unclaimed"] = dict(self._unclaimed)
            payload["journal"] = {
                "events": journal.export_ring(),
                "last_seq": journal.last_seq(),
                "fingerprint": journal.fingerprint(),
            }
            payload["counters"] = self._metrics.counters_snapshot()
            if self._clock is not None:
                payload["clock"] = float(self._clock())
            if self.tier is not None:
                payload["serving"] = self.tier.serving_state_dict()
            save_snapshot(self.snapshot_path, payload)
            self.snapshots += 1
            n = self.snapshots
        if self.wal is not None:
            try:
                self.wal.rotate()
            except RuntimeError:
                # An open cycle (a commit raced the cadence hook, or a
                # pre-restart cycle awaits reconciliation): keep the
                # log, rotate on a later snapshot.
                self._metrics.counter("wal_rotate_deferred").add(1)
        plane = self._cost_plane()
        if plane is not None and plane.enabled:
            # The cost ledger rides the snapshot cadence as its own
            # sidecar artifact (atomic, like the snapshot): derived
            # telemetry, so it never bloats snapshot.json and a torn
            # ledger never fails a recovery.
            try:
                plane.save_ledger(self.cost_ledger_path)
            except OSError:
                self._metrics.counter(
                    "cost_ledger_errors", labels={"op": "save"}
                ).add(1)
        self._metrics.counter("durability_snapshots").add(1)
        journal.emit(
            "durability.snapshot",
            path=SNAPSHOT_NAME,
            n=n,
            events=len(payload["journal"]["events"]),
            router_steps=payload["router_steps"],
        )
        return self.snapshot_path

    def install_cadence(self, every_n_steps: int = 1) -> None:
        """Snapshot every N cycles from the stack's quiesced point:
        the SERVING tier's post-step hook when a tier is wired
        (completions counted, queues updated — so every admitted
        request is accountable as completed / queued / deferred), else
        the router's (no commit in flight between fabric cycles)."""
        if every_n_steps < 1:
            raise ValueError("every_n_steps must be >= 1")

        if self.tier is not None:
            def hook(_report: Dict[str, Any]) -> None:
                if self.tier.steps % every_n_steps == 0:
                    self.snapshot()

            self.tier.post_step_hooks.append(hook)
        else:
            def hook(_report: Dict[str, Any]) -> None:
                if self.multi.router.steps % every_n_steps == 0:
                    self.snapshot()

            self.multi.router.post_step_hooks.append(hook)

    # -- the recovery side --------------------------------------------------

    def recover(
        self,
        *,
        adapters: Optional[Dict[str, Any]] = None,
        trace_path: Optional[str] = None,
        resend: bool = True,
        prewarm: bool = False,
    ) -> Dict[str, Any]:
        """Bring a freshly-constructed fabric back to the pre-crash
        state: snapshot restore → fingerprint-checked journal ring →
        trace-tail roll-forward → counter re-seed → serving queue
        re-enqueue + lost-request accounting → WAL reconcile.  Safe
        with NO snapshot on disk (first-crash-before-first-snapshot:
        everything restores empty and the WAL reconcile still runs).
        ``prewarm=True`` then walks the primary universe synchronously
        (the pinned ``warmup_mode`` holds: ``"none"`` walks nothing), so
        that the first request after the recovery dispatches warm; a
        defect is counted, never fatal.
        """
        journal = self._journal()
        report: Dict[str, Any] = {
            "snapshot": None,
            "journal_events": 0,
            "tail_events": 0,
            "restored_clock": None,
            "membership": None,
            "requeued": 0,
            "lost_requests": 0,
            "reconcile": None,
        }
        payload = None
        if os.path.exists(self.snapshot_path):
            payload = load_snapshot(self.snapshot_path)
            report["snapshot"] = self.snapshot_path
            report["membership"] = restore_multi_session(
                payload, self.multi, adapters=adapters
            )
            # Quarantined orphans (claims gone from the live roster)
            # survive every future snapshot until an operator (or a
            # later restore into a roster that has them) claims them.
            self._unclaimed.update(payload.get("unclaimed") or {})
        # Ring restore + fingerprint continuity + trace-tail roll-forward
        # (fires ``recovery.post_restore`` between restore and the
        # re-seeding below — the restart-storm kill window).
        rolled = roll_forward_journal(journal, payload, trace_path)
        report["journal_events"] = rolled["journal_events"]
        report["tail_events"] = rolled["tail_events"]
        tail = rolled["tail"]
        if payload is not None:
            self._metrics.restore_counters(payload.get("counters", []))
            if payload.get("clock") is not None:
                report["restored_clock"] = float(payload["clock"])
            if self.tier is not None and payload.get("serving"):
                report["requeued"] = self.tier.restore_serving_state(
                    payload["serving"]
                )
        plane = self._cost_plane()
        if plane is not None and plane.enabled:
            # Warm/cold cost estimates survive the restart with the
            # process: a recovered scheduler plans with measured
            # numbers, not a fresh empty ledger.
            report["cost_ledger_keys"] = plane.restore_ledger(
                self.cost_ledger_path
            )
        report["lost_requests"] = self._account_lost_requests(journal, tail)
        if self.wal is not None:
            rec: ReconcileReport = reconcile_wal(
                self.wal,
                self._adapter_for,
                resend=resend,
                journal=journal,
                registry=self._metrics,
            )
            report["reconcile"] = rec.as_dict()
        if prewarm:
            # Primary variants only: a blocking recovery reaches
            # serving-ready fast; the twins land on the next background walk.
            try:
                worker = self.multi.start_prewarm(background=False, include_twins=False)
                report["prewarm"] = worker.stats() if worker is not None else None
            except Exception:  # noqa: BLE001 — counted, the recovery proceeds
                self._metrics.counter("compile_cache_errors", labels={"op": "prewarm"}).add(1)
                report["prewarm"] = {"error": True}
        return report

    # -- views ---------------------------------------------------------------

    def status(self) -> Dict[str, Any]:
        """The durability panel: snapshot freshness, WAL health — cheap,
        no chain I/O."""
        from svoc_torch.compile.cache import cache_stats

        snap_exists = os.path.exists(self.snapshot_path)
        open_cycles: List[str] = []
        wal_records = 0
        if self.wal is not None:
            records = self.wal.records()
            wal_records = len(records)
            open_cycles = [
                lin
                for lin, c in wal_cycles(records).items()
                if not c["done"]
            ]
        return {
            "snapshot_path": self.snapshot_path,
            "snapshot_exists": snap_exists,
            "snapshots_this_process": self.snapshots,
            "wal_path": getattr(self.wal, "path", None),
            "wal_records": wal_records,
            "wal_open_cycles": open_cycles,
            "compilation_cache": self.compilation_cache,
            "compile_cache_dir": self.compile_cache_dir,
            # Stats of the directory this manager owns only: another
            # enabler may have pointed the process elsewhere.
            "compile_cache": (
                cache_stats(self.compile_cache_dir) if self.compile_cache_dir is not None
                else {"entries": 0.0, "bytes": 0.0}
            ),
        }

    def attach(self, console) -> None:
        """Expose this manager through a
        :class:`~svoc_torch.apps.commands.CommandConsole`: the
        ``durability`` command and ``/api/state``'s durability section
        read it."""
        console.durability = self

    def _adapter_for(self, claim: Optional[str]):
        if claim is None:
            states = self.multi.registry.states()
            if not states:
                raise KeyError("no claims registered")
            return states[0].session.adapter
        return self.multi.get(claim).session.adapter

    def _account_lost_requests(self, journal, tail) -> int:
        """Every request ADMITTED after the snapshot (the trace tail)
        was in flight when the process died: its text is gone (only
        the snapshot carries queue contents), so it cannot be
        re-served — journal each one as
        ``serving.deferred{reason="crash_recovery"}`` and count it
        dropped.  Deliberately CONSERVATIVE: a post-snapshot request
        that completed before the crash is deferred too (per-request
        completions are not journaled — that would bloat every replay
        fingerprint), so the dropped/deferred side may over-count but
        an admitted request is never silently unaccounted; the
        restored counters keep every pre-snapshot completion."""
        lost = 0
        for record in tail:
            if record.get("event") != "serving.admitted":
                continue
            data = record.get("data") or {}
            if data.get("source") != "queue":
                continue  # cache answers completed synchronously
            journal.emit(
                "serving.deferred",
                lineage=record.get("lineage"),
                claim=data.get("claim"),
                seq=data.get("seq"),
                reason="crash_recovery",
            )
            if data.get("claim"):
                self._metrics.counter(
                    "serving_dropped", labels={"claim": str(data["claim"])}
                ).add(1)
            lost += 1
        return lost


class GracefulDrain:
    """SIGTERM/SIGINT → stop admission, flush, snapshot, bundle.

    The drain sequence (docs/RESILIENCE.md §drain):

    1. admission latches: new submissions shed ``reason="draining"``;
    2. in-flight micro-batches flush (bounded ``tier.drain`` steps);
       what cannot complete is journaled ``serving.deferred``;
    3. the recovery manager snapshots (the restart's warm start);
    4. a ``shutdown``-classified postmortem bundle is written
       (:meth:`svoc_torch.utils.postmortem.PostmortemMonitor.shutdown`);
    5. one ``durability.drain`` event summarizes the teardown.

    ``install()`` wires it to SIGTERM/SIGINT, chaining any previous
    handler; ``drain()`` is idempotent and callable directly (tests, the
    end of a scenario).
    """

    def __init__(
        self,
        *,
        manager: Optional[RecoveryManager] = None,
        tier=None,
        monitor=None,
        journal=None,
    ):
        self.manager = manager
        self.tier = tier if tier is not None else (
            manager.tier if manager is not None else None
        )
        self.monitor = monitor
        self._journal = journal
        self._lock = threading.Lock()
        self._drained = False
        from svoc_torch.utils.postmortem import SignalChain

        self._signal_chain = SignalChain(
            lambda signum, _frame: self.drain(reason=f"signal_{signum}")
        )

    def _resolve_journal(self):
        from svoc_torch.utils.events import resolve_journal

        if self._journal is not None:
            return resolve_journal(self._journal)
        if self.manager is not None:
            return self.manager._journal()
        return resolve_journal(None)

    def drain(self, reason: str = "signal") -> Dict[str, Any]:
        with self._lock:
            if self._drained:
                return {"already_drained": True}
            self._drained = True
        report: Dict[str, Any] = {"reason": reason}
        if self.tier is not None:
            report["flush"] = self.tier.drain()
        if self.manager is not None:
            report["snapshot"] = self.manager.snapshot()
        if self.monitor is not None:
            report["bundle"] = self.monitor.shutdown(reason)
        self._resolve_journal().emit(
            "durability.drain",
            reason=reason,
            deferred=report.get("flush", {}).get("deferred", 0),
            snapshot=report.get("snapshot") is not None,
            bundle=report.get("bundle"),
        )
        return report

    def attach(self, console) -> None:
        """Expose the drain path through a
        :class:`~svoc_torch.apps.commands.CommandConsole` (the ``drain``
        command)."""
        console.drainer = self

    def install(self, signals=None) -> "GracefulDrain":
        """Hook SIGTERM/SIGINT through the shared
        :class:`~svoc_torch.utils.postmortem.SignalChain` (previous
        handlers chained, ignored signals stay ignored, default
        disposition re-delivered otherwise)."""
        import signal as _signal

        if signals is None:
            signals = (_signal.SIGTERM, _signal.SIGINT)
        self._signal_chain.install(signals)
        return self

    def uninstall(self) -> None:
        self._signal_chain.uninstall()
