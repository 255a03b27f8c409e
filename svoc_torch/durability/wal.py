"""Commit-intent write-ahead log: durable exactly-once chain semantics.

Mirrors :mod:`svoc_tpu.durability.wal` (``wal.py:1-507``):
:func:`payload_digest`, :func:`seal_jsonl`, :func:`read_wal`,
:class:`CommitIntentWAL` (``:151``) and :class:`WALCycle` (``:356``),
with their declared fault points.  Record lines are the reference's,
byte for byte, for the same cycle (``json.dumps(record, sort_keys=True)``
over the same fields), so either package's reconciler reads the other's
log.

The chain has no rollback, and the off-chain process is a long-lived
multi-claim service: a crash mid-``commit_resilient`` either strands
oracles (txs never sent) or — if a naive restart re-runs the cycle —
double-sends txs that already landed.  The in-process resume solves
this within a process lifetime via ``ChainCommitError.committed``; this
module makes the same accounting survive process death:

- **Before** each per-oracle tx, an *intent* record is appended and
  fsynced (``no durable intent, no tx`` — the hook contract in
  :meth:`svoc_torch.io.chain.ChainAdapter.update_all_the_predictions`).
- **After** the invoke returns, a *landed* record is appended.
- The cycle-open record carries the full felt payload matrix, so a
  restart can both CLASSIFY every slot (join the payload digest against
  the on-chain value, :mod:`svoc_torch.durability.reconcile`) and RESEND
  exactly the stranded ones.

Kill the process at any instruction and the WAL plus the chain pin the
truth:

========================  =========================================
kill point                restart evidence
========================  =========================================
mid cycle-record append   torn tail (ignored) — no intents, no txs
after intent, before tx   intent w/o landed; chain digest ≠ payload
                          → stranded → resend (no tx ever went out)
after tx, before landed   intent w/o landed; chain digest = payload
                          → landed → do NOT resend (zero duplicates)
after landed append       landed record — nothing to reconcile
after done append         cycle closed — nothing to do
========================  =========================================

The WAL is also the **authoritative in-process resume cursor**: a
backend that dies *before reporting* its partial-commit count can
raise a :class:`~svoc_torch.io.chain.ChainCommitError` whose ``committed``
index overstates progress (``sent_count=None`` legacy/third-party
raisers); ``commit_fleet_with_resume`` then consults
:meth:`WALCycle.attempt_cursor` instead of trusting the index delta —
the last slot with a durable intent and no landed record IS the failed
slot (docs/RESILIENCE.md §durability).
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import threading
from typing import Any, Dict, List, Optional, Sequence

from svoc_torch.durability.faultspace import (
    SMOKE_CRASH,
    SMOKE_FUZZ,
    declare,
    fault_point,
    torn_line_write,
)
from svoc_torch.utils.events import fsync_dir

#: The WAL's fault surface: every record append is a durable boundary
#: (a kill before the fsync returns may lose the record to a power cut
#: — the ``torn`` action; a kill after it leaves exactly the durable
#: prefix — ``kill``).  One point per record kind, because each kind
#: threatens a different invariant.
_WAL_POINT = {
    kind: declare(
        f"wal.{kind}.pre_fsync",
        owner="svoc_torch/durability/wal.py",
        invariant=invariant,
        actions=("kill", "torn"),
        smokes=smokes,
        modes=modes,
    )
    for kind, invariant, modes, smokes in (
        ("cycle", "no durable cycle record => no intents, no txs",
         ("per_tx", "batched"), (SMOKE_FUZZ,)),
        ("intent", "no durable intent, no tx (per-tx granularity)",
         ("per_tx",), (SMOKE_FUZZ, SMOKE_CRASH)),
        ("landed", "a lost landed record must re-classify via the "
         "chain digest, never resend", ("per_tx",), (SMOKE_FUZZ,)),
        ("intent_batch", "no durable batch intent, no batch RPC",
         ("batched",), (SMOKE_FUZZ,)),
        ("landed_batch", "a lost landed_batch record must re-classify "
         "via chain digests, never resend", ("batched",), (SMOKE_FUZZ,)),
        ("done", "a cycle killed before its done record must reconcile "
         "to the identical outcome", ("per_tx", "batched"), (SMOKE_FUZZ,)),
    )
}

WAL_ROTATE_PRE_REPLACE = declare(
    "wal.rotate.pre_replace",
    owner="svoc_torch/durability/wal.py",
    invariant="rotation only follows a snapshot: a kill mid-rotate must "
    "leave either the full active log or the full archive, never both "
    "halves",
    actions=("kill",),
    smokes=(SMOKE_FUZZ,),
)


def payload_digest(felts: Sequence[int]) -> str:
    """Canonical digest of one oracle's felt payload — computed over
    the exact ints that cross the chain ABI, so the WAL's digest equals
    the digest of a ``get_the_prediction`` read-back iff the tx landed."""
    blob = json.dumps([int(x) for x in felts]).encode()
    return hashlib.sha256(blob).hexdigest()


def seal_jsonl(path: str) -> bool:
    """Truncate a torn final line off an append-only JSONL file (a
    SIGKILL mid-append).  By WAL semantics a record is durable only
    once its newline is on disk — a torn intent is NO intent, a torn tx
    record is NO tx — so truncation is the correct repair, and it keeps
    the file appendable (a new record concatenated onto a torn tail
    would corrupt BOTH lines).  Returns True when bytes were removed."""
    if not os.path.exists(path):
        return False
    with open(path, "rb") as f:
        blob = f.read()
    if not blob or blob.endswith(b"\n"):
        return False
    cut = blob.rfind(b"\n") + 1  # 0 when no complete line survives
    with open(path, "rb+") as f:
        f.truncate(cut)
        f.flush()
        os.fsync(f.fileno())
    return True


def read_wal(path: str) -> List[Dict[str, Any]]:
    """Parse a WAL file, tolerating a torn final line (a SIGKILL mid-
    append).  Mid-file garbage raises — corruption, not a crash."""
    if not os.path.exists(path):
        return []
    with open(path, "r") as f:
        lines = f.read().split("\n")
    torn = bool(lines) and lines[-1] != ""
    body = lines[:-1]
    out: List[Dict[str, Any]] = []
    for line in body:
        if line:
            out.append(json.loads(line))
    if torn:
        with contextlib.suppress(ValueError):
            out.append(json.loads(lines[-1]))
    return out


class CommitIntentWAL:
    """Append-only fsynced JSONL of commit intents (one per service,
    claim-tagged records — the router commits claims sequentially, and
    the internal lock covers any other caller)."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._f = None
        #: Lazily-loaded set of lineages with a ``done`` record — the
        #: exactly-once dedup key for snapshot-replay re-execution
        #: (:meth:`completed_lineages`).
        self._completed: Optional[set] = None
        #: Lazily-loaded set of lineages with a ``cycle`` record and no
        #: ``done`` record AT ALL — the session's pre-re-execution
        #: guard (:meth:`open_lineages`); incrementally maintained so
        #: the hot path never re-parses the log.
        self._open: Optional[set] = None
        seal_jsonl(path)  # a torn tail from a previous life is NO record
        fsync_dir(self.path)

    def _append(self, record: Dict[str, Any]) -> None:
        with self._lock:
            point = _WAL_POINT.get(record["kind"])
            if point is not None:
                # The named durable boundary (docs/RESILIENCE.md
                # §fault-surface).  Inert unless a chaos harness armed a
                # controller; ``torn`` writes half this record's line
                # (fsynced, no newline) before the SIGKILL — the
                # power-cut fault ``seal_jsonl`` repairs on reopen.
                fault_point(
                    point,
                    payload={"lineage": record.get("lineage")},
                    torn=lambda: self.simulate_torn_append(record),
                )
            if self._f is None:
                self._f = open(self.path, "a")
            self._f.write(json.dumps(record, sort_keys=True) + "\n")
            self._f.flush()
            os.fsync(self._f.fileno())
            if (
                record["kind"] == "done"
                and "failed" not in record
                and self._completed is not None
            ):
                self._completed.add(record["lineage"])
            if self._open is not None:
                if record["kind"] == "cycle":
                    self._open.add(record["lineage"])
                elif record["kind"] == "done":
                    # ANY done record (failure-closed included) makes
                    # the outcome REPORTED — no longer "open".
                    self._open.discard(record["lineage"])

    def simulate_torn_append(self, record: Dict[str, Any]) -> None:
        """CRASH-HARNESS ONLY: write *half* of the record's line (no
        newline), fsync it, and return — the ``torn`` writer the
        ``wal.*.pre_fsync`` fault points hand the controller, which then
        SIGKILLs the process, leaving exactly the torn tail a mid-append
        power cut would (the lock is already held at the fire site).
        The shared power-cut primitive lives in
        :func:`svoc_torch.durability.faultspace.torn_line_write`."""
        if self._f is None:
            self._f = open(self.path, "a")
        torn_line_write(self._f, record)

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                with contextlib.suppress(OSError):
                    self._f.close()
                self._f = None

    def rotate(self) -> None:
        """Archive the active file to ``<path>.1`` (replacing any
        previous archive) and start fresh — called by the recovery
        manager AFTER a successful snapshot, which supersedes every
        closed cycle in the log.  Refuses while a cycle is open."""
        with self._lock:
            records = read_wal(self.path)
            # Failure-closed cycles (done{failed=...}) do NOT block
            # rotation: their outcome was REPORTED (the caller/
            # supervisor own the retry), and rotation only ever runs
            # right after a snapshot — re-execution starts AT that
            # snapshot, so an archived cycle can never re-execute and
            # needs no dedup entry.  Only a cycle with no done record
            # at all (a commit in flight, or a crash awaiting
            # reconciliation) refuses — otherwise one transient
            # transport failure would wedge rotation for the process
            # lifetime and the active log would grow without bound.
            open_cycles = {
                r["lineage"] for r in records if r.get("kind") == "cycle"
            } - {r["lineage"] for r in records if r.get("kind") == "done"}
            if open_cycles:
                raise RuntimeError(
                    f"refusing to rotate WAL with open cycles: "
                    f"{sorted(open_cycles)}"
                )
            if self._f is not None:
                with contextlib.suppress(OSError):
                    self._f.close()
                self._f = None
            fault_point(WAL_ROTATE_PRE_REPLACE)
            if os.path.exists(self.path):
                os.replace(self.path, self.path + ".1")
            self._completed = set()  # the active log is empty again
            self._open = set()
        fsync_dir(self.path)

    def close_cycle(
        self,
        lineage: str,
        sent: int = 0,
        note: Optional[str] = None,
        superseded: Sequence[int] = (),
    ) -> None:
        """Append a ``done`` record for an EXISTING open cycle — the
        reconciler's close, after every slot was accounted (a crashed
        process's cycles have no live :class:`WALCycle` to call
        ``done`` on).  ``superseded`` records the slots a NEWER cycle
        owns (never sent, deliberately — the exactly-once auditors
        exclude them like skips)."""
        record: Dict[str, Any] = {
            "kind": "done",
            "lineage": lineage,
            "sent": int(sent),
            "stranded": [],
        }
        if note is not None:
            record["note"] = note
        if superseded:
            record["superseded"] = sorted(int(s) for s in superseded)
        self._append(record)

    def records(self) -> List[Dict[str, Any]]:
        with self._lock:
            if self._f is not None:
                self._f.flush()
        return read_wal(self.path)

    def completed_lineages(self) -> set:
        """Lineages whose cycle carries a SUCCESSFUL ``done`` record in
        the ACTIVE log — the snapshot-replay dedup set
        (docs/RESILIENCE.md §durability): a restart re-EXECUTES the
        steps after its snapshot, and a re-executed commit whose
        lineage is already done here must skip the chain writes
        outright (its txs landed in the previous life; re-sending them
        is exactly the duplicate the WAL exists to prevent).

        Failure-closed cycles (``done`` with ``failed=...``) are
        deliberately EXCLUDED: their outcome was an error the caller
        may legitimately retry (a breaker that re-closed, a deadline
        that passed), and deduping the retry would fabricate a
        success out of a commit that never completed.  The restart
        reconciler resolves such cycles instead — classifying and
        resending their stranded slots, then closing them cleanly so a
        subsequent re-execution DOES dedup.  Cycles archived by
        rotation are older than the snapshot that rotated them and can
        never re-execute."""
        with self._lock:
            if self._completed is None:
                self._completed = {
                    r["lineage"]
                    for r in read_wal(self.path)
                    if r.get("kind") == "done" and "failed" not in r
                }
            return set(self._completed)

    def open_lineages(self) -> set:
        """Lineages with a ``cycle`` record and NO ``done`` record of
        any kind in the active log — cycles a kill left for the
        reconciler.  A lineage here must never be blind-re-executed:
        its txs may be durably on chain with nothing reported
        (``Session.commit_resilient``'s pre-re-execution guard;
        failure-CLOSED cycles are deliberately absent — their outcome
        was reported and the caller owns the retry).  Cached and
        incrementally maintained; O(1) on the commit hot path."""
        with self._lock:
            if self._open is None:
                opened, done = set(), set()
                for r in read_wal(self.path):
                    if r.get("kind") == "cycle":
                        opened.add(r["lineage"])
                    elif r.get("kind") == "done":
                        done.add(r["lineage"])
                self._open = opened - done
            return set(self._open)

    def cycle(
        self,
        lineage: str,
        *,
        claim: Optional[str] = None,
        oracles: Sequence[Any] = (),
        payloads: Sequence[Optional[List[int]]] = (),
        skip: Sequence[int] = (),
    ) -> "WALCycle":
        """Open one commit cycle: durably records WHAT is about to be
        committed (per-slot felt payloads + oracle addresses) before
        any tx.  ``payloads[i] is None`` marks a slot with no signable
        payload (quarantined/unencodable) — the reconciler treats it
        like ``skip``."""
        return WALCycle(self, lineage, claim, oracles, payloads, skip)


class WALCycle:
    """One cycle's WAL handle — the ``wal=`` object
    :func:`svoc_torch.resilience.retry.commit_fleet_with_resume` drives.

    In-memory attempt state (``attempt_landed`` / ``attempt_cursor``)
    backs the resume-cursor fix; the durable records back the restart
    reconciler.  Not thread-safe across cycles — one commit loop owns
    one cycle, under the session's commit lock.
    """

    def __init__(self, wal, lineage, claim, oracles, payloads, skip):
        self.wal = wal
        self.lineage = lineage
        self.claim = claim
        self._attempt = 0
        self._last_intent: Optional[int] = None
        self._last_intent_landed = False
        self._attempt_landed = 0
        self._attempt_start = 0
        self.wal._append(
            {
                "kind": "cycle",
                "lineage": lineage,
                "claim": claim,
                "total": len(payloads),
                "skip": sorted(int(i) for i in skip),
                "oracles": [
                    a if isinstance(a, (int, str)) else repr(a)
                    for a in oracles
                ],
                "payloads": [
                    None if p is None else [int(x) for x in p]
                    for p in payloads
                ],
            }
        )

    # -- the commit loop's side ---------------------------------------------

    def new_attempt(self, start: int) -> None:
        """Reset attempt-scoped state; called at the top of each commit
        attempt so stranded slots from PREVIOUS attempts never pollute
        the cursor."""
        self._attempt += 1
        self._last_intent = None
        self._last_intent_landed = False
        self._attempt_landed = 0
        self._attempt_start = int(start)

    def intent(self, slot: int, oracle: Any, felts: Sequence[int]) -> None:
        """The pre-tx hook (``on_intent``)."""
        self._last_intent = int(slot)
        self._last_intent_landed = False
        self.wal._append(
            {
                "kind": "intent",
                "lineage": self.lineage,
                "slot": int(slot),
                "attempt": self._attempt,
                "digest": payload_digest(felts),
            }
        )

    def landed(self, slot: int) -> None:
        """The post-tx hook (``on_landed``)."""
        self._attempt_landed += 1
        if self._last_intent == int(slot):
            self._last_intent_landed = True
        self.wal._append(
            {"kind": "landed", "lineage": self.lineage, "slot": int(slot)}
        )

    # -- the batched commit plane (docs/RESILIENCE.md §batched-commits) ------

    def intent_batch(self, slots: Sequence[int]) -> None:
        """ONE fsynced intent covering a whole batched attempt: the
        cycle-open record already journals every slot's payload, so the
        batch intent only pins WHICH slots the single RPC is about to
        carry ("no durable intent, no tx" at batch granularity — one
        fsync instead of N).  No per-slot cursor is maintained: a
        failed batched RPC reports its own failure index
        (``BatchTxError`` → ``ChainCommitError.sent_count``), and a
        crash mid-batch leaves the chain digest as the per-slot
        witness, exactly the reconciler's existing columns."""
        self._last_intent = None
        self._last_intent_landed = False
        self.wal._append(
            {
                "kind": "intent_batch",
                "lineage": self.lineage,
                "slots": [int(s) for s in slots],
                "attempt": self._attempt,
            }
        )

    def landed_batch(self, slots: Sequence[int]) -> None:
        """The batched twin of :meth:`landed`: one fsynced record marks
        every slot the single RPC durably applied (the whole batch on
        success; the applied prefix when the RPC failed mid-fleet).
        The restart reconciler classifies these slots ``landed_batch``
        — same no-resend action as per-tx ``landed`` records."""
        slots = [int(s) for s in slots]
        self._attempt_landed += len(slots)
        self.wal._append(
            {
                "kind": "landed_batch",
                "lineage": self.lineage,
                "slots": slots,
            }
        )

    def done(
        self,
        sent: int,
        stranded: Sequence[Any] = (),
        failed: Optional[str] = None,
    ) -> None:
        """Close the cycle: the outcome was REPORTED to the caller —
        including the failure paths (``failed`` names the reason), whose
        accounting the session already journaled.  A restart has
        nothing to reconcile for a closed cycle; only a kill BETWEEN
        the last durable record and this one leaves work behind."""
        record = {
            "kind": "done",
            "lineage": self.lineage,
            "sent": int(sent),
            "stranded": [
                a if isinstance(a, (int, str)) else repr(a)
                for a in stranded
            ],
        }
        if failed is not None:
            record["failed"] = failed
        self.wal._append(record)

    # -- the resume-cursor fix ----------------------------------------------

    @property
    def attempt_landed(self) -> int:
        """Txs the CURRENT attempt durably landed — the authoritative
        landed count when the raiser supplied no ``sent_count``."""
        return self._attempt_landed

    def attempt_cursor(self) -> Optional[int]:
        """The absolute slot index of the current attempt's in-flight
        (intended, not landed) tx — the failed slot, regardless of what
        the backend's exception claims.  None when the attempt failed
        before its first intent (e.g. the oracle-list read) or after
        its last intent landed (no tx was in flight)."""
        if self._last_intent is None or self._last_intent_landed:
            return None
        return self._last_intent
