"""WAL reconciliation: join commit intents against on-chain truth.

Mirrors :mod:`svoc_tpu.durability.reconcile` (``reconcile.py:1-383``):
the slot classifications, the report classes (:class:`SlotVerdict`,
:class:`CycleReconciliation`, :class:`ReconcileReport`),
:func:`wal_cycles` (``:179``) and :func:`reconcile_wal` (``:226``),
with its two recovery-stage fault points.  It emits the reference's
``durability.reconcile`` events, field for field.

On restart the WAL may hold cycles with no ``done`` record — the
process died mid-commit.  For every such cycle the reconciler
classifies each eligible slot (docs/RESILIENCE.md §durability):

=======================  ====================================  =========
evidence                 meaning                               action
=======================  ====================================  =========
``landed`` record        tx durably confirmed before the       none
                         crash
``landed_batch`` record  slot applied by a batched single-RPC  none
                         commit (docs/RESILIENCE.md
                         §batched-commits) — one record covers
                         the whole applied range
chain digest == WAL      tx landed; the landed append was      none
                         lost
chain digest != WAL      the slot still holds the previous     resend
                         block's value — the tx never went out
chain digest == a NEWER  a later cycle for the same claim      none —
cycle's payload for the  legitimately owns the slot now;       ``super-
same slot                resending this cycle's stale payload  seded``
                         would regress chain data AND, when an
                         earlier partial reconcile already
                         resent it, double-send (fuzzer
                         capture: tests/fixtures/chaos_corpus/
                         duplicate-txs-reconcile-error.json)
chain read fails         backend unreachable: cannot prove     none (re-
                         either way                            run later)
``skip`` / no payload    quarantined or unencodable slot —     none
                         the original commit would not have
                         sent it
=======================  ====================================  =========

A batched attempt killed between its single RPC and its
``landed_batch`` append leaves an ``intent_batch`` with no landed
record — every slot then classifies through the chain-digest columns
above, exactly like a per-tx intent whose landed append was lost.

Only *stranded* slots are resent — a slot is never resent on missing
evidence, so a kill at ANY point (including during a previous
reconcile) produces zero duplicate transactions; and because resends
use the WAL's recorded payload, a crash mid-reconcile converges: the
next reconcile sees the resent slots as landed (chain witness) and
finishes the rest.  *Unknown* slots keep the cycle OPEN (the next
reconcile retries); a cycle with everything landed/stranded-resent is
closed with a ``done`` record so the recovery manager's WAL rotation
can proceed.

One caveat, documented rather than hidden: the chain witness compares
payload digests, so a stranded tx whose payload equals the value
ALREADY on chain (a byte-identical consecutive block — measure-zero for
continuous sentiment vectors) classifies as landed and is not resent.
The chain state is indistinguishable either way; the tx is semantically
idempotent.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

from svoc_torch.durability.faultspace import SMOKE_FUZZ, declare, fault_point
from svoc_torch.durability.wal import CommitIntentWAL, payload_digest

#: The reconciler's own fault surface (kills DURING recovery — the
#: restart-storm class; docs/RESILIENCE.md §fault-surface).
RECONCILE_PRE_RESEND = declare(
    "reconcile.pre_resend",
    owner="svoc_torch/durability/reconcile.py",
    invariant="a resend that faults or dies leaves the slot stranded-"
    "and-accounted; the cycle is conservatively held open, never "
    "double-sent",
    actions=("kill", "error"),
    smokes=(SMOKE_FUZZ,),
    stage="recovery",
)
RECONCILE_MID_CYCLE = declare(
    "reconcile.mid_cycle",
    owner="svoc_torch/durability/reconcile.py",
    invariant="a kill after a cycle's resends but before its close is "
    "idempotent — the next reconcile sees the resent slots landed via "
    "the chain witness and finishes",
    actions=("kill",),
    smokes=(SMOKE_FUZZ,),
    stage="recovery",
)

#: Slot classifications (the decision table above).
LANDED_DURABLE = "landed_durable"
LANDED_BATCH = "landed_batch"
LANDED_CHAIN = "landed_chain"
STRANDED = "stranded"
SUPERSEDED = "superseded"
UNKNOWN = "unknown"
SKIPPED = "skipped"

#: Every classification, in decision-table order — the one tuple the
#: counts/report/gate logic share so a new outcome cannot be added
#: half-way.
CLASSIFICATIONS = (
    LANDED_DURABLE, LANDED_BATCH, LANDED_CHAIN, STRANDED, SUPERSEDED,
    UNKNOWN, SKIPPED,
)


@dataclasses.dataclass
class SlotVerdict:
    slot: int
    oracle: Any
    classification: str
    resent: bool = False
    resend_error: Optional[str] = None

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class CycleReconciliation:
    lineage: str
    claim: Optional[str]
    slots: List[SlotVerdict]
    closed: bool

    def count(self, classification: str) -> int:
        return sum(
            1 for s in self.slots if s.classification == classification
        )

    def as_dict(self) -> Dict[str, Any]:
        return {
            "lineage": self.lineage,
            "claim": self.claim,
            "closed": self.closed,
            "slots": [s.as_dict() for s in self.slots],
            "counts": {c: self.count(c) for c in CLASSIFICATIONS},
        }


@dataclasses.dataclass
class ReconcileReport:
    cycles: List[CycleReconciliation]

    @property
    def open_cycles(self) -> int:
        return len(self.cycles)

    @property
    def resent(self) -> int:
        return sum(1 for c in self.cycles for s in c.slots if s.resent)

    @property
    def unknown(self) -> int:
        return sum(c.count(UNKNOWN) for c in self.cycles)

    @property
    def unaccounted(self) -> int:
        """Slots with NO classification — always 0 by construction;
        exported so the crash gate asserts the property instead of
        trusting it."""
        return sum(
            1
            for c in self.cycles
            for s in c.slots
            if s.classification not in CLASSIFICATIONS
        )

    def as_dict(self) -> Dict[str, Any]:
        return {
            "open_cycles": self.open_cycles,
            "resent": self.resent,
            "unknown": self.unknown,
            "unaccounted": self.unaccounted,
            "cycles": [c.as_dict() for c in self.cycles],
        }


def wal_cycles(records: List[Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    """Fold raw WAL records into per-lineage cycle views."""
    cycles: Dict[str, Dict[str, Any]] = {}
    for r in records:
        kind = r.get("kind")
        lineage = r.get("lineage")
        if kind == "cycle":
            cycles[lineage] = {
                "claim": r.get("claim"),
                "total": int(r.get("total", 0)),
                "skip": set(int(i) for i in r.get("skip", [])),
                "oracles": list(r.get("oracles", [])),
                "payloads": list(r.get("payloads", [])),
                "intents": {},
                "landed": set(),
                "landed_batch": set(),
                "done": False,
                "failed": None,
                "superseded": set(),
            }
        elif lineage in cycles:
            if kind == "intent":
                cycles[lineage]["intents"][int(r["slot"])] = r.get("digest")
            elif kind == "intent_batch":
                # Batch intents pin the attempted range; digests live in
                # the cycle-open payload matrix, which classification
                # reads anyway.
                for slot in r.get("slots", []):
                    cycles[lineage]["intents"].setdefault(int(slot), None)
            elif kind == "landed":
                cycles[lineage]["landed"].add(int(r["slot"]))
            elif kind == "landed_batch":
                for slot in r.get("slots", []):
                    cycles[lineage]["landed_batch"].add(int(slot))
            elif kind == "done":
                # A failure-closed cycle is NOT done for durability
                # purposes: its outcome was an error, its stranded
                # slots still want reconciling, and the replay dedup
                # set excludes it (wal.completed_lineages).
                cycles[lineage]["done"] = "failed" not in r
                cycles[lineage]["failed"] = r.get("failed")
                cycles[lineage]["superseded"] = set(
                    int(s) for s in r.get("superseded", [])
                )
    return cycles


def reconcile_wal(
    wal: CommitIntentWAL,
    adapter_for: Callable[[Optional[str]], Any],
    *,
    resend: bool = True,
    journal=None,
    registry=None,
    lineages=None,
) -> ReconcileReport:
    """Reconcile every open cycle in ``wal`` against the chain.

    ``adapter_for(claim)`` resolves the claim's
    :class:`~svoc_torch.io.chain.ChainAdapter` (claim is None for
    single-claim sessions).  With ``resend=True`` stranded slots are
    re-sent from the WAL's recorded payloads; cycles with nothing left
    unknown are closed.  ``lineages`` (a set) restricts the pass to
    those cycles — the session's pre-re-execution guard resolves ONE
    lineage this way — while supersession evidence still reads the
    full record fold.  Emits one ``durability.reconcile`` journal
    event per open cycle and counts outcomes into
    ``wal_reconciled{outcome=}``.
    """
    from svoc_torch.utils.events import resolve_journal
    from svoc_torch.utils.metrics import registry as _default_registry

    j = resolve_journal(journal)
    reg = registry if registry is not None else _default_registry
    out: List[CycleReconciliation] = []
    ordered = list(wal_cycles(wal.records()).items())
    for idx, (lineage, cyc) in enumerate(ordered):
        if cyc["done"]:
            continue
        if lineages is not None and lineage not in lineages:
            continue
        # Supersession evidence: payload digests of LATER cycles for
        # the same claim, per slot.  Commits are sequential per claim,
        # so a later cycle record means the system moved past this one
        # — if the chain now holds a newer cycle's value, this cycle's
        # stale payload must never be resent (decision table above).
        # All relevant records are in the active log: rotation refuses
        # while this cycle is open.
        newer_digests: Dict[int, set] = {}
        for _lin2, cyc2 in ordered[idx + 1:]:
            if cyc2["claim"] != cyc["claim"]:
                continue
            for slot2, payload2 in enumerate(cyc2["payloads"]):
                if payload2 is not None:
                    newer_digests.setdefault(slot2, set()).add(
                        payload_digest(payload2)
                    )
        try:
            adapter = adapter_for(cyc["claim"])
        except Exception:  # svoclint: disable=SVOC014 -- deliberate: no adapter ⇒ every slot classifies `unknown`, counted below under wal_reconciled{outcome=unknown} and journaled in the durability.reconcile event — never resend on missing evidence
            adapter = None
        # ONE bulk read per cycle (not two RPCs per slot): the chain
        # witness for every slot, or None when the backend is
        # unreachable — the whole cycle then classifies unknown.
        chain_rows = None
        if adapter is not None:
            try:
                chain_rows = adapter.get_the_predictions()
            except Exception:  # svoclint: disable=SVOC014 -- deliberate: an unreachable chain witness ⇒ `unknown` verdicts, counted under wal_reconciled{outcome=unknown}; the cycle stays open for a later pass (the never-resend-on-missing-evidence rule)
                chain_rows = None
        verdicts: List[SlotVerdict] = []
        for slot in range(cyc["total"]):
            oracle = (
                cyc["oracles"][slot] if slot < len(cyc["oracles"]) else None
            )
            payload = (
                cyc["payloads"][slot] if slot < len(cyc["payloads"]) else None
            )
            if slot in cyc["skip"] or payload is None:
                verdicts.append(SlotVerdict(slot, oracle, SKIPPED))
                continue
            if slot in cyc["landed"]:
                verdicts.append(SlotVerdict(slot, oracle, LANDED_DURABLE))
                continue
            if slot in cyc["landed_batch"]:
                # Applied by a batched single-RPC commit — durably
                # recorded, never resent (docs/RESILIENCE.md
                # §batched-commits).
                verdicts.append(SlotVerdict(slot, oracle, LANDED_BATCH))
                continue
            if (
                adapter is None
                or chain_rows is None
                or not 0 <= slot < len(chain_rows)
            ):
                # Backend unreachable / pre-consensus read failure /
                # fleet shrank under us: cannot prove landed OR
                # stranded — never resend on missing evidence.
                verdicts.append(SlotVerdict(slot, oracle, UNKNOWN))
                continue
            on_chain = chain_rows[slot]
            chain_digest = payload_digest(on_chain)
            if chain_digest == payload_digest(payload):
                verdicts.append(SlotVerdict(slot, oracle, LANDED_CHAIN))
                continue
            if chain_digest in newer_digests.get(slot, ()):
                # A later cycle's value owns the slot: resending this
                # cycle's stale payload would regress chain data and —
                # when an earlier partial reconcile already resent it —
                # duplicate the tx.
                verdicts.append(SlotVerdict(slot, oracle, SUPERSEDED))
                continue
            verdict = SlotVerdict(slot, oracle, STRANDED)
            if resend:
                try:
                    # An injected ``error`` here is a resend that
                    # faulted (conservative hold); a ``kill`` is the
                    # restart-storm window before the resend went out.
                    fault_point(
                        RECONCILE_PRE_RESEND,
                        payload={"lineage": lineage, "slot": slot},
                    )
                    adapter._invoke_prediction_felts(oracle, payload)
                    verdict.resent = True
                except Exception as e:
                    # A resend failure leaves the slot stranded-and-
                    # accounted; the cycle stays open for a later pass.
                    verdict.resend_error = repr(e)
            verdicts.append(verdict)
        # The restart-storm window: resends for THIS cycle are on chain
        # but its close (and every later cycle) has not happened — a
        # kill here must be idempotent across the next recovery.
        fault_point(RECONCILE_MID_CYCLE, payload={"lineage": lineage})
        unknown = sum(1 for v in verdicts if v.classification == UNKNOWN)
        failed_resend = sum(
            1 for v in verdicts if v.classification == STRANDED and not v.resent
        ) if resend else 0
        closed = resend and unknown == 0 and failed_resend == 0
        if closed:
            wal.close_cycle(
                lineage,
                sent=sum(1 for v in verdicts if v.resent),
                note="reconciled",
                superseded=[
                    v.slot for v in verdicts
                    if v.classification == SUPERSEDED
                ],
            )
        rec = CycleReconciliation(
            lineage=lineage, claim=cyc["claim"], slots=verdicts, closed=closed
        )
        out.append(rec)
        for v in verdicts:
            reg.counter(
                "wal_reconciled", labels={"outcome": v.classification}
            ).add(1)
        j.emit(
            "durability.reconcile",
            lineage=lineage,
            claim=cyc["claim"],
            closed=closed,
            **{c: rec.count(c) for c in CLASSIFICATIONS},
            resent=sum(1 for v in verdicts if v.resent),
        )
    return ReconcileReport(cycles=out)
