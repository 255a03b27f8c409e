"""Fleet health supervisor: scores, hysteresis, automatic replacement.

Mirrors :mod:`svoc_tpu.resilience.supervisor` (``supervisor.py:1-448``),
the whole module, over the port's chain adapter and contract.

The contract carries an admin voting mechanism to replace oracles
(``contract.cairo:661-738``) but the reference drives it by hand
through a menu.  This supervisor closes the loop: it folds two signal
families into a per-oracle health score —

- **commit-failure history** (from the retry layer's
  ``on_oracle_failure`` callback / ``record_commit_failure``): an
  oracle whose signed txs keep failing is infrastructure-dead even if
  its values were fine;
- **on-chain reliability**: the per-oracle ``reliable`` flags from
  ``get_oracle_value_list`` (the two-pass consensus marks the masked
  outliers) weighted by the fleet-level
  ``get_second_pass_consensus_reliability()`` — when the fleet agrees
  confidently (rel₂ high), an individually-flagged oracle is genuinely
  deviant and the penalty is strong; when the whole fleet is noisy the
  flag carries little evidence —

via an EMA (``score = decay·score + (1-decay)·signal``) with
**hysteresis**: quarantine requires the score to sit below
``unhealthy_threshold`` for ``quarantine_after`` consecutive steps
(one bad cycle never triggers a replacement vote), and recovery
requires climbing back above the separate ``healthy_threshold`` (no
flapping at a single boundary).  A quarantined oracle is replaced by
driving the contract's own vote flow: admin 0 proposes (self-voting),
the remaining admins vote yes until the majority swaps the address
in place — the exact mechanism a human operator would use, so the
supervisor needs no privileged backdoor.

Health scores are exported as ``oracle_health{slot=...}`` gauges
(slot-indexed, not address-indexed: the contract swaps addresses in
place, and slot labels keep the cardinality at fleet size with no
stale-label leak after a replacement) plus ``oracle_health_min``, and
replacements count into ``oracle_replacements_total``.

Thread-safe: score state is lock-guarded; chain reads/votes go through
the adapter's own per-op locking and are never made under this lock.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Set

from svoc_torch.consensus.state import ContractError
from svoc_torch.io.chain import ChainAdapter, to_hex
from svoc_torch.utils.metrics import MetricsRegistry
from svoc_torch.utils.metrics import registry as _default_registry


@dataclass(frozen=True)
class SupervisorConfig:
    """Hysteresis and scoring knobs (docs/RESILIENCE.md §supervisor)."""

    #: recovery bound — scores above this clear the unhealthy streak.
    healthy_threshold: float = 0.75
    #: quarantine bound — scores below this grow the streak.
    unhealthy_threshold: float = 0.35
    #: EMA weight on history (0.5 ⇒ a persistently failing oracle
    #: halves per step: 1 → .5 → .25 → quarantine streak begins).
    decay: float = 0.5
    #: per-failure penalty: signal = max(0, 1 − weight·failures).
    failure_weight: float = 0.5
    #: flagged-unreliable signal = weight·(1 − rel₂/2) — fleet
    #: confidence scales the penalty (module docstring).
    unreliable_weight: float = 0.6
    #: consecutive below-threshold steps before quarantine.
    quarantine_after: int = 2
    #: health-failure equivalents per input-integrity quarantine event
    #: (docs/ROBUSTNESS.md): a vector the gate refuses counts like an
    #: EXHAUSTED commit cycle — the retry layer records
    #: ``RetryPolicy.max_attempts`` (default 4) failures for a
    #: persistent offender, and a garbage emitter must be voted out on
    #: the same clock as a dead signer, not 4× slower.
    quarantine_penalty: int = 4
    #: drive the replacement vote (False = observe/alert only).
    auto_replace: bool = True
    #: lifetime replacement budget (runaway-vote backstop).
    max_replacements: int = 8

    def __post_init__(self):
        if not 0.0 <= self.unhealthy_threshold < self.healthy_threshold <= 1.0:
            raise ValueError(
                "need 0 <= unhealthy_threshold < healthy_threshold <= 1"
            )
        if not 0.0 < self.decay < 1.0:
            raise ValueError("decay must be in (0, 1)")
        if self.quarantine_after < 1:
            raise ValueError("quarantine_after must be >= 1")
        if self.quarantine_penalty < 1:
            raise ValueError("quarantine_penalty must be >= 1")


def _default_address_factory(existing: Set[Any]) -> int:
    """Fresh replacement addresses in the 0x1000+ range (clear of the
    test fixtures' 0xA0 admins / 0x10 oracles), skipping collisions.

    SIMULATOR-ONLY: these are synthetic addresses nobody holds keys
    for.  The supervisor refuses to vote them onto a non-local backend
    (see :meth:`FleetHealthSupervisor._replace_oracle`) — on a real
    chain an operator must supply a ``new_address_factory`` that mints
    funded, key-backed accounts."""
    addr = 0x1000
    while addr in existing:
        addr += 1
    return addr


def _backend_is_local(backend: Any, max_depth: int = 8) -> bool:
    """True when the adapter's backend chain bottoms out in the
    in-memory contract simulator (wrappers like the fault injector and
    test recorders expose their wrapped backend as ``.backend`` /
    ``.inner``)."""
    from svoc_torch.io.chain import LocalChainBackend

    for _ in range(max_depth):
        if backend is None:
            return False
        if isinstance(backend, LocalChainBackend):
            return True
        backend = getattr(backend, "backend", None) or getattr(
            backend, "inner", None
        )
    return False


def _addr_label(addr: Any) -> str:
    return to_hex(addr) if isinstance(addr, int) else str(addr)


class FleetHealthSupervisor:
    def __init__(
        self,
        adapter: ChainAdapter,
        config: Optional[SupervisorConfig] = None,
        *,
        new_address_factory: Callable[[Set[Any]], Any] = _default_address_factory,
        registry: Optional[MetricsRegistry] = None,
        journal=None,
        claim: Optional[str] = None,
    ):
        self.adapter = adapter
        self.config = config or SupervisorConfig()
        self._new_address_factory = new_address_factory
        self._registry = registry or _default_registry
        #: Event journal (``svoc_torch.utils.events``): health folds,
        #: quarantine charges, and replacement votes become typed
        #: events joinable by block lineage.  None = process default.
        self._journal = journal
        #: Multi-claim fabric (docs/FABRIC.md): the claim this fleet
        #: serves.  When set, every health/charge/replacement event
        #: carries ``claim`` in its data and the gauges grow a
        #: ``claim`` label — N supervisors in one process stay N
        #: distinguishable series instead of overwriting each other's
        #: slot gauges.  None = the single-claim series, unchanged.
        self.claim = claim
        self._lock = threading.Lock()
        self._scores: Dict[Any, float] = {}
        self._streaks: Dict[Any, int] = {}
        self._quarantined: Set[Any] = set()
        self._pending_failures: Dict[Any, int] = {}
        self._steps = 0
        self._replace_disabled = False
        #: replacement history: {step, slot, old, new, ts} (soak artifacts).
        self.replacements: List[Dict[str, Any]] = []

    # -- signal intake (called from the commit path) ------------------------

    def record_commit_failure(self, oracle_address: Any, cause: Any = None) -> None:
        """One failed signed tx for this oracle (the retry layer calls
        this per attempt, so a persistent offender accrues
        ``max_attempts`` failures per cycle — a strong, fast signal)."""
        with self._lock:
            self._pending_failures[oracle_address] = (
                self._pending_failures.get(oracle_address, 0) + 1
            )

    def _emit(self, event_type: str, lineage: Optional[str] = None, **data):
        """Journal emission — callers must not hold ``self._lock``
        (subscribers may read supervisor snapshots back)."""
        j = self._journal
        if j is None:
            from svoc_torch.utils.events import journal as j
        if self.claim is not None:
            # Claim travels with the event (fabric audit joins can then
            # partition without parsing lineage ids).  Only when set:
            # single-claim payloads — and their replay fingerprints —
            # must stay byte-identical without a claim.
            data.setdefault("claim", self.claim)
        j.emit(event_type, lineage=lineage, **data)

    def record_quarantine(
        self, oracle_address: Any, reason: str, lineage: Optional[str] = None
    ) -> None:
        """One input-integrity quarantine for this oracle (the gate in
        :mod:`svoc_torch.robustness.sanitize` calls this when it refuses
        a vector).  Feeds the SAME pending-failure channel as
        :meth:`record_commit_failure` — a quarantined vector counts
        against the oracle exactly like commit failures, scaled by
        ``quarantine_penalty`` so one refused vector per cycle matches
        the signal strength of an exhausted commit budget.  Counted
        into ``oracle_quarantine{reason=}`` (the gate counts its own
        series too; this one is scoped to SUPERVISED refusals) and
        journaled as ``supervisor.charge`` carrying the block lineage
        that triggered it — the audit-record link between a quarantine
        verdict and the replacement clock it advanced."""
        with self._lock:
            self._pending_failures[oracle_address] = (
                self._pending_failures.get(oracle_address, 0)
                + self.config.quarantine_penalty
            )
        self._registry.counter(
            "oracle_quarantine_supervised", labels={"reason": reason}
        ).add(1)
        self._emit(
            "supervisor.charge",
            lineage=lineage,
            oracle=_addr_label(oracle_address),
            reason=reason,
            penalty=self.config.quarantine_penalty,
        )

    # -- the supervision step ----------------------------------------------

    def step(self, lineage: Optional[str] = None) -> Dict[str, Any]:
        """One fold: read chain signals, update scores + hysteresis,
        quarantine, and (when enabled) drive replacement votes.  Chain
        I/O happens OUTSIDE the score lock — a slow RPC must not block
        ``record_commit_failure`` from the commit path.  ``lineage``
        tags the emitted ``supervisor.health`` / ``.replacement``
        events with the block cycle that drove this fold."""
        adapter = self.adapter
        admins = adapter.call_admin_list()
        oracles = adapter.call_oracle_list()
        rel2 = 0.0
        reliable: Dict[Any, bool] = {}
        enabled: Dict[Any, bool] = {}
        try:
            # peek: the history-feeding read is for operators — a 5 s
            # supervision cadence must not flood the rel₂ trajectory
            # ring the capture-slide alarm windows over.
            rel2 = float(adapter.peek_second_pass_reliability())
            rel2 = max(0.0, min(1.0, rel2))
            if admins:
                for addr, _vec, en, ok in adapter.call_oracle_value_list(
                    admins[0]
                ):
                    reliable[addr] = bool(ok)
                    enabled[addr] = bool(en)
        except Exception:  # svoclint: disable=SVOC014 -- deliberate: a pre-consensus contract state is routine bootstrap (rel₂ simply absent this step) and a faulted TRANSPORT read already counted on the breaker before reaching here; health keeps running on the commit-failure signal
            # Pre-consensus state or a faulted read: health runs on the
            # commit-failure signal alone this step.
            reliable, enabled = {}, {}

        cfg = self.config
        to_replace: List[Any] = []
        with self._lock:
            self._steps += 1
            pending, self._pending_failures = self._pending_failures, {}
            # Drop state for addresses no longer in the fleet (replaced
            # out from under us, e.g. by a human admin).
            current = set(oracles)
            for stale in [a for a in self._scores if a not in current]:
                self._scores.pop(stale, None)
                self._streaks.pop(stale, None)
                self._quarantined.discard(stale)
            for addr in oracles:
                fails = pending.get(addr, 0)
                # Fold by min(): the WORSE of the two signal families
                # wins — a precedence ordering would let a mild
                # tx-failure stream (e.g. one flake per cycle ⇒ 0.5)
                # mask a stronger consensus-unreliability penalty and
                # shield a bad oracle from quarantine indefinitely.
                signal = 1.0
                if fails:
                    signal = max(0.0, 1.0 - cfg.failure_weight * fails)
                if enabled.get(addr) and not reliable.get(addr, True):
                    # consensus flagged it; fleet confidence scales the
                    # penalty (rel₂→1 ⇒ signal→weight/2, rel₂→0 ⇒ weight)
                    signal = min(
                        signal, cfg.unreliable_weight * (1.0 - rel2 / 2.0)
                    )
                score = cfg.decay * self._scores.get(addr, 1.0) + (
                    1.0 - cfg.decay
                ) * signal
                self._scores[addr] = score
                if score < cfg.unhealthy_threshold:
                    streak = self._streaks.get(addr, 0) + 1
                    self._streaks[addr] = streak
                    if (
                        streak >= cfg.quarantine_after
                        and addr not in self._quarantined
                    ):
                        self._quarantined.add(addr)
                elif score > cfg.healthy_threshold:
                    self._streaks[addr] = 0
                    self._quarantined.discard(addr)  # hysteresis recovery
            quarantined = list(self._quarantined)
            if (
                cfg.auto_replace
                and not self._replace_disabled
                and len(self.replacements) < cfg.max_replacements
            ):
                to_replace = [a for a in oracles if a in self._quarantined]
            self._export_gauges(oracles)

        replaced: List[Dict[str, Any]] = []
        for old_addr in to_replace:
            record = self._replace_oracle(old_addr, lineage=lineage)
            if record is not None:
                replaced.append(record)
        report = {
            "step": self._steps,
            "rel2": rel2,
            "scores": self.health_snapshot(),
            "quarantined": [_addr_label(a) for a in quarantined],
            "replaced": replaced,
        }
        self._emit(
            "supervisor.health",
            lineage=lineage,
            step=report["step"],
            rel2=round(rel2, 6),
            min_score=min(report["scores"].values(), default=1.0),
            quarantined=report["quarantined"],
            replaced=len(replaced),
        )
        return report

    def _export_gauges(self, oracles: List[Any]) -> None:
        # Callers hold self._lock.
        claim_label = (
            {} if self.claim is None else {"claim": self.claim}
        )
        lo = 1.0
        for slot, addr in enumerate(oracles):
            score = self._scores.get(addr, 1.0)
            lo = min(lo, score)
            self._registry.gauge(
                "oracle_health", labels={"slot": str(slot), **claim_label}
            ).set(score)
        self._registry.gauge("oracle_health_min", labels=claim_label).set(lo)
        self._registry.gauge(
            "oracles_quarantined", labels=claim_label
        ).set(len(self._quarantined))

    # -- the replacement vote flow ------------------------------------------

    def _replace_oracle(
        self, old_addr: Any, lineage: Optional[str] = None
    ) -> Optional[Dict[str, Any]]:
        """Drive the contract's own replacement machinery: admin 0
        proposes (self-vote), remaining admins vote yes until the swap
        lands.  Returns the history record, or None when replacement is
        unavailable (disabled on chain, address raced away, ...)."""
        adapter = self.adapter
        if (
            self._new_address_factory is _default_address_factory
            and not _backend_is_local(adapter.backend)
        ):
            # The default factory mints SYNTHETIC addresses (no keys
            # exist for them).  Voting one into a real fleet would turn
            # a flaky oracle into a permanently unsignable slot —
            # strictly worse than doing nothing.  Downgrade to
            # observe-only until an operator wires a real factory.
            with self._lock:
                self._replace_disabled = True
            self._registry.counter("supervisor_replace_errors").add(1)
            return None
        try:
            admins = adapter.call_admin_list()
            oracles = adapter.call_oracle_list()
            if old_addr not in oracles or not admins:
                return None
            slot = oracles.index(old_addr)
            new_addr = self._new_address_factory(set(oracles))
            adapter.invoke_update_proposition(admins[0], slot, new_addr)
            for admin in admins[1:]:
                if new_addr in adapter.call_oracle_list():
                    break  # majority reached — voting again would panic
                adapter.invoke_vote_for_a_proposition(admin, 0, True)
            swapped = new_addr in adapter.call_oracle_list()
        except ContractError as e:
            if "replacement disabled" in str(e):
                # Deployed without the feature — stop trying forever.
                with self._lock:
                    self._replace_disabled = True
                return None
            self._registry.counter("supervisor_replace_errors").add(1)
            return None
        except Exception:
            # A faulted chain read/tx mid-flow: count it, try again on a
            # later step — the proposition survives on chain.
            self._registry.counter("supervisor_replace_errors").add(1)
            return None
        if not swapped:
            # Majority not reachable with the available admins.
            self._registry.counter("supervisor_replace_errors").add(1)
            return None
        record = {
            "step": self._steps,
            "slot": slot,
            "old": _addr_label(old_addr),
            "new": _addr_label(new_addr),
            "ts": time.time(),
        }
        with self._lock:
            self.replacements.append(record)
            # Fresh identity, fresh health.
            self._quarantined.discard(old_addr)
            self._scores.pop(old_addr, None)
            self._streaks.pop(old_addr, None)
            self._scores[new_addr] = 1.0
        self._registry.counter("oracle_replacements").add(1)
        self._emit(
            "supervisor.replacement",
            lineage=lineage,
            step=record["step"],
            slot=record["slot"],
            old=record["old"],
            new=record["new"],
        )
        return record

    # -- read-only views (web UI / soak artifacts) --------------------------

    def health_snapshot(self) -> Dict[str, float]:
        """``{slot: score}`` keyed by current oracle-list position —
        no chain I/O beyond the cached oracle list."""
        oracles = self.adapter.cache_snapshot().get("oracle_list") or []
        with self._lock:
            return {
                str(slot): round(self._scores.get(addr, 1.0), 4)
                for slot, addr in enumerate(oracles)
            }

    def quarantined_slots(self) -> List[int]:
        oracles = self.adapter.cache_snapshot().get("oracle_list") or []
        with self._lock:
            return [
                slot
                for slot, addr in enumerate(oracles)
                if addr in self._quarantined
            ]
