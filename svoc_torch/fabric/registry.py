"""Claim registry: per-claim state for the multi-claim consensus fabric.

Mirrors :mod:`svoc_tpu.fabric.registry` (``registry.py:36-198``), the
whole module:

- :class:`ClaimSpec` — the static description of one claim (fleet
  shape, consensus model, scheduling weight, SLO objectives, and an
  optional seeded ``tamper`` hook for Byzantine scenarios);
- :class:`ClaimState` — the live state the fabric owns per claim: the
  claim's :class:`~svoc_torch.apps.session.Session`, its SLO evaluator,
  its scheduling bookkeeping, and the latest claim-batched consensus
  slice;
- :class:`ClaimRegistry` — the thread-safe id → state map the
  :class:`~svoc_torch.fabric.router.ClaimRouter` schedules over.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, List, Optional

from svoc_torch.consensus.kernel import ConsensusConfig


@dataclasses.dataclass(frozen=True)
class ClaimSpec:
    """One claim (market, story, topic).

    ``seed=None`` takes the claim's oracle-stream seed from the fabric's
    base seed (:func:`svoc_torch.sim.generators.claim_seed`).
    ``weight`` is the claim's fair-scheduling share.  ``tamper`` is the
    Byzantine-scenario hook, called as ``tamper(cycle, block)`` with the
    claim's served-cycle count and its ``[N, M]`` fleet block as a host
    float64 numpy array, returning the (possibly corrupted) block as an
    array, which is cast to float32 and put back on the device (the
    reference's contract, ``svoc_tpu/apps/session.py:622-633``); None for
    an honest claim."""

    claim_id: str
    seed: Optional[int] = None
    n_oracles: int = 7
    n_failing: int = 2
    dimension: int = 6
    constrained: bool = True
    #: unconstrained estimator spread (> 0 when ``constrained=False``).
    max_spread: float = 10.0
    weight: int = 1
    commit_objective: float = 0.99
    admission_objective: float = 0.90
    tamper: Optional[Callable] = None

    def __post_init__(self):
        if not self.claim_id:
            raise ValueError("claim_id must be non-empty")
        if "-" in self.claim_id or "/" in self.claim_id:
            # Lineage ids are ``blk<scope>-<claim>-<n>``: a separator in
            # the claim id would make the partition ambiguous.
            raise ValueError(
                f"claim_id {self.claim_id!r} must not contain '-' or '/'"
            )
        if self.weight < 1:
            raise ValueError("weight must be >= 1")
        if not self.constrained and self.max_spread <= 0.0:
            raise ValueError(
                "unconstrained claims need max_spread > 0 "
                "(contract.cairo:365-368 divides by it)"
            )

    def consensus_config(self) -> ConsensusConfig:
        """The claim's consensus configuration; claims that share it and
        their fleet shape batch into one dispatch."""
        return ConsensusConfig(
            n_failing=self.n_failing,
            constrained=self.constrained,
            max_spread=self.max_spread,
        )


class ClaimState:
    """Everything the fabric owns for one live claim.

    Mutable fields are written only by the router's (single-threaded)
    scheduling loop; readers (web UI snapshots) take the registry lock
    around whole-dict reads and tolerate a torn *latest-consensus*
    view exactly like the single-claim web UI tolerates a mid-fetch
    poll.
    """

    def __init__(self, spec: ClaimSpec, session, evaluator, index: int):
        self.spec = spec
        #: the claim's Session (claim-scoped lineage, own adapter /
        #: supervisor / gate / breaker, one instance per claim).
        self.session = session
        #: per-claim SLO evaluator (``svoc_torch.utils.slo.claim_slos``).
        self.evaluator = evaluator
        #: registration ordinal — the scheduler's deterministic tie-break.
        self.index = index
        #: served-cycle count (the ``tamper`` hook's clock).
        self.cycles = 0
        #: scheduling pause (an operator can drain a claim without
        #: removing its state).
        self.paused = False
        #: latest claim-batched consensus slice (None before the first
        #: served cycle): essence, interval_valid, reliable mask,
        #: reliabilities — the fabric's device-side view, vs the
        #: exact-engine state on the claim's own chain.
        self.last_consensus: Optional[Dict[str, Any]] = None
        #: latest commit outcome summary.
        self.last_commit: Optional[Dict[str, Any]] = None

    def snapshot(self) -> Dict[str, Any]:
        """JSON-friendly per-claim state (``/api/state``'s ``claims``
        section, docs/FABRIC.md)."""
        session = self.session
        with session.lock:
            lineage = session.last_lineage
        resilience = session.resilience_snapshot()
        return {
            "claim": self.spec.claim_id,
            "cycles": self.cycles,
            "paused": self.paused,
            "lineage": lineage,
            "consensus": self.last_consensus,
            "commit": self.last_commit,
            "health": resilience["health"],
            "replacements": resilience["replacements"],
            "quarantined": resilience["quarantined"],
            "oracle_list": [
                repr(a) for a in session.adapter.cache_snapshot().get(
                    "oracle_list"
                ) or []
            ],
        }


class ClaimRegistry:
    """Thread-safe claim id → :class:`ClaimState` map, iteration in
    registration order (the scheduler's deterministic base order)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._states: Dict[str, ClaimState] = {}
        self._next_index = 0

    def add(self, spec: ClaimSpec, session, evaluator) -> ClaimState:
        with self._lock:
            if spec.claim_id in self._states:
                raise ValueError(f"claim {spec.claim_id!r} already registered")
            state = ClaimState(spec, session, evaluator, self._next_index)
            self._next_index += 1
            self._states[spec.claim_id] = state
            return state

    def remove(self, claim_id: str) -> ClaimState:
        with self._lock:
            try:
                return self._states.pop(claim_id)
            except KeyError:
                raise KeyError(f"unknown claim {claim_id!r}") from None

    def get(self, claim_id: str) -> ClaimState:
        with self._lock:
            try:
                return self._states[claim_id]
            except KeyError:
                raise KeyError(f"unknown claim {claim_id!r}") from None

    def ids(self) -> List[str]:
        with self._lock:
            return list(self._states)

    def states(self) -> List[ClaimState]:
        """Registration-order snapshot (safe to iterate while claims
        are added concurrently — the list is a copy)."""
        with self._lock:
            return list(self._states.values())

    def __len__(self) -> int:
        with self._lock:
            return len(self._states)

    def __contains__(self, claim_id: str) -> bool:
        with self._lock:
            return claim_id in self._states
