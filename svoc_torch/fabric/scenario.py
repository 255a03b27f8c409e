"""Seeded multi-claim fabric scenario: the fabric smoke's gate.

Mirrors :mod:`svoc_tpu.fabric.scenario` (``scenario.py:1-242``):
:func:`run_fabric_scenario`, :func:`deterministic_vectorizer` and
:func:`_injection_schedule`.  ``device=None`` means CUDA (raising
without a card); ``device_resident=True`` turns on the router's resident
staging (the same fingerprints); ``mesh`` pins the router's claim mesh
(the same fingerprints: the claim-sharded dispatch is bitwise the
unsharded one).  ``warmup=True`` runs a
synchronous prewarm of the claim-cube universe before the first cycle
(``scenario.py:183-184``); it never journals, so the fingerprints are
the same with it or without it.

N claims (default 4 × 7 oracles) multiplexed through one
:class:`~svoc_torch.fabric.session.MultiSession`; the LAST claim carries
a Byzantine offender — its final oracle slot emits NaN / Inf /
out-of-range vectors on a seeded schedule (cycle 0 always clean, so every claim's consensus activates).
The run must show:

- every injected vector quarantined by THAT claim's gate and skipped
  from its commit (zero dirty txs), with ZERO quarantines on the
  sibling claims — one claim's poison never crosses the claim axis;
- the offender charged through its own supervisor and voted out via
  its own contract's replacement flow, while sibling fleets keep all
  their oracles;
- byte-identical PER-CLAIM journal fingerprints across two runs of the
  same seed (``EventJournal.fingerprint(lineage_prefix=...)`` — seqs
  are global, so per-claim identity also certifies the scheduler
  interleaved the claims identically).

Everything the run touches is derived from ``seed``: per-claim comment
stores and oracle streams key off :func:`claim_seed`, the injection
schedule off a crc-folded offender key, the deterministic vectorizer
off the comment text itself, and the lineage scope is pinned
(``lineage_scope="fab"``) with a FRESH journal + metrics registry per
run so event seqs and SLO counter deltas replay exactly.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from svoc_torch.fabric.registry import ClaimSpec
from svoc_torch.fabric.session import MultiSession
from svoc_torch.sim.generators import claim_seed

#: Claim ids for the default scenario — no ``-``/``/`` (lineage ids are
#: ``blk<scope>-<claim>-<n>``; ClaimSpec enforces this).
CLAIM_NAMES = ("alpha", "beta", "gamma", "delta", "epsilon", "zeta")


def _claim_names(n: int) -> List[str]:
    if n <= len(CLAIM_NAMES):
        return list(CLAIM_NAMES[:n])
    return list(CLAIM_NAMES) + [f"claim{i}" for i in range(len(CLAIM_NAMES), n)]


def deterministic_vectorizer(texts) -> np.ndarray:
    """Comments → ``[B, 6]`` rows in (0, 1): a pure function of the
    TEXT (crc-seeded), so two runs over the same seeded stores vectorize
    identically — no transformer build, no global RNG."""
    import zlib

    out = np.empty((len(texts), 6), dtype=np.float64)
    for i, text in enumerate(texts):
        rng = np.random.default_rng(zlib.crc32(text.encode()))
        row = rng.uniform(0.05, 0.95, size=6)
        out[i] = row / row.sum()
    return out


def _injection_schedule(
    seed: int, offender_claim: str, cycles: int
) -> List[Optional[str]]:
    """Per-cycle malformed-input kind for the offender slot (None =
    clean).  Cycle 0 is always clean so the claim's consensus activates
    before the attack starts; the kinds cover the constrained gate's
    reachable taxonomy (nan / inf / range — codec-breaking values
    report as ``range`` under the constrained precedence,
    docs/ROBUSTNESS.md)."""
    rng = np.random.default_rng(claim_seed(seed, offender_claim) ^ 0x5C0FAB)
    kinds: List[Optional[str]] = []
    for cycle in range(cycles):
        if cycle == 0 or rng.random() > 0.7:
            kinds.append(None)
        else:
            kinds.append(str(rng.choice(["nan", "inf", "range"])))
    return kinds


def run_fabric_scenario(
    seed: int = 0,
    *,
    cycles: int = 12,
    n_claims: int = 4,
    n_oracles: int = 7,
    dimension: int = 6,
    journal=None,
    metrics=None,
    mesh=None,
    pipelined: bool = False,
    device_resident: bool = False,
    commit_mode: Optional[str] = None,
    warmup: bool = False,
    device=None,
) -> Dict[str, Any]:
    """One seeded fabric run; returns per-claim fingerprints, isolation
    accounting, and the injection log.  Pure function of ``seed`` (plus
    the shape arguments) — :mod:`svoc_torch.tools.fabric_smoke` runs it
    twice and asserts the fingerprints match byte-for-byte.

    ``pipelined`` turns on the double-buffered dispatch (its own
    fingerprint family: consensus events land one cycle later).
    ``commit_mode`` pins the commit plane; it is NOT a fingerprint
    family (the batched plane emits the per-tx plane's exact journal
    events).  ``device`` is where the fleets are drawn and the claim
    cubes dispatched (``None``: CUDA).  ``device_resident`` stages the
    claim cubes in place (bit-identical, not a fingerprint family);
    ``mesh`` is the router's claim mesh (not a fingerprint family either).
    ``warmup=True`` prewarms the universe synchronously first."""
    from svoc_torch.io.comment_store import CommentStore
    from svoc_torch.io.scraper import SyntheticSource
    from svoc_torch.utils.events import EventJournal
    from svoc_torch.utils.metrics import MetricsRegistry

    if n_claims < 2:
        raise ValueError("isolation needs at least one sibling claim")
    journal = journal if journal is not None else EventJournal()
    metrics = metrics if metrics is not None else MetricsRegistry()
    names = _claim_names(n_claims)
    offender_claim = names[-1]
    offender_slot = n_oracles - 1
    kinds = _injection_schedule(seed, offender_claim, cycles)
    injections: List[Dict[str, Any]] = []

    def tamper(cycle: int, block: np.ndarray) -> np.ndarray:
        kind = kinds[cycle] if cycle < len(kinds) else None
        if kind is None:
            return block
        block = np.array(block, copy=True)
        if kind == "nan":
            block[offender_slot, 0] = np.nan
        elif kind == "inf":
            block[offender_slot, :] = np.inf
        else:  # out of the constrained [0, 1] domain
            block[offender_slot, :] = 7.5
        injections.append({"cycle": cycle, "kind": kind})
        return block

    def store_factory(claim_id: str) -> CommentStore:
        store = CommentStore()
        store.save(
            SyntheticSource(batch=120, seed=claim_seed(seed, claim_id))()
        )
        return store

    multi = MultiSession(
        base_seed=seed,
        vectorizer=deterministic_vectorizer,
        store_factory=store_factory,
        journal=journal,
        metrics=metrics,
        lineage_scope="fab",
        max_claims_per_batch=n_claims,
        mesh=mesh,
        pipelined=pipelined,
        device_resident=device_resident,
        commit_mode=commit_mode,
        device=device,
    )
    for name in names:
        multi.add_claim(
            ClaimSpec(
                claim_id=name,
                n_oracles=n_oracles,
                dimension=dimension,
                tamper=tamper if name == offender_claim else None,
            )
        )
    if warmup:
        multi.start_prewarm(background=False, force=True)
    reports = multi.run(cycles)

    claims: Dict[str, Any] = {}
    for name in names:
        state = multi.get(name)
        session = state.session
        resilience = session.resilience_snapshot()
        verdicts = [
            e
            for e in journal.recent(
                type="quarantine.verdict",
                lineage_prefix=session.lineage_prefix + "-",
            )
            if e.data.get("reasons")
        ]
        claims[name] = {
            "cycles": state.cycles,
            "fingerprint": multi.claim_fingerprint(name),
            "replacements": resilience["replacements"],
            "quarantined_slots": resilience["quarantined"],
            "quarantine_verdicts": len(verdicts),
            "oracle_list": [
                hex(a) for a in session.adapter.call_oracle_list()
            ],
            "interval_valid": (
                None
                if state.last_consensus is None
                else state.last_consensus["interval_valid"]
            ),
        }

    offender = claims[offender_claim]
    siblings = {n: c for n, c in claims.items() if n != offender_claim}
    # The offender's original address (slot layout from
    # apps.session._default_contract): replaced means it left the list.
    offender_address = hex(0x10 + offender_slot)
    return {
        "seed": seed,
        "cycles": cycles,
        "claims": claims,
        "offender_claim": offender_claim,
        "offender_address": offender_address,
        "injections": injections,
        "injection_count": len(injections),
        "offender_replaced": (
            offender["replacements"] >= 1
            and offender_address not in offender["oracle_list"]
        ),
        # Isolation: sibling fleets untouched — no quarantine verdicts
        # with reasons, no replacements, full rosters.
        "siblings_clean": all(
            c["quarantine_verdicts"] == 0 and c["replacements"] == 0
            for c in siblings.values()
        ),
        "journal_fingerprint": journal.fingerprint(),
        "journal_events": journal.last_seq(),
        "served_per_step": [len(r["served"]) for r in reports],
    }
