"""Hot-path gate: resident staging and batched commits as a check, on the card by default.

The twin of ``tools/hotpath_smoke.py`` (``hotpath_smoke.py:1-179``).  The
seeded 4-claim fabric scenario
(:func:`svoc_torch.fabric.scenario.run_fabric_scenario`) runs TWICE with
the optimised hot path pinned on — resident staging of the claim cubes
(``device_resident=True``) and the batched commit plane
(``commit_mode="batched"``) — and ONCE as the unoptimised control.  A
clean (quarantine-free) 4 claims × 4 cycles × 8 oracles leg runs
batched too.  The reference's six checks, by name:

1. ``optimized_replay_identical`` — the two optimised runs' per-claim
   and journal fingerprints are byte-identical;
2. ``optimized_equals_unoptimized`` — and equal the control's: staging
   and batched commits are not a fingerprint family;
3. ``injections_happened`` — the offender's malformed inputs fired;
4. ``quarantine_fallbacks_counted`` — every quarantined cycle that forced
   the offender's commit to tx granularity is counted in
   ``commit_batch_fallback{reason="skip_slots"}``;
5. ``rpcs_batch_is_claim_cycles`` — the clean leg commits one batched
   RPC a claim-cycle,
6. ``rpcs_tx_is_zero`` — and no per-tx RPC.

At a seed of :data:`REFERENCE_FINGERPRINTS` (with the default cycle
count) the journal and per-claim fingerprints must also equal the JAX
package's ``tools/hotpath_smoke.py``, kept below as literals
(``tests/test_torch_hotpath.py`` rechecks them against a live reference
run); a mismatch fails the gate.

Every run goes on ``--device`` (default CUDA, raising without a card).

Usage::

    python -m svoc_torch.tools.hotpath_smoke [--seed 0] [--cycles 10] [--device cpu] [--out FILE]
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional

#: The clean leg's shape (``hotpath_smoke.py:118``).
RPC_CLAIMS, RPC_CYCLES, RPC_ORACLES = 4, 4, 8
DEFAULT_CYCLES = 10

#: The JAX package's ``tools/hotpath_smoke.py --seed S`` at the default
#: cycle count: the journal fingerprint and the per-claim fingerprints of
#: the optimised runs (the card's machine has no JAX, so they are kept as
#: literals).
REFERENCE_FINGERPRINTS: Dict[int, Dict[str, Any]] = {
    0: {
        "journal": "df75d900940e1abc787d3ef9efd12262d575287a213436e0ceee3e01f743274a",
        "claims": {
            "alpha": "be6e55ffbdbb48ca15980466083e879eb3ac7614eead8b690da43e1e8b9dbd41",
            "beta": "c1cfd91c6e45441a2cea3321b5f14aad026dc0d3118deff29ecc97f670a306a4",
            "delta": "bf55a3a7fd0c9b299626865189462a84b788de1ea1fb1c4ac75b4e4179a075a3",
            "gamma": "cb6317ab3478a8d92ef30abeb9e96be01825dd3fb87868ba2a74c37303ed1815",
        },
    },
}


def reference_mismatches(artifact: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """What of ``artifact``'s fingerprints differs from
    :data:`REFERENCE_FINGERPRINTS`: ``{}`` when everything matches, None
    when its seed and cycle count have no reference figures."""
    ref = REFERENCE_FINGERPRINTS.get(artifact["seed"])
    if ref is None or artifact["cycles"] != DEFAULT_CYCLES:
        return None
    out: Dict[str, Any] = {}
    if artifact["journal_fingerprint"] != ref["journal"]:
        out["journal"] = artifact["journal_fingerprint"]
    claims = artifact["per_claim_fingerprints"]
    for cid in sorted(set(claims) | set(ref["claims"])):
        if claims.get(cid) != ref["claims"].get(cid):
            out[cid] = claims.get(cid)
    return out


def clean_leg_rpcs(seed: int, claims: int, cycles: int, oracles: int, device=None) -> Dict[str, float]:
    """The quarantine-free batched leg; returns the process registry's
    commit-RPC deltas (the adapter counts RPCs in the process registry)."""
    from svoc_torch.fabric.registry import ClaimSpec
    from svoc_torch.fabric.scenario import _claim_names, deterministic_vectorizer
    from svoc_torch.fabric.session import MultiSession
    from svoc_torch.io.comment_store import CommentStore
    from svoc_torch.io.scraper import SyntheticSource
    from svoc_torch.sim.generators import claim_seed
    from svoc_torch.utils.events import EventJournal
    from svoc_torch.utils.metrics import MetricsRegistry
    from svoc_torch.utils.metrics import registry as process_registry

    def store_factory(claim_id: str) -> CommentStore:
        store = CommentStore()
        store.save(SyntheticSource(batch=100, seed=claim_seed(seed, claim_id))())
        return store

    multi = MultiSession(
        base_seed=seed,
        vectorizer=deterministic_vectorizer,
        store_factory=store_factory,
        journal=EventJournal(),
        metrics=MetricsRegistry(),
        lineage_scope="hps",
        max_claims_per_batch=claims,
        device_resident=True,
        commit_mode="batched",
        device=device,
    )
    for name in _claim_names(claims):
        multi.add_claim(ClaimSpec(claim_id=name, n_oracles=oracles))

    def counts():
        return {mode: process_registry.counter("chain_commit_rpcs", labels={"mode": mode}).count
                for mode in ("tx", "batch")}

    before = counts()
    multi.run(cycles)
    after = counts()
    return {mode: after[mode] - before[mode] for mode in after}


def run(seed: int = 0, cycles: int = DEFAULT_CYCLES, device=None) -> Dict[str, Any]:
    """The gate's three scenario runs and the clean leg; returns the
    artifact (``checks``, ``ok``, the fingerprints and the RPC counts)."""
    from svoc_torch.device import resolve_device
    from svoc_torch.fabric.scenario import run_fabric_scenario
    from svoc_torch.utils.metrics import registry as process_registry

    device = resolve_device(device)

    def fallback_count() -> float:
        return process_registry.counter("commit_batch_fallback", labels={"reason": "skip_slots"}).count

    fallbacks_before = fallback_count()
    opt1 = run_fabric_scenario(seed, cycles=cycles, device_resident=True, commit_mode="batched",
                               device=device)
    opt2 = run_fabric_scenario(seed, cycles=cycles, device_resident=True, commit_mode="batched",
                               device=device)
    fallbacks_delta = fallback_count() - fallbacks_before
    control = run_fabric_scenario(seed, cycles=cycles, device=device)

    claim_ids = sorted(opt1["claims"])
    rpcs = clean_leg_rpcs(seed, RPC_CLAIMS, RPC_CYCLES, RPC_ORACLES, device=device)
    checks = {
        "optimized_replay_identical": all(
            opt1["claims"][c]["fingerprint"] == opt2["claims"][c]["fingerprint"] for c in claim_ids
        ) and opt1["journal_fingerprint"] == opt2["journal_fingerprint"],
        "optimized_equals_unoptimized": all(
            opt1["claims"][c]["fingerprint"] == control["claims"][c]["fingerprint"] for c in claim_ids
        ) and opt1["journal_fingerprint"] == control["journal_fingerprint"],
        "injections_happened": opt1["injection_count"] > 0,
        "quarantine_fallbacks_counted": fallbacks_delta > 0,
        # One commit RPC a claim-cycle on the clean leg: C, not C × N.
        "rpcs_batch_is_claim_cycles": rpcs["batch"] == RPC_CLAIMS * RPC_CYCLES,
        "rpcs_tx_is_zero": rpcs["tx"] == 0,
    }
    artifact = {
        "seed": seed,
        "cycles": cycles,
        "device": str(device),
        "checks": checks,
        "clean_leg": {"claims": RPC_CLAIMS, "cycles": RPC_CYCLES, "oracles": RPC_ORACLES,
                      "rpcs": rpcs},
        "skip_slot_fallbacks": fallbacks_delta,
        "journal_fingerprint": opt1["journal_fingerprint"],
        "per_claim_fingerprints": {c: opt1["claims"][c]["fingerprint"] for c in claim_ids},
    }
    mismatches = reference_mismatches(artifact)
    artifact["reference_mismatches"] = mismatches
    artifact["ok"] = all(checks.values()) and not mismatches
    return artifact


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cycles", type=int, default=DEFAULT_CYCLES)
    p.add_argument("--out", default=None, help="write the JSON artifact here")
    p.add_argument("--device", default=None, help="default: cuda (raises without a card)")
    args = p.parse_args(argv)

    artifact = run(args.seed, args.cycles, args.device)
    if args.out:
        from svoc_torch.utils.artifacts import atomic_write_json

        atomic_write_json(args.out, artifact)
    for name, passed in artifact["checks"].items():
        print(f"  {'PASS' if passed else 'FAIL'}  {name}")
    mismatches = artifact["reference_mismatches"]
    if mismatches is None:
        print("  (no reference fingerprints at this seed and cycle count)")
    else:
        print(f"  {'FAIL' if mismatches else 'PASS'}  reference_fingerprints"
              + (f" — differ: {sorted(mismatches)}" if mismatches else ""))
    rpcs = artifact["clean_leg"]["rpcs"]
    print(
        f"hotpath-smoke {'OK' if artifact['ok'] else 'FAILED'} on {artifact['device']}: "
        f"{len(artifact['per_claim_fingerprints'])} claims × {args.cycles} cycles optimized twice "
        f"+ control, clean leg {int(rpcs['batch'])} batched RPCs for "
        f"{RPC_CLAIMS * RPC_CYCLES} claim-cycles"
    )
    return 0 if artifact["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
