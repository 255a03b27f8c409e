"""Multi-claim fabric smoke: per-claim replay identity + cross-claim
isolation as a gate, on the card by default.

The twin of ``tools/fabric_smoke.py``.  The seeded scenario
(:func:`svoc_torch.fabric.scenario.run_fabric_scenario` — 4 claims × 7
oracles, the last claim carrying a Byzantine offender slot) runs TWICE
with fresh journals, metrics registries, and a pinned lineage scope.
The gate asserts:

1. **Per-claim replay identity** — every claim's slice of the journal
   digests byte-identically across the two runs (slices keep their
   GLOBAL seqs, so identity also certifies the router interleaved the
   claims identically).
2. **Offender handled** — every injected malformed vector was
   quarantined by the offender claim's own gate, and the offender
   address was voted out through that claim's contract.
3. **Isolation** — sibling claims saw ZERO refusing quarantine verdicts
   and ZERO replacements.
4. **Fair service** — every claim was served every cycle.

At seed 0 and 12 cycles it also holds the run to the JAX package's
fingerprints, kept below as constants (:data:`REFERENCE_FINGERPRINTS`,
computed by the reference's ``run_fabric_scenario(0, cycles=12)`` and
rechecked against it by ``tests/test_torch_fabric.py``).

Usage::

    python -m svoc_torch.tools.fabric_smoke [--seed 0] [--cycles 12]
        [--pipelined] [--commit-mode batched] [--device cpu] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
from typing import Any, Dict, Optional

#: ``run_fabric_scenario(0, cycles=12)`` of the JAX package, unpipelined
#: (False) and pipelined (True): the per-claim journal fingerprints, the
#: whole journal's, and its event count.  Both commit modes give these.
REFERENCE_FINGERPRINTS: Dict[bool, Dict[str, Any]] = {
    False: {
        "claims": {
            "alpha": "10304404c1d037c2f3ede70e87f3767f46030f824c7d19e5e6a51d2fab599671",
            "beta": "f554c858b3d681c0c8160f3af92d71035f324b5f95e0f665993371834c23b8b6",
            "gamma": "7a9335bf88a0b5705d64e46bfa3d13f534abe81700481e75d8797f9d9026bc3a",
            "delta": "1d317ea0a333b81a39b94a7dcff41a49e0255a6d067738fc9c2b7ac2bb245f83",
        },
        "journal": "da2379cfe2f20876bc5c9693adeaf86c877b318e22f410a8ebda0223adadbcdb",
        "events": 303,
    },
    True: {
        "claims": {
            "alpha": "4acbad2a572f4431a4a921ccc38c4b3206069e1baf38bd53f6e31e869f68a216",
            "beta": "203c5fd4cf4522bb7249d5501076e486661df4586a49961f3b752818b087d4cb",
            "gamma": "42c0656a71814f76ae5c40fa245e938f1f90078e35eb83845f3d31d297701baf",
            "delta": "2d431bc59381d808581a46f86298c1aaa1ec1abbc60b28f4a775fed45328a153",
        },
        "journal": "dc8d44533b938824b9c7caf15140a0d373c909e1b696f98c075520aa803a28a2",
        "events": 303,
    },
}


def reference_mismatches(result: Dict[str, Any], pipelined: bool) -> Dict[str, Any]:
    """The keys of a seed-0, 12-cycle scenario result that differ from
    :data:`REFERENCE_FINGERPRINTS` (empty when it matches)."""
    ref = REFERENCE_FINGERPRINTS[pipelined]
    got = {c: v["fingerprint"] for c, v in result["claims"].items()}
    out = {c: got.get(c) for c in ref["claims"] if got.get(c) != ref["claims"][c]}
    if result["journal_fingerprint"] != ref["journal"]:
        out["journal"] = result["journal_fingerprint"]
    if result["journal_events"] != ref["events"]:
        out["events"] = result["journal_events"]
    return out


def checks(first: Dict[str, Any], second: Dict[str, Any]) -> Dict[str, bool]:
    """The reference smoke's checks over two runs of one seed."""
    claim_ids = sorted(first["claims"])
    offender = first["claims"][first["offender_claim"]]
    return {
        "per_claim_replay_identical": all(
            first["claims"][c]["fingerprint"] == second["claims"][c]["fingerprint"]
            for c in claim_ids
        ),
        "journal_replay_identical": (
            first["journal_fingerprint"] == second["journal_fingerprint"]
        ),
        "journal_nonempty": first["journal_events"] > 0,
        "injections_happened": first["injection_count"] > 0,
        "every_injection_quarantined": (
            offender["quarantine_verdicts"] == first["injection_count"]
        ),
        "offender_replaced": first["offender_replaced"],
        "siblings_clean": first["siblings_clean"],
        "all_claims_served_every_cycle": all(
            n == len(claim_ids) for n in first["served_per_step"]
        ),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cycles", type=int, default=12)
    p.add_argument("--pipelined", action="store_true")
    p.add_argument("--commit-mode", choices=("per_tx", "batched"), default=None)
    p.add_argument("--device", default=None, help="default: cuda (raises without a card)")
    p.add_argument("--out", default=None, help="write the JSON artifact here")
    args = p.parse_args(argv)

    from svoc_torch.fabric.scenario import run_fabric_scenario

    kwargs = dict(
        cycles=args.cycles, pipelined=args.pipelined,
        commit_mode=args.commit_mode, device=args.device,
    )
    first = run_fabric_scenario(args.seed, **kwargs)
    second = run_fabric_scenario(args.seed, **kwargs)
    result = checks(first, second)
    mismatches: Optional[Dict[str, Any]] = None
    if args.seed == 0 and args.cycles == 12:
        mismatches = reference_mismatches(first, args.pipelined)
        result["matches_reference_fingerprints"] = not mismatches
    ok = all(result.values())
    artifact = {
        "seed": args.seed,
        "cycles": args.cycles,
        "pipelined": args.pipelined,
        "device": args.device or "cuda",
        "checks": result,
        "ok": ok,
        "reference_mismatches": mismatches,
        "offender_claim": first["offender_claim"],
        "offender_address": first["offender_address"],
        "injections": first["injections"],
        "claims": first["claims"],
        "journal_fingerprint": first["journal_fingerprint"],
        "journal_events": first["journal_events"],
    }
    if args.out:
        from svoc_torch.utils.artifacts import atomic_write_json

        atomic_write_json(args.out, artifact)
    for name, passed in result.items():
        print(f"  {'PASS' if passed else 'FAIL'}  {name}")
    if mismatches:
        print("reference mismatches: " + json.dumps(mismatches))
    print(
        f"fabric-smoke {'OK' if ok else 'FAILED'}: "
        f"{len(first['claims'])} claims × {args.cycles} cycles on "
        f"{artifact['device']}, {first['injection_count']} injections "
        f"quarantined, offender {first['offender_address']} replaced in "
        f"'{first['offender_claim']}' only"
    )
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
