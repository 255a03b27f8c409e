"""Serving-tier smoke: seeded replay identity and graceful overload as a
gate, on the card by default.

The twin of ``tools/serving_smoke.py``.  The seeded virtual-time
scenario (:func:`svoc_torch.serving.scenario.run_serving_scenario`: warm,
overload and recovery phases over 3 claims, a hot comment pool feeding
the dedup cache) runs TWICE with fresh journals, fresh metrics
registries and a pinned lineage scope.  The five gates:

1. **Replay identity**: the journal's fingerprint (every admission,
   shed, step, fetch, consensus and commit event) and every per-claim
   slice digest byte-identically across the two runs.
2. **Warm phase clean**: at most 1 % of the under-capacity arrivals shed.
3. **Overload sheds**: the overload phase sheds something.
4. **Cache serves**: the hot pool produces cache hits.
5. **p99 reported**: the request-latency histogram saw completions and
   reports a finite p99.

At seed 0 with the default phases it also holds the run to the JAX
package's fingerprints, kept below as constants
(:data:`REFERENCE_FINGERPRINTS`: the reference's
``run_serving_scenario(0)``, with the cost plane on and off alike;
``tests/test_torch_serving_tier.py`` rechecks them against it).

Usage::

    python -m svoc_torch.tools.serving_smoke [--seed 0] [--cost-plane on|off]
        [--device cpu] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
from typing import Any, Dict

#: ``run_serving_scenario(0)`` of the JAX package (default phases; the
#: cost plane on or off gives these): the per-claim journal
#: fingerprints, the whole journal's, and its event count.
REFERENCE_FINGERPRINTS: Dict[str, Any] = {
    "claims": {
        "alpha": "bce8ccc070ac0accf1a48af7192b7d1ae7e780c6198731b5f678f09115fcf03e",
        "beta": "a92f4d640500b884e9a6b6acde34fdac5120b4b800e074fc9c3a5e26975942f2",
        "gamma": "1c510eb024d9370e3f1a9a463f29670a645eced8931d23e689fa74b4babab57d",
    },
    "journal": "ea0bd35fa8802cd95715c2c5fa80bfaab977e9f6af2136fc74c21caa62d53ad1",
    "events": 1009,
}


def reference_mismatches(result: Dict[str, Any]) -> Dict[str, Any]:
    """The keys of a seed-0, default-phase scenario result that differ
    from :data:`REFERENCE_FINGERPRINTS` (empty when it matches)."""
    ref = REFERENCE_FINGERPRINTS
    got = result["per_claim_fingerprints"]
    out = {c: got.get(c) for c in ref["claims"] if got.get(c) != ref["claims"][c]}
    if result["journal_fingerprint"] != ref["journal"]:
        out["journal"] = result["journal_fingerprint"]
    if result["journal_events"] != ref["events"]:
        out["events"] = result["journal_events"]
    return out


def checks(first: Dict[str, Any], second: Dict[str, Any]) -> Dict[str, bool]:
    """The reference smoke's checks over two runs of one seed."""
    warm, overload, _recovery = first["phases"]
    latency = first["latency"]
    return {
        "journal_replay_identical": first["journal_fingerprint"] == second["journal_fingerprint"],
        "per_claim_replay_identical": all(
            first["per_claim_fingerprints"][c] == second["per_claim_fingerprints"][c]
            for c in first["claims"]
        ),
        "journal_nonempty": first["journal_events"] > 0,
        "warm_phase_clean": warm["shed"] <= 0.01 * warm["submitted"],
        "overload_sheds": overload["shed"] > 0,
        "cache_hits_nonzero": first["cache"]["hits"] > 0,
        "completions_nonzero": first["completed"] > 0,
        "p99_reported": (
            latency.get("count", 0) > 0
            and latency.get("p99") is not None
            and latency["p99"] < float("inf")
        ),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cost-plane", choices=("on", "off"), default=None,
                   help="default: the tier's own resolution")
    p.add_argument("--device", default=None, help="default: cuda (raises without a card)")
    p.add_argument("--out", default=None, help="write the JSON artifact here")
    args = p.parse_args(argv)

    from svoc_torch.serving.scenario import run_serving_scenario

    first = run_serving_scenario(args.seed, cost_plane=args.cost_plane, device=args.device)
    second = run_serving_scenario(args.seed, cost_plane=args.cost_plane, device=args.device)
    result = checks(first, second)
    mismatches = None
    if args.seed == 0:
        mismatches = reference_mismatches(first)
        result["matches_reference_fingerprints"] = not mismatches
    ok = all(result.values())
    latency = first["latency"]
    artifact = {
        "seed": args.seed,
        "device": args.device or "cuda",
        "checks": result,
        "ok": ok,
        "reference_mismatches": mismatches,
        "phases": first["phases"],
        "shed_by_reason": first["shed_by_reason"],
        "cache": first["cache"],
        "latency": latency,
        **{k: first[k] for k in ("submitted", "admitted", "cached", "shed", "completed",
                                 "journal_fingerprint", "journal_events")},
    }
    if args.out:
        from svoc_torch.utils.artifacts import atomic_write_json

        atomic_write_json(args.out, artifact)
    for name, passed in result.items():
        print(f"  {'PASS' if passed else 'FAIL'}  {name}")
    if mismatches:
        print("reference mismatches: " + json.dumps(mismatches))
    print(
        f"serving-smoke {'OK' if ok else 'FAILED'}: {first['submitted']:g} arrivals over "
        f"{first['steps']} steps ({len(first['claims'])} claims) on {artifact['device']}, shed "
        f"{first['shed']:g} (overload {first['phases'][1]['shed']:g}), cache hit rate "
        f"{first['cache']['hit_rate']:.1%}, p99 {latency.get('p99', 0.0) * 1e3:.0f} ms"
    )
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
