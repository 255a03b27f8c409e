"""Sharded claim-cube smoke: mesh-pinned replay identity as a gate, on the
card by default.

The twin of ``tools/shard_smoke.py``.  The seeded fabric scenario (4
claims × 8 oracles, 8 so that the ``"2x4"`` mesh's oracle axis divides
the fleet) runs three times: twice with the router's claim mesh pinned
at ``"2x4"`` (eight slots of the one device,
:mod:`svoc_torch.parallel.mesh`) and once unmeshed (``mesh="off"``).
The gate asserts:

1. the two meshed runs give byte-identical per-claim and whole-journal
   fingerprints;
2. the meshed fingerprints equal the unmeshed ones: the claim-sharded
   dispatch is bitwise the unsharded cube, so a mesh never changes what
   the fabric journals;
3. the mesh really served: ``claim_shard_dispatches`` at least one a
   cycle and ``claim_shard_fallback`` at zero;
4. the Byzantine accounting (offender replaced, siblings clean) holds.

At seed 0 and 10 cycles it also holds the run to the JAX package's
fingerprints, kept below (:data:`REFERENCE_FINGERPRINTS`, computed by
the reference's ``run_fabric_scenario(0, cycles=10, n_oracles=8,
mesh="2x4")`` and rechecked against it by
``tests/test_torch_shard_smoke.py``).  On CUDA it counts the gated
claim-cube kernel's launches of the first meshed run and of the
unmeshed one: the runner launches it once a claim shard (the oracle-axis
slots share that result), so ``MESH_CLAIMS`` a dispatch meshed and one
unmeshed.

Usage::

    python -m svoc_torch.tools.shard_smoke [--seed 0] [--cycles 10]
        [--device cpu] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
from typing import Any, Dict, Optional

MESH = "2x4"
MESH_CLAIMS = 2  # the mesh's claim axis: B3 launches a meshed dispatch
N_ORACLES = 8  # divisible by the mesh's oracle axis

#: ``run_fabric_scenario(0, cycles=10, n_oracles=8, mesh="2x4")`` of the
#: JAX package on its 8 simulated CPU devices: the per-claim journal
#: fingerprints, the whole journal's, and its event count.
REFERENCE_FINGERPRINTS: Dict[str, Any] = {
    "claims": {
        "alpha": "4a81eaf8575ff853e5f76920ab76aa3177f4ff361a342a0e42362dbb9e3d5e6f",
        "beta": "b0455e0e194744f7fd6361d6975d2d637bd13cb2ea116dbe7d977681935e0030",
        "gamma": "4d81238a6cb692ace713eb7874df3b288f3aa64bd0a3553add761e78b4e99f44",
        "delta": "c6c1a88cc841f17ce8bee32e7f113477d01382c1e063143d98919056e2e6204d",
    },
    "journal": "7f07bf1ef5197791c3ea79455b62353e674b0432ed9a2383e2a3007a1e35c14d",
    "events": 251,
}


def _run(seed: int, cycles: int, mesh: str, device) -> Dict[str, Any]:
    """One scenario run with its own metrics registry; on CUDA also the
    gated claim-cube kernel's launches during it."""
    from svoc_torch.fabric.scenario import run_fabric_scenario
    from svoc_torch.ops.fused_consensus import fused_consensus_gated_claims_cuda as b3
    from svoc_torch.utils.metrics import MetricsRegistry

    metrics = MetricsRegistry()
    before = b3.launches
    result = run_fabric_scenario(seed, cycles=cycles, n_oracles=N_ORACLES, mesh=mesh, metrics=metrics,
                                 device=device)
    result["b3_launches"] = b3.launches - before
    result["shard_dispatches"] = metrics.family_total("claim_shard_dispatches")
    result["shard_fallbacks"] = metrics.family_total("claim_shard_fallback")
    return result


def run_shard_smoke(seed: int = 0, cycles: int = 10, device=None) -> Dict[str, Any]:
    """The three runs and the gate's checks; returns the report."""
    first = _run(seed, cycles, MESH, device)
    second = _run(seed, cycles, MESH, device)
    # mesh="off", not None: None would read SVOC_MESH, and a pinned
    # environment would shard the control run too.
    unmeshed = _run(seed, cycles, "off", device)
    claim_ids = sorted(first["claims"])
    fingerprints = {c: first["claims"][c]["fingerprint"] for c in claim_ids}
    checks = {
        "meshed_replay_identical": all(
            fingerprints[c] == second["claims"][c]["fingerprint"] for c in claim_ids
        ),
        "meshed_journal_identical": first["journal_fingerprint"] == second["journal_fingerprint"],
        "meshed_equals_unmeshed": all(
            fingerprints[c] == unmeshed["claims"][c]["fingerprint"] for c in claim_ids
        ) and first["journal_fingerprint"] == unmeshed["journal_fingerprint"],
        "journal_nonempty": first["journal_events"] > 0,
        "sharded_dispatches_happened": first["shard_dispatches"] >= cycles,
        "zero_shard_fallbacks": first["shard_fallbacks"] == 0,
        "injections_happened": first["injection_count"] > 0,
        "offender_replaced": first["offender_replaced"],
        "siblings_clean": first["siblings_clean"],
    }
    mismatches: Optional[Dict[str, Any]] = None
    if seed == 0 and cycles == 10:
        ref = REFERENCE_FINGERPRINTS
        mismatches = {c: fingerprints.get(c) for c in ref["claims"] if fingerprints.get(c) != ref["claims"][c]}
        if first["journal_fingerprint"] != ref["journal"]:
            mismatches["journal"] = first["journal_fingerprint"]
        if first["journal_events"] != ref["events"]:
            mismatches["events"] = first["journal_events"]
        checks["matches_reference_fingerprints"] = not mismatches
    return {
        "seed": seed,
        "cycles": cycles,
        "mesh": MESH,
        "n_oracles": N_ORACLES,
        "device": str(device or "cuda"),
        "checks": checks,
        "ok": all(checks.values()),
        "reference_mismatches": mismatches,
        "fingerprints": fingerprints,
        "journal_fingerprint": first["journal_fingerprint"],
        "journal_events": first["journal_events"],
        "shard_dispatches": first["shard_dispatches"],
        "shard_fallbacks": first["shard_fallbacks"],
        "b3_launches": {"meshed": first["b3_launches"], "unmeshed": unmeshed["b3_launches"]},
        "injection_count": first["injection_count"],
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cycles", type=int, default=10)
    p.add_argument("--device", default=None, help="default: cuda (raises without a card)")
    p.add_argument("--out", default=None, help="write the JSON artifact here")
    args = p.parse_args(argv)
    report = run_shard_smoke(args.seed, args.cycles, args.device)
    if args.out:
        from svoc_torch.utils.artifacts import atomic_write_json

        atomic_write_json(args.out, report)
    for name, passed in report["checks"].items():
        print(f"  {'PASS' if passed else 'FAIL'}  {name}")
    if report["reference_mismatches"]:
        print("reference mismatches: " + json.dumps(report["reference_mismatches"]))
    print(
        f"shard-smoke {'OK' if report['ok'] else 'FAILED'}: mesh {MESH} on {report['device']}, "
        f"{report['shard_dispatches']:.0f} sharded dispatches, {report['shard_fallbacks']:.0f} fallbacks, "
        f"B3 launches {report['b3_launches']}"
    )
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
