"""Chaos smoke: the seeded fault-injection scenario as a gate.

The twin of ``tools/chaos_smoke.py``.  :func:`svoc_torch.resilience.
chaos.run_chaos_scenario` (7 oracles, transient commit faults on 2,
one persistent offender, the full retry/resume/breaker/supervisor
stack against the local chain) runs twice on one seed.  The checks:
replay identity (the fingerprint over the contract state, the
replacement history, the fired-fault log and the journal), an active
consensus, a complete final cycle, no duplicate tx, the offender voted
out and exactly one replacement, and faults that actually fired.  At
the default seed 4 and 12 cycles it also holds the fingerprint to the
JAX package's (:data:`REFERENCE_FINGERPRINT`).  The scenario is host
work: the contract simulator and the seeded plan take no device.

Usage::

    python -m svoc_torch.tools.chaos_smoke [--seed 4] [--cycles 12] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
from typing import Any, Dict

#: ``run_chaos_scenario(4, cycles=12)`` of the JAX package.
REFERENCE_FINGERPRINT = "caab2f8d00d26d7fa65e8993bcda1d42e70da3037e9c39ea1cad11590e26fa95"


def checks(first: Dict[str, Any], second: Dict[str, Any]) -> Dict[str, bool]:
    """The reference smoke's checks over two runs of one seed."""
    return {
        "replayable": first["fingerprint"] == second["fingerprint"],
        "consensus_active": bool(first["consensus_active"]),
        "final_cycle_complete": bool(first["final_cycle_complete"]),
        "no_duplicate_txs": first["duplicate_txs"] == 0,
        "offender_replaced": bool(first["offender_replaced"]),
        "exactly_one_replacement": first["replacements"] == 1,
        "faults_actually_fired": first["faults_fired"] > 0,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=4)
    p.add_argument("--cycles", type=int, default=12)
    p.add_argument("--out", default=None, help="write the JSON artifact here")
    args = p.parse_args(argv)

    from svoc_torch.resilience.chaos import run_chaos_scenario

    first = run_chaos_scenario(args.seed, cycles=args.cycles)
    second = run_chaos_scenario(args.seed, cycles=args.cycles)
    result = checks(first, second)
    if (args.seed, args.cycles) == (4, 12):
        result["matches_reference_fingerprint"] = (
            first["fingerprint"] == REFERENCE_FINGERPRINT
        )
    ok = all(result.values())
    if args.out:
        from svoc_torch.utils.artifacts import atomic_write_json

        atomic_write_json(args.out, {
            "seed": args.seed, "cycles": args.cycles, "checks": result, "ok": ok,
            "run": first, "replay_fingerprint": second["fingerprint"],
        })
    print(
        json.dumps(
            {
                "chaos_smoke": "ok" if ok else "FAILED",
                "seed": args.seed,
                "checks": result,
                "faults_fired": first["faults_fired"],
                "replacements": first["replacement_history"],
                "fingerprint": first["fingerprint"][:16],
            }
        ),
        flush=True,
    )
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
