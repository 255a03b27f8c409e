"""Multi-replica fleet chaos gate: failover as a check, on the card by default.

The twin of ``tools/cluster_smoke.py`` (``cluster_smoke.py:1-225``): one
seeded 3-replica × 6-claim scenario
(:func:`svoc_torch.cluster.scenario.run_cluster_scenario`), run TWICE in
fresh work directories with an identical schedule:

- one replica is killed mid-run (SIGKILL semantics at a step boundary —
  the ``replica.kill`` registry point) and failed over two steps later
  (recover-then-migrate over its durable dirs);
- one injected forwarding fault (``error`` @ ``cluster.forward.pre_send``)
  that the per-replica retry/breaker plane must absorb;
- one stale-epoch probe (typed redirect) and one down-replica probe
  (typed ``cluster.unavailable`` shed) aimed into the outage window.

The reference's 13 checks over the results: replay identity (per-claim
and fleet fingerprints byte-identical across the two runs), the
failover served (no claim left on the dead replica, every failed-over
claim migrated with lineage continuity and its chain still growing,
the placement epoch advanced), zero duplicate txs across the shared
chain logs, zero unaccounted admitted requests fleet-wide, the outage
window's sheds typed, the stale probe redirected, all five cluster fault
points witnessed in the durable fired log, and the injected fault
executed.  At a seed of :data:`REFERENCE_FINGERPRINTS` the per-claim and
fleet fingerprints must also equal the JAX package's, kept below as
literals (``tests/test_torch_cluster_smoke.py`` rechecks them against a
live reference run).

Both runs go on ``--device`` (default CUDA, raising without a card).

Usage::

    python -m svoc_torch.tools.cluster_smoke [--seed 0] [--device cpu] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Any, Dict, Optional

N_REPLICAS = 3
N_CLAIMS = 6
TOTAL_STEPS = 10
ARRIVALS_PER_STEP = 8
KILL_REPLICA = "r1"
KILL_AT_STEP = 4
#: The one injected forwarding fault: ``error`` at the 7th firing.
INJECTED = dict(point="cluster.forward.pre_send", nth=7, action="error")

CLUSTER_POINTS = (
    "cluster.forward.pre_send",
    "cluster.migrate.pre_drain",
    "cluster.migrate.post_ship",
    "cluster.migrate.pre_adopt",
    "replica.kill",
)

#: The JAX package's ``tools/cluster_smoke.py --seed S``: the fleet
#: fingerprint and the per-claim fingerprints (the card's machine has no
#: JAX, so they are kept as literals).
REFERENCE_FINGERPRINTS: Dict[int, Dict[str, Any]] = {
    0: {
        "fleet": "d653a533bfef9b2c4e8726aa8a033ad40184de47da118b57578b8352aaea58c0",
        "claims": {
            "c0": "2c1c696016c8c01c2adf80a5d7fa3b90336ba8c14094b9f1ab1521bc9595b886",
            "c1": "3369b8134b3a83885ca82cedd0feef97bbc1d1320c1ad6c2162000f96e67e190",
            "c2": "f7ae40fc8db4c81410bb2078ed333ac81d7c51b3846016e3679f434be61a8aac",
            "c3": "876be020f1ea7e8d46ce80c119d1052b8c4e712da645ce5b4704caa67421d841",
            "c4": "16f596c23c34e5a5408e5d827ce44659abfa62227393b231a4e8bc3876b9181b",
            "c5": "eef52d63e22353bf72120abc8cbfc2edea8084e07a8e043fc6a33fa0d5398bc5",
        },
    },
    3: {
        "fleet": "20b2b52fd9d3bd29f5aab1fc36a7b073394887e5907092d6073278a113fa1e8b",
        "claims": {
            "c0": "a7c2bbae4ce1eb14130b617ad865705240ad5fa4965fb05c62ed8be37f8f2150",
            "c1": "415941a5f48fb7098d590a54b77098ea06ffb5d355db9bdf98be52f8558e51cf",
            "c2": "1c6d72aaa1c2f4719fdcdc9e688ebcb45ed6edb5a24094b8ce4434a74e773e8d",
            "c3": "53b138dccedfbd01e584f09816622cd7d777f521babf331d7149918526594eaa",
            "c4": "2b932fc8d9836dc3b893350589110de632d42ec9aa5386f0206d118b98ecac10",
            "c5": "362592be221fa20ac9f391f1827308aafaca22b21ca4419a9528e3a748ba83da",
        },
    },
}


def reference_mismatches(result: Dict[str, Any], seed: int) -> Optional[Dict[str, Any]]:
    """What of ``result`` (one run's scenario result) differs from
    :data:`REFERENCE_FINGERPRINTS` at ``seed``: ``{}`` when everything
    matches, None when the seed has no reference figures."""
    ref = REFERENCE_FINGERPRINTS.get(seed)
    if ref is None:
        return None
    out: Dict[str, Any] = {}
    if result["fleet_fingerprint"] != ref["fleet"]:
        out["fleet"] = result["fleet_fingerprint"]
    claims = {cid: c["fingerprint"] for cid, c in result["claims"].items()}
    for cid in sorted(set(claims) | set(ref["claims"])):
        if claims.get(cid) != ref["claims"].get(cid):
            out[cid] = claims.get(cid)
    return out


def run_once(seed: int, device=None, workdir: Optional[str] = None) -> dict:
    """One scenario run in ``workdir`` (a fresh temporary directory when
    None), with its durable fired log read back."""
    from svoc_torch.cluster.scenario import run_cluster_scenario
    from svoc_torch.durability.faultspace import FaultEvent, read_fired_log

    workdir = workdir or tempfile.mkdtemp(prefix="cluster-smoke-")
    result = run_cluster_scenario(
        workdir,
        seed=seed,
        n_replicas=N_REPLICAS,
        n_claims=N_CLAIMS,
        total_steps=TOTAL_STEPS,
        arrivals_per_step=ARRIVALS_PER_STEP,
        kill_replica=KILL_REPLICA,
        kill_at_step=KILL_AT_STEP,
        events=[FaultEvent(**INJECTED)],
        device=device,
    )
    result["workdir"] = workdir
    result["fired_log"] = read_fired_log(os.path.join(workdir, "fired.jsonl"))
    return result


def evaluate(first: dict, second: dict) -> list:
    """The reference's 13 checks over two same-seed runs, in its order:
    ``[{"check", "ok", "detail"}]``."""
    checks = []

    def check(name: str, ok: bool, detail: str = "") -> None:
        checks.append({"check": name, "ok": bool(ok), "detail": detail})

    check(
        "per-claim fingerprints byte-identical across runs",
        all(
            first["claims"][cid]["fingerprint"] == second["claims"][cid]["fingerprint"]
            for cid in first["claims"]
        ),
        f"{len(first['claims'])} claims",
    )
    check(
        "fleet fingerprint byte-identical across runs",
        first["fleet_fingerprint"] == second["fleet_fingerprint"],
        first["fleet_fingerprint"][:16],
    )
    check(
        "replica killed mid-run and failed over",
        first["kill"] is not None and first["failover"] is not None,
        f"killed {KILL_REPLICA} @ step {KILL_AT_STEP}",
    )
    owners = {cid: v["owner"] for cid, v in first["claims"].items()}
    check(
        "no claim still placed on the dead replica",
        all(owner != KILL_REPLICA for owner in owners.values()),
        str(owners),
    )
    moved = (first["failover"] or {}).get("claims", {})
    check(
        "every failed-over claim migrated with lineage continuity",
        bool(moved)
        and all(m.get("status") == "migrated" and m.get("continuity") for m in moved.values()),
        f"{sorted(moved)} -> {[m.get('target') for m in moved.values()]}",
    )
    check(
        "migrated claims serving on the new owners (chain still growing)",
        all(first["chain"][cid]["predictions"] > 0 for cid in moved),
        str({cid: first["chain"][cid]["predictions"] for cid in sorted(moved)}),
    )
    check(
        "placement epoch advanced through the failover",
        first["epoch"] > N_REPLICAS,
        f"epoch {first['epoch']}",
    )
    check(
        "zero duplicate txs across the shared chain logs",
        first["duplicate_txs"] == 0 and second["duplicate_txs"] == 0,
        f"{first['duplicate_txs']} + {second['duplicate_txs']}",
    )
    requests = first["requests"]
    check(
        "zero unaccounted admitted requests fleet-wide",
        requests["unaccounted"] == 0 and second["requests"]["unaccounted"] == 0,
        f"admitted={requests['admitted']:.0f} completed={requests['completed']:.0f} "
        f"dropped={requests['dropped']:.0f}",
    )
    check(
        "outage window shed typed, counted, journaled",
        first["cluster_counters"]["cluster_unavailable"] > 0,
        f"{first['cluster_counters']['cluster_unavailable']:.0f} sheds",
    )
    check(
        "stale-epoch probe answered with a typed redirect",
        any(p.get("status") == "redirect" for p in first["probes"]),
    )
    fired = set(first["fired_log"]["fired"]) | set(second["fired_log"]["fired"])
    missing = [p for p in CLUSTER_POINTS if p not in fired]
    check(
        "all cluster fault points witnessed in the durable fired log",
        not missing,
        f"missing={missing}" if missing else f"{len(CLUSTER_POINTS)} points",
    )
    actions = first["fired_log"]["actions"] + second["fired_log"]["actions"]
    check(
        "injected forwarding fault executed and absorbed by retry",
        any(
            a["point"] == "cluster.forward.pre_send" and a["action"] == "error"
            for a in actions
        ),
    )
    return checks


def run(seed: int = 0, device=None, base: Optional[str] = None) -> dict:
    """Both runs and their checks; returns the artifact (``ok``,
    ``checks``, ``reference_mismatches``, the first run's figures, and
    both runs' results under ``runs``)."""
    base = base or tempfile.mkdtemp(prefix="cluster-smoke-")
    first = run_once(seed, device, os.path.join(base, "run1"))
    second = run_once(seed, device, os.path.join(base, "run2"))
    checks = evaluate(first, second)
    mismatches = reference_mismatches(first, seed)
    if mismatches is not None:
        checks.append({
            "check": "fingerprints equal the JAX package's",
            "ok": not mismatches,
            "detail": json.dumps(mismatches) if mismatches else f"seed {seed}",
        })
    return {
        "artifact": "cluster_smoke",
        "seed": seed,
        "device": str(device or "cuda"),
        "config": {
            "n_replicas": N_REPLICAS,
            "n_claims": N_CLAIMS,
            "total_steps": TOTAL_STEPS,
            "arrivals_per_step": ARRIVALS_PER_STEP,
            "kill": {"replica": KILL_REPLICA, "at_step": KILL_AT_STEP},
        },
        "checks": checks,
        "reference_mismatches": mismatches,
        "requests": first["requests"],
        "cluster_counters": first["cluster_counters"],
        "claims": first["claims"],
        "fleet_fingerprint": first["fleet_fingerprint"],
        "epoch": first["epoch"],
        "ok": all(c["ok"] for c in checks),
        "runs": [first, second],
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="write the JSON artifact here")
    p.add_argument("--device", default=None, help="default: cuda (raises without a card)")
    args = p.parse_args(argv)

    artifact = run(args.seed, args.device)
    for c in artifact["checks"]:
        print(f"[{'PASS' if c['ok'] else 'FAIL'}] {c['check']}"
              + (f" — {c['detail']}" if c["detail"] else ""))
    if args.out:
        from svoc_torch.utils.artifacts import atomic_write_json

        atomic_write_json(args.out, {k: v for k, v in artifact.items() if k != "runs"})
    print(f"{'PASS' if artifact['ok'] else 'FAIL'}: cluster smoke on {artifact['device']}, fleet "
          f"fingerprint {artifact['fleet_fingerprint'][:16]}, epoch {artifact['epoch']}")
    return 0 if artifact["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
