"""Live-reconfiguration chaos gate: transactional re-pin as a check, on the card by default.

The twin of ``tools/reconfig_smoke.py`` (``reconfig_smoke.py:1-297``):
three run families over
:func:`svoc_torch.cluster.reconfig_scenario.run_reconfig_scenario`, all
seeded and byte-reproducible:

1. **Committed transition, twice** — a 3-replica × 6-claim fleet under
   traffic (10 steps, 8 arrivals a step), with a rolling re-pin applied
   at step 4: ``commit_mode="batched"`` and claim ``c0`` re-specced to 9
   oracles, in one transaction.  The controller's traffic hook fires a
   probe at every stage boundary, so the DEFERRED path is in the
   replayed stream.  Checked: replay identity (fleet and per-claim
   fingerprints byte-identical across the two runs, INCLUDING the epoch
   transition), the epoch chain advanced exactly once, lineage
   continuity for every re-pinned claim, the spec-diff claim carried,
   zero shed (every probe deferred), every deferred request released,
   zero duplicate txs, zero unaccounted requests, the pending universe
   prewarmed.
2. **Abort at every fault point** — a 2-replica × 3-claim fleet, one run
   per ``reconfig.*`` point with an injected ``error``, each against a
   baseline with the identical schedule AND event list but no plan.
   Checked: the abort report is typed, the rollback leaves the fleet
   fingerprint byte-identical to never having attempted the plan, and
   zero requests were dropped or duplicated.
3. **Coverage** — all five ``reconfig.*`` points witnessed in the durable
   fired logs.

At a seed of :data:`REFERENCE_FINGERPRINTS` the committed run's fleet and
per-claim fingerprints and epoch chain, and each abort pair's baseline
fleet fingerprint, must also equal the JAX package's, kept below as
literals (``tests/test_torch_reconfig_smoke.py`` rechecks them against a
live reference run).

Every run goes on ``--device`` (default CUDA, raising without a card).

Usage::

    python -m svoc_torch.tools.reconfig_smoke [--seed 0] [--device cpu] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Any, Dict, Optional

N_REPLICAS = 3
N_CLAIMS = 6
TOTAL_STEPS = 10
ARRIVALS_PER_STEP = 8
RECONFIG_AT_STEP = 4
#: The abort family's smaller fleet and schedule.
ABORT_RUN = dict(n_replicas=2, n_claims=3, total_steps=6, arrivals_per_step=4, reconfig_at_step=2,
                 traffic_probes=False)

RECONFIG_POINTS = (
    "reconfig.prepare",
    "reconfig.post_drain",
    "reconfig.post_ship",
    "reconfig.pre_repin",
    "reconfig.pre_resume",
)

#: The JAX package's ``tools/reconfig_smoke.py --seed S`` figures: the
#: committed run's fleet fingerprint, per-claim fingerprints and epoch
#: chain, and each abort pair's baseline fleet fingerprint (the card's
#: machine has no JAX, so they are kept as literals).
REFERENCE_FINGERPRINTS: Dict[int, Dict[str, Any]] = {
    0: {
        "fleet": "05a6020901edd25df5b1b695364a072dfae67a7d2b225e3ffcde5f828214e2b7",
        "claims": {
            "c0": "40bedc2d6627a0cb9c9fd980ce45576debad6924ae9cc855e7450fbaa854d8ca",
            "c1": "e4038ab327696c0b4524b35861fa8d657a066ac691ad816c0c55722b7fecaf91",
            "c2": "4b61c64b9feb9918077be7c5d13f7ab954126aea86176b83524654d929dad536",
            "c3": "6f41830f627507c3a31d758268a68d842ce2a4d19093b12769b778511a96c2ac",
            "c4": "b3e4ad17fbe7e993687357a850ea39830ec5f2d29ba08cde0fdf082f50e3da0d",
            "c5": "51df79ce8615ebe1ee551e56d3ea25c790c3c44d2805ebfce7009caa5ffafd9f",
        },
        "epoch_chain": [{
            "epoch": 1,
            "plan": "59c20c395b1d6988c5e7c60e36d2efefd1964e40620e620235dee4bd7320cbdd",
            "pre_fleet": "1082d368f11be18a51007acf5fdc304e168633c4ffaf4535055f4f9b793c67c9",
            "replicas": ["r0", "r1", "r2"], "added": [], "removed": [],
        }],
        "abort_baselines": {
            "reconfig.prepare": "4f053be1e517662b1d3bc85756db0243a15fd099cab500c4c0da64773913d1c4",
            "reconfig.post_drain": "76f3b78ef83e4debd2395c070790558b829b02096464166f042e2d67552d4fe4",
            "reconfig.post_ship": "900541a5c53a2dea284357fb1bd6754de81e975dd437a0d46125663e90437aeb",
            "reconfig.pre_repin": "1d19d0f147f21a28435401a85de812ed951571528f856eb5b46e846b3653b9b5",
            "reconfig.pre_resume": "03823f854b51463d128e8b25c43bb6126bcdaaedfe23064c16c543d8f1760213",
        },
    },
}


def plan_dict(n_oracles: int = 7, dimension: int = 6) -> dict:
    """The committed transition: flip the WAL commit mode and re-spec one
    claim (a wider oracle panel) in one transaction — a knob re-pin AND a
    spec-diff carry through the same epoch boundary."""
    from svoc_torch.fabric.registry import ClaimSpec
    from svoc_torch.utils.checkpoint import claim_spec_to_dict

    return {
        "consensus_impl": None,
        "mesh": None,
        "commit_mode": "batched",
        "claims": {"c0": claim_spec_to_dict(ClaimSpec(claim_id="c0", n_oracles=n_oracles + 2,
                                                      dimension=dimension))},
        "add_replicas": [],
        "remove_replicas": [],
    }


def _run(workdir: str, seed: int, device, **kwargs) -> dict:
    from svoc_torch.cluster.reconfig_scenario import run_reconfig_scenario
    from svoc_torch.durability.faultspace import read_fired_log

    t0 = time.perf_counter()
    result = run_reconfig_scenario(workdir, seed=seed, device=device, **kwargs)
    result["seconds"] = time.perf_counter() - t0
    result["workdir"] = workdir
    result["fired_log"] = read_fired_log(os.path.join(workdir, "fired.jsonl"))
    return result


def run_committed(seed: int, device=None, workdir: Optional[str] = None) -> dict:
    """One committed transition run in ``workdir`` (fresh when None)."""
    return _run(workdir or tempfile.mkdtemp(prefix="reconfig-smoke-"), seed, device,
                n_replicas=N_REPLICAS, n_claims=N_CLAIMS, total_steps=TOTAL_STEPS,
                arrivals_per_step=ARRIVALS_PER_STEP, reconfig_at_step=RECONFIG_AT_STEP, plan=plan_dict())


def run_abort_pair(seed: int, point: str, device=None, base: Optional[str] = None) -> tuple:
    """(baseline, aborted) — identical schedule and event list; only the
    plan differs, and the abort must erase it."""
    from svoc_torch.durability.faultspace import FaultEvent

    base = base or tempfile.mkdtemp(prefix="reconfig-abort-")
    events = [FaultEvent(point=point, nth=1, action="error")]
    return tuple(
        _run(os.path.join(base, f"{point}-{tag}"), seed, device, plan=plan, events=list(events), **ABORT_RUN)
        for tag, plan in (("baseline", None), ("aborted", plan_dict()))
    )


def reference_mismatches(first: dict, aborts: Dict[str, dict], seed: int) -> Optional[Dict[str, Any]]:
    """What of the committed run ``first`` and the abort family's
    baselines (``aborts[point]["baseline_fleet"]``) differs from
    :data:`REFERENCE_FINGERPRINTS` at ``seed``: ``{}`` when everything
    matches, None when the seed has no reference figures."""
    ref = REFERENCE_FINGERPRINTS.get(seed)
    if ref is None:
        return None
    out: Dict[str, Any] = {}
    if first["fleet_fingerprint"] != ref["fleet"]:
        out["fleet"] = first["fleet_fingerprint"]
    claims = {cid: c["fingerprint"] for cid, c in first["claims"].items()}
    for cid in sorted(set(claims) | set(ref["claims"])):
        if claims.get(cid) != ref["claims"].get(cid):
            out[cid] = claims.get(cid)
    if first["epoch_chain"] != ref["epoch_chain"]:
        out["epoch_chain"] = first["epoch_chain"]
    for point, fp in ref["abort_baselines"].items():
        got = aborts.get(point, {}).get("baseline_fleet")
        if got != fp:
            out[f"baseline {point}"] = got
    return out


def evaluate(first: dict, second: dict, aborted: Dict[str, tuple]) -> list:
    """The reference's checks over the three families, in its order:
    ``[{"check", "ok", "detail"}]``."""
    checks = []

    def check(name: str, ok: bool, detail: str = "") -> None:
        checks.append({"check": name, "ok": bool(ok), "detail": detail})

    report = first["reconfig"] or {}
    check("transition committed under traffic", report.get("status") == "committed",
          f"epoch {first['reconfig_epoch']}")
    check("fleet fingerprint byte-identical across committed runs",
          first["fleet_fingerprint"] == second["fleet_fingerprint"], first["fleet_fingerprint"][:16])
    check("per-claim fingerprints byte-identical across committed runs",
          all(first["claims"][cid]["fingerprint"] == second["claims"][cid]["fingerprint"]
              for cid in first["claims"]),
          f"{len(first['claims'])} claims")
    check("epoch chain advanced exactly once, plan fingerprint recorded",
          first["reconfig_epoch"] == 1 and len(first["epoch_chain"]) == 1
          and first["epoch_chain"][0]["plan"] == report.get("plan_fingerprint"),
          first["epoch_chain"][0]["plan"][:16] if first["epoch_chain"] else "")
    repinned = report.get("replicas") or {}
    check("lineage continuity for every re-pinned claim",
          bool(repinned) and all(c["continuity"] for rep in repinned.values() for c in rep["claims"].values()),
          f"{sum(len(rep['claims']) for rep in repinned.values())} claims across {len(repinned)} replicas")
    check("spec-diff claim carried (fresh session, lineage fields kept)",
          any(rep["claims"].get("c0", {}).get("carried") for rep in repinned.values()))
    deferred = [p for p in first["probes"] if p["response"].get("status") == "deferred"]
    check("mid-transition traffic deferred, never shed",
          len(deferred) > 0 and first["cluster_counters"]["cluster_unavailable"] == 0,
          f"{len(deferred)} deferred, {first['cluster_counters']['cluster_unavailable']:g} sheds")
    check("every deferred request released at commit", report.get("deferred_released") == len(deferred),
          f"{report.get('deferred_released')} released")
    check("zero duplicate txs through the epoch boundary",
          first["duplicate_txs"] == 0 and second["duplicate_txs"] == 0,
          f"{first['duplicate_txs']} + {second['duplicate_txs']}")
    requests = first["requests"]
    check("zero unaccounted admitted requests fleet-wide",
          requests["unaccounted"] == 0 and second["requests"]["unaccounted"] == 0,
          f"admitted={requests['admitted']:.0f} completed={requests['completed']:.0f} "
          f"dropped={requests['dropped']:.0f}")
    check("pending-config universe prewarmed in PREPARE", (report.get("prewarm") or {}).get("keys", 0) > 0,
          str(report.get("prewarm")))

    fired = set(first["fired_log"]["fired"])
    for point, (baseline, abort) in aborted.items():
        rep = abort["reconfig"] or {}
        fired |= set(abort["fired_log"]["fired"])
        check(f"abort @ {point} rolls back to the never-attempted fingerprint",
              rep.get("status") == "aborted" and abort["fleet_fingerprint"] == baseline["fleet_fingerprint"]
              and abort["requests"]["unaccounted"] == 0 and abort["duplicate_txs"] == 0,
              f"phase={rep.get('phase')}")
    missing = [p for p in RECONFIG_POINTS if p not in fired]
    check("all reconfig fault points witnessed in the durable fired logs", not missing,
          f"missing={missing}" if missing else f"{len(RECONFIG_POINTS)} points")
    return checks


def run(seed: int = 0, device=None, base: Optional[str] = None) -> dict:
    """Every run and its checks; returns the artifact (``ok``, ``checks``,
    ``reference_mismatches``, ``seconds`` by run, the committed run's
    figures, and the runs themselves under ``runs``)."""
    base = base or tempfile.mkdtemp(prefix="reconfig-smoke-")
    first = run_committed(seed, device, os.path.join(base, "committed-1"))
    second = run_committed(seed, device, os.path.join(base, "committed-2"))
    aborted = {point: run_abort_pair(seed, point, device, os.path.join(base, "aborts"))
               for point in RECONFIG_POINTS}
    checks = evaluate(first, second, aborted)
    aborts = {
        point: {
            "status": (a["reconfig"] or {}).get("status"),
            "phase": (a["reconfig"] or {}).get("phase"),
            "identical": a["fleet_fingerprint"] == b["fleet_fingerprint"],
            "baseline_fleet": b["fleet_fingerprint"],
            "unaccounted": a["requests"]["unaccounted"],
            "duplicate_txs": a["duplicate_txs"],
        }
        for point, (b, a) in aborted.items()
    }
    mismatches = reference_mismatches(first, aborts, seed)
    if mismatches is not None:
        checks.append({
            "check": "fingerprints equal the JAX package's",
            "ok": not mismatches,
            "detail": json.dumps(mismatches) if mismatches else f"seed {seed}",
        })
    seconds = {"committed": [first["seconds"], second["seconds"]],
               "aborts": {p: [b["seconds"], a["seconds"]] for p, (b, a) in aborted.items()}}
    return {
        "artifact": "reconfig_smoke",
        "seed": seed,
        "device": str(device or "cuda"),
        "config": {
            "n_replicas": N_REPLICAS,
            "n_claims": N_CLAIMS,
            "total_steps": TOTAL_STEPS,
            "arrivals_per_step": ARRIVALS_PER_STEP,
            "reconfig_at_step": RECONFIG_AT_STEP,
            "plan": plan_dict(),
        },
        "checks": checks,
        "reference_mismatches": mismatches,
        "reconfig": first["reconfig"],
        "epoch_chain": first["epoch_chain"],
        "aborts": aborts,
        "requests": first["requests"],
        "cluster_counters": first["cluster_counters"],
        "claims": first["claims"],
        "fleet_fingerprint": first["fleet_fingerprint"],
        "seconds": seconds,
        "ok": all(c["ok"] for c in checks),
        "runs": [first, second] + [r for pair in aborted.values() for r in pair],
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="write the JSON artifact here")
    p.add_argument("--device", default=None, help="default: cuda (raises without a card)")
    args = p.parse_args(argv)

    artifact = run(args.seed, args.device)
    for c in artifact["checks"]:
        print(f"[{'PASS' if c['ok'] else 'FAIL'}] {c['check']}" + (f" — {c['detail']}" if c["detail"] else ""))
    if args.out:
        from svoc_torch.utils.artifacts import atomic_write_json

        atomic_write_json(args.out, {k: v for k, v in artifact.items() if k != "runs"})
    print(f"{'PASS' if artifact['ok'] else 'FAIL'}: reconfig smoke on {artifact['device']}, fleet "
          f"fingerprint {artifact['fleet_fingerprint'][:16]}, epoch chain {len(artifact['epoch_chain'])}")
    return 0 if artifact["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
