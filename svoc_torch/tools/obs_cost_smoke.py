"""Cost-attribution plane smoke: fingerprint invisibility, gapless
timelines, universe-wide cost estimates and JSONL reconstruction as a
gate, on the card by default.

The twin of ``tools/obs_cost_smoke.py`` (``obs_cost_smoke.py:1-222``;
``make obs-cost-smoke``).  The seeded serving scenario
(:func:`svoc_torch.serving.scenario.run_serving_scenario`) runs four
times on ``--device`` (default CUDA, raising without a card: every
dispatch is the gated claim-cube kernel and every fleet the fleet-draws
kernel there) — the plane on twice, off twice, fresh journals and
metrics, a virtual clock — and the gate holds the reference's 8 checks:

1. all four journal fingerprints are byte-identical (the plane's
   records never touch the replay-pinned journal), and the off runs
   took no ledger sample;
2. every completed request's stage durations telescope to its
   end-to-end latency, every stage of the taxonomy appears, and
   ``queue_wait`` accrues;
3. ``CostModel.estimate`` prices every key of the router's compile
   universe, warm and cold;
4. the ledger took samples, and ``python -m svoc_torch.tools.obs_query
   --json`` refolds the streamed ``cost.sample`` records into cells
   identical to the live ledger's.

:data:`REFERENCE_JOURNAL_FINGERPRINTS` holds the JAX package's journal
fingerprint at seed 0 (a literal: the card's machine has no JAX;
``tests/test_torch_obs_smoke.py`` rechecks it against a live reference
run).

Usage::

    python -m svoc_torch.tools.obs_cost_smoke [--seed 0] [--device cpu] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

STAGES = (
    "queue_wait",
    "vectorize",
    "h2d",
    "dispatch",
    "sync",
    "commit",
    "respond",
)

#: The JAX package's ``tools/obs_cost_smoke.py --seed S`` journal
#: fingerprint (the same in all four runs).
REFERENCE_JOURNAL_FINGERPRINTS = {
    0: "ea0bd35fa8802cd95715c2c5fa80bfaab977e9f6af2136fc74c21caa62d53ad1",
}

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def gapless(plane, tol=1e-6):
    """(checked, worst gap, stages seen, stages with positive time) over
    completed timeline records.  On the scenario's virtual clock the
    stages inside a step are zero-width, so positivity is asserted for
    ``queue_wait`` alone and the taxonomy by key presence."""
    checked, worst = 0, 0.0
    seen, positive = set(), set()
    for rec in plane.obslog.recent(10_000, kind="timeline.request"):
        data = rec.get("data") or {}
        if data.get("outcome") != "completed":
            continue
        stages = data.get("stages") or {}
        seen.update(stages)
        positive.update(k for k, v in stages.items() if v > 0.0)
        worst = max(worst, abs(sum(stages.values()) - float(data.get("e2e_s", 0.0))))
        checked += 1
    return checked, worst, seen, positive


def universe_coverage(result):
    """Every key the router's universe enumerates must price, warm and
    cold (through the exact cell, its (N, M) group, or the global pool)."""
    from svoc_torch.compile.universe import enumerate_universe, registry_groups, universe_summary

    multi = result["multi"]
    router = multi.router
    keys = enumerate_universe(
        registry_groups(multi.registry),
        max_claims_per_batch=router.max_claims_per_batch,
        sanitized_dispatch=router.sanitized_dispatch,
        impl=router.consensus_impl,
        donate=router.device_resident,
    )
    model = result["cost_plane"].model
    uncovered = []
    sources = {}
    for key in keys:
        est = model.estimate(key)
        if est["warm"] is None or est["cold"] is None:
            uncovered.append(est["key"])
            continue
        for regime in ("warm", "cold"):
            src = est[regime]["source"]
            sources[src] = sources.get(src, 0) + 1
    return {
        "universe": universe_summary(keys),
        "estimated": len(keys) - len(uncovered),
        "uncovered": uncovered,
        "sources": sources,
    }


def reconstruction_identical(trace_path, plane, device):
    """``obs_query --json`` in its own interpreter, its refolded ledger
    against the live one, cell for cell."""
    path = os.environ.get("PYTHONPATH")
    proc = subprocess.run(
        [sys.executable, "-m", "svoc_torch.tools.obs_query", trace_path, "--tag", f"{trace_path}=smoke", "--json",
         "--device", str(device)],
        capture_output=True, text=True, check=False, cwd=_ROOT,
        env=dict(os.environ, PYTHONPATH=_ROOT + (os.pathsep + path if path else "")),
    )
    if proc.returncode != 0:
        return False, {"error": proc.stderr[-500:]}
    doc = json.loads(proc.stdout)
    rebuilt = doc["ledgers"]["smoke"]["ledger"]["entries"]
    live = plane.ledger.to_dict()["entries"]
    return rebuilt == live, {
        "rebuilt_keys": len(rebuilt),
        "live_keys": len(live),
        "samples": doc["ledgers"]["smoke"]["samples"],
        "timelines": len(doc["timelines"]),
    }


def run(seed: int = 0, device=None) -> dict:
    """The four runs and the reference's 8 checks; returns the artifact,
    the journal fingerprint beside :data:`REFERENCE_JOURNAL_FINGERPRINTS`
    (``reference_fingerprint`` None at other seeds)."""
    from svoc_torch.device import resolve_device
    from svoc_torch.serving.scenario import run_serving_scenario

    device = resolve_device(device)
    with tempfile.TemporaryDirectory(prefix="obs_cost_smoke_") as tmp:
        trace_path = os.path.join(tmp, "obs_trace.jsonl")
        on_a = run_serving_scenario(seed, cost_plane="on", cost_trace_path=trace_path, device=device)
        on_b = run_serving_scenario(seed, cost_plane="on", device=device)
        off_a = run_serving_scenario(seed, cost_plane="off", device=device)
        off_b = run_serving_scenario(seed, cost_plane="off", device=device)

        fingerprints = [r["journal_fingerprint"] for r in (on_a, on_b, off_a, off_b)]
        plane = on_a["cost_plane"]
        checked, worst_gap, stages_seen, stages_positive = gapless(plane)
        coverage = universe_coverage(on_a)
        ledger = plane.ledger.summary()
        rebuilt_ok, rebuild_info = reconstruction_identical(trace_path, plane, device)

    checks = {
        "fingerprints_identical": len(set(fingerprints)) == 1,
        "off_plane_inert": off_a["cost_plane"].snapshot()["ledger"]["samples"] == 0,
        "timelines_gapless": checked > 0 and worst_gap <= 1e-6,
        "stages_observed": set(STAGES) <= stages_seen,
        "queue_wait_accrues": "queue_wait" in stages_positive,
        "universe_fully_estimated": not coverage["uncovered"],
        "ledger_samples_nonzero": ledger["samples"] > 0,
        "ledger_rebuilt_from_jsonl": rebuilt_ok,
    }
    return {
        "seed": seed,
        "device": str(device),
        "checks": checks,
        "ok": all(checks.values()),
        "journal_fingerprint": fingerprints[0],
        "reference_fingerprint": REFERENCE_JOURNAL_FINGERPRINTS.get(seed),
        "fingerprints": fingerprints,
        "timelines_checked": checked,
        "worst_gap_s": worst_gap,
        "stages_seen": sorted(stages_seen),
        "stages_positive": sorted(stages_positive),
        "coverage": coverage,
        "ledger": ledger,
        "reconstruction": rebuild_info,
        "completed": on_a["completed"],
        "shed": on_a["shed"],
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="write the JSON artifact here")
    p.add_argument("--device", default=None, help="default: cuda (raises without a card)")
    args = p.parse_args(argv)

    artifact = run(args.seed, args.device)
    if args.out:
        from svoc_torch.utils.artifacts import atomic_write_json

        atomic_write_json(args.out, artifact)
    checks, coverage, ledger = artifact["checks"], artifact["coverage"], artifact["ledger"]
    for name, passed in checks.items():
        print(f"  {'PASS' if passed else 'FAIL'}  {name}")
    ref = artifact["reference_fingerprint"]
    print(
        f"obs-cost-smoke {'OK' if artifact['ok'] else 'FAILED'} on {artifact['device']}: 4x fingerprint "
        f"{artifact['journal_fingerprint'][:16]}"
        + ("" if ref is None else f" ({'equal to' if ref == artifact['journal_fingerprint'] else 'NOT'} "
                                  f"the JAX package's)")
        + f", {artifact['timelines_checked']} timelines gapless (worst {artifact['worst_gap_s']:.2e}s), "
        f"{coverage['estimated']}/{coverage['universe']['keys']} universe keys priced, "
        f"{ledger['samples']} samples over {ledger['keys']} keys, JSONL rebuild "
        f"{'identical' if checks['ledger_rebuilt_from_jsonl'] else 'DIVERGED'}"
    )
    return 0 if artifact["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
