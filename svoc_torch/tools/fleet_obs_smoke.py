"""Fleet observability plane smoke: replay invisibility, hop-join
coverage, merge-math identity, retired monotonicity, and the seeded
anomaly -> profile -> postmortem trigger chain, on the card by default.

The twin of ``tools/fleet_obs_smoke.py`` (``fleet_obs_smoke.py:1-246``),
with its :data:`KILL_PLAN` and :data:`DEGRADATION_PLAN` (``:44-65``).
Three seeded cluster scenarios drive the gate:

1. **Kill/failover + migrate leg, plane ON twice / OFF twice** — all
   four ``fleet_fingerprint``s are byte-identical: hop records, merged
   telemetry, SLO alerts, and anomaly observations ride the obs
   channel only, so enabling the plane cannot change what a seeded
   fleet replay reproduces.  The OFF runs carry no plane state at all.
2. **Quiet leg (no kill)** — every counter family in the merged
   exposition equals the SUM of the per-source scrapes, series for
   series: the fleet view is arithmetic over the replica views, never a
   separate measurement.
3. **Degradation leg** — a mid-run replica kill under heavy arrivals
   produces a SUSTAINED seeded anomaly (EWMA z-score, thresholds
   pinned at construction), which auto-captures a profile
   (``torch.profiler``, with the card's activity on CUDA) and writes a
   postmortem bundle.  The kill leg also proves fleet totals never
   step backward across the failover (the ``@retired`` fold).

The reference's 10 checks, and at a seed of
:data:`REFERENCE_FLEET_FINGERPRINTS` an 11th: the fingerprint equals
the JAX package's (a literal: the card's machine has no JAX;
``tests/test_torch_cluster_smoke.py`` rechecks it against a live
reference run).  Every scenario runs on ``--device`` (default CUDA,
raising without a card).

Usage::

    python -m svoc_torch.tools.fleet_obs_smoke [--seed 3] [--device cpu] [--out FILE]
"""

from __future__ import annotations

import argparse
import os
import re
import tempfile
from typing import Optional

KILL_PLAN = dict(
    n_replicas=3,
    n_claims=3,
    total_steps=8,
    arrivals_per_step=4,
    kill_replica="r1",
    kill_at_step=4,
    migrate_at_step=7,
)

#: Heavier traffic + a later kill: the outage window sheds enough per
#: step (delta >= min_delta, z >= threshold) for ``sustain_steps``
#: consecutive breaches — the smallest deterministic config that fires
#: the full anomaly -> profile -> bundle chain.
DEGRADATION_PLAN = dict(
    n_replicas=3,
    n_claims=6,
    total_steps=10,
    arrivals_per_step=12,
    kill_replica="r1",
    kill_at_step=5,
)

QUIET_PLAN = dict(n_replicas=3, n_claims=3, total_steps=6, arrivals_per_step=4)

#: The JAX package's ``tools/fleet_obs_smoke.py --seed S`` fleet
#: fingerprint (the same in all four kill-plan runs).
REFERENCE_FLEET_FINGERPRINTS = {
    0: "69be5e852be5f410219724db4beef53d3135461c99c922ae7a6a2bbf6f77812d",
    3: "113dd75bf2885caff27de35d82adf3de958fce725183421f4b03cbe1823b2f30",
}


def hop_coverage(result):
    """Join every sidecar's hop records; coverage is total iff every
    chain classifies AND complete forward chains equal the router's
    ``cluster_forwarded`` count (no hop invisible to the join)."""
    from svoc_torch.obsplane.hopchain import chain_stats, join_hop_chains
    from svoc_torch.obsplane.timeline import read_observations

    records = []
    for path in result["fleet_obs"]["obs_paths"].values():
        records.extend(read_observations(path))
    chains = join_hop_chains(records)
    stats = chain_stats(chains)
    forwarded = sum(
        e["count"]
        for counters in result["fleet_obs"]["per_source_counters"].values()
        for e in counters
        if e["name"] == "cluster_forwarded"
    )
    complete_forwards = sum(
        1
        for c in chains.values()
        if c["reason"] == "forward" and c["classification"] == "complete"
    )
    classified = sum(stats["by_classification"].values())
    return {
        "stats": stats,
        "fully_classified": bool(chains) and classified == stats["chains"],
        "cluster_forwarded": forwarded,
        "complete_forwards": complete_forwards,
        "forwards_joined": complete_forwards == forwarded,
    }


_SERIES_RE = re.compile(r"^(svoc_\w+_total)(?:\{[^}]*\})? ([0-9.eE+-]+)$")


def exposition_totals(exposition):
    """Fold the Prometheus text back into ``{family_total: sum}``."""
    totals = {}
    for line in exposition.splitlines():
        m = _SERIES_RE.match(line)
        if m:
            totals[m.group(1)] = totals.get(m.group(1), 0.0) + float(m.group(2))
    return totals


def merge_identity(result):
    """Merged exposition counter totals == sum over the per-source
    scrapes, family for family (quiet leg: nothing retired, so the
    per-source section is the whole fleet)."""
    merged = exposition_totals(result["fleet_obs"]["exposition"])
    scraped = {}
    for counters in result["fleet_obs"]["per_source_counters"].values():
        for e in counters:
            key = f"svoc_{e['name']}_total"
            scraped[key] = scraped.get(key, 0.0) + e["count"]
    mismatched = {
        k: {"merged": merged.get(k, 0.0), "scraped": scraped.get(k, 0.0)}
        for k in set(merged) | set(scraped)
        if abs(merged.get(k, 0.0) - scraped.get(k, 0.0)) > 1e-9
    }
    return {
        "families": len(merged),
        "mismatched": mismatched,
        "identical": bool(merged) and not mismatched,
    }


def monotonic(result):
    """No accounting family steps backward across the kill/failover
    (the ``@retired`` max-fold)."""
    from svoc_torch.obsplane.fleet import ACCOUNTING_FAMILIES

    history = result["fleet_obs"]["accounting_history"]
    regressions = []
    for family in ACCOUNTING_FAMILIES:
        series = [h.get(family, 0.0) for h in history]
        for prev, cur in zip(series, series[1:]):
            if cur < prev:
                regressions.append({"family": family, "series": series})
                break
    return {"steps": len(history), "regressions": regressions}


def run_legs(seed: int, base: str, device=None) -> dict:
    """The six scenario runs under ``base``: ``on_a``, ``on_b``,
    ``off_a``, ``off_b`` (the kill plan), ``quiet`` and ``degraded``."""
    from svoc_torch.cluster.scenario import run_cluster_scenario

    runs = {}
    for tag, plane in (("on_a", True), ("on_b", True), ("off_a", False), ("off_b", False)):
        runs[tag] = run_cluster_scenario(
            os.path.join(base, tag), seed, fleet_plane=plane, device=device, **KILL_PLAN
        )
    runs["quiet"] = run_cluster_scenario(
        os.path.join(base, "quiet"), seed, fleet_plane=True, device=device, **QUIET_PLAN
    )
    runs["degraded"] = run_cluster_scenario(
        os.path.join(base, "degraded"), seed, fleet_plane=True, device=device, **DEGRADATION_PLAN
    )
    return runs


def evaluate(runs: dict, seed: int) -> dict:
    """The reference's 10 checks (plus the reference match at a seed of
    :data:`REFERENCE_FLEET_FINGERPRINTS`) over :func:`run_legs`' runs;
    returns the artifact."""
    kill_tags = ("on_a", "on_b", "off_a", "off_b")
    fingerprints = [runs[t]["fleet_fingerprint"] for t in sorted(kill_tags)]
    coverage = hop_coverage(runs["on_a"])
    identity = merge_identity(runs["quiet"])
    mono = monotonic(runs["on_a"])
    snap = runs["degraded"]["fleet_obs"]
    sustained = [a for a in snap["recent_anomalies"] if a["sustained"]]
    bundles = snap["bundles"]
    bundles_on_disk = [b for b in bundles if os.path.exists(b)]
    profiles = snap.get("profiler", {}).get("captures", 0)
    sidecars_present = all(
        os.path.exists(path) for path in runs["on_a"]["fleet_obs"]["obs_paths"].values()
    )
    checks = {
        "fleet_fingerprints_identical": len(set(fingerprints)) == 1,
        "off_plane_inert": all(
            runs[t]["fleet_obs"] == {"enabled": False} for t in ("off_a", "off_b")
        ),
        "sidecars_written": sidecars_present,
        "hop_chains_fully_classified": coverage["fully_classified"],
        "forwards_joined": coverage["forwards_joined"],
        "merged_equals_scrape_sum": identity["identical"],
        "totals_monotonic_across_failover": not mono["regressions"],
        "anomaly_sustained": len(sustained) >= 1,
        "profile_captured": profiles >= 1,
        "postmortem_bundle_written": len(bundles_on_disk) >= 1,
    }
    reference = REFERENCE_FLEET_FINGERPRINTS.get(seed)
    if reference is not None:
        checks["matches_reference_fingerprint"] = fingerprints[0] == reference
    return {
        "seed": seed,
        "checks": checks,
        "ok": all(checks.values()),
        "fleet_fingerprint": fingerprints[0],
        "fingerprints": fingerprints,
        "reference_fingerprint": reference,
        "hop_coverage": coverage,
        "merge_identity": {k: v for k, v in identity.items() if k != "mismatched"}
        | {"mismatched": list(identity["mismatched"])},
        "monotonicity": mono,
        "anomalies": snap["recent_anomalies"],
        "bundles": bundles,
        "profiler": snap.get("profiler"),
        "retired": snap["retired"],
        "observations": snap["observations"],
    }


def run(seed: int = 3, device=None, base: Optional[str] = None) -> dict:
    """All six runs and the checks.  With ``base`` the work directories
    (sidecars, profiles, bundles) stay there; without, they live in a
    temporary directory removed at the end, as in the reference."""
    if base is not None:
        return evaluate(run_legs(seed, base, device), seed)
    with tempfile.TemporaryDirectory(prefix="fleet_obs_smoke_") as tmp:
        return evaluate(run_legs(seed, tmp, device), seed)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--out", default=None, help="write the JSON artifact here")
    p.add_argument("--device", default=None, help="default: cuda (raises without a card)")
    args = p.parse_args(argv)

    artifact = run(args.seed, args.device)
    if args.out:
        from svoc_torch.utils.artifacts import atomic_write_json

        atomic_write_json(args.out, artifact)
    for name, passed in artifact["checks"].items():
        print(f"  {'PASS' if passed else 'FAIL'}  {name}")
    coverage, stats = artifact["hop_coverage"], artifact["hop_coverage"]["stats"]
    sustained = [a for a in artifact["anomalies"] if a["sustained"]]
    profiles = (artifact["profiler"] or {}).get("captures", 0)
    print(
        f"fleet-obs-smoke {'OK' if artifact['ok'] else 'FAILED'}: 4x fingerprint "
        f"{artifact['fleet_fingerprint'][:16]}, {stats['chains']} hop chains "
        f"({coverage['complete_forwards']}/{coverage['cluster_forwarded']} "
        f"forwards joined), {artifact['merge_identity']['families']} merged families "
        f"identical to scrape sums, {len(sustained)} sustained anomaly(ies) -> "
        f"{profiles} profile(s) + {len(artifact['bundles'])} bundle(s)"
    )
    return 0 if artifact["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
