"""Offline cost-attribution queries over trace JSONL.

The twin of ``tools/obs_query.py`` (``obs_query.py:1-423``), whole: it
joins the three line shapes that one or many processes stream into
trace files — journal events (keyed ``"event"``), tracer spans (keyed
``"name"``) and observation records (keyed ``"obs"``) — into
per-lineage timelines, per-claim stage percentiles, and the cost ledger
rebuilt from the ``cost.sample`` stream through the live
:class:`~svoc_torch.obsplane.ledger.CostLedger`'s EMA (identical samples
in identical order give the persisted cells exactly).  ``--fleet`` joins
every ``hop`` observation across the given sidecars into cross-replica
chains (:func:`~svoc_torch.obsplane.hopchain.join_hop_chains`).  Each
file is tagged with a source label (``--tag path=name``; default the
basename) and records join on ``(tag, lineage)`` unless
``--merge-scopes``.  ``--json`` prints one machine-readable document
(``svoc_torch.tools.obs_cost_smoke``'s round-trip check calls ``python
-m svoc_torch.tools.obs_query ... --json``).

It reads files and draws nothing: ``--device`` (default CUDA, raising
without a card) is resolved as every twin's is, and ``--seed`` is taken
for the same command line as the other twins and unused.

Usage::

    python -m svoc_torch.tools.obs_query TRACE.jsonl [...] [--tag PATH=NAME] [--json] [--fleet] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

from svoc_torch.obsplane.ledger import DEFAULT_ALPHA, CostLedger


def read_jsonl(path, keep=8):
    """All records from a (possibly rotated) trace file, oldest first,
    classified by line shape.  Torn tails (a crash mid-write) are
    skipped, matching ``read_trace_events``'s tolerance."""
    records = []
    paths = [f"{path}.{i}" for i in range(keep, 0, -1)] + [path]
    for p in paths:
        if not os.path.exists(p):
            continue
        with open(p, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if not isinstance(rec, dict):
                    continue
                if "obs" in rec:
                    rec["_shape"] = "obs"
                elif "event" in rec:
                    rec["_shape"] = "event"
                elif "name" in rec:
                    rec["_shape"] = "span"
                else:
                    continue
                records.append(rec)
    return records


def load_sources(paths, tags):
    """``[(tag, records)]`` per input file, tags unique."""
    out = []
    seen = set()
    for path in paths:
        tag = tags.get(path, os.path.basename(path))
        base, n = tag, 2
        while tag in seen:
            tag = f"{base}#{n}"
            n += 1
        seen.add(tag)
        out.append((tag, read_jsonl(path)))
    return out


def lineage_claim(lineage):
    """``blk<scope>-<claim>-rq<seq>`` → claim, else None (the plane's
    records carry the claim explicitly; this is the join fallback for
    bare journal events)."""
    if not lineage:
        return None
    parts = lineage.split("-")
    return parts[1] if len(parts) >= 3 else None


def build_timelines(sources, merge_scopes=False):
    """Per-lineage view: the ``timeline.request`` record + journal
    event types + span names joined on (tag, lineage)."""
    timelines = {}
    for tag, records in sources:
        for rec in records:
            lineage = rec.get("lineage")
            if not lineage:
                continue
            key = lineage if merge_scopes else f"{tag}:{lineage}"
            entry = timelines.setdefault(
                key,
                {
                    "lineage": lineage,
                    "source": tag,
                    "claim": lineage_claim(lineage),
                    "timeline": None,
                    "events": [],
                    "spans": [],
                },
            )
            shape = rec["_shape"]
            if shape == "obs" and rec.get("obs") == "timeline.request":
                data = rec.get("data") or {}
                entry["timeline"] = {
                    "outcome": data.get("outcome"),
                    "e2e_s": data.get("e2e_s"),
                    "stages": data.get("stages") or {},
                    **(
                        {"reason": data["reason"]}
                        if "reason" in data
                        else {}
                    ),
                }
                if data.get("claim"):
                    entry["claim"] = data["claim"]
            elif shape == "event":
                entry["events"].append(rec["event"])
            elif shape == "span":
                entry["spans"].append(rec["name"])
    return timelines


def percentile(sorted_vals, q):
    if not sorted_vals:
        return None
    i = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[i]


def stage_percentiles(timelines):
    """p50/p90/p99 seconds per (claim, stage) over COMPLETED requests —
    shed/dropped outcomes carry partial stage sets and would skew the
    decomposition."""
    by_claim = {}
    for entry in timelines.values():
        tl = entry["timeline"]
        if tl is None or tl.get("outcome") != "completed":
            continue
        claim = entry["claim"] or "?"
        stages = by_claim.setdefault(claim, {})
        for stage, seconds in (tl.get("stages") or {}).items():
            stages.setdefault(stage, []).append(float(seconds))
    out = {}
    for claim, stages in sorted(by_claim.items()):
        out[claim] = {}
        for stage, vals in sorted(stages.items()):
            vals.sort()
            out[claim][stage] = {
                "n": len(vals),
                "p50": percentile(vals, 0.50),
                "p90": percentile(vals, 0.90),
                "p99": percentile(vals, 0.99),
            }
    return out


def reconstruct_ledger(sources, alpha=DEFAULT_ALPHA):
    """Fold every ``cost.sample`` record through the live ledger's EMA,
    in file order per source — the offline twin of the persisted
    ``cost_ledger.json``.  One ledger per source tag (different
    processes measured different hosts) plus sample counts."""
    ledgers = {}
    for tag, records in sources:
        ledger = CostLedger(alpha=alpha)
        n = 0
        for rec in records:
            if rec["_shape"] != "obs" or rec.get("obs") != "cost.sample":
                continue
            data = rec.get("data") or {}
            try:
                ledger.observe_key_str(
                    str(data["key"]),
                    str(data.get("group", "")),
                    str(data["warmth"]),
                    float(data["seconds"]),
                )
                n += 1
            except (KeyError, TypeError, ValueError):
                continue
        ledgers[tag] = {"samples": n, "ledger": ledger.to_dict()}
    return ledgers


def fleet_view(sources):
    """Join every ``hop`` observation across the sources into chains
    + summary stats (the ``--fleet`` document)."""
    from svoc_torch.obsplane.hopchain import chain_stats, join_hop_chains

    hops = []
    other = {}
    for _tag, records in sources:
        for rec in records:
            if rec["_shape"] != "obs":
                continue
            if rec.get("obs") == "hop":
                hops.append(rec)
            else:
                kind = rec.get("obs")
                other[kind] = other.get(kind, 0) + 1
    chains = join_hop_chains(hops)
    return {
        "chains": {
            cid: {
                "claim": c["claim"],
                "lineage": c["lineage"],
                "reason": c["reason"],
                "src": c["src"],
                "dst": c["dst"],
                "classification": c["classification"],
                "outcome": c["outcome"],
                "attempts": c["attempts"],
                "dead_attempts": c["dead_attempts"],
                "records": [
                    {
                        "side": r["data"].get("side"),
                        "hop": r["data"].get("hop"),
                        **{
                            k: v
                            for k, v in r["data"].items()
                            if k
                            not in (
                                "side",
                                "hop",
                                "chain",
                                "claim",
                                "src",
                                "dst",
                                "reason",
                            )
                        },
                    }
                    for r in c["records"]
                ],
            }
            for cid, c in sorted(chains.items())
        },
        "stats": chain_stats(chains),
        "other_observations": other,
    }


def print_fleet(doc) -> None:
    stats = doc["stats"]
    print(
        f"{stats['chains']} hop chain(s), "
        f"{stats['dead_attempts']} dead attempt(s)"
    )
    for cls, n in sorted(stats["by_classification"].items()):
        print(f"  {cls:<14} {n}")
    print("by reason:")
    for reason, n in sorted(stats["by_reason"].items()):
        print(f"  {reason:<14} {n}")
    for cid, c in doc["chains"].items():
        if c["classification"] == "complete" and c["reason"] == "forward":
            continue  # routine; only the interesting chains narrate
        line = (
            f"{cid} {c['reason']} {c['src']}->{c['dst']} "
            f"claim={c['claim']} [{c['classification']}]"
        )
        if c["outcome"]:
            line += f" outcome={c['outcome']}"
        if c["dead_attempts"]:
            line += f" dead_attempts={c['dead_attempts']}"
        print(line)
        for r in c["records"]:
            extras = ", ".join(
                f"{k}={v}" for k, v in sorted(r.items()) if k not in ("side", "hop")
            )
            print(f"    hop {r['hop']} {r['side']}" + (f" ({extras})" if extras else ""))
    if doc["other_observations"]:
        print("other observations:")
        for kind, n in sorted(doc["other_observations"].items()):
            print(f"  {kind:<20} {n}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("files", nargs="+", help="trace JSONL file(s)")
    parser.add_argument(
        "--fleet",
        action="store_true",
        help="join hop chains across the given observation sidecars "
        "(docs/OBSERVABILITY.md §fleet-plane)",
    )
    parser.add_argument(
        "--tag",
        action="append",
        default=[],
        metavar="PATH=NAME",
        help="source label for a file (default: basename)",
    )
    parser.add_argument(
        "--merge-scopes",
        action="store_true",
        help="join lineages across files (default: per-file keys)",
    )
    parser.add_argument("--lineage", help="show one lineage only")
    parser.add_argument("--claim", help="filter timelines to one claim")
    parser.add_argument(
        "--alpha",
        type=float,
        default=DEFAULT_ALPHA,
        help="EMA alpha for ledger reconstruction (default: %(default)s)",
    )
    parser.add_argument("--json", action="store_true", dest="as_json")
    parser.add_argument("--device", default=None, help="default: cuda (raises without a card)")
    parser.add_argument("--seed", type=int, default=None, help="unused: a query draws nothing")
    args = parser.parse_args(argv)

    from svoc_torch.device import resolve_device

    resolve_device(args.device)

    tags = {}
    for spec in args.tag:
        if "=" not in spec:
            parser.error(f"--tag wants PATH=NAME, got {spec!r}")
        path, name = spec.split("=", 1)
        tags[path] = name

    sources = load_sources(args.files, tags)
    if args.fleet:
        doc = fleet_view(sources)
        if args.as_json:
            print(json.dumps(doc, indent=1, sort_keys=True))
        else:
            for tag, records in sources:
                print(f"source {tag}: {len(records)} records")
            print_fleet(doc)
        return 0
    timelines = build_timelines(sources, merge_scopes=args.merge_scopes)
    if args.lineage:
        timelines = {
            k: v
            for k, v in timelines.items()
            if v["lineage"] == args.lineage
        }
    if args.claim:
        timelines = {
            k: v for k, v in timelines.items() if v["claim"] == args.claim
        }
    percentiles = stage_percentiles(timelines)
    ledgers = reconstruct_ledger(sources, alpha=args.alpha)

    doc = {
        "sources": {
            tag: {"records": len(records)} for tag, records in sources
        },
        "timelines": {
            k: {kk: vv for kk, vv in v.items()}
            for k, v in sorted(timelines.items())
        },
        "stage_percentiles": percentiles,
        "ledgers": ledgers,
    }
    if args.as_json:
        print(json.dumps(doc, indent=1, sort_keys=True))
        return 0

    for tag, records in sources:
        print(f"source {tag}: {len(records)} records")
    with_tl = [v for v in timelines.values() if v["timeline"] is not None]
    print(
        f"{len(timelines)} lineages, {len(with_tl)} with timelines "
        f"({sum(1 for v in with_tl if v['timeline']['outcome'] == 'completed')}"
        " completed)"
    )
    if args.lineage:
        for entry in with_tl:
            tl = entry["timeline"]
            print(f"  {entry['lineage']} [{entry['source']}] "
                  f"claim={entry['claim']} outcome={tl['outcome']} "
                  f"e2e={tl['e2e_s']:.4f}s")
            for stage, seconds in tl["stages"].items():
                print(f"    {stage:<12} {seconds:.4f}s")
            print(f"    events: {', '.join(entry['events']) or '(none)'}")
    for claim, stages in percentiles.items():
        print(f"claim {claim}:")
        for stage, p in stages.items():
            print(
                f"  {stage:<12} n={p['n']:<5} p50={p['p50']:.4f}s "
                f"p90={p['p90']:.4f}s p99={p['p99']:.4f}s"
            )
    for tag, rec in ledgers.items():
        entries = rec["ledger"]["entries"]
        print(
            f"ledger [{tag}]: {rec['samples']} samples, "
            f"{len(entries)} keys (alpha={rec['ledger']['alpha']})"
        )
        for key_str, entry in sorted(entries.items()):
            cells = "  ".join(
                f"{w}: {c['ema_s'] * 1e3:.2f} ms ({c['samples']}x)"
                for w, c in sorted(entry["warmth"].items())
            )
            print(f"  {key_str} [{entry['group']}]  {cells}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
