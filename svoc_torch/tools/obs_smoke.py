"""Flight-recorder smoke: journal replay identity, audit linkage and
bundle completeness as a gate, on the card by default.

The twin of ``tools/obs_smoke.py`` (``obs_smoke.py:1-237``;
``make obs-smoke``).  Its legs:

1. **Journal replay identity**: the seeded Byzantine scenario
   (:func:`svoc_torch.resilience.chaos.run_byzantine_scenario`, host
   work) runs twice with fresh journals; the two event streams digest
   byte-identically (``journal_fingerprint``), not only the outcomes.
2. **Audit linkage**: one lineage in that journal links a refusing
   ``quarantine.verdict``, a ``supervisor.charge`` and a
   ``supervisor.replacement``.
3. **Bundle completeness and session lineage**: a seeded mini-session
   (synthetic store, a fake vectorizer) on ``--device`` (default CUDA,
   raising without a card: its fleet is the fleet-draws kernel's draw and
   its commit's certification sweep runs there) fetches and commits; its
   journal carries ``block.fetched``, ``quarantine.verdict``,
   ``consensus.result`` and ``commit.sent`` on the block's lineage, the
   audit record joins events and spans on that id, and a postmortem
   bundle built from the live singletons carries every section
   (``BUNDLE_KEYS``) and reads back as JSON.
4. **Overhead**: a journal emit and a lineage-tagged span stay in the
   microsecond class (the loose bound is 1 ms an operation).

The reference's 11 checks, by their names.  :data:`REFERENCE_JOURNAL_FINGERPRINTS`
holds the JAX package's journal fingerprint at seed 0 (a literal: the
card's machine has no JAX; ``tests/test_torch_obs_smoke.py`` rechecks it
against a live reference run).

Usage::

    python -m svoc_torch.tools.obs_smoke [--seed 0] [--device cpu] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import tempfile

#: The JAX package's ``tools/obs_smoke.py --seed S`` journal fingerprint
#: (the Byzantine scenario's; the same in both runs).
REFERENCE_JOURNAL_FINGERPRINTS = {
    0: "943bd327cbe256b29cf73b20c47f6e21b40685091dd139753fb44d0f1f29f624",
}


def _audit_linkage(journal) -> dict:
    """A lineage linking verdict → charge → replacement, or ``{}``."""
    by_lineage: dict = {}
    for e in journal.recent():
        if e.lineage is not None:
            by_lineage.setdefault(e.lineage, []).append(e)
    for lineage, events in by_lineage.items():
        has_verdict = any(e.type == "quarantine.verdict" and e.data.get("reasons") for e in events)
        charges = [e for e in events if e.type == "supervisor.charge"]
        replacements = [e for e in events if e.type == "supervisor.replacement"]
        if has_verdict and charges and replacements:
            return {
                "lineage": lineage,
                "charged": sorted({str(c.data.get("oracle")) for c in charges}),
                "replaced": [{"slot": r.data.get("slot"), "old": r.data.get("old")} for r in replacements],
            }
    return {}


def _session_leg(out_dir: str, device=None) -> dict:
    """Leg 3: a seeded mini-session's fetch and commit, its audit and a
    bundle."""
    import numpy as np

    from svoc_torch.apps.session import Session, SessionConfig
    from svoc_torch.io.comment_store import CommentStore
    from svoc_torch.io.scraper import SyntheticSource
    from svoc_torch.utils.events import journal
    from svoc_torch.utils.postmortem import BUNDLE_KEYS, build_bundle

    def fake_vectorizer(texts):
        rng = np.random.default_rng(len(texts))
        v = rng.uniform(0.05, 0.95, size=(len(texts), 6))
        return v / v.sum(axis=1, keepdims=True)

    store = CommentStore()
    store.save(SyntheticSource(batch=120)())
    session = Session(config=SessionConfig(), store=store, vectorizer=fake_vectorizer, device=device)
    seq_before = journal.last_seq()
    session.fetch()
    outcome = session.commit_resilient()
    session.supervisor_step()
    slo = session.slo_snapshot()
    lineage = session.last_lineage

    block_events = {e.type for e in journal.recent(lineage=lineage) if e.seq > seq_before}
    needed = {"block.fetched", "quarantine.verdict", "consensus.result", "commit.sent"}
    audit = session.audit()
    bundle_path = build_bundle(out_dir=out_dir, trigger="obs_smoke", session=session)
    with open(bundle_path) as f:
        bundle = json.load(f)
    return {
        "lineage": lineage,
        "device": str(session.device),
        "committed": outcome.sent,
        "commit_complete": bool(outcome.complete),
        "block_event_types": sorted(block_events),
        "missing_event_types": sorted(needed - block_events),
        "audit_found": bool(audit.get("found")),
        "audit_spans": len(audit.get("spans") or []),
        "audit_commit_sent": audit.get("summary", {}).get("commit_sent"),
        "slo_names": sorted(slo),
        "bundle_path": bundle_path,
        "bundle_missing_keys": sorted(k for k in BUNDLE_KEYS if k not in bundle),
        "bundle_journal_events": len(bundle["journal"]["events"]),
    }


def _overhead_leg() -> dict:
    """Journal emission and lineage-tagged spans stay host-side
    microseconds; the bound is 1 ms an operation so a loaded host cannot
    flake it, and the measured means land in the artifact."""
    import time

    from svoc_torch.utils.events import EventJournal
    from svoc_torch.utils.metrics import MetricsRegistry, Tracer

    n = 5000
    reg = MetricsRegistry()
    j = EventJournal(reg, capacity=256)
    t0 = time.perf_counter()
    for _ in range(n):
        j.emit("commit.sent", lineage="blk-000001", sent=7, total=7)
    emit_us = (time.perf_counter() - t0) / n * 1e6

    tracer = Tracer(reg)
    t0 = time.perf_counter()
    for _ in range(n):
        with tracer.span("consensus"):
            pass
    span_us = (time.perf_counter() - t0) / n * 1e6
    t0 = time.perf_counter()
    for _ in range(n):
        with tracer.span("consensus", lineage="blk-000001"):
            pass
    span_lineage_us = (time.perf_counter() - t0) / n * 1e6
    return {
        "emit_us_mean": round(emit_us, 3),
        "span_us_mean": round(span_us, 3),
        "span_lineage_us_mean": round(span_lineage_us, 3),
        "within_bounds": emit_us < 1000.0 and span_lineage_us < 1000.0,
    }


def run(seed: int = 0, device=None) -> dict:
    """The legs and the reference's checks; returns the artifact, with the
    journal fingerprint held to :data:`REFERENCE_JOURNAL_FINGERPRINTS`
    (``reference_fingerprint`` None at other seeds)."""
    from svoc_torch.device import resolve_device
    from svoc_torch.resilience.chaos import run_byzantine_scenario
    from svoc_torch.utils.events import EventJournal
    from svoc_torch.utils.metrics import MetricsRegistry

    device = resolve_device(device)
    j1 = EventJournal(MetricsRegistry())
    first = run_byzantine_scenario(seed, registry=MetricsRegistry(), journal=j1)
    j2 = EventJournal(MetricsRegistry())
    second = run_byzantine_scenario(seed, registry=MetricsRegistry(), journal=j2)
    linkage = _audit_linkage(j1)
    with tempfile.TemporaryDirectory() as tmp:
        session_leg = _session_leg(tmp, device)
    overhead = _overhead_leg()

    checks = {
        "journal_replay_identical": first["journal_fingerprint"] == second["journal_fingerprint"],
        "scenario_replay_identical": first["fingerprint"] == second["fingerprint"],
        "journal_nonempty": first["journal_events"] > 0,
        "audit_links_verdict_charge_replacement": bool(linkage),
        "session_block_events_complete": not session_leg["missing_event_types"],
        "session_audit_found": session_leg["audit_found"],
        "session_audit_has_spans": session_leg["audit_spans"] > 0,
        "session_commit_complete": session_leg["commit_complete"],
        "bundle_complete": not session_leg["bundle_missing_keys"],
        "slo_evaluated": len(session_leg["slo_names"]) == 3,
        "overhead_within_bounds": overhead["within_bounds"],
    }
    return {
        "seed": seed,
        "device": str(device),
        "checks": checks,
        "ok": all(checks.values()),
        "journal_fingerprint": first["journal_fingerprint"],
        "reference_fingerprint": REFERENCE_JOURNAL_FINGERPRINTS.get(seed),
        "journal_events": first["journal_events"],
        "audit_linkage": linkage,
        "session": session_leg,
        "overhead": overhead,
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
    print(json.dumps({
        "obs_smoke": "ok" if artifact["ok"] else "FAILED",
        "seed": args.seed,
        "device": artifact["device"],
        "checks": artifact["checks"],
        "journal_events": artifact["journal_events"],
        "linkage": artifact["audit_linkage"],
        "journal_fingerprint": artifact["journal_fingerprint"][:16],
        "matches_reference": artifact["reference_fingerprint"] in (None, artifact["journal_fingerprint"]),
        "overhead": artifact["overhead"],
    }), flush=True)
    return 0 if artifact["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
