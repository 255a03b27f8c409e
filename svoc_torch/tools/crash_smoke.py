"""Kill/restart gate: crash-consistent durability, on the card by default.

The twin of ``tools/crash_smoke.py``.  Each leg of the matrix is a chain
of child processes in one work directory, SIGKILLed at a NAMED fault
point (:mod:`svoc_torch.durability.faultspace`; the scenario maps each
leg onto a registry event — :mod:`svoc_torch.durability.scenario`):

- ``mid_wal_append`` — ``torn`` @ ``wal.intent.pre_fsync`` (a
  commit-intent record torn in half mid-fsync);
- ``inter_tx`` — ``kill`` @ ``chainlog.tx.post_fsync`` (between tx *i*
  landing on the chain log and its WAL ``landed`` record);
- ``pre_snapshot`` — ``kill`` @ ``serving.step.post`` (after a serving
  step's commits, before its cadence snapshot);
- ``batch_mid_fleet`` — ``kill`` @ ``chain.batch.mid_fleet`` with
  ``commit_mode="batched"``: the one-RPC batched commit killed while
  logging its txs; the restart reconciler must classify the durable
  prefix via its ``landed_batch``/chain-digest columns and resend only
  the suffix;
- ``recovery_storm`` — an ``inter_tx`` crash whose RECOVERY child is
  itself killed at ``recovery.post_restore``; the third child's
  recovery must be idempotent.

After every chain's final (clean) child: **zero duplicate txs** in any
chain log, **zero unknown and zero unaccounted WAL slots**, **zero
unaccounted admitted requests**, **zero open WAL cycles**, and each
leg's named fault point present in the durable fired log.  The FULL
matrix runs twice, side by side in disjoint directories, each phase as
one parallel wave of children; the recovered per-claim journal
fingerprints must be byte-identical across the two runs.  At seed 0 every leg's recovered per-claim fingerprints
must also equal the JAX package's, kept below as constants
(:data:`REFERENCE_FINGERPRINTS`; ``tests/test_torch_crash.py`` rechecks
one leg against the live reference).

Every child runs the scenario on ``--device`` (default CUDA, raising
without a card).  On CUDA the parent builds every kernel source first,
so the children of a wave never race one build.  Where the reference
spawns a fresh interpreter a child, each child here is forked from a
fork server that has imported torch and the scenario and never
initialised CUDA (:mod:`svoc_torch.durability.forked`): still its own
process, SIGKILLed at its fault point and initialising CUDA itself,
without a fresh interpreter's imports (6-10 s of torch's on the card's
host).

Usage::

    python -m svoc_torch.tools.crash_smoke [--seed 0] [--device cpu] [--out FILE]
    python -m svoc_torch.tools.crash_smoke --child <workdir> [--crash-point P] \\
        [--commit-mode M] [--device cpu]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import signal
import tempfile
from typing import Any, Dict, Optional

from svoc_torch.durability import forked
from svoc_torch.durability.forked import ForkedChild

TOTAL_STEPS = 8

#: Leg → (phase chain, commit mode).  Every phase but the last must die
#: by SIGKILL; the last recovers, drains, and writes result.json.
LEGS = {
    "mid_wal_append": (("mid_wal_append", None), "per_tx"),
    "inter_tx": (("inter_tx", None), "per_tx"),
    "pre_snapshot": (("pre_snapshot", None), "per_tx"),
    "batch_mid_fleet": (("batch_mid_fleet", None), "batched"),
    # The restart storm: crash, then kill the recovery itself, then a
    # third child whose recovery must be idempotent.
    "recovery_storm": (("inter_tx", "recovery_storm", None), "per_tx"),
}

#: The named point each leg must prove fired.
LEG_POINT = {
    "mid_wal_append": "wal.intent.pre_fsync",
    "inter_tx": "chainlog.tx.post_fsync",
    "pre_snapshot": "serving.step.post",
    "batch_mid_fleet": "chain.batch.mid_fleet",
    "recovery_storm": "recovery.post_restore",
}

#: The JAX package's ``tools/crash_smoke.py --seed 0``: each leg's
#: recovered per-claim journal fingerprints (the card's machine has no
#: JAX, so they are kept here as literals).
REFERENCE_FINGERPRINTS: Dict[str, Dict[str, str]] = {
    "mid_wal_append": {
        "alpha": "1877a25073436330673d3f45da497ac363641b6373ee20676cc1acfc3673cc71",
        "beta": "2353725c8e7715d2f51cdef8c9329f3b90c49e3e276e8e245c6b56124728a95c",
    },
    "inter_tx": {
        "alpha": "1877a25073436330673d3f45da497ac363641b6373ee20676cc1acfc3673cc71",
        "beta": "5f0f7262d8e2986c1b5edd5dcf02a3bc38825e1825703c79e42ec9cc6c63b17a",
    },
    "pre_snapshot": {
        "alpha": "586351e812ed1cce0b7e62492ddc92cb60d9c59757a865e37e117f1c9f0c1a3d",
        "beta": "3472b689cfdec56839abbb650829a6e92d115645c36d3be4643e1f60cff2c4df",
    },
    "batch_mid_fleet": {
        "alpha": "1877a25073436330673d3f45da497ac363641b6373ee20676cc1acfc3673cc71",
        "beta": "f5d05f3a8a1ac3f00bd61311e0ee4b0abfbc6cb95b79972e94b2620066b4bf2d",
    },
    "recovery_storm": {
        "alpha": "1877a25073436330673d3f45da497ac363641b6373ee20676cc1acfc3673cc71",
        "beta": "5f0f7262d8e2986c1b5edd5dcf02a3bc38825e1825703c79e42ec9cc6c63b17a",
    },
}


def reference_mismatches(fingerprints: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """The legs whose recovered per-claim fingerprints (``{leg: {claim:
    fingerprint}}``) differ from :data:`REFERENCE_FINGERPRINTS` (empty
    when every leg matches)."""
    return {
        leg: fingerprints.get(leg)
        for leg, ref in REFERENCE_FINGERPRINTS.items()
        if fingerprints.get(leg) != ref
    }


def child_main(args) -> int:
    from svoc_torch.durability.scenario import run_durable_scenario

    result = run_durable_scenario(
        args.child,
        seed=args.seed,
        total_steps=TOTAL_STEPS,
        crash_point=args.crash_point,
        commit_mode=args.commit_mode,
        device=args.device,
    )
    # Only the non-crashing (recovery / clean) phase reaches here.
    with open(os.path.join(args.child, "result.json"), "w") as f:
        json.dump(result, f, indent=1)
    return 0


def fork_child(workdir: str, seed: int, crash_point=None, commit_mode=None, device=None) -> ForkedChild:
    """One child of a leg (``--child workdir ...``), forked from the fork
    server (:mod:`svoc_torch.durability.forked`)."""
    argv = ["--child", workdir, "--seed", str(seed)]
    if crash_point is not None:
        argv += ["--crash-point", crash_point]
    if commit_mode is not None:
        argv += ["--commit-mode", commit_mode]
    if device is not None:
        argv += ["--device", device]
    return ForkedChild("svoc_torch.tools.crash_smoke", argv)


def run_matrix(seed: int, legs, base_dir: str, device: Optional[str] = None) -> dict:
    """One full kill/restart matrix.  The legs use disjoint work
    directories, so each phase wave runs the legs in parallel."""
    out = {
        leg: {"crash_point": leg, "killed": [], "result": None,
              "fired": None, "notes": []}
        for leg in legs
    }
    for leg in legs:
        os.makedirs(os.path.join(base_dir, leg), exist_ok=True)
    max_phases = max(len(LEGS[leg][0]) for leg in legs)
    from svoc_torch.durability.faultspace import read_fired_log

    for phase in range(max_phases):
        procs = {}
        for leg in legs:
            chain, commit_mode = LEGS[leg]
            if phase >= len(chain):
                continue
            procs[leg] = (
                fork_child(
                    os.path.join(base_dir, leg), seed,
                    crash_point=chain[phase], commit_mode=commit_mode,
                    device=device,
                ),
                chain[phase] is not None,  # expect SIGKILL?
            )
        for leg, (proc, expect_kill) in procs.items():
            _stdout, stderr = proc.communicate()
            killed = proc.returncode == -signal.SIGKILL
            out[leg]["killed"].append(killed)
            if expect_kill and not killed:
                out[leg]["notes"].append(
                    f"phase {phase} exited {proc.returncode}, expected "
                    f"SIGKILL; stderr tail: {stderr[-500:]}"
                )
            elif not expect_kill:
                if proc.returncode != 0:
                    out[leg]["notes"].append(
                        f"recovery phase exited {proc.returncode}; "
                        f"stderr tail: {stderr[-500:]}"
                    )
                else:
                    workdir = os.path.join(base_dir, leg)
                    with open(os.path.join(workdir, "result.json")) as f:
                        out[leg]["result"] = json.load(f)
                    out[leg]["fired"] = read_fired_log(
                        os.path.join(workdir, "fired.jsonl")
                    )
    return out


def check_matrix(matrix: dict) -> dict:
    """The reference's per-leg checks over one matrix run."""
    checks = {}
    for leg, entry in matrix.items():
        chain, _mode = LEGS[leg]
        r = entry["result"]
        kills_ok = (
            len(entry["killed"]) == len(chain)
            and all(entry["killed"][:-1])
            and not entry["killed"][-1]
        )
        fired = (entry["fired"] or {}).get("fired", [])
        rec = (r or {}).get("recovery") or {}
        reconcile = rec.get("reconcile") or {}
        checks[leg] = {
            "killed_by_sigkill": kills_ok,
            "recovered": bool(r and r["recovered"]),
            "zero_duplicate_txs": bool(r and r["duplicate_txs"] == 0),
            "zero_open_wal_cycles": bool(r and not r["wal_open_cycles"]),
            "zero_unknown_slots": reconcile.get("unknown", 0) == 0,
            "zero_unaccounted_slots": reconcile.get("unaccounted", 0) == 0,
            "zero_unaccounted_requests": bool(
                r and r["requests"]["unaccounted"] == 0
            ),
            "ran_to_completion": bool(r and r["steps"] == TOTAL_STEPS),
            "named_point_fired": LEG_POINT[leg] in fired,
            "notes": entry["notes"],
        }
        if leg == "batch_mid_fleet":
            # The mid-batch kill must classify through the reconciler's
            # landed_batch/chain-digest columns — a durable prefix held
            # (landed), a suffix resent.
            counts = reconcile_counts(reconcile)
            checks[leg]["batch_prefix_landed"] = (
                counts.get("landed_chain", 0)
                + counts.get("landed_batch", 0)
                + counts.get("landed_durable", 0)
            ) >= 1
            checks[leg]["batch_suffix_resent"] = (
                reconcile.get("resent", 0) >= 1
            )
        checks[leg]["ok"] = all(
            v for k, v in checks[leg].items() if k != "notes"
        )
    return checks


def reconcile_counts(reconcile: dict) -> dict:
    """A reconcile report's slot classifications, summed over cycles."""
    totals: dict = {}
    for cyc in reconcile.get("cycles", []):
        for k, v in (cyc.get("counts") or {}).items():
            totals[k] = totals.get(k, 0) + v
    return totals


def build_kernels(device: Optional[str]) -> None:
    """On CUDA, build every kernel source before the first wave, so the
    children load finished libraries and never race one build."""
    from svoc_torch.device import resolve_device

    if resolve_device(device).type == "cuda":
        from svoc_torch.ops import _build

        _build.build(sorted(p.stem for p in _build.CSRC.glob("*.cu")))


def run(seed: int = 0, device: Optional[str] = None, base: Optional[str] = None) -> dict:
    """Both matrix runs and their checks; returns the artifact (``ok``,
    ``checks``, ``fingerprints``, ``reference_mismatches``, ``matrix``)."""
    build_kernels(device)
    legs = list(LEGS)
    base = base or tempfile.mkdtemp(prefix="crash-smoke-")
    # The two runs share nothing but the built kernels, so they run side by side.
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        first, second = pool.map(lambda run: run_matrix(seed, legs, os.path.join(base, run), device),
                                 ("run1", "run2"))
    checks = check_matrix(first)

    fingerprints = {}
    for leg in legs:
        r1 = first[leg]["result"] or {}
        r2 = second[leg]["result"] or {}
        c1 = {c: v["fingerprint"] for c, v in (r1.get("claims") or {}).items()}
        c2 = {c: v["fingerprint"] for c, v in (r2.get("claims") or {}).items()}
        fingerprints[leg] = {"identical": bool(c1) and c1 == c2, "claims": c1}
    all_checks = {
        f"{leg}.{name}": value
        for leg, ch in checks.items()
        for name, value in ch.items()
        if name not in ("ok", "notes")
    }
    all_checks["recovered_fingerprints_identical_across_matrix_runs"] = all(
        f["identical"] for f in fingerprints.values()
    )
    mismatches = None
    if seed == 0:
        mismatches = reference_mismatches(
            {leg: f["claims"] for leg, f in fingerprints.items()}
        )
        all_checks["matches_reference_fingerprints"] = not mismatches
    return {
        "seed": seed,
        "device": device or "cuda",
        "total_steps": TOTAL_STEPS,
        "crash_points": legs,
        "all_checks": all_checks,
        "checks": checks,
        "fingerprints": fingerprints,
        "reference_mismatches": mismatches,
        "ok": all(all_checks.values()),
        "matrix": {
            leg: {
                "killed": first[leg]["killed"],
                "commit_mode": LEGS[leg][1],
                "fired": first[leg]["fired"],
                "notes": first[leg]["notes"],
                "result": first[leg]["result"],
            }
            for leg in legs
        },
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="write the JSON artifact here")
    p.add_argument("--device", default=None, help="default: cuda (raises without a card)")
    p.add_argument("--child", default=None, help="(internal) scenario workdir")
    p.add_argument(
        "--crash-point", default=None,
        choices=sorted({pt for chain, _ in LEGS.values() for pt in chain if pt}),
    )
    p.add_argument("--commit-mode", default=None, choices=["per_tx", "batched"])
    args = p.parse_args(argv)
    if args.child is not None:
        return child_main(args)

    try:
        artifact = run(args.seed, args.device)
    finally:
        forked.stop()
    if args.out:
        from svoc_torch.utils.artifacts import atomic_write_json

        atomic_write_json(args.out, artifact)
    for name, passed in sorted(artifact["all_checks"].items()):
        print(f"  {'PASS' if passed else 'FAIL'}  {name}")
    if artifact["reference_mismatches"]:
        print("reference mismatches: " + json.dumps(artifact["reference_mismatches"]))
    for leg, notes in ((leg, c["notes"]) for leg, c in artifact["checks"].items()):
        for note in notes:
            print(f"  {leg}: {note}")
    print(
        f"crash-smoke {'OK' if artifact['ok'] else 'FAILED'}: "
        f"{len(LEGS)} kill legs (incl. batched mid-fleet + restart storm) "
        f"x 2 matrix runs on {artifact['device']}, 0 duplicate txs asserted "
        f"over the chain logs"
    )
    return 0 if artifact["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
