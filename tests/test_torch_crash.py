"""The crash smoke's ``batch_mid_fleet`` leg in child processes, for the
port and for the JAX package side by side, on the CPU.

Each package's first child runs the durable scenario with batched
commits and is SIGKILLed at the ``chain.batch.mid_fleet`` fault point
(mid-way through the second claim's batch); its second child recovers
in the same directory and runs to the end.  The port's leg passes the
reference's checks, and its recovered per-claim fingerprints equal both
the reference's live run and the port's ``REFERENCE_FINGERPRINTS``
entry, which pins the literals the card's run is held to.  The chain
logs and the WAL the two packages leave are the same bytes.
"""

import importlib.util
import json
import os
import signal
from pathlib import Path

import pytest

pytest.importorskip("jax")

from svoc_torch.durability.faultspace import read_fired_log
from svoc_torch.tools import crash_smoke

REPO = Path(__file__).resolve().parent.parent
LEG = "batch_mid_fleet"


def _reference_tool():
    spec = importlib.util.spec_from_file_location("ref_crash_smoke", REPO / "tools" / "crash_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_batch_mid_fleet_leg_matches_reference(tmp_path):
    ref_tool = _reference_tool()
    chain, mode = crash_smoke.LEGS[LEG]
    assert (chain, mode) == ref_tool.LEGS[LEG]
    dirs = {"ref": tmp_path / "ref", "port": tmp_path / "port"}
    killed = {"ref": [], "port": []}
    for phase, point in enumerate(chain):
        procs = {
            "ref": ref_tool.spawn_child(str(dirs["ref"]), 0, crash_point=point, commit_mode=mode),
            "port": crash_smoke.fork_child(str(dirs["port"]), 0, crash_point=point,
                                           commit_mode=mode, device="cpu"),
        }
        for name, proc in procs.items():
            _out, err = proc.communicate(timeout=120)
            killed[name].append(proc.returncode == -signal.SIGKILL)
            if point is None:
                assert proc.returncode == 0, f"{name} recovery child failed:\n{err[-2000:]}"
    results = {name: json.loads((d / "result.json").read_text()) for name, d in dirs.items()}
    matrix = {LEG: {"killed": killed["port"], "result": results["port"],
                    "fired": read_fired_log(str(dirs["port"] / "fired.jsonl")), "notes": []}}
    checks = crash_smoke.check_matrix(matrix)[LEG]
    assert checks["ok"], checks
    assert killed["ref"] == killed["port"] == [True, False]

    port_fp = {c: v["fingerprint"] for c, v in results["port"]["claims"].items()}
    ref_fp = {c: v["fingerprint"] for c, v in results["ref"]["claims"].items()}
    assert port_fp == ref_fp == crash_smoke.REFERENCE_FINGERPRINTS[LEG]
    assert crash_smoke.reference_mismatches({LEG: port_fp}) == {
        leg: None for leg in crash_smoke.REFERENCE_FINGERPRINTS if leg != LEG}
    ref_rec, port_rec = results["ref"]["recovery"], results["port"]["recovery"]
    assert port_rec["reconcile"] == ref_rec["reconcile"]
    assert crash_smoke.reconcile_counts(port_rec["reconcile"])["landed_chain"] >= 1
    for name in sorted(os.listdir(dirs["ref"])):
        if name.startswith(("wal.jsonl", "chain-", "fired.jsonl")):
            assert (dirs["ref"] / name).read_bytes() == (dirs["port"] / name).read_bytes(), name


def test_check_matrix_flags_a_leg_that_was_not_killed():
    result = {"recovered": True, "duplicate_txs": 1, "wal_open_cycles": [],
              "requests": {"unaccounted": 0.0}, "steps": crash_smoke.TOTAL_STEPS,
              "recovery": {"reconcile": {"unknown": 0, "unaccounted": 0, "resent": 0,
                                         "cycles": []}}}
    matrix = {LEG: {"killed": [False, False], "result": result,
                    "fired": {"fired": []}, "notes": []}}
    checks = crash_smoke.check_matrix(matrix)[LEG]
    assert not checks["ok"]
    assert {k for k, v in checks.items() if v is False} == {
        "killed_by_sigkill", "zero_duplicate_txs", "named_point_fired",
        "batch_prefix_landed", "batch_suffix_resent", "ok"}


@pytest.mark.parametrize("leg", ["recovery_storm", "pre_snapshot"])
def test_a_forked_leg_recovers_to_the_reference_fingerprints(tmp_path, leg):
    """``run_matrix``'s children, forked from the fork server: each is
    SIGKILLed where its chain says, the last recovers, and the recovered
    per-claim fingerprints are the JAX package's literals."""
    matrix = crash_smoke.run_matrix(0, [leg], str(tmp_path), device="cpu")
    chain, _mode = crash_smoke.LEGS[leg]
    assert matrix[leg]["killed"] == [True] * (len(chain) - 1) + [False], matrix[leg]["notes"]
    assert crash_smoke.check_matrix(matrix)[leg]["ok"], matrix[leg]["notes"]
    fingerprints = {c: v["fingerprint"] for c, v in matrix[leg]["result"]["claims"].items()}
    assert fingerprints == crash_smoke.REFERENCE_FINGERPRINTS[leg]
    assert not any(name.startswith("forked-") for name in os.listdir(tmp_path / leg))
