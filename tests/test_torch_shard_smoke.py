"""The port's shard-smoke twin against the JAX package's, on the CPU.

``svoc_torch.tools.shard_smoke`` runs the seeded 4-claim × 8-oracle
fabric scenario twice mesh-pinned at ``"2x4"`` (eight CPU slots) and
once unmeshed; every check of ``tools/shard_smoke.py`` must pass, and
the meshed per-claim fingerprints must equal both the tool's seed-0
constants and a live run of the reference's meshed scenario.

Tolerance: none; fingerprints are compared as strings.
"""

from __future__ import annotations

import pytest

jax = pytest.importorskip("jax")

from svoc_tpu.fabric.scenario import run_fabric_scenario as ref_run  # noqa: E402

from svoc_torch.tools import shard_smoke  # noqa: E402


@pytest.fixture(scope="module")
def report():
    return shard_smoke.run_shard_smoke(0, 10, device="cpu")


def test_every_check_passes(report):
    assert report["ok"], report["checks"]
    assert set(report["checks"]) >= {
        "meshed_replay_identical", "meshed_journal_identical", "meshed_equals_unmeshed",
        "sharded_dispatches_happened", "zero_shard_fallbacks", "offender_replaced", "siblings_clean",
        "matches_reference_fingerprints",
    }
    assert report["shard_dispatches"] >= 10 and report["shard_fallbacks"] == 0
    # On the CPU the plain claim-cube forms serve: no kernel launches.
    assert report["b3_launches"] == {"meshed": 0, "unmeshed": 0}


def test_constants_equal_a_live_reference_run(report):
    ref = ref_run(0, cycles=10, n_oracles=8, mesh="2x4")
    consts = shard_smoke.REFERENCE_FINGERPRINTS
    assert {c: v["fingerprint"] for c, v in ref["claims"].items()} == consts["claims"] == report["fingerprints"]
    assert ref["journal_fingerprint"] == consts["journal"] == report["journal_fingerprint"]
    assert ref["journal_events"] == consts["events"] == report["journal_events"]


def test_main_prints_the_gate(capsys, tmp_path):
    out = tmp_path / "shard.json"
    assert shard_smoke.main(["--device", "cpu", "--out", str(out)]) == 0
    text = capsys.readouterr().out
    assert "PASS  meshed_equals_unmeshed" in text and "shard-smoke OK" in text
    assert out.exists()
