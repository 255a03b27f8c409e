"""The port's cold-start smoke on the CPU against the JAX package's.

The smoke's three children (``control``, ``warm_first`` SIGKILLed while
parked, ``warm_restart`` on the same durable directory) run as separate
interpreters on the CPU; their per-claim and whole-journal fingerprints
must equal each other, the literals of
``svoc_torch.tools.coldstart_smoke.REFERENCE_FINGERPRINTS`` and the JAX
package's own warmed fabric scenario (the reference smoke's leg, seed 0,
8 cycles) run in this test.  The three cache checks need kernel builds,
so the report lists them as not run on the CPU.
"""

import pytest

pytest.importorskip("jax")

from svoc_tpu.fabric.scenario import run_fabric_scenario as ref_run_fabric_scenario

from svoc_torch.tools import coldstart_smoke


@pytest.fixture(scope="module")
def reference():
    result = ref_run_fabric_scenario(0, cycles=coldstart_smoke.REFERENCE_CYCLES, warmup=True)
    return {"journal_fingerprint": result["journal_fingerprint"],
            "claims": {c: result["claims"][c]["fingerprint"] for c in sorted(result["claims"])}}


def test_reference_fingerprints_are_the_live_references(reference):
    assert coldstart_smoke.REFERENCE_FINGERPRINTS == reference


def test_three_children_on_the_cpu(reference, tmp_path):
    artifact = coldstart_smoke.run(0, device="cpu", base=str(tmp_path))
    assert artifact["ok"], artifact["checks"]
    assert artifact["not_run"] == list(coldstart_smoke.CACHE_CHECKS)
    assert artifact["reference_mismatches"] == {}
    for leg in coldstart_smoke.LEGS:
        got = artifact["legs"][leg]
        assert {"journal_fingerprint": got["journal_fingerprint"], "claims": got["claims"]} == reference, leg
    assert artifact["legs"]["warm_first"]["returncode"] == -9
    warmed = artifact["legs"]["warm_restart"]["prewarm_outcomes"]
    # buckets 1, 2, 4 x both gate fusions x both donate flips (the reference's universe)
    assert warmed["primed"] == 12 and warmed["error"] == 0
    assert artifact["legs"]["control"]["prewarm_outcomes"]["primed"] == 0


def test_reference_mismatches_name_the_leg():
    good = dict(coldstart_smoke.REFERENCE_FINGERPRINTS)
    bad = {**good, "journal_fingerprint": "0" * 64}
    assert coldstart_smoke.reference_mismatches({"control": good}) == {}
    assert list(coldstart_smoke.reference_mismatches({"control": good, "warm_first": bad})) == ["warm_first"]


@pytest.mark.parametrize("pipelined", [False, True])
def test_warmed_fabric_scenario_keeps_the_references_fingerprints(pipelined):
    """``run_fabric_scenario(0, warmup=True)`` (12 cycles) journals what
    the JAX package's unwarmed scenario journals: warmup never journals."""
    from svoc_torch.fabric.scenario import run_fabric_scenario
    from svoc_torch.tools import fabric_smoke

    result = run_fabric_scenario(0, warmup=True, pipelined=pipelined, device="cpu")
    assert fabric_smoke.reference_mismatches(result, pipelined) == {}
