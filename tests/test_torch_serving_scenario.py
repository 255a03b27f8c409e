"""The port's seeded serving scenario and serving smoke against the JAX
package's, on the CPU.

- The seeded serving scenario: journal and per-claim fingerprints
  byte-identical to the reference's for seeds 0 and 1, with the cost
  plane on and off (and at short phases for seed 3, replayed, beside
  seed 4, which diverges); the serving smoke's committed constants equal
  the live reference's, and the smoke passes its gates on the CPU.
"""

import pytest

jax = pytest.importorskip("jax")

from svoc_tpu.serving import scenario as ref_scenario

from svoc_torch.serving import scenario
from svoc_torch.tools import serving_smoke


# -- the seeded scenario -------------------------------------------------------------------

PHASES = ((4, 3), (30, 4), (4, 3))
FINGERPRINTED = ("journal_fingerprint", "journal_events", "per_claim_fingerprints",
                 "shed_by_reason", "phases", "submitted", "admitted", "cached", "shed",
                 "completed", "cache", "latency")


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("plane", ["on", "off"])
def test_scenario_fingerprints_equal_the_reference(seed, plane):
    want = ref_scenario.run_serving_scenario(seed, cost_plane=plane)
    got = scenario.run_serving_scenario(seed, cost_plane=plane, device="cpu")
    for key in FINGERPRINTED:
        assert got[key] == want[key], key
    assert got["cost_plane"].enabled == (plane == "on")
    if seed == 0:
        assert not serving_smoke.reference_mismatches(got)
        assert not serving_smoke.reference_mismatches(want)  # the committed constants are live


def test_scenario_short_phases_replay_and_diverge():
    a = scenario.run_serving_scenario(3, phases=PHASES, device="cpu")
    b = scenario.run_serving_scenario(3, phases=PHASES, device="cpu")
    c = scenario.run_serving_scenario(4, phases=PHASES, device="cpu")
    ref = ref_scenario.run_serving_scenario(3, phases=PHASES)
    assert a["journal_fingerprint"] == b["journal_fingerprint"] == ref["journal_fingerprint"]
    assert a["per_claim_fingerprints"] == b["per_claim_fingerprints"]
    assert a["journal_fingerprint"] != c["journal_fingerprint"]
    d = scenario.run_serving_scenario(0, phases=PHASES, device="cpu")
    warm, overload, _ = d["phases"]
    assert warm["shed"] == 0 and overload["shed"] > 0 and d["cache"]["hits"] > 0
    assert d["completed"] > 0 and d["latency"]["count"] > 0


def test_serving_smoke_passes_on_the_cpu(capsys):
    assert serving_smoke.main(["--device", "cpu"]) == 0
    assert "serving-smoke OK" in capsys.readouterr().out
