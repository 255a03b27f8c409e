"""The port's claim fabric (``MultiSession`` over the ``ClaimRouter``)
against the JAX package's, on the CPU.

- ``run_fabric_scenario`` for seeds 0 and 1, unpipelined and pipelined,
  under both commit modes: every key of the result equal, so the
  per-claim and whole-journal fingerprints are byte-identical, and each
  claim's last consensus slice equal (``reliable`` exactly, the essences
  and reliabilities within 1e-5).
- The reference fingerprints committed in
  :mod:`svoc_torch.tools.fabric_smoke` (what ``chip_smoke.py`` holds the
  card to) still equal the live reference's.
- The fabric smoke's twin passes on the CPU (``tests/test_torch_fabric_router.py``
  holds the router's other modes).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

from svoc_tpu.fabric import scenario as ref_scenario
from svoc_tpu.fabric import session as ref_fabric_session

from svoc_torch.fabric import scenario
from svoc_torch.fabric import session as fabric_session
from svoc_torch.tools import fabric_smoke

CASES = [(seed, pipelined, mode) for seed in (0, 1) for pipelined in (False, True)
         for mode in ("per_tx", "batched")]


def _run(mod, fabric_mod, seed, pipelined, mode, **kw):
    """One scenario run; also returns the MultiSession it built."""
    built = []
    original = fabric_mod.MultiSession.run

    def run(self, cycles):
        built.append(self)
        return original(self, cycles)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fabric_mod.MultiSession, "run", run)
        result = mod.run_fabric_scenario(seed, pipelined=pipelined, commit_mode=mode, **kw)
    return result, built[0]


@pytest.fixture(scope="module")
def reference_runs():
    return {case: _run(ref_scenario, ref_fabric_session, *case) for case in CASES}


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"seed{c[0]}-{'pipe' if c[1] else 'serial'}-{c[2]}")
def test_scenario_equals_the_reference(case, reference_runs):
    ref, ref_multi = reference_runs[case]
    port, multi = _run(scenario, fabric_session, *case, device="cpu")
    assert set(port) == set(ref)
    for key in ref:
        assert port[key] == ref[key], key
    assert port["offender_replaced"] and port["siblings_clean"]
    assert port["injection_count"] == 7 if case[0] == 0 else port["injection_count"] > 0
    for claim in ref["claims"]:
        got = multi.get(claim).last_consensus
        want = ref_multi.get(claim).last_consensus
        assert got["reliable"] == want["reliable"]
        assert (got["interval_valid"], got["admitted"]) == (want["interval_valid"], want["admitted"])
        for field in ("essence", "essence_first_pass", "reliability_first_pass",
                      "reliability_second_pass"):
            np.testing.assert_allclose(got[field], want[field], atol=1e-5, rtol=0)


@pytest.mark.parametrize("pipelined", [False, True])
def test_committed_fingerprints_equal_the_live_reference(pipelined, reference_runs):
    ref, _ = reference_runs[(0, pipelined, "batched")]
    assert fabric_smoke.reference_mismatches(ref, pipelined) == {}
    per_tx, _ = reference_runs[(0, pipelined, "per_tx")]
    assert fabric_smoke.reference_mismatches(per_tx, pipelined) == {}


def test_fabric_smoke_twin_on_the_cpu(capsys):
    assert fabric_smoke.main(["--device", "cpu", "--cycles", "12"]) == 0
    out = capsys.readouterr().out
    assert "PASS  matches_reference_fingerprints" in out and "FAIL" not in out
