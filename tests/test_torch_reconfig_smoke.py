"""The port's reconfig smoke (``svoc_torch.tools.reconfig_smoke``) and
scenario (``svoc_torch.cluster.reconfig_scenario``) against the JAX
package's, on the CPU:

- the smoke's ``REFERENCE_FINGERPRINTS`` at seed 0 equal a live run of
  the reference smoke's committed transition and abort baselines (the
  constants the card's run is held to);
- the port's smoke at seed 0 passes every check, the reference
  comparison included;
- the committed ``reconfig/rolling-repin-commit.json`` entry, read as it
  is, replays to the reference's fleet and per-claim fingerprints and
  epoch chain, twice over;
- the durable fuzzer's ``load_corpus`` never returns a reconfiguration or
  cluster entry.
"""

import json
import os
import sys

import pytest

pytest.importorskip("jax")

import jax  # noqa: F401

import svoc_tpu.cluster.reconfig_scenario as ref_scenario

import svoc_torch.cluster.reconfig_scenario as scenario
from svoc_torch.durability.fuzz import load_corpus
from svoc_torch.tools import reconfig_smoke

CORPUS_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "chaos_corpus")
ENTRY = os.path.join(CORPUS_DIR, "reconfig", "rolling-repin-commit.json")


@pytest.fixture(scope="module")
def ref_smoke():
    """The reference smoke's module (``tools/reconfig_smoke.py``), imported
    from the repository's tools directory."""
    tools = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")
    sys.path.insert(0, tools)
    try:
        import reconfig_smoke as ref
    finally:
        sys.path.remove(tools)
    return ref


def test_reference_constants_equal_the_live_reference(ref_smoke, tmp_path):
    first = ref_smoke.run_committed(0)
    live = {
        "fleet": first["fleet_fingerprint"],
        "claims": {cid: c["fingerprint"] for cid, c in first["claims"].items()},
        "epoch_chain": first["epoch_chain"],
        "abort_baselines": {},
    }
    for point in reconfig_smoke.RECONFIG_POINTS:
        baseline = ref_scenario.run_reconfig_scenario(
            str(tmp_path / point), seed=0, plan=None,
            events=[ref_scenario.FaultEvent(point=point, nth=1, action="error")],
            **reconfig_smoke.ABORT_RUN)
        live["abort_baselines"][point] = baseline["fleet_fingerprint"]
    assert reconfig_smoke.REFERENCE_FINGERPRINTS[0] == live
    assert reconfig_smoke.RECONFIG_POINTS == ref_smoke.RECONFIG_POINTS
    assert reconfig_smoke.plan_dict() == ref_smoke._plan(7, 6)
    assert (reconfig_smoke.N_REPLICAS, reconfig_smoke.N_CLAIMS, reconfig_smoke.TOTAL_STEPS,
            reconfig_smoke.ARRIVALS_PER_STEP, reconfig_smoke.RECONFIG_AT_STEP) == (
        ref_smoke.N_REPLICAS, ref_smoke.N_CLAIMS, ref_smoke.TOTAL_STEPS, ref_smoke.ARRIVALS_PER_STEP,
        ref_smoke.RECONFIG_AT_STEP)


def test_port_smoke_passes_every_check(tmp_path):
    artifact = reconfig_smoke.run(0, "cpu", str(tmp_path))
    failed = [c for c in artifact["checks"] if not c["ok"]]
    assert not failed and artifact["ok"]
    assert artifact["reference_mismatches"] == {}
    assert len(artifact["checks"]) == 18
    assert all(a["status"] == "aborted" and a["identical"] for a in artifact["aborts"].values())


def test_reconfig_corpus_entry_replays_to_the_reference(tmp_path):
    with open(ENTRY) as f:
        entry = json.load(f)
    port = [scenario.replay_corpus_entry(entry, str(tmp_path / f"port-{tag}"), device="cpu") for tag in "ab"]
    ref = ref_scenario.replay_corpus_entry(entry, str(tmp_path / "ref"))

    def figures(r):
        return (r["reconfig"]["status"], r["fleet_fingerprint"], r["epoch_chain"],
                {c: v["fingerprint"] for c, v in r["claims"].items()}, r["duplicate_txs"],
                r["requests"], r["cluster_counters"], [p["response"]["status"] for p in r["probes"]])

    assert figures(port[0]) == figures(port[1]) == figures(ref)
    assert figures(ref)[0] == "committed" and ref["reconfig_epoch"] == 1
    with pytest.raises(ValueError, match="not a reconfig corpus entry"):
        scenario.replay_corpus_entry({"format": "svoc-cluster-corpus-v1"}, str(tmp_path / "x"), device="cpu")


def test_load_corpus_never_returns_reconfig_or_cluster_entries():
    formats = {e.get("format") for e in load_corpus(CORPUS_DIR)}
    assert formats == {"svoc-chaos-corpus-v1"}
    assert load_corpus(os.path.join(CORPUS_DIR, "reconfig")) and load_corpus(os.path.join(CORPUS_DIR, "cluster"))
