"""Both fleet smoke twins on the CPU, against the JAX package's.

- ``svoc_torch.tools.cluster_smoke`` at seed 0: every one of the
  reference's 13 checks passes, and the per-claim and fleet fingerprints
  equal the twin's ``REFERENCE_FINGERPRINTS`` and a live run of the
  reference's scenario under the same schedule.
- ``svoc_torch.tools.fleet_obs_smoke`` at its default seed (3): every one
  of the reference's 10 checks passes, and the fleet fingerprint equals
  ``REFERENCE_FLEET_FINGERPRINTS`` and the reference's kill-plan run.
- Every literal the card's run is held to (both smokes at seeds 0 and 3)
  equals a live reference run, and the twins' plans are the reference
  tools' own.
"""

import importlib.util
from pathlib import Path

import pytest

pytest.importorskip("jax")

from svoc_tpu.cluster.scenario import run_cluster_scenario as ref_run
from svoc_tpu.durability.faultspace import FaultEvent as RefFaultEvent

from svoc_torch.cluster.scenario import run_cluster_scenario
from svoc_torch.tools import cluster_smoke, fleet_obs_smoke

REPO = Path(__file__).resolve().parent.parent


def _reference_tool(name):
    spec = importlib.util.spec_from_file_location(f"ref_{name}", REPO / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def ref_cluster_run(workdir, seed):
    """The reference tool's ``run_once`` schedule, in ``workdir``."""
    return ref_run(
        str(workdir), seed=seed, n_replicas=cluster_smoke.N_REPLICAS, n_claims=cluster_smoke.N_CLAIMS,
        total_steps=cluster_smoke.TOTAL_STEPS, arrivals_per_step=cluster_smoke.ARRIVALS_PER_STEP,
        kill_replica=cluster_smoke.KILL_REPLICA, kill_at_step=cluster_smoke.KILL_AT_STEP,
        events=[RefFaultEvent(**cluster_smoke.INJECTED)],
    )


def test_twins_carry_the_reference_plans():
    ref = _reference_tool("cluster_smoke")
    assert (cluster_smoke.N_REPLICAS, cluster_smoke.N_CLAIMS, cluster_smoke.TOTAL_STEPS,
            cluster_smoke.ARRIVALS_PER_STEP, cluster_smoke.KILL_REPLICA, cluster_smoke.KILL_AT_STEP,
            cluster_smoke.CLUSTER_POINTS) == (
        ref.N_REPLICAS, ref.N_CLAIMS, ref.TOTAL_STEPS, ref.ARRIVALS_PER_STEP, ref.KILL_REPLICA,
        ref.KILL_AT_STEP, ref.CLUSTER_POINTS)
    ref_obs = _reference_tool("fleet_obs_smoke")
    assert fleet_obs_smoke.KILL_PLAN == ref_obs.KILL_PLAN
    assert fleet_obs_smoke.DEGRADATION_PLAN == ref_obs.DEGRADATION_PLAN


def test_cluster_smoke_twin_passes_with_the_reference_fingerprints(tmp_path):
    artifact = cluster_smoke.run(0, "cpu", str(tmp_path / "port"))
    failed = [c for c in artifact["checks"] if not c["ok"]]
    assert not failed, failed
    assert len(artifact["checks"]) == 14  # the reference's 13 and the reference match
    assert artifact["reference_mismatches"] == {}
    ref = ref_cluster_run(tmp_path / "ref", 0)
    assert artifact["fleet_fingerprint"] == ref["fleet_fingerprint"]
    assert {c: v["fingerprint"] for c, v in artifact["claims"].items()} == {
        c: v["fingerprint"] for c, v in ref["claims"].items()}
    assert artifact["requests"]["unaccounted"] == 0.0 and artifact["epoch"] == ref["epoch"]
    assert artifact["cluster_counters"] == ref["cluster_counters"]


def test_fleet_obs_smoke_twin_passes_with_the_reference_fingerprint(tmp_path):
    artifact = fleet_obs_smoke.run(device="cpu", base=str(tmp_path / "port"))
    assert artifact["seed"] == 3 and artifact["ok"], artifact["checks"]
    assert len(artifact["checks"]) == 11 and all(artifact["checks"].values())
    ref = ref_run(str(tmp_path / "ref"), 3, fleet_plane=True, **fleet_obs_smoke.KILL_PLAN)
    assert artifact["fleet_fingerprint"] == ref["fleet_fingerprint"] == artifact["reference_fingerprint"]
    stats = artifact["hop_coverage"]["stats"]
    assert stats["by_classification"] == {"complete": 114, "terminal": 6}
    assert artifact["bundles"] and artifact["profiler"]["captures"] == 1
    assert artifact["profiler"]["active"] is None  # stopped on the thread that started it


@pytest.mark.parametrize("seed", [0, 3])
def test_literals_equal_a_live_reference_run(tmp_path, seed):
    port = cluster_smoke.run_once(seed, "cpu", str(tmp_path / "cluster"))
    assert cluster_smoke.reference_mismatches(port, seed) == {}
    ref = ref_cluster_run(tmp_path / "cluster-ref", seed)
    assert cluster_smoke.REFERENCE_FINGERPRINTS[seed]["fleet"] == ref["fleet_fingerprint"]
    assert cluster_smoke.REFERENCE_FINGERPRINTS[seed]["claims"] == {
        c: v["fingerprint"] for c, v in ref["claims"].items()}
    obs = run_cluster_scenario(str(tmp_path / "obs"), seed, fleet_plane=False, device="cpu",
                               **fleet_obs_smoke.KILL_PLAN)
    ref_obs = ref_run(str(tmp_path / "obs-ref"), seed, fleet_plane=False, **fleet_obs_smoke.KILL_PLAN)
    assert obs["fleet_fingerprint"] == ref_obs["fleet_fingerprint"] == (
        fleet_obs_smoke.REFERENCE_FLEET_FINGERPRINTS[seed])
    assert cluster_smoke.reference_mismatches(port, 99) is None

