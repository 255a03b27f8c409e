"""The port's flight-recorder and cost-plane gates (``svoc_torch.tools.
{obs_smoke,obs_cost_smoke,obs_query,postmortem}``) on the CPU at seed 0:

- ``obs_smoke``: the reference's 11 checks pass and the journal
  fingerprint equals ``REFERENCE_JOURNAL_FINGERPRINTS[0]``; that constant
  equals a live reference run of the Byzantine scenario;
- ``obs_cost_smoke``: the reference's 8 checks pass (the JSONL rebuild
  through ``python -m svoc_torch.tools.obs_query`` in its own
  interpreter), all four fingerprints equal its constant, itself a
  live reference serving scenario's, and its universe is the
  reference's 16 keys (donate twins included);
- ``obs_query --json`` over one streamed trace gives the reference's
  ``tools/obs_query.py`` document, key for key;
- ``postmortem`` writes a complete bundle and records its device.
"""

import json
import runpy
from pathlib import Path

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402, F401

from svoc_torch.tools import obs_cost_smoke, obs_query, obs_smoke, postmortem  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def test_obs_smoke_on_the_cpu_equals_the_reference():
    from svoc_tpu.resilience.chaos import run_byzantine_scenario
    from svoc_tpu.utils.events import EventJournal
    from svoc_tpu.utils.metrics import MetricsRegistry

    art = obs_smoke.run(0, "cpu")
    assert art["ok"] and len(art["checks"]) == 11 and art["device"] == "cpu"
    assert art["journal_fingerprint"] == obs_smoke.REFERENCE_JOURNAL_FINGERPRINTS[0] == art["reference_fingerprint"]
    live = run_byzantine_scenario(0, registry=MetricsRegistry(), journal=EventJournal(MetricsRegistry()))
    assert live["journal_fingerprint"] == obs_smoke.REFERENCE_JOURNAL_FINGERPRINTS[0]
    assert art["audit_linkage"]["lineage"] and art["session"]["bundle_missing_keys"] == []


def test_obs_cost_smoke_on_the_cpu_equals_the_reference():
    from svoc_tpu.serving.scenario import run_serving_scenario

    art = obs_cost_smoke.run(0, "cpu")
    assert art["ok"] and len(art["checks"]) == 8, art["checks"]
    assert set(art["fingerprints"]) == {obs_cost_smoke.REFERENCE_JOURNAL_FINGERPRINTS[0]}
    assert art["reconstruction"]["rebuilt_keys"] == art["reconstruction"]["live_keys"] > 0
    live = run_serving_scenario(0, cost_plane="off")
    assert live["journal_fingerprint"] == obs_cost_smoke.REFERENCE_JOURNAL_FINGERPRINTS[0]
    # The universe is the reference's, its donate twins included: 16 keys.
    ref_tool = runpy.run_path(str(REPO / "tools" / "obs_cost_smoke.py"), run_name="ref_obs_cost_smoke")
    assert art["coverage"]["universe"] == ref_tool["universe_coverage"](live)["universe"]
    assert art["coverage"]["universe"]["keys"] == 16


def test_obs_query_document_equals_the_reference(tmp_path, capsys):
    from svoc_torch.serving.scenario import run_serving_scenario

    trace = str(tmp_path / "obs.jsonl")
    run_serving_scenario(0, phases=((2, 6), (2, 12)), cost_plane="on", cost_trace_path=trace, device="cpu")
    argv = [trace, "--tag", f"{trace}=smoke", "--json"]
    assert obs_query.main(argv + ["--device", "cpu"]) == 0
    ours = json.loads(capsys.readouterr().out)
    ref_tool = runpy.run_path(str(REPO / "tools" / "obs_query.py"), run_name="ref_obs_query")
    assert ref_tool["main"](argv) == 0
    theirs = json.loads(capsys.readouterr().out)
    assert ours == theirs and ours["ledgers"]["smoke"]["samples"] > 0 and ours["timelines"]
    assert obs_query.main([trace, "--device", "cpu"]) == 0  # the human-readable view
    assert "ledger [obs.jsonl]" in capsys.readouterr().out


def test_postmortem_writes_a_complete_bundle(tmp_path, capsys):
    from svoc_torch.utils.postmortem import BUNDLE_KEYS

    assert postmortem.main(["--out-dir", str(tmp_path), "--device", "cpu", "--seed", "3"]) == 0
    (path,) = tmp_path.glob("*.json")
    bundle = json.loads(path.read_text())
    assert all(k in bundle for k in BUNDLE_KEYS) and bundle["trigger"] == "manual"
    assert bundle["extra"] == {"device": "cpu", "seed": 3}
    assert "postmortem bundle written" in capsys.readouterr().out
