"""The port's cost-attribution plane and dispatch keys against the JAX
package's, on the CPU.

- ``CompileKey``, ``dispatch_key``, ``ledger_key`` and ``group_key`` give
  the reference's labels and cell ids for the same fields.
- The ledger folds the same samples into the same EMAs (exactly: the
  same float64 arithmetic in the same order), and ``to_dict`` /
  ``restore`` / ``CostModel.estimate`` give the reference's results.
- ``RequestTimeline`` stages and the ``ObservationLog`` records (ring,
  sidecar file, ``read_observations``) equal the reference's on the same
  marks and samples.
- The plane's resolution: the argument, then ``SVOC_COST_PLANE``, then
  the committed decision (on), as the reference resolves it.
- Through the seeded serving scenario with the plane on, the
  ``timeline.request`` observations (virtual clock) equal the
  reference's record for record, the ``cost.sample`` records carry the
  same cells and warmths in the same order (their seconds are host
  time), and ``consensus_dispatch{warmth=}`` counts alike.
"""

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from svoc_tpu.compile import universe as ref_universe
from svoc_tpu.consensus.kernel import ConsensusConfig as RefConfig
from svoc_tpu.obsplane import ledger as ref_ledger
from svoc_tpu.obsplane import plane as ref_plane
from svoc_tpu.obsplane import timeline as ref_timeline
from svoc_tpu.serving import scenario as ref_scenario

from svoc_torch.compile import universe
from svoc_torch.consensus.kernel import ConsensusConfig
from svoc_torch.obsplane import ledger, plane, timeline
from svoc_torch.serving import scenario

PHASES = ((4, 3), (30, 4), (4, 3))


def _keys(mod, cfg_cls):
    out = []
    for sanitized in (False, True):
        for bucket, n, m in ((1, 7, 6), (4, 7, 6), (64, 1024, 6)):
            for cfg in (cfg_cls(n_failing=2), cfg_cls(n_failing=128, constrained=False)):
                out.append(mod.dispatch_key(sanitized=sanitized, sharded=False, bucket=bucket,
                                            n_oracles=n, dimension=m, cfg=cfg, donate=False,
                                            impl="xla", mesh=None))
    return out


def test_dispatch_keys_and_cell_ids_equal_the_reference():
    ours, theirs = _keys(universe, ConsensusConfig), _keys(ref_universe, RefConfig)
    assert [k.label() for k in ours] == [k.label() for k in theirs]
    assert [ledger.ledger_key(k) for k in ours] == [ref_ledger.ledger_key(k) for k in theirs]
    assert [ledger.group_key(k) for k in ours] == [ref_ledger.group_key(k) for k in theirs]
    assert [k.group()[:2] for k in ours] == [k.group()[:2] for k in theirs]
    sharded = universe.dispatch_key(sanitized=True, sharded=True, bucket=8, n_oracles=7,
                                    dimension=6, cfg=ConsensusConfig(), donate=True, impl="xla",
                                    mesh="2x1")
    assert sharded.label() == "sharded_sanitized:c8n7m6+donate@2x1"
    for bad in (dict(kind="other", bucket=1), dict(kind="gated", bucket=0)):
        with pytest.raises(ValueError):
            universe.CompileKey(n_oracles=7, dimension=6, cfg=ConsensusConfig(), **bad)


def _samples(seed=0, n=60):
    rng = np.random.default_rng(seed)
    ours, theirs = _keys(universe, ConsensusConfig), _keys(ref_universe, RefConfig)
    picks = rng.integers(0, len(ours), n)
    warmths = rng.choice(ledger.WARMTHS, n)
    seconds = rng.exponential(1e-3, n)
    return [(ours[i], theirs[i], str(w), float(s)) for i, w, s in zip(picks, warmths, seconds)]


def test_ledger_emas_to_dict_restore_and_estimates_equal_the_reference():
    ours, theirs = ledger.CostLedger(alpha=0.3), ref_ledger.CostLedger(alpha=0.3)
    for k_ours, k_theirs, warmth, seconds in _samples():
        assert ours.observe(k_ours, warmth, seconds) == theirs.observe(k_theirs, warmth, seconds)
    assert ours.to_dict() == theirs.to_dict()
    assert ours.summary() == theirs.summary() and len(ours) == len(theirs)
    # Restore into fresh ledgers, with foreign entries skipped alike.
    payload = json.loads(json.dumps(ours.to_dict()))
    payload["entries"]["junk"] = {"warmth": "not a dict"}
    payload["entries"]["half"] = {"group": "n7m6", "warmth": {"warm": {"ema_s": 1.0}}}
    a, b = ledger.CostLedger(), ref_ledger.CostLedger()
    assert a.restore(payload) == b.restore(payload) == len(ours)
    assert a.to_dict()["entries"] == b.to_dict()["entries"] == ours.to_dict()["entries"]
    assert a.restore(None) == b.restore(None) == 0
    # Estimates: exact cells, group and global fallbacks, and nothing at all.
    model, ref_model = ledger.CostModel(ours), ref_ledger.CostModel(theirs)
    probe_ours = _keys(universe, ConsensusConfig) + [
        universe.dispatch_key(sanitized=True, sharded=False, bucket=2, n_oracles=7, dimension=3,
                              cfg=ConsensusConfig(), donate=False, impl="xla", mesh=None)]
    probe_theirs = _keys(ref_universe, RefConfig) + [
        ref_universe.dispatch_key(sanitized=True, sharded=False, bucket=2, n_oracles=7,
                                  dimension=3, cfg=RefConfig(), donate=False, impl="xla",
                                  mesh=None)]
    for k_ours, k_theirs in zip(probe_ours, probe_theirs):
        assert model.estimate(k_ours) == ref_model.estimate(k_theirs)
    assert ledger.CostModel(ledger.CostLedger()).estimate(probe_ours[0]) == \
        ref_ledger.CostModel(ref_ledger.CostLedger()).estimate(probe_theirs[0])
    with pytest.raises(ValueError):
        ledger.CostLedger(alpha=0.0)


def test_timelines_and_observation_records_equal_the_reference(tmp_path):
    marks = [("assembled", 0.3), ("vectorized", 0.35), ("h2d", 0.36), ("dispatched", 0.4),
             ("synced", 0.41), ("assembled", 9.0), ("completed", 0.5)]
    ours, theirs = timeline.RequestTimeline("blk-a-rq1", "a", 0.1), \
        ref_timeline.RequestTimeline("blk-a-rq1", "a", 0.1)
    for name, t in marks:
        ours.mark(name, t)
        theirs.mark(name, t)
    assert ours.marks == theirs.marks and ours.stages() == theirs.stages()
    assert ours.e2e_s() == theirs.e2e_s() and sum(ours.stages().values()) == pytest.approx(0.4)
    with pytest.raises(ValueError):
        ours.mark("nope", 1.0)

    paths = {"ours": str(tmp_path / "ours.jsonl"), "theirs": str(tmp_path / "theirs.jsonl")}
    logs = {"ours": timeline.ObservationLog(trace_path=paths["ours"], max_records=5),
            "theirs": ref_timeline.ObservationLog(trace_path=paths["theirs"], max_records=5)}
    for log in logs.values():
        for i in range(8):
            log.record("cost.sample", lineage=f"blk-{i % 2}", key=f"k{i}", seconds=i * 0.5)
        log.record("timeline.request", lineage="blk-0", stages={"queue_wait": 0.2})
    assert logs["ours"].recent(10) == logs["theirs"].recent(10)
    assert logs["ours"].recent(10, kind="cost.sample", lineage="blk-1") == \
        logs["theirs"].recent(10, kind="cost.sample", lineage="blk-1")
    assert len(logs["ours"]) == 5 and logs["ours"].last_seq() == 9
    assert timeline.read_observations(paths["ours"]) == \
        ref_timeline.read_observations(paths["theirs"])
    assert len(timeline.read_observations(paths["ours"])) == 9
    with open(paths["ours"], "a") as f:
        f.write('{"obs": "torn')  # a crashed writer's tail
    assert len(timeline.read_observations(paths["ours"])) == 9


@pytest.mark.parametrize("env,arg,want", [("", None, True), ("off", None, False), ("1", None, True),
                                          ("off", True, True), ("on", False, False)])
def test_plane_resolution_equals_the_reference(monkeypatch, env, arg, want):
    monkeypatch.setenv("SVOC_COST_PLANE", env)
    assert plane.resolve_cost_plane_enabled(arg) == ref_plane.resolve_cost_plane_enabled(arg) == want
    assert plane.resolve_cost_plane(enabled=arg).enabled == want


def test_plane_hooks_are_inert_when_off():
    off = plane.CostPlane(enabled=False, clock=lambda: 1.0)
    assert off.timeline_for("l", "c", 0.0) is None
    off.claim_mark(["c"], "h2d")
    off.shed("l", "c", "queue_full")
    off.observe_dispatch(_keys(universe, ConsensusConfig)[0], "cold", 0.1)
    assert len(off.obslog) == 0 and off.snapshot()["ledger"]["keys"] == 0


def test_plane_ledger_save_and_restore(tmp_path):
    on = plane.CostPlane(enabled=True)
    for k_ours, _k, warmth, seconds in _samples(1, 10):
        on.observe_dispatch(k_ours, warmth, seconds, breakdown={"sync": seconds})
    path = str(tmp_path / "ledger.json")
    on.save_ledger(path)
    fresh = plane.CostPlane(enabled=True)
    assert fresh.restore_ledger(path) == len(on.ledger)
    assert fresh.ledger.to_dict() == on.ledger.to_dict()
    assert fresh.restore_ledger(str(tmp_path / "missing.json")) == 0
    (tmp_path / "bad.json").write_text("{not json")
    assert fresh.restore_ledger(str(tmp_path / "bad.json")) == 0
    assert fresh._metrics.counter("cost_ledger_errors", labels={"op": "restore"}).count >= 1
    assert [r["obs"] for r in on.obslog.recent(20)] == ["cost.sample"] * 10


def test_scenario_observations_equal_the_reference():
    ours = scenario.run_serving_scenario(0, phases=PHASES, cost_plane="on", device="cpu")
    theirs = ref_scenario.run_serving_scenario(0, phases=PHASES, cost_plane="on")
    assert ours["journal_fingerprint"] == theirs["journal_fingerprint"]
    obs = {name: r["cost_plane"].obslog.recent(10_000) for name, r in (("ours", ours), ("theirs", theirs))}
    timelines = [[r for r in obs[n] if r["obs"] == "timeline.request"] for n in ("ours", "theirs")]
    assert timelines[0] == timelines[1] and len(timelines[0]) > 0
    assert {r["data"]["outcome"] for r in timelines[0]} >= {"completed", "shed"}

    def cells(records):
        return [(r["data"]["key"].split("|")[0], r["data"]["group"], r["data"]["warmth"])
                for r in records if r["obs"] == "cost.sample"]

    assert cells(obs["ours"]) == cells(obs["theirs"]) and len(cells(obs["ours"])) > 0
    assert all(r["data"]["key"].split("|")[1] == "plain" for r in obs["ours"] if r["obs"] == "cost.sample")
    for name, r in (("ours", ours), ("theirs", theirs)):
        obs[name] = sorted(r["multi"].metrics.family_series("consensus_dispatch"),
                           key=lambda s: s[0]["warmth"])
    assert obs["ours"] == obs["theirs"]
    off = scenario.run_serving_scenario(0, phases=PHASES, cost_plane="off", device="cpu")
    assert off["journal_fingerprint"] == ours["journal_fingerprint"]
    assert len(off["cost_plane"].obslog) == 0
