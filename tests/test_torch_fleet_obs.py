"""The port's fleet observability plane (``svoc_torch.obsplane.{fleet,
hopchain,anomaly}``, ``utils/slo.py::fleet_slos``) against the JAX
package's, on the CPU: twins of ``tests/test_fleet_obs.py``, each
holding the port to the reference in the same test.

- ``join_hop_chains`` and ``chain_stats`` equal the reference's on the
  same records (the reference's own sidecars and hand-made chains).
- ``AnomalyDetector`` alerts and summaries equal on seeded series.
- ``FleetAggregator.merge`` and the Prometheus exposition equal on the
  same registries (counters, gauges, timers, histograms, mismatched
  grids, the retired fold).
- ``fleet_slos`` evaluations equal over a seeded sequence of merges.
- Over the seeded kill/failover + migrate fleet: the plane is invisible
  to the fleet fingerprint (on and off, equal to the reference's), the
  off plane is inert, hop chains join across replicas, the fleet totals
  never step backward, and the accounting carries the observations.
"""

import os

import numpy as np
import pytest

pytest.importorskip("jax")

import svoc_tpu.obsplane.anomaly as ref_anomaly
import svoc_tpu.obsplane.fleet as ref_fleet
import svoc_tpu.obsplane.hopchain as ref_hopchain
import svoc_tpu.utils.metrics as ref_metrics
import svoc_tpu.utils.slo as ref_slo
from svoc_tpu.cluster.scenario import run_cluster_scenario as ref_run
from svoc_tpu.obsplane.timeline import read_observations as ref_read_observations

import svoc_torch.obsplane.anomaly as anomaly
import svoc_torch.obsplane.fleet as fleet
import svoc_torch.obsplane.hopchain as hopchain
import svoc_torch.utils.metrics as metrics_mod
import svoc_torch.utils.slo as slo
from svoc_torch.cluster.scenario import run_cluster_scenario
from svoc_torch.obsplane.fleet import ACCOUNTING_FAMILIES, FleetAggregator
from svoc_torch.obsplane.timeline import ObservationLog, read_observations

PLAN = dict(
    seed=3,
    n_replicas=3,
    n_claims=3,
    total_steps=8,
    arrivals_per_step=4,
    kill_replica="r1",
    kill_at_step=4,
    migrate_at_step=7,
)


@pytest.fixture(scope="module")
def fleet_runs(tmp_path_factory):
    """The plan with the plane on and off in the port, and on in the
    reference (one run each)."""
    kw = {k: v for k, v in PLAN.items() if k != "seed"}
    runs = {}
    for tag, plane in (("on", True), ("off", False)):
        runs[tag] = run_cluster_scenario(str(tmp_path_factory.mktemp(f"fleet-obs-{tag}")), PLAN["seed"],
                                         fleet_plane=plane, device="cpu", **kw)
    runs["ref"] = ref_run(str(tmp_path_factory.mktemp("fleet-obs-ref")), PLAN["seed"], fleet_plane=True, **kw)
    return runs


def hop_records(result, read=read_observations):
    recs = []
    for path in result["fleet_obs"]["obs_paths"].values():
        recs.extend(r for r in read(path) if r.get("obs") == "hop")
    return recs


# ---------------------------------------------------------------------------
# replay invisibility
# ---------------------------------------------------------------------------


def test_plane_invisible_to_fleet_fingerprint(fleet_runs):
    on, off, ref = fleet_runs["on"], fleet_runs["off"], fleet_runs["ref"]
    assert on["fleet_fingerprint"] == off["fleet_fingerprint"] == ref["fleet_fingerprint"]
    for cid, claim in on["claims"].items():
        assert claim["fingerprint"] == off["claims"][cid]["fingerprint"] == ref["claims"][cid]["fingerprint"]


def test_off_run_carries_no_plane_state(fleet_runs):
    assert fleet_runs["off"]["fleet_obs"] == {"enabled": False}


@pytest.mark.parametrize("setting,enabled", [("1", True), ("off", False), ("", False), ("yes", True)])
def test_enabled_resolves_argument_then_environment_then_decision(monkeypatch, setting, enabled):
    monkeypatch.setenv("SVOC_FLEET_PLANE", setting)
    assert fleet.resolve_fleet_plane_enabled() is enabled
    assert fleet.resolve_fleet_plane_enabled(True) is True
    assert fleet.resolve_fleet_plane_enabled(False) is False
    # The reference reads PERF_DECISIONS.json, which holds no fleet_plane key.
    assert ref_fleet.resolve_fleet_plane_enabled() is enabled
    assert fleet.FLEET_PLANE_DECISION == "off"


# ---------------------------------------------------------------------------
# hop chains
# ---------------------------------------------------------------------------


def test_hop_join_equal_on_the_same_records(fleet_runs):
    """The reference's own sidecar records through both joins; and the
    port's run gives the reference's chains, record for record."""
    ref_records = hop_records(fleet_runs["ref"], ref_read_observations)
    port_chains = hopchain.join_hop_chains(ref_records)
    assert port_chains == ref_hopchain.join_hop_chains(ref_records)
    assert hopchain.chain_stats(port_chains) == ref_hopchain.chain_stats(port_chains)
    own = hopchain.join_hop_chains(hop_records(fleet_runs["on"]))
    assert hopchain.chain_stats(own) == hopchain.chain_stats(port_chains)
    assert {c: v["records"] for c, v in own.items()} == {c: v["records"] for c, v in port_chains.items()}


def test_hop_join_gapless(fleet_runs):
    chains = hopchain.join_hop_chains(hop_records(fleet_runs["on"]))
    assert chains
    stats = hopchain.chain_stats(chains)
    assert sum(stats["by_classification"].values()) == stats["chains"]
    assert set(stats["by_classification"]) <= {"complete", "terminal", "died_mid_hop"}
    forwarded = sum(
        e["count"]
        for counters in fleet_runs["on"]["fleet_obs"]["per_source_counters"].values()
        for e in counters
        if e["name"] == "cluster_forwarded"
    )
    complete = sum(1 for c in chains.values() if c["reason"] == "forward" and c["classification"] == "complete")
    assert complete == forwarded


def test_failover_chain_joins_across_replicas(fleet_runs):
    chains = hopchain.join_hop_chains(hop_records(fleet_runs["on"]))
    failovers = [c for c in chains.values() if c["reason"] == "failover"]
    assert failovers
    for c in failovers:
        assert c["classification"] == "complete"
        assert {"send", "recv"} <= {r["data"]["side"] for r in c["records"]}
        assert c["src"] != c["dst"]


def test_mid_hop_death_classification():
    base = {"chain": "h000001", "claim": "c9", "src": "a", "dst": "b", "reason": "forward"}
    died = [{"obs": "hop", "data": {**base, "side": "send", "hop": 0}}]
    retried = died + [
        {"obs": "hop", "data": {**base, "side": "send", "hop": 1}},
        {"obs": "hop", "data": {**base, "side": "recv", "hop": 1}},
    ]
    ended = [{"obs": "hop", "data": {**base, "chain": "h2", "side": "end", "hop": 0, "outcome": "redirect"}},
             {"obs": "timeline", "data": {"chain": "h3"}}, {"obs": "hop", "data": {}}]
    for records in (died, retried, ended, died + ended):
        assert hopchain.join_hop_chains(records) == ref_hopchain.join_hop_chains(records)
    chains = hopchain.join_hop_chains(died)
    assert (chains["h000001"]["classification"], chains["h000001"]["outcome"],
            chains["h000001"]["dead_attempts"]) == ("died_mid_hop", "lost", [0])
    chains = hopchain.join_hop_chains(retried)
    assert (chains["h000001"]["classification"], chains["h000001"]["dead_attempts"]) == ("complete", [0])
    assert hopchain.join_hop_chains(ended)["h2"]["outcome"] == "redirect"
    with pytest.raises(ValueError, match="hop reason"):
        hopchain.HopContext("h", "c", "l", "a", "b", "teleport")


# ---------------------------------------------------------------------------
# aggregator merge math and the exposition
# ---------------------------------------------------------------------------


def fill_registries(m, seed):
    """Two registries with the same seeded series in either package."""
    rng = np.random.default_rng(seed)
    a, b = m.MetricsRegistry(), m.MetricsRegistry()
    grid = (0.1, 1.0)
    for reg in (a, b):
        for family in ("serving_admitted", "serving_completed", "cluster_forwarded"):
            reg.counter(family).add(int(rng.integers(0, 50)))
        reg.counter("serving_shed", labels={"reason": "queue"}).add(int(rng.integers(0, 5)))
        reg.gauge("queue_depth").set(float(rng.integers(0, 9)))
        for v in rng.uniform(0.0, 3.0, size=5):
            reg.histogram("latency", buckets=grid).observe(float(v))
            reg.timer("step").observe(float(v) / 10)
    b.histogram("other", buckets=(0.2, 2.0)).observe(0.5)
    a.histogram("other", buckets=(0.1, 1.0)).observe(0.5)
    return a, b


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_and_exposition_equal_reference(seed):
    port_agg, ref_agg = FleetAggregator(), ref_fleet.FleetAggregator()
    retired = [{"name": "serving_completed", "labels": {}, "count": 6.0},
               {"name": "cluster_unavailable", "labels": {"claim": "c0"}, "count": 2.0}]
    port_agg.retire("r9", retired)
    ref_agg.retire("r9", retired)
    pa, pb = fill_registries(metrics_mod, seed)
    ra, rb = fill_registries(ref_metrics, seed)
    port = port_agg.merge({"r0": pa, "r1": pb})
    ref = ref_agg.merge({"r0": ra, "r1": rb})
    # Timers hold float sums of the same draws: the exposition is the same text.
    assert port.render_prometheus() == ref.render_prometheus()
    assert port.counters_snapshot() == ref.counters_snapshot()
    assert port_agg.retired_keys() == ref_agg.retired_keys() == ["r9"]
    assert port.family_total("serving_completed") == pa.family_total("serving_completed") + pb.family_total(
        "serving_completed") + 6.0


def test_merge_counters_sum_and_gauges_label():
    a, b = metrics_mod.MetricsRegistry(), metrics_mod.MetricsRegistry()
    a.counter("serving_admitted").add(3)
    b.counter("serving_admitted").add(4)
    a.counter("serving_shed", labels={"reason": "queue"}).add(2)
    a.gauge("queue_depth").set(5)
    b.gauge("queue_depth").set(7)
    merged = FleetAggregator().merge({"r0": a, "r1": b})
    assert merged.family_total("serving_admitted") == 7.0
    assert merged.family_series("serving_shed") == [({"reason": "queue"}, 2.0)]
    depths = {
        tuple(sorted(lbl.items())): g.get()
        for (key, g) in merged.gauges.items()
        for (name, lbl) in [merged._labels.get(key, (key, {}))]
        if name == "queue_depth"
    }
    assert depths == {(("replica", "r0"),): 5.0, (("replica", "r1"),): 7.0}


def test_merge_histograms_bucket_wise_and_timers():
    a, b = metrics_mod.MetricsRegistry(), metrics_mod.MetricsRegistry()
    grid = (0.1, 1.0)
    for v in (0.05, 0.5):
        a.histogram("latency", buckets=grid).observe(v)
    b.histogram("latency", buckets=grid).observe(5.0)
    a.timer("step").observe(0.2)
    b.timer("step").observe(0.4)
    merged = FleetAggregator().merge({"r0": a, "r1": b})
    h = merged.histogram("latency", buckets=grid)
    assert (h.count, h._counts) == (3, [1, 1, 1])
    assert h.sum == pytest.approx(5.55)
    t = merged.timer("step")
    assert t.n == 2 and t.total_s == pytest.approx(0.6) and t.max_s == pytest.approx(0.4)


def test_merge_histogram_grid_mismatch_keeps_replica_series():
    a, b = metrics_mod.MetricsRegistry(), metrics_mod.MetricsRegistry()
    a.histogram("latency", buckets=(0.1, 1.0)).observe(0.5)
    b.histogram("latency", buckets=(0.2, 2.0)).observe(0.5)
    merged = FleetAggregator().merge({"r0": a, "r1": b})
    labeled = [
        lbl
        for key in merged.histograms
        for (name, lbl) in [merged._labels.get(key, (key, {}))]
        if name == "latency" and lbl
    ]
    assert {"replica": "r1"} in labeled


def test_retired_fold_under_retired_label():
    live = metrics_mod.MetricsRegistry()
    live.counter("serving_completed").add(10)
    agg = FleetAggregator()
    agg.retire("r1", [{"name": "serving_completed", "labels": {}, "count": 6.0}])
    merged = agg.merge({"r0": live})
    assert merged.family_total("serving_completed") == 16.0
    series = {tuple(sorted(lbl.items())): n for lbl, n in merged.family_series("serving_completed")}
    assert series[(("replica", "r1@retired"),)] == 6.0


# ---------------------------------------------------------------------------
# fleet SLOs
# ---------------------------------------------------------------------------


def test_fleet_slo_evaluations_equal_reference():
    """The same seeded growth of two replicas' counters, latencies and
    commit timers, merged and evaluated at the same virtual times."""
    def evaluate(m, s):
        rng = np.random.default_rng(7)
        a, b = m.MetricsRegistry(), m.MetricsRegistry()
        out_registry = m.MetricsRegistry()

        class Clock:
            now = 0.0

            def __call__(self):
                return self.now

        clock = Clock()

        def merged():
            out = m.MetricsRegistry()
            for reg in (a, b):
                for e in reg.counters_snapshot():
                    out.counter(e["name"], labels=e["labels"] or None).add(e["count"])
                for key, h in reg.histograms.items():
                    dst = out.histogram(s.REQUEST_LATENCY_HISTOGRAM)
                    for i, c in enumerate(h._counts):
                        dst._counts[i] += c
                    dst._count += h._count
                t = reg.timer("commit_latency")
                out.timer("commit_latency").n += t.n
            return out

        evaluator = s.SLOEvaluator(s.fleet_slos(merged, latency_target_s=0.25, fast_window_s=1.0,
                                                slow_window_s=5.0),
                                   registry=out_registry, journal=_Sink(), clock=clock)
        passes = []
        for step in range(12):
            clock.now = 0.5 * step
            for reg in (a, b):
                reg.counter("serving_admitted").add(int(rng.integers(5, 15)))
                reg.counter("serving_shed").add(int(rng.integers(0, 6 if step > 6 else 1)))
                reg.counter("serving_dropped").add(int(rng.integers(0, 2)))
                for v in rng.uniform(0.0, 0.6 if step > 6 else 0.2, size=4):
                    reg.histogram(s.REQUEST_LATENCY_HISTOGRAM).observe(float(v))
                for _ in range(int(rng.integers(1, 3))):
                    reg.timer("commit_latency").observe(0.01)
                if step > 8:
                    reg.counter("chain_commit_failures").add(1)
            passes.append(evaluator.evaluate())
        return passes, evaluator.alerting(), out_registry.render_prometheus()

    port = evaluate(metrics_mod, slo)
    ref = evaluate(ref_metrics, ref_slo)
    assert port == ref
    assert [d.name for d in slo.fleet_slos(lambda: None)] == ["commit_success", "request_latency",
                                                             "serving_admission"]
    assert any(v["alerting"] for p in port[0] for v in p.values())


class _Sink:
    def __init__(self):
        self.events = []

    def emit(self, event_type, **data):
        self.events.append((event_type, data))


# ---------------------------------------------------------------------------
# retired-replica monotonicity through the kill
# ---------------------------------------------------------------------------


def test_fleet_totals_never_step_backward(fleet_runs):
    history = fleet_runs["on"]["fleet_obs"]["accounting_history"]
    assert len(history) >= PLAN["total_steps"]
    for family in ACCOUNTING_FAMILIES:
        series = [h.get(family, 0.0) for h in history]
        assert all(cur >= prev for prev, cur in zip(series, series[1:])), (family, series)
    assert history == fleet_runs["ref"]["fleet_obs"]["accounting_history"]


def test_retired_replica_in_snapshot_and_accounting(fleet_runs):
    snap, ref = fleet_runs["on"]["fleet_obs"], fleet_runs["ref"]["fleet_obs"]
    assert snap["enabled"] is True and "r1" in snap["retired"] and "r1" not in snap["sources"]
    for acct in snap["observations"].values():
        assert acct["records"] >= 0 and acct["last_seq"] >= acct["records"] and acct["dropped"] == 0
    for key in ("step", "sources", "retired", "chains", "observations", "slo", "anomaly",
                "recent_anomalies", "bundles"):
        assert snap[key] == ref[key], key


# ---------------------------------------------------------------------------
# anomaly detector determinism
# ---------------------------------------------------------------------------

SERIES = [0, 0, 1, 0, 1, 9, 18, 28, 29, 30]


def run_detector(module, series, cfg=None):
    det = module.AnomalyDetector(cfg)
    alerts = []
    for step, totals in enumerate(series):
        alerts.extend(det.on_step(step, totals))
    return det, alerts


@pytest.mark.parametrize("seed", range(6))
def test_anomaly_alerts_equal_reference_on_seeded_series(seed):
    rng = np.random.default_rng(seed)
    keys = [("r0", "serving_shed"), ("r1", "serving_dropped"), ("router", "cluster_unavailable")]
    totals = {k: 0.0 for k in keys}
    series = []
    for step in range(40):
        burst = 20 <= step < 26 and seed % 2 == 0
        for k in keys:
            totals[k] += float(rng.poisson(12.0 if burst else 0.3))
        series.append(dict(totals))
    guard = {"serving_dropped": 6.0} if seed >= 3 else {}
    port_det, port = run_detector(anomaly, series, anomaly.AnomalyConfig(guardrails=guard))
    ref_det, ref = run_detector(ref_anomaly, series, ref_anomaly.AnomalyConfig(guardrails=guard))
    assert port == ref
    assert port_det.summary() == ref_det.summary()
    if seed % 2 == 0:
        assert any(a["sustained"] for a in port)


def test_anomaly_deterministic_and_sustained():
    series = [{("r0", "serving_shed"): t} for t in SERIES]
    _, first = run_detector(anomaly, series)
    _, second = run_detector(anomaly, series)
    assert first == second == run_detector(ref_anomaly, series)[1]
    sustained = [a for a in first if a["sustained"]]
    assert len(sustained) == 1 and sustained[0]["streak"] == anomaly.AnomalyConfig().sustain_steps
    assert max(a["streak"] for a in first) > sustained[0]["streak"]


def test_anomaly_breaches_not_absorbed():
    det = anomaly.AnomalyDetector()
    for step, total in enumerate(SERIES[:5]):
        det.on_step(step, {("r0", "serving_shed"): total})
    state = det._series[("r0", "serving_shed")]
    mean_before = state.mean
    alerts = det.on_step(5, {("r0", "serving_shed"): SERIES[5]})
    assert alerts and alerts[0]["trigger"] == "z" and state.mean == mean_before


def test_anomaly_guardrail_always_armed_and_config_checked():
    det = anomaly.AnomalyDetector(anomaly.AnomalyConfig(guardrails={"serving_shed": 4.0}))
    det.on_step(0, {("r0", "serving_shed"): 0})
    alerts = det.on_step(1, {("r0", "serving_shed"): 5})
    assert alerts and alerts[0]["trigger"] == "guardrail"
    det.drop_source("r0")
    assert det.summary()["series"] == 0
    for bad in (dict(alpha=0.0), dict(sigma_floor=0.0), dict(sustain_steps=0)):
        with pytest.raises(ValueError):
            anomaly.AnomalyConfig(**bad)


def test_anomaly_quiet_on_healthy_scenario(fleet_runs):
    snap = fleet_runs["on"]["fleet_obs"]
    assert not [a for a in snap["recent_anomalies"] if a["sustained"]]
    assert snap["bundles"] == []


# ---------------------------------------------------------------------------
# observation-channel loss accounting
# ---------------------------------------------------------------------------


def test_obs_lines_dropped_latch_and_counter(tmp_path):
    blocker = tmp_path / "not-a-dir"
    blocker.write_text("")
    metrics = metrics_mod.MetricsRegistry()
    log = ObservationLog(trace_path=str(blocker / "obs.jsonl"), metrics=metrics, owner="r9")
    log.record("probe", n=1)
    assert log.write_error_latched
    log.record("probe", n=2)
    assert log.dropped >= 2
    series = {tuple(sorted(lbl.items())): n for lbl, n in metrics.family_series("obs_lines_dropped")}
    assert series[(("replica", "r9"),)] == float(log.dropped)
    assert log.last_seq() == 2 and len(log.recent(10)) == 2


def test_fleet_accounting_carries_observations(fleet_runs):
    acct = fleet_runs["on"]["fleet_obs"]
    assert set(acct["observations"]) >= {"router", "r0", "r2"}
    assert "svoc_serving_admitted_total" in acct["exposition"]
    assert 'replica="r1@retired"' in acct["exposition"]
    assert all(os.path.exists(p) for p in acct["obs_paths"].values())
    assert fleet_runs["on"]["requests"]["observations"] == fleet_runs["ref"]["requests"]["observations"]
