"""The port's serving tier against the JAX package's, on the CPU.

Twins of the reference's cache, admission, frontend, batcher,
request-fed fabric and tier tests (``tests/test_serving_tier.py:76-541``;
the web and console ones wait for ROADMAP A12).  Each body runs once
over the reference's classes and once over the port's (``device="cpu"``)
and returns what it observed: the two must be equal, and the port's must
satisfy the reference test's assertions.

A tiny real ``call_packed`` vectorizer (TINY_TEST, seq 32, flax's
weights carried across by ``params_from_flax``) goes through both tiers:
the served vectors within 1e-5 (the bar of
``tests/test_torch_pipeline.py``), the reliable masks exact and the
essences within 1e-5.  The seeded scenario is in
``tests/test_torch_serving_scenario.py``.
"""

import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from svoc_tpu.fabric import registry as ref_registry
from svoc_tpu.fabric import scenario as ref_fabric_scenario
from svoc_tpu.fabric import session as ref_fabric_session
from svoc_tpu.serving import batcher as ref_batcher
from svoc_tpu.serving import cache as ref_cache
from svoc_tpu.serving import frontend as ref_frontend
from svoc_tpu.serving import scenario as ref_scenario
from svoc_tpu.serving import tier as ref_tier
from svoc_tpu.utils import events as ref_events
from svoc_tpu.utils import metrics as ref_metrics
from svoc_tpu.utils import slo as ref_slo

from svoc_torch.fabric import registry, scenario as fabric_scenario, session as fabric_session
from svoc_torch.serving import batcher, cache, frontend, scenario, tier
from svoc_torch.utils import events, metrics, slo


def _pkg(reg, fab_scen, fab_sess, bat, cac, front, scen, tie, ev, met, sl, **multi_kw):
    return types.SimpleNamespace(
        ClaimSpec=reg.ClaimSpec, deterministic_vectorizer=fab_scen.deterministic_vectorizer,
        MultiSession=fab_sess.MultiSession, MicroBatcher=bat.MicroBatcher,
        ResultCache=cac.ResultCache, content_key=cac.content_key,
        AdmissionConfig=front.AdmissionConfig, AdmissionController=front.AdmissionController,
        VirtualClock=scen.VirtualClock, run_serving_scenario=scen.run_serving_scenario,
        ServingTier=tie.ServingTier, EventJournal=ev.EventJournal,
        MetricsRegistry=met.MetricsRegistry, REQUEST_LATENCY_HISTOGRAM=sl.REQUEST_LATENCY_HISTOGRAM,
        serving_slos=sl.serving_slos, multi_kw=multi_kw,
    )


REF = _pkg(ref_registry, ref_fabric_scenario, ref_fabric_session, ref_batcher, ref_cache,
           ref_frontend, ref_scenario, ref_tier, ref_events, ref_metrics, ref_slo)
PORT = _pkg(registry, fabric_scenario, fabric_session, batcher, cache, frontend, scenario, tier,
            events, metrics, slo, device="cpu")


def twin(body, *args, **kwargs):
    """``body(pkg, ...)`` over both packages; returns the port's result
    after asserting it equals the reference's."""
    want = body(REF, *args, **kwargs)
    got = body(PORT, *args, **kwargs)
    assert got == want
    return got


def _multi(p, journal, registry_, claims=("alpha", "beta")):
    multi = p.MultiSession(base_seed=0, vectorizer=p.deterministic_vectorizer, journal=journal,
                           metrics=registry_, lineage_scope="t", sanitized_dispatch=True,
                           **p.multi_kw)
    for cid in claims:
        multi.add_claim(p.ClaimSpec(claim_id=cid, n_oracles=7, dimension=6))
    return multi


def _tier(p, claims=("alpha", "beta"), *, admission=None, clock=None, **kw):
    journal = p.EventJournal(p.MetricsRegistry())
    reg = p.MetricsRegistry()
    clock = clock or p.VirtualClock()
    multi = _multi(p, journal, reg, claims)
    serving = p.ServingTier(
        multi, vectorizer=kw.pop("vectorizer", p.deterministic_vectorizer), admission=admission,
        clock=clock,
        slos=p.serving_slos(reg, latency_target_s=0.25, fast_window_s=1.0, slow_window_s=5.0),
        **kw,
    )
    return serving, multi, journal, reg, clock


def _events(journal):
    return [(e.type, e.lineage, e.data) for e in journal.recent(10_000)]


# -- the result cache ----------------------------------------------------------


def test_cache_miss_then_hit_counts_and_copies():
    def body(p):
        c = p.ResultCache(4, metrics=p.MetricsRegistry())
        key = p.content_key("alpha", "hello")
        assert c.get(key) is None
        c.put(key, np.array([1.0, 2.0]))
        got = c.get(key)
        got[0] = 99.0  # a copy: the caller's change never reaches the cache
        return key, c.get(key).tolist(), c.stats()

    key, vec, stats = twin(body)
    assert vec == [1.0, 2.0] and stats["hits"] == 2 and stats["misses"] == 1
    assert stats["size"] == 1 and stats["evictions"] == 0 and len(key) == 24


def test_cache_lru_eviction_and_capacity_bound():
    def body(p):
        c = p.ResultCache(2, metrics=p.MetricsRegistry())
        ka, kb, kc = (p.content_key("c", t) for t in "abc")
        c.put(ka, np.zeros(2))
        c.put(kb, np.ones(2))
        c.get(ka)  # 'a' is now the most recent
        c.put(kc, np.full(2, 2.0))  # evicts 'b'
        churn = p.ResultCache(8, metrics=p.MetricsRegistry())
        for i in range(50):
            churn.put(p.content_key("c", f"t{i}"), np.array([float(i)]))
        return [k in c for k in (ka, kb, kc)], len(c), c.stats(), len(churn), churn.stats()

    present, size, stats, churn_size, churn_stats = twin(body)
    assert present == [True, False, True] and size == 2 and stats["evictions"] == 1
    assert churn_size == 8 and churn_stats["evictions"] == 42


def test_cache_keys_partition_by_claim_and_bad_capacity():
    assert cache.content_key("alpha", "same") != cache.content_key("beta", "same")
    assert cache.content_key("alpha", "same") == ref_cache.content_key("alpha", "same")
    assert cache.text_digest("ü text") == ref_cache.text_digest("ü text")
    for p in (REF, PORT):
        with pytest.raises(ValueError):
            p.ResultCache(0)


# -- the admission controller ------------------------------------------------------


def test_admission_queue_bound_and_burn_flip():
    def body(p):
        reg = p.MetricsRegistry()
        bound = p.AdmissionController(p.AdmissionConfig(queue_capacity=2), metrics=reg)
        out = [(d.action, d.reason) for d in (bound.decide("alpha", q, q + 1) for q in range(3))]
        ctrl = p.AdmissionController(p.AdmissionConfig(burn_threshold=4.0, shed_fraction=1.0),
                                     metrics=reg)
        gauge = reg.gauge("slo_burn_rate", labels={"slo": "request_latency", "window": "fast"})
        for burn in (0.0, 10.0, 1.0):
            gauge.set(burn)
            d = ctrl.decide("alpha", 0, len(out))
            out.append((d.action, d.reason))
        return out

    assert twin(body) == [("admit", ""), ("admit", ""), ("shed", "queue_full"),
                          ("admit", ""), ("shed", "slo_burn"), ("admit", "")]


def test_admission_fractional_shed_draw_is_seeded():
    def body(p):
        reg = p.MetricsRegistry()
        cfg = p.AdmissionConfig(burn_threshold=4.0, shed_fraction=0.5, seed=7)
        reg.gauge("slo_burn_rate", labels={"slo": "request_latency", "window": "fast"}).set(10.0)
        a, b = p.AdmissionController(cfg, metrics=reg), p.AdmissionController(cfg, metrics=reg)
        return [a.decide("alpha", 0, s).action for s in range(40)], \
            [b.decide("alpha", 0, s).action for s in range(40)]

    seq_a, seq_b = twin(body)
    assert seq_a == seq_b and {"admit", "shed"} == set(seq_a)


def test_admission_rejects_bad_config():
    for p in (REF, PORT):
        for kw in (dict(queue_capacity=0), dict(shed_fraction=1.5), dict(burn_threshold=0.0)):
            with pytest.raises(ValueError):
                p.AdmissionConfig(**kw)


# -- the frontend --------------------------------------------------------------------


def test_frontend_submit_admits_with_claim_lineage():
    def body(p):
        serving, _multi, journal, reg, _ = _tier(p)
        response = serving.submit("alpha", "first comment")
        with pytest.raises(KeyError):
            serving.submit("nope", "text")
        return response, serving.frontend.depth("alpha"), _events(journal), \
            reg.counter("serving_admitted", labels={"claim": "alpha"}).count

    response, depth, evs, admitted = twin(body)
    assert response["status"] == "admitted" and response["lineage"].startswith("blkt-alpha-rq")
    assert depth == 1 and admitted == 1
    assert [e for e in evs if e[0] == "serving.admitted"][0][1] == response["lineage"]


def test_frontend_cached_repeat_answers_immediately():
    def body(p):
        serving, _multi, journal, reg, _ = _tier(p)
        serving.submit("alpha", "viral take")
        serving.step()
        response = serving.submit("alpha", "viral take")
        return response, serving.frontend.depth("alpha"), \
            reg.counter("serving_cache", labels={"event": "hit"}).count, journal.fingerprint()

    response, depth, hits, _ = twin(body)
    assert response["status"] == "cached" and len(response["vector"]) == 6
    assert depth == 0 and hits == 1


def test_frontend_overflow_sheds_on_its_own_lineage():
    def body(p):
        serving, _multi, journal, reg, _ = _tier(p, admission=p.AdmissionConfig(queue_capacity=2))
        responses = [serving.submit("alpha", f"flood {i}") for i in range(5)]
        responses.append(serving.submit("beta", "calm"))
        report = serving.step()
        return responses, sorted(report["served"]), reg.family_total("serving_shed"), \
            reg.family_total("serving_completed"), _events(journal)

    responses, served, shed, completed, evs = twin(body)
    assert [r["status"] for r in responses] == ["admitted"] * 2 + ["shed"] * 3 + ["admitted"]
    assert served == ["alpha", "beta"] and shed == 3 and completed == 3
    assert all(e[1].startswith("blkt-alpha-rq") for e in evs if e[0] == "serving.shed")


def test_frontend_drain_fifo_state_dict_and_restore():
    def body(p):
        serving, *_ = _tier(p)
        for i in range(3):
            serving.submit("alpha", f"c{i}")
        serving.submit("beta", "b0")
        got = [r.text for r in serving.frontend.drain("alpha", 2)]
        state = serving.serving_state_dict()
        other, *_ = _tier(p)
        n = other.restore_serving_state(state)
        after = other.submit("alpha", "next")
        return got, serving.frontend.depth("alpha"), state, n, other.frontend.depths(), after

    got, depth, state, n, depths, after = twin(body)
    assert got == ["c0", "c1"] and depth == 1 and n == 2
    assert state["seqs"] == {"alpha": 3, "beta": 1} and depths == {"alpha": 2, "beta": 1}
    assert after["lineage"].endswith("rq000004")  # the seq cursor survived


def test_frontend_drain_latch_sheds_misses():
    def body(p):
        serving, *_ = _tier(p)
        serving.submit("alpha", "kept")
        serving.submit("beta", "paused one")
        serving.multi.pause("beta")
        accounting = serving.drain()
        return accounting, serving.submit("alpha", "late")["status"], serving.frontend.draining

    accounting, late, draining = twin(body)
    assert accounting == {"flush_steps": 1, "deferred": 1, "queues_empty": True}
    assert late == "shed" and draining


# -- the micro-batcher ---------------------------------------------------------------


def test_batcher_round_robin_is_fair():
    def body(p):
        serving, *_ = _tier(p, max_requests_per_step=4)
        for i in range(6):
            serving.submit("alpha", f"a{i}")
        serving.submit("beta", "b0")
        serving.submit("beta", "b1")
        return [r.claim for r in serving.batcher.assemble()], serving.frontend.depth("alpha")

    assert twin(body) == (["alpha", "beta", "alpha", "beta"], 4)


def test_batcher_group_by_claim_requires_vectors():
    for p in (REF, PORT):
        serving, *_ = _tier(p)
        serving.submit("alpha", "x")
        (request,) = serving.batcher.assemble()
        with pytest.raises(ValueError, match="no vector"):
            p.MicroBatcher.group_by_claim([request])


def test_batcher_dedups_in_batch_duplicates():
    def body(p):
        calls = []

        def counting(texts):
            calls.append(list(texts))
            return np.stack([p.deterministic_vectorizer([t])[0] for t in texts])

        serving, *_ = _tier(p, vectorizer=counting)
        texts = ["viral take", "fresh a", "viral take", "fresh b", "viral take"]
        out = serving.batcher.vectorize(texts)
        for t in texts[:3]:
            serving.submit("alpha", t)
        by_digest = serving.batcher.vectorize_requests(serving.batcher.assemble())
        return calls, out.tolist(), by_digest.tolist()

    calls, out, by_digest = twin(body)
    assert calls[0] == ["viral take", "fresh a", "fresh b"] and calls[1] == ["viral take", "fresh a"]
    assert out[0] == out[2] == out[4] and by_digest[0] == by_digest[2]


def test_batcher_removed_claim_queue_is_purged_and_dropped():
    def body(p):
        serving, multi, _journal, reg, _ = _tier(p)
        for i in range(3):
            serving.submit("beta", f"b{i}")
        serving.submit("alpha", "a0")
        multi.remove_claim("beta")
        report = serving.step()
        return report["dropped"], report["served"], \
            reg.counter("serving_dropped", labels={"claim": "beta"}).count, \
            "beta" in serving.frontend.depths()

    assert twin(body) == (3, ["alpha"], 3, False)


# -- the request-fed fabric ------------------------------------------------------------


def _feeds(seed=0):
    rng = np.random.default_rng(seed)
    return {"alpha": rng.uniform(0.1, 0.9, (3, 6)).astype(np.float32),
            "beta": rng.uniform(0.1, 0.9, (2, 6)).astype(np.float32)}


def test_fabric_batched_step_equals_claim_at_a_time():
    def body(p):
        feeds = _feeds()
        a = _multi(p, p.EventJournal(p.MetricsRegistry()), p.MetricsRegistry())
        report = a.step(feeds=feeds)
        b = _multi(p, p.EventJournal(p.MetricsRegistry()), p.MetricsRegistry())
        b.step(feeds={"alpha": feeds["alpha"]})
        b.step(feeds={"beta": feeds["beta"]})
        return sorted(report["served"]), {cid: (a.get(cid).last_consensus, b.get(cid).last_consensus)
                                          for cid in ("alpha", "beta")}

    served, pairs = twin(body)
    assert served == ["alpha", "beta"]
    for batched, looped in pairs.values():
        for field in ("essence", "reliable", "interval_valid", "reliability_second_pass"):
            assert batched[field] == looped[field]


def test_fabric_request_fed_cold_start_and_isolation():
    def body(p):
        journal, reg = p.EventJournal(p.MetricsRegistry()), p.MetricsRegistry()
        multi = _multi(p, journal, reg, claims=("alpha",))
        rng = np.random.default_rng(7)
        first = multi.step(feeds={"alpha": rng.uniform(0.1, 0.9, (1, 6)).astype(np.float32)})
        deferred = multi.get("alpha").last_commit
        multi.step(feeds={"alpha": rng.uniform(0.1, 0.9, (3, 6)).astype(np.float32)})
        committed = multi.get("alpha").last_commit.get("complete")
        other = _multi(p, p.EventJournal(p.MetricsRegistry()), reg)
        feeds = _feeds()
        feeds["alpha"] = np.zeros((2, 3), dtype=np.float32)  # the wrong dimension
        bad = other.step(feeds=feeds)
        feeds["alpha"] = np.zeros((0, 6), dtype=np.float32)
        empty = other.step(feeds=feeds)
        other.pause("beta")
        ghost = other.step(feeds={"ghost": feeds["beta"], "beta": feeds["beta"]})
        return first["served"], deferred, committed, bad["served"], bad["skipped"], \
            empty["skipped"], ghost["skipped"], \
            reg.counter("claim_commit_deferred", labels={"claim": "alpha"}).count, \
            reg.counter("fabric_claim_errors", labels={"claim": "alpha", "stage": "fetch"}).count, \
            journal.fingerprint()

    out = twin(body)
    assert out[0] == ["alpha"] and out[1] == {"deferred": True} and out[2] is True
    assert out[3] == ["beta"] and out[4]["alpha"].startswith("fetch_error:")
    assert out[5] == {"alpha": "empty_store"}
    assert out[6] == {"ghost": "unknown_claim", "beta": "paused"}
    assert out[7] == 1 and out[8] == 1


# -- the tier end to end ----------------------------------------------------------------


def test_tier_step_completes_requests_and_observes_latency():
    def body(p):
        serving, _multi, journal, reg, clock = _tier(p)
        serving.submit("alpha", "one")
        serving.submit("beta", "two")
        clock.advance(0.05)
        report = serving.step()
        snap = serving.snapshot()
        return report, reg.histogram(p.REQUEST_LATENCY_HISTOGRAM).snapshot()["count"], \
            reg.family_total("serving_completed"), serving.cache.stats()["size"], \
            [e for e in _events(journal) if e[0] == "serving.step"], \
            {k: snap[k] for k in ("steps", "submitted", "completed", "queues", "cache", "latency")}, \
            snap["costs"]["enabled"], snap["costs"]["ledger"]["keys"], journal.fingerprint()

    report, count, completed, size, steps, snap, plane_on, keys, _ = twin(body)
    assert report["requests"] == 2 and sorted(report["served"]) == ["alpha", "beta"]
    assert report["latencies_s"] == [0.05, 0.05] and count == 2 and completed == 2 and size == 2
    assert len(steps) == 1 and steps[0][2]["requests"] == 2
    assert snap["steps"] == 1 and "p99" in snap["latency"]
    assert plane_on and keys == 1  # the committed decision: the plane is on


def test_tier_skipped_claim_and_poison_text_drop():
    def body(p):
        serving, multi, _journal, reg, clock = _tier(p)
        serving.submit("alpha", "one")
        serving.submit("beta", "two")
        multi.pause("beta")
        clock.advance(0.05)
        skipped = serving.step()

        def poisoned(texts):
            if any(t == "poison" for t in texts):
                raise RuntimeError("tokenizer exploded")
            return p.deterministic_vectorizer(texts)

        other, _m, _j, reg2, clock2 = _tier(p, vectorizer=poisoned)
        other.submit("alpha", "a perfectly fine comment")
        other.submit("beta", "poison")
        clock2.advance(0.05)
        poison = other.step()
        return skipped, reg.counter("serving_dropped", labels={"claim": "beta"}).count, \
            serving.snapshot()["dropped"], poison, reg2.counter("serving_vectorize_errors").count, \
            reg2.family_total("serving_completed")

    skipped, dropped, snap_dropped, poison, errors, completed = twin(body)
    assert skipped["served"] == ["alpha"] and skipped["skipped"] == {"beta": "paused"}
    assert skipped["dropped"] == 1 and skipped["latencies_s"] == [0.05]
    assert dropped == 1 and snap_dropped == 1
    assert poison["requests"] == 2 and poison["dropped"] == 1 and poison["served"] == ["alpha"]
    assert errors == 1 and completed == 1


def test_tier_idle_step_evaluates_and_hooks_run():
    def body(p):
        serving, *_ = _tier(p)
        seen = []
        serving.post_step_hooks.append(lambda report: seen.append(report["step"]))
        serving.post_step_hooks.append(lambda report: 1 / 0)
        report = serving.step()
        return report["requests"], serving.frontend.controller.burn_rate(), seen, \
            serving.multi.metrics.counter("serving_hook_errors").count

    assert twin(body) == (0, 0.0, [1], 1)


def test_tier_run_loop_serves_and_stops():
    serving, *_ = _tier(PORT)
    serving.submit("alpha", "looped")
    stop = serving.run_loop(period_s=0.01)
    assert serving.run_loop() is stop  # a live loop is reused
    for _ in range(500):
        if serving.snapshot()["completed"] == 1:
            break
        stop.wait(0.01)
    serving.stop_loop()
    serving._loop_thread.join(timeout=5)
    assert serving.snapshot()["completed"] == 1 and not serving._loop_thread.is_alive()
    console = types.SimpleNamespace()
    serving.attach(console)  # the console's ``serving`` command and /api/submit read it
    assert console.serving is serving


# -- a real packed vectorizer through both tiers -------------------------------------------


def test_tiny_call_packed_vectorizer_through_both_tiers():
    from svoc_tpu.models import configs as jax_configs
    from svoc_tpu.models.encoder import SentimentEncoder as JaxEncoder
    from svoc_tpu.models.encoder import init_params as jax_init_params
    from svoc_tpu.models.sentiment import SentimentPipeline as JaxPipeline

    from svoc_torch.models.configs import TINY_TEST
    from svoc_torch.models.from_jax import params_from_flax
    from svoc_torch.models.sentiment import SentimentPipeline

    flax_params = jax_init_params(JaxEncoder(jax_configs.TINY_TEST), seed=5)
    pipes = {
        "ref": JaxPipeline(cfg=jax_configs.TINY_TEST, seq_len=32, batch_size=4,
                           tokenizer_name=None, params=flax_params),
        "port": SentimentPipeline(TINY_TEST, seq_len=32, batch_size=4,
                                  params=params_from_flax(flax_params), device="cpu"),
    }
    texts = ["short", "a somewhat longer comment with more tokens in it", "medium length remark",
             "another take entirely", "yet more words to pack", "final thought", "short"]
    runs = {}
    for name, p in (("ref", REF), ("port", PORT)):
        serving, multi, *_ = _tier(p, ("alpha", "beta", "gamma"), vectorizer=pipes[name])
        for i, text in enumerate(texts):
            serving.submit(("alpha", "beta", "gamma")[i % 3], text)
        report = serving.step()
        vectors = np.stack([serving.cache.get(p.content_key(("alpha", "beta", "gamma")[i % 3], t))
                            for i, t in enumerate(texts)])
        runs[name] = (report, vectors, {c: multi.get(c).last_consensus for c in ("alpha", "beta", "gamma")})
    (ref_report, ref_vecs, ref_cons), (report, vecs, cons) = runs["ref"], runs["port"]
    assert report["requests"] == ref_report["requests"] == 7
    assert report["served"] == ref_report["served"] == ["alpha", "beta", "gamma"]
    np.testing.assert_allclose(vecs, ref_vecs, atol=1e-5)
    np.testing.assert_allclose(vecs.sum(axis=1), 1.0, atol=1e-6)
    # The packed cross-claim forward equals a per-request loop through the model.
    np.testing.assert_allclose(vecs, np.stack([pipes["port"]([t])[0] for t in texts]), atol=1e-5)
    for cid in cons:
        assert cons[cid]["reliable"] == ref_cons[cid]["reliable"]
        np.testing.assert_allclose(cons[cid]["essence"], ref_cons[cid]["essence"], atol=1e-5)
