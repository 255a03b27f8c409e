"""The port's web UI against the JAX package's, on port 0 of the loopback, on the CPU.

Twins of ``tests/test_web.py``'s properties, with one server of each
package over the same seeded session (the deterministic
``fake_sentiment_vectorizer``):

- ``GET /`` serves the reference's page byte for byte;
- ``POST /api/query`` runs commands; ``GET /api/state`` equals the
  reference's payload after the same commands, with a fabric, a serving
  tier and a durability manager attached (but for the pinned route,
  ``consensus_impl`` of the fabric and the tier, the port's ``device``, and the preview's
  float32 statistics, held at 1e-6 as ``tests/test_torch_session.py``
  holds them);
- ``/api/events`` pushes state versions and journal frames, and is
  capped at ``MAX_SSE_STREAMS`` (503 with Retry-After);
- ``/api/profile``, ``/api/audit/<lineage>``, ``/metrics`` and
  ``/metrics/fleet`` answer with the reference's codes;
- ``POST /api/submit`` answers 200, 429, 404, 400 and 503 as the
  reference's does;
- the CSRF (Origin) and DNS-rebinding (Host) guards answer 403, and a
  non-loopback bind warns.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

pytest.importorskip("jax")

from conftest import fake_sentiment_vectorizer

from svoc_tpu.apps import web as ref_web
from svoc_tpu.apps.commands import CommandConsole as RefConsole
from svoc_tpu.apps.session import Session as RefSession
from svoc_tpu.apps.session import SessionConfig as RefConfig
from svoc_tpu.io.comment_store import CommentStore as RefStore
from svoc_tpu.io.scraper import SyntheticSource as RefSource

from svoc_torch.apps import web
from svoc_torch.apps.commands import CommandConsole
from svoc_torch.apps.session import Session, SessionConfig
from svoc_torch.io.comment_store import CommentStore
from svoc_torch.io.scraper import SyntheticSource


def _console(ref=False):
    if ref:
        store = RefStore()
        store.save(RefSource(batch=200)())
        return RefConsole(RefSession(RefConfig(lineage_scope="w"), store=store,
                                     vectorizer=fake_sentiment_vectorizer))
    store = CommentStore()
    store.save(SyntheticSource(batch=200)())
    return CommandConsole(Session(SessionConfig(lineage_scope="w"), store=store,
                                  vectorizer=fake_sentiment_vectorizer, device="cpu"))


def _serve(console, module=web):
    srv, _thread = module.serve(console, port=0, block=False)
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture()
def server():
    console = _console()
    srv, base = _serve(console)
    yield base, console
    srv.shutdown()


def post(base, text, path="/api/query", headers=None):
    req = urllib.request.Request(f"{base}{path}", data=text.encode(), method="POST", headers=headers or {})
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.status, json.loads(r.read())


def get(base, path):
    with urllib.request.urlopen(f"{base}{path}", timeout=10) as r:
        return r.read()


def code_of(fn, *args, **kwargs):
    try:
        fn(*args, **kwargs)
    except urllib.error.HTTPError as e:
        return e.code
    return 200


def test_page_is_the_references(server):
    base, _ = server
    page = get(base, "/").decode()
    assert page == ref_web._PAGE and web._PAGE == ref_web._PAGE
    assert "EventSource('/api/events?journal=1')" in page and "drawScatter" in page


def test_query_and_state_equal_the_reference(tmp_path):
    from svoc_tpu.durability.recovery import RecoveryManager as RefRecovery
    from svoc_tpu.fabric.registry import ClaimSpec as RefSpec
    from svoc_tpu.fabric.session import MultiSession as RefMulti
    from svoc_tpu.serving.tier import ServingTier as RefTier

    from svoc_torch.durability.recovery import RecoveryManager
    from svoc_torch.fabric.registry import ClaimSpec
    from svoc_torch.fabric.session import MultiSession
    from svoc_torch.serving.tier import ServingTier

    states = []
    for ref in (False, True):
        console = _console(ref)
        Multi, Spec, Tier, Recovery = (RefMulti, RefSpec, RefTier, RefRecovery) if ref else (
            MultiSession, ClaimSpec, ServingTier, RecoveryManager)
        kw = {} if ref else {"device": "cpu"}
        multi = Multi(base_seed=1, vectorizer=fake_sentiment_vectorizer, lineage_scope="web", **kw)
        multi.add_claim(Spec(claim_id="alpha", n_oracles=7))
        multi.attach(console)
        tier = Tier(multi, vectorizer=fake_sentiment_vectorizer)
        tier.attach(console)
        out = tmp_path / ("ref" if ref else "port")
        out.mkdir()
        Recovery(multi, out_dir=str(out), tier=tier).attach(console)
        srv, base = _serve(console, ref_web if ref else web)
        try:
            assert json.loads(get(base, "/api/state"))["preview"] is None
            assert post(base, "dimension") == (200, ["Dimension: 6"])
            for command in ("fetch", "commit", "resume", "update_proposition 0 3 0xbeef",
                            "vote_for_a_proposition 1 0 yes", "resume"):
                post(base, command)
            state = json.loads(get(base, "/api/state"))
        finally:
            srv.shutdown()
        state["durability"] = {k: v for k, v in state["durability"].items()
                               if k not in ("snapshot_path", "compile_cache_dir", "compile_cache",
                                            "wal_path", "compilation_cache")}
        for section in ("fabric", "serving"):
            state[section].pop("consensus_impl")
            state[section].pop("device", None)
        states.append(state)
    ours, theirs = states
    assert ours["consensus_active"] is True and ours["oracle_list"][3] == "0xbeef"
    assert len(ours["preview"]["values"]) == 7 and ours["rel2_history"]
    assert ours.keys() == theirs.keys()
    # The preview's float32 statistics, at the session tests' 1e-6
    # (tests/test_torch_session.py); everything else exactly.
    for key in ("values", "mean", "median", "normalized_ranks"):
        np.testing.assert_allclose(ours["preview"][key], theirs["preview"][key], atol=1e-6, rtol=0)
    for key in ours:
        if key != "preview":
            assert ours[key] == theirs[key], key


def test_unknown_paths_and_audit(server):
    base, console = server
    assert code_of(get, base, "/nope") == 404
    assert code_of(post, base, "dimension", path="/api/nope") == 404
    assert code_of(get, base, "/api/audit/blkX-none-1") == 404
    post(base, "fetch")
    lineage = console.session.last_lineage
    record = json.loads(get(base, f"/api/audit/{lineage}"))
    assert record["found"] and record["lineage"] == lineage


def test_guards_reject_cross_origin_and_rebound_hosts(server):
    base, _ = server
    port = base.rsplit(":", 1)[1]
    assert code_of(post, base, "dimension", headers={"Origin": "http://evil.example"}) == 403
    host = base.split("://", 1)[1]
    assert post(base, "dimension", headers={"Origin": f"http://{host}"}) == (200, ["Dimension: 6"])
    assert code_of(post, base, "dimension", headers={"Origin": f"http://evil.example:{port}",
                                                     "Host": f"evil.example:{port}"}) == 403


def test_non_loopback_bind_warns():
    with pytest.warns(UserWarning, match="non-loopback"):
        srv, _ = web.serve(_console(), host="0.0.0.0", port=0, block=False)
    srv.shutdown()


def test_events_push_versions_and_journal_frames(server):
    base, console = server
    with urllib.request.urlopen(f"{base}/api/events?journal=1", timeout=10) as r:
        assert r.headers["Content-Type"].startswith("text/event-stream")

        def next_frame(kind):
            event = None
            while True:
                line = r.readline().decode()
                if line.startswith("event: "):
                    event = line[7:].strip()
                elif line.startswith("data: "):
                    if (event or "message") == kind:
                        return json.loads(line[6:])
                    event = None

        v0 = next_frame("message")["state_version"]
        console.session.fetch()
        assert next_frame("message")["state_version"] == v0 + 1
        assert next_frame("journal")["event"]


def test_sse_streams_capped(server):
    base, console = server
    streams = []
    try:
        for _ in range(web._Handler.MAX_SSE_STREAMS):
            streams.append(urllib.request.urlopen(f"{base}/api/events", timeout=10))
        with pytest.raises(urllib.error.HTTPError) as exc_info:
            urllib.request.urlopen(f"{base}/api/events", timeout=10)
        assert exc_info.value.code == 503 and exc_info.value.headers["Retry-After"]
        assert json.loads(get(base, "/api/state"))["state_version"] == 0
    finally:
        for s in streams:
            s.close()
    deadline = time.time() + 15
    while time.time() < deadline:
        console.session.bump_state()
        try:
            with urllib.request.urlopen(f"{base}/api/events", timeout=10) as r:
                assert r.status == 200
            break
        except urllib.error.HTTPError:
            time.sleep(0.3)
    else:
        pytest.fail("SSE slot never freed after client disconnect")


def test_metrics_profile_and_fleet_routes(server, tmp_path):
    from svoc_torch.obsplane.profiler import ProfileCapture

    base, console = server
    post(base, "fetch")
    text = get(base, "/metrics").decode()
    assert "# TYPE" in text and "fetch" in text
    assert code_of(get, base, "/metrics/fleet") == 404
    assert code_of(get, base, "/api/profile") == 503
    ProfileCapture(str(tmp_path / "prof")).attach(console)
    status = json.loads(get(base, "/api/profile"))
    assert "active" in status and "captures" in status
    assert code_of(get, base, "/api/profile?action=bogus") == 400
    assert code_of(get, base, "/api/profile?action=start&duration_s=x") == 400


def test_submit_codes(tmp_path):
    from svoc_torch.fabric.registry import ClaimSpec
    from svoc_torch.fabric.session import MultiSession
    from svoc_torch.serving.frontend import AdmissionConfig
    from svoc_torch.serving.tier import ServingTier

    console = _console()
    srv, base = _serve(console)
    try:
        body = json.dumps({"claim": "alpha", "text": "hello"})
        assert code_of(post, base, body, path="/api/submit") == 503
        multi = MultiSession(base_seed=1, vectorizer=fake_sentiment_vectorizer, device="cpu")
        multi.add_claim(ClaimSpec(claim_id="alpha", n_oracles=7))
        ServingTier(multi, vectorizer=fake_sentiment_vectorizer,
                    admission=AdmissionConfig(queue_capacity=1)).attach(console)
        status, response = post(base, body, path="/api/submit")
        assert status == 200 and response["status"] == "admitted"
        shed = json.dumps({"claim": "alpha", "text": "another"})
        assert code_of(post, base, shed, path="/api/submit") == 429
        assert code_of(post, base, json.dumps({"claim": "nobody", "text": "x"}), path="/api/submit") == 404
        assert code_of(post, base, "not json", path="/api/submit") == 400
        assert code_of(post, base, json.dumps({"claim": 1, "text": "x"}), path="/api/submit") == 400
    finally:
        srv.shutdown()
