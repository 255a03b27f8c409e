"""The port's durable scenario and the session's open-cycle reconcile
against the JAX package's, on the CPU.

- ``run_durable_scenario`` fresh (4 steps, per-tx and batched), and
  restarted in-process (3 steps, then 6 in the same directory): the
  per-claim and journal fingerprints, the chain logs and the WAL equal
  the reference's, byte for byte, and the durability contract holds
  (zero duplicate txs, zero open cycles, every admitted request
  accounted for).
- ``Session.commit_resilient`` on a lineage whose WAL cycle is open
  reconciles it exactly as the reference does (resending only the
  stranded slots, then deduping as a replayed lineage), and refuses
  exactly as the reference does when the chain witness is unreachable.
- Without a card the entry points raise: ``run_durable_scenario()``,
  a ``MultiSession`` (so a ``RecoveryManager`` over one) and the crash
  smoke without ``--device cpu``; nothing falls back to the CPU.
"""

import types

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import svoc_tpu.apps.session as ref_session
import svoc_tpu.durability.scenario as ref_scenario
import svoc_tpu.durability.wal as ref_wal
import svoc_tpu.io.chain as ref_chain
import svoc_tpu.io.comment_store as ref_store
import svoc_tpu.ops.fixedpoint as ref_fixedpoint
import svoc_tpu.utils.events as ref_events
from svoc_tpu.fabric.scenario import deterministic_vectorizer

import svoc_torch.apps.session as session_mod
import svoc_torch.durability.scenario as scenario
import svoc_torch.durability.wal as wal_mod
import svoc_torch.io.chain as chain
import svoc_torch.io.comment_store as store
import svoc_torch.ops.fixedpoint as fixedpoint
import svoc_torch.utils.events as events
from svoc_torch.io.scraper import SyntheticSource

REF = types.SimpleNamespace(session=ref_session, scenario=ref_scenario, wal=ref_wal,
                            chain=ref_chain, store=ref_store, fixedpoint=ref_fixedpoint,
                            events=ref_events, kw={})
PORT = types.SimpleNamespace(session=session_mod, scenario=scenario, wal=wal_mod,
                             chain=chain, store=store, fixedpoint=fixedpoint,
                             events=events, kw={"device": "cpu"})
CLAIMS = ("alpha", "beta")
ARTIFACTS = ("wal.jsonl", "chain-", "fired.jsonl")


@pytest.fixture(autouse=True)
def _fresh_bundle_numbers(monkeypatch):
    """The drain's postmortem bundle is numbered by a process-wide counter
    and its path is journaled, so the whole-journal fingerprint depends on
    how many bundles this process built before: both packages' counters
    start afresh for each test."""
    import svoc_tpu.utils.postmortem as ref_postmortem
    import svoc_torch.utils.postmortem as postmortem

    for mod in (ref_postmortem, postmortem):
        monkeypatch.setattr(mod, "_bundle_counter", iter(range(1, 10**9)))


def _summary(r):
    """What a replay must reproduce (paths and wall-clock fields left out)."""
    rec = r["recovery"] or {}
    return {
        "claims": r["claims"], "journal": r["journal_fingerprint"],
        "events": r["journal_events"], "steps": r["steps"], "chain": r["chain"],
        "requests": r["requests"], "open": r["wal_open_cycles"],
        "dups": r["duplicate_txs"], "fired": r["fault_points_fired"],
        "commit_mode": r["commit_mode"], "recovered": r["recovered"],
        "reconcile": rec.get("reconcile"),
        "restored": {k: rec.get(k) for k in ("journal_events", "tail_events",
                                             "restored_clock", "membership",
                                             "requeued", "lost_requests")},
        "drain": {k: v for k, v in r["drain"].items() if k not in ("snapshot", "bundle")},
    }


def _scenario_both(tmp_path, **kw):
    """One phase of each package's scenario.  Both run in the same
    directory path (their artifacts are moved aside between runs): the
    postmortem bundle's path is journaled, so the whole-journal
    fingerprint depends on it."""
    out = []
    work = tmp_path / "w"
    for name, p in (("ref", REF), ("port", PORT)):
        if (tmp_path / name).exists():
            (tmp_path / name).rename(work)
        out.append(p.scenario.run_durable_scenario(str(work), seed=0, **kw, **p.kw))
        work.rename(tmp_path / name)
    return out


def _same_artifacts(tmp_path):
    """The WAL (active and archived), the chain logs and the fired log:
    the same files, byte for byte (the trace and the snapshot carry
    wall-clock stamps)."""
    names = {f.name for f in (tmp_path / "ref").iterdir() if f.name.startswith(ARTIFACTS)}
    assert names == {f.name for f in (tmp_path / "port").iterdir()
                     if f.name.startswith(ARTIFACTS)}
    assert {"chain-alpha.jsonl", "chain-beta.jsonl", "fired.jsonl"} <= names
    for name in names:
        assert (tmp_path / "ref" / name).read_bytes() == (tmp_path / "port" / name).read_bytes(), name


@pytest.mark.parametrize("commit_mode", ["per_tx", "batched"])
def test_fresh_run_equals_reference(tmp_path, commit_mode):
    ref, port = _scenario_both(tmp_path, total_steps=4, commit_mode=commit_mode)
    assert _summary(port) == _summary(ref)
    _same_artifacts(tmp_path)
    assert port["duplicate_txs"] == 0 and not port["wal_open_cycles"]
    assert port["requests"]["unaccounted"] == 0 and not port["recovered"]
    assert all(port["claims"][c]["cycles"] == 4 for c in CLAIMS)


def test_restart_recovers_and_continues_as_reference(tmp_path):
    first = _scenario_both(tmp_path, total_steps=3)
    assert _summary(first[1]) == _summary(first[0]) and first[1]["steps"] == 3
    ref, port = _scenario_both(tmp_path, total_steps=6)
    assert _summary(port) == _summary(ref)
    _same_artifacts(tmp_path)
    assert port["recovered"] and port["steps"] == 6
    assert port["duplicate_txs"] == 0 and port["requests"]["unaccounted"] == 0
    assert port["recovery"]["restored_clock"] == pytest.approx(0.3)


def test_crash_tables_equal_reference():
    assert scenario.DEFAULT_CRASH_AT == ref_scenario.DEFAULT_CRASH_AT
    assert scenario.CRASH_COMMIT_MODE == ref_scenario.CRASH_COMMIT_MODE
    assert scenario.CRASH_POINTS == ref_scenario.CRASH_POINTS
    for point, make in scenario.CRASH_EVENTS.items():
        assert make(3).as_dict() == ref_scenario.CRASH_EVENTS[point](3).as_dict()
    with pytest.raises(ValueError, match="unknown crash_point"):
        scenario.run_durable_scenario("unused", crash_point="nowhere", device="cpu")


# ---------------------------------------------------------------------------
# The session's open-cycle guard
# ---------------------------------------------------------------------------


def _session(p, tmp_path):
    s = p.store.CommentStore()
    s.save(SyntheticSource(batch=120, seed=5)())
    sess = p.session.Session(
        p.session.SessionConfig(seed=5, lineage_scope="t", commit_mode="per_tx"),
        store=s, vectorizer=deterministic_vectorizer, journal=p.events.EventJournal(), **p.kw)
    w = p.wal.CommitIntentWAL(str(tmp_path / "wal.jsonl"))
    sess.attach_wal(w)
    return sess, w


def _open_cycle(p, sess, w):
    """What a kill mid-commit leaves: the block's cycle open, slots 0 and 1
    on chain, only slot 0 with its landed record."""
    lineage = sess.last_lineage
    payloads = [p.fixedpoint.encode_vector(row) for row in np.asarray(sess.predictions)]
    oracles = sess.adapter.call_oracle_list()
    cyc = w.cycle(lineage, oracles=oracles, payloads=payloads)
    cyc.new_attempt(0)
    for slot in (0, 1):
        cyc.intent(slot, oracles[slot], payloads[slot])
        sess.adapter._invoke_prediction_felts(oracles[slot], payloads[slot])
    cyc.landed(0)
    return lineage


def test_commit_resilient_reconciles_an_open_cycle(tmp_path):
    out = []
    for name, p in (("ref", REF), ("port", PORT)):
        (tmp_path / name).mkdir()
        sess, w = _session(p, tmp_path / name)
        sess.fetch()
        sess.commit_resilient()
        sess.fetch()
        lineage = _open_cycle(p, sess, w)
        outcome = sess.commit_resilient()
        c = sess.adapter.backend.contract
        out.append((outcome.sent, outcome.attempts, w.records(), sess.journal.fingerprint(),
                    [(e.type, e.data) for e in sess.journal.recent(30)],
                    [list(o.value) for o in c.oracles], c.consensus_active,
                    lineage in w.completed_lineages()))
    ref, port = out
    assert port == ref
    sent, attempts, records, _fp, evts, _values, active, closed = port
    assert closed and active and attempts == 0
    reconcile = [d for t, d in evts if t == "durability.reconcile"]
    assert len(reconcile) == 1 and reconcile[0]["stranded"] == 5 and reconcile[0]["resent"] == 5
    assert records[-1]["kind"] == "done" and records[-1]["note"] == "reconciled"
    assert evts[-1][1].get("replayed") is True or any(d.get("replayed") for t, d in evts)
    assert (tmp_path / "ref" / "wal.jsonl").read_bytes() == (tmp_path / "port" / "wal.jsonl").read_bytes()


def test_commit_resilient_refuses_an_unresolvable_open_cycle(tmp_path):
    out = []
    for name, p in (("ref", REF), ("port", PORT)):
        (tmp_path / name).mkdir()
        sess, w = _session(p, tmp_path / name)
        sess.fetch()
        lineage = _open_cycle(p, sess, w)

        def unreachable():
            raise RuntimeError("rpc down")

        sess.adapter.get_the_predictions = unreachable
        with pytest.raises(p.chain.ChainCommitError) as err:
            sess.commit_resilient()
        out.append((err.value.committed, err.value.sent_count, lineage in w.open_lineages(),
                    [(e.type, e.data) for e in sess.journal.recent(5)],
                    sess.journal.fingerprint()))
    ref, port = out
    assert port == ref
    assert port[2] and port[3][-1] == ("commit.failed", {
        "reason": "open_cycle_unresolved", "sent": 0})


# ---------------------------------------------------------------------------
# No card, no fallback
# ---------------------------------------------------------------------------


def test_entry_points_raise_without_a_card(tmp_path, monkeypatch):
    from svoc_torch.fabric import MultiSession
    from svoc_torch.tools import crash_smoke

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        scenario.run_durable_scenario(str(tmp_path / "d"))
    assert not (tmp_path / "d").exists()  # raised before writing anything
    with pytest.raises(RuntimeError, match="CUDA"):
        MultiSession()
    with pytest.raises(RuntimeError, match="CUDA"):
        crash_smoke.run(0, base=str(tmp_path / "m"))
    assert not (tmp_path / "m").exists()
    with pytest.raises(RuntimeError, match="CUDA"):
        crash_smoke.main([])
