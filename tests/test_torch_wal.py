"""The port's write-ahead log, chain log, reconciler and fault controller
against the JAX package's, on the CPU.

Twins of ``tests/test_durability.py:65-348``: every case runs the same
sequence through both packages and compares what each writes to disk,
byte for byte, and what each reports.

- The WAL's record lines for one cycle (per-tx and batched families,
  the reconciler's close, a failure-closed cycle), torn-tail sealing,
  rotation that refuses an open cycle, and the WAL cursor that rescues
  a resume from an over-advanced committed index.
- The reconciler's verdicts in every cell of the decision table
  (``landed_durable``, ``landed_batch``, ``landed_chain``, ``stranded``,
  ``superseded``, ``skipped`` with a reachable chain; ``unknown`` with
  an unreachable one), its ``durability.reconcile`` events, its resends
  and its close records.
- The durable chain log: its lines, its replay onto a fresh contract,
  and duplicate detection.
- The fault surface and the armed controller: the same declared points,
  the same firing schedule, actions and durable fired log.
"""

import os
import types

import numpy as np
import pytest

pytest.importorskip("jax")

import svoc_tpu.consensus.state as ref_state
import svoc_tpu.durability.chainlog as ref_chainlog
import svoc_tpu.durability.faultspace as ref_faultspace
import svoc_tpu.durability.reconcile as ref_reconcile
import svoc_tpu.durability.wal as ref_wal
import svoc_tpu.io.chain as ref_chain
import svoc_tpu.ops.fixedpoint as ref_fixedpoint
import svoc_tpu.resilience.faults as ref_faults
import svoc_tpu.resilience.retry as ref_retry
import svoc_tpu.utils.events as ref_events
import svoc_tpu.utils.metrics as ref_metrics

import svoc_torch.consensus.state as state
import svoc_torch.durability.chainlog as chainlog
import svoc_torch.durability.faultspace as faultspace
import svoc_torch.durability.reconcile as reconcile
import svoc_torch.durability.wal as wal_mod
import svoc_torch.io.chain as chain
import svoc_torch.ops.fixedpoint as fixedpoint
import svoc_torch.resilience.faults as faults
import svoc_torch.resilience.retry as retry
import svoc_torch.utils.events as events
import svoc_torch.utils.metrics as metrics

ADMINS = [0xA0, 0xA1, 0xA2]
ORACLES = [0x10 + i for i in range(7)]

REF = types.SimpleNamespace(
    state=ref_state, chainlog=ref_chainlog, faultspace=ref_faultspace,
    reconcile=ref_reconcile, wal=ref_wal, chain=ref_chain,
    fixedpoint=ref_fixedpoint, faults=ref_faults, retry=ref_retry,
    events=ref_events, metrics=ref_metrics, contract_kw={},
)
PORT = types.SimpleNamespace(
    state=state, chainlog=chainlog, faultspace=faultspace,
    reconcile=reconcile, wal=wal_mod, chain=chain,
    fixedpoint=fixedpoint, faults=faults, retry=retry,
    events=events, metrics=metrics, contract_kw={"device": "cpu"},
)


def make_contract(p, **kwargs):
    defaults = dict(admins=ADMINS, oracles=ORACLES, required_majority=2,
                    n_failing_oracles=2, constrained=True, dimension=6)
    defaults.update(kwargs)
    return p.state.OracleConsensusContract(**defaults, **p.contract_kw)


def fleet_predictions(seed=0, n=7, dim=6):
    return np.random.default_rng(seed).uniform(0.05, 0.95, size=(n, dim))


def encode_fleet(p, predictions):
    return [p.fixedpoint.encode_vector(row) for row in predictions]


def journal(p):
    return p.events.EventJournal(registry=p.metrics.MetricsRegistry())


def both(tmp_path, fn):
    """``fn(package, directory)`` for the reference and the port, each in
    its own directory; returns the two results."""
    out = []
    for name, p in (("ref", REF), ("port", PORT)):
        d = tmp_path / name
        d.mkdir()
        out.append(fn(p, d))
    return out


def same_bytes(tmp_path, name):
    a = (tmp_path / "ref" / name).read_bytes()
    b = (tmp_path / "port" / name).read_bytes()
    assert a == b and a


# ---------------------------------------------------------------------------
# WAL mechanics
# ---------------------------------------------------------------------------


def test_wal_lines_byte_identical(tmp_path):
    def run(p, d):
        payloads = encode_fleet(p, fleet_predictions())
        payloads[5] = None  # an unencodable slot
        w = p.wal.CommitIntentWAL(str(d / "wal.jsonl"))
        cyc = w.cycle("blk1-000001", claim="alpha", oracles=ORACLES,
                      payloads=payloads, skip=(6,))
        cyc.new_attempt(0)
        for slot in range(3):
            cyc.intent(slot, ORACLES[slot], payloads[slot])
            cyc.landed(slot)
        cyc.new_attempt(3)
        cyc.intent(3, ORACLES[3], payloads[3])
        cursor = cyc.attempt_cursor()
        cyc.done(3, stranded=[ORACLES[3], "0x14"])
        batch = w.cycle("blk1-000002", claim="beta", oracles=ORACLES, payloads=payloads)
        batch.new_attempt(0)
        batch.intent_batch(range(7))
        batch.landed_batch(range(4))
        batch.done(4, failed="deadline")
        w.cycle("blk1-000003", oracles=ORACLES, payloads=payloads)
        w.close_cycle("blk1-000003", sent=2, note="reconciled", superseded=[4, 1])
        return (cursor, batch.attempt_landed, w.completed_lineages(), w.open_lineages(),
                w.records())

    ref, port = both(tmp_path, run)
    assert port == ref
    assert port[0] == 3 and port[2] == {"blk1-000001", "blk1-000003"} and port[3] == set()
    same_bytes(tmp_path, "wal.jsonl")


def test_torn_tail_is_ignored_and_sealed(tmp_path):
    def run(p, d):
        path = str(d / "wal.jsonl")
        w = p.wal.CommitIntentWAL(path)
        w.cycle("blk1-000001", oracles=[1], payloads=[[5]])
        w.close()
        with open(path, "a") as f:
            f.write('{"kind": "intent", "slo')  # the mid-append kill
        kinds = [r["kind"] for r in p.wal.read_wal(path)]
        w2 = p.wal.CommitIntentWAL(path)  # seals the torn bytes
        w2.close_cycle("blk1-000001")
        return kinds, [r["kind"] for r in w2.records()]

    ref, port = both(tmp_path, run)
    assert port == ref == (["cycle"], ["cycle", "done"])
    same_bytes(tmp_path, "wal.jsonl")


@pytest.mark.parametrize("body, kept", [
    ('{"a": 1}\n{"b": 2}\n{"torn', '{"a": 1}\n{"b": 2}\n'),
    ('{"torn', ""),
    ('{"a": 1}\n', '{"a": 1}\n'),
])
def test_seal_jsonl_truncates_only_torn_bytes(tmp_path, body, kept):
    def run(p, d):
        path = str(d / "x.jsonl")
        with open(path, "w") as f:
            f.write(body)
        first, second = p.wal.seal_jsonl(path), p.wal.seal_jsonl(path)
        return first, second, open(path).read()

    ref, port = both(tmp_path, run)
    assert port == ref == (body != kept, False, kept)


def test_rotate_refuses_open_cycles(tmp_path):
    def run(p, d):
        w = p.wal.CommitIntentWAL(str(d / "wal.jsonl"))
        w.cycle("blk1-000001", oracles=[1], payloads=[[5]])
        with pytest.raises(RuntimeError, match="open cycles"):
            w.rotate()
        w.close_cycle("blk1-000001")
        w.rotate()
        # A failure-closed cycle does not wedge rotation.
        w.cycle("blk9-000001", oracles=[1], payloads=[[5]]).done(0, failed="circuit_open")
        assert w.completed_lineages() == set()
        w.rotate()
        return w.records(), w.completed_lineages(), os.path.exists(str(d / "wal.jsonl.1"))

    ref, port = both(tmp_path, run)
    assert port == ref == ([], set(), True)
    same_bytes(tmp_path, "wal.jsonl.1")


class LyingBackend:
    """Dies at one oracle's tx but reports an over-advanced committed
    index with ``sent_count=None``."""

    def __init__(self, p, contract, fail_at, overstate=2):
        self.p = p
        self.inner = p.chain.LocalChainBackend(contract)
        self.fail_at, self.overstate, self.fail_times = fail_at, overstate, 1
        self.sends = {}

    def call(self, fn):
        return self.inner.call(fn)

    def call_as(self, caller, fn):
        return self.inner.call_as(caller, fn)

    def invoke(self, caller, fn, /, **kwargs):
        if fn == "update_prediction":
            idx = self.inner.contract.get_oracle_list().index(caller)
            if idx == self.fail_at and self.fail_times > 0:
                self.fail_times -= 1
                raise self.p.chain.ChainCommitError(
                    committed=idx + self.overstate,
                    total=len(self.inner.contract.get_oracle_list()),
                    failed_oracle=caller,
                    cause=RuntimeError("backend died before reporting"),
                    sent_count=None,
                )
            self.sends[caller] = self.sends.get(caller, 0) + 1
        return self.inner.invoke(caller, fn, **kwargs)


@pytest.mark.parametrize("with_wal", [True, False])
def test_wal_cursor_rescues_overadvanced_resume(tmp_path, with_wal):
    def run(p, d):
        contract = make_contract(p)
        backend = LyingBackend(p, contract, fail_at=3)
        predictions = fleet_predictions()
        cyc = None
        if with_wal:
            w = p.wal.CommitIntentWAL(str(d / "wal.jsonl"))
            cyc = w.cycle("blk1-000001", oracles=ORACLES, payloads=encode_fleet(p, predictions))
        j = journal(p)
        outcome = p.retry.commit_fleet_with_resume(
            p.chain.ChainAdapter(backend), predictions,
            p.retry.RetryPolicy(max_attempts=4, base_s=0.0, cap_s=0.0, jitter_seed=0),
            sleep=lambda s: None, registry=p.metrics.MetricsRegistry(), journal=j, wal=cyc,
        )
        return (outcome.sent, outcome.complete, dict(backend.sends), contract.consensus_active,
                j.fingerprint())

    ref, port = both(tmp_path, run)
    assert port == ref
    if with_wal:
        assert port[:2] == (7, True) and all(port[2][o] == 1 for o in ORACLES)
        same_bytes(tmp_path, "wal.jsonl")
    else:
        assert sum(port[2].values()) == 5  # the lie loses two txs without the WAL


# ---------------------------------------------------------------------------
# Reconciliation decision table
# ---------------------------------------------------------------------------


class DeadReadsBackend:
    """Writes work; the value-list read the reconciler needs fails."""

    def __init__(self, p, contract):
        self.inner = p.chain.LocalChainBackend(contract)

    def call(self, fn):
        return self.inner.call(fn)

    def call_as(self, caller, fn):
        raise RuntimeError("rpc down")

    def invoke(self, caller, fn, /, **kwargs):
        return self.inner.invoke(caller, fn, **kwargs)


def open_cycle_wal(p, d, predictions, landed_slots, sent_slots, skip=()):
    """A WAL as a crash leaves it: the cycle open, ``sent_slots`` on
    chain, ``landed_slots`` of them with durable landed records."""
    contract = make_contract(p)
    adapter = p.chain.ChainAdapter(p.chain.LocalChainBackend(contract))
    payloads = encode_fleet(p, predictions)
    w = p.wal.CommitIntentWAL(str(d / "wal.jsonl"))
    cyc = w.cycle("blk1-000001", oracles=ORACLES, payloads=payloads, skip=skip)
    cyc.new_attempt(0)
    for slot in sent_slots:
        cyc.intent(slot, ORACLES[slot], payloads[slot])
        adapter._invoke_prediction_felts(ORACLES[slot], payloads[slot])
        if slot in landed_slots:
            cyc.landed(slot)
    return w, contract, adapter


def reconcile_both(tmp_path, build, adapter_of=lambda p, adapter, contract: adapter):
    """Build the crashed state in both packages, reconcile twice, and
    return (report, second pass's open cycles, chain values, events)."""
    def run(p, d):
        w, contract, adapter = build(p, d)
        j = journal(p)
        use = adapter_of(p, adapter, contract)
        report = p.reconcile.reconcile_wal(w, lambda claim: use, journal=j,
                                           registry=p.metrics.MetricsRegistry())
        again = p.reconcile.reconcile_wal(w, lambda claim: use, journal=j,
                                          registry=p.metrics.MetricsRegistry())
        return (report.as_dict(), again.open_cycles,
                [list(o.value) for o in contract.oracles],
                [(e.type, e.lineage, e.data) for e in j.recent(100)])

    ref, port = both(tmp_path, run)
    assert port == ref
    same_bytes(tmp_path, "wal.jsonl")
    return port


def test_reconcile_reachable_backend_all_cells(tmp_path):
    report, again, values, evts = reconcile_both(
        tmp_path,
        lambda p, d: open_cycle_wal(p, d, fleet_predictions(), {0, 1}, [0, 1, 2], skip=(6,)),
    )
    (cycle,) = report["cycles"]
    by_slot = {v["slot"]: v for v in cycle["slots"]}
    assert [by_slot[s]["classification"] for s in range(7)] == [
        "landed_durable", "landed_durable", "landed_chain", "stranded", "stranded",
        "stranded", "skipped"]
    assert [by_slot[s]["resent"] for s in range(7)] == [False] * 3 + [True] * 3 + [False]
    assert cycle["closed"] and report["unknown"] == 0 and report["unaccounted"] == 0
    assert again == 0
    assert [t for t, _l, _d in evts] == ["durability.reconcile"] and evts[0][2]["stranded"] == 3


def test_reconcile_unreachable_backend_never_resends(tmp_path):
    invoked = []

    def dead(p, adapter, contract):
        a = p.chain.ChainAdapter(DeadReadsBackend(p, contract))
        a._invoke_prediction_felts = lambda *args: invoked.append(args)
        return a

    report, again, _values, _evts = reconcile_both(
        tmp_path,
        lambda p, d: open_cycle_wal(p, d, fleet_predictions(), {0}, [0, 1]),
        adapter_of=dead,
    )
    (cycle,) = report["cycles"]
    assert [v["classification"] for v in cycle["slots"]] == ["landed_durable"] + ["unknown"] * 6
    assert not invoked and not cycle["closed"] and again == 1 and report["unaccounted"] == 0


def test_reconcile_batched_and_superseded_cells(tmp_path):
    """A batched attempt killed after its RPC with a partial landed_batch
    record, followed by a newer cycle of the same claim whose value owns
    two slots on chain."""
    def build(p, d):
        contract = make_contract(p)
        adapter = p.chain.ChainAdapter(p.chain.LocalChainBackend(contract))
        old = encode_fleet(p, fleet_predictions(1))
        new = encode_fleet(p, fleet_predictions(2))
        w = p.wal.CommitIntentWAL(str(d / "wal.jsonl"))
        cyc = w.cycle("blk1-000001", claim="alpha", oracles=ORACLES, payloads=old)
        cyc.new_attempt(0)
        cyc.intent_batch(range(7))
        for slot in range(3):
            adapter._invoke_prediction_felts(ORACLES[slot], old[slot])
        cyc.landed_batch([0, 1])
        w.cycle("blk1-000002", claim="alpha", oracles=ORACLES, payloads=new)
        for slot in (4, 5):
            adapter._invoke_prediction_felts(ORACLES[slot], new[slot])
        return w, contract, adapter

    report, again, _values, evts = reconcile_both(tmp_path, build)
    first, second = report["cycles"]
    assert [v["classification"] for v in first["slots"]] == [
        "landed_batch", "landed_batch", "landed_chain", "stranded", "superseded", "superseded",
        "stranded"]
    assert first["closed"] and report["resent"] == 2 + 5  # then the newer cycle resends 5 of 7
    assert second["counts"]["landed_chain"] == 2 and again == 0
    assert len(evts) == 2


def test_reconcile_resolves_failure_closed_cycles(tmp_path):
    def build(p, d):
        w, contract, adapter = open_cycle_wal(p, d, fleet_predictions(), {0}, [0])
        w._append({"kind": "done", "lineage": "blk1-000001", "sent": 1, "stranded": [],
                   "failed": "deadline"})
        assert w.completed_lineages() == set()
        return w, contract, adapter

    report, again, _values, _evts = reconcile_both(tmp_path, build)
    (cycle,) = report["cycles"]
    assert cycle["counts"]["stranded"] == 6 and cycle["closed"] and again == 0


def test_wal_cycles_fold(tmp_path):
    def run(p, d):
        w, _contract, _adapter = open_cycle_wal(p, d, fleet_predictions(), {0}, [0, 1])
        w.cycle("blk1-000002", oracles=ORACLES, payloads=[None] * 7).done(0, failed="x")
        folded = p.reconcile.wal_cycles(w.records())
        return {k: {f: sorted(v) if isinstance(v, set) else v for f, v in c.items()}
                for k, c in folded.items()}

    ref, port = both(tmp_path, run)
    assert port == ref and port["blk1-000002"]["failed"] == "x"


# ---------------------------------------------------------------------------
# Durable chain log
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch", [False, True])
def test_chain_log_lines_and_replay(tmp_path, batch):
    def run(p, d):
        path = str(d / "chain.jsonl")
        contract = make_contract(p)
        backend = p.chainlog.DurableLocalBackend(contract, path)
        adapter = p.chain.ChainAdapter(backend)
        predictions = fleet_predictions()
        if batch:
            backend.update_predictions_batched(ORACLES, encode_fleet(p, predictions))
        else:
            adapter.update_all_the_predictions(predictions, batch=False)
        backend.invoke(ADMINS[0], "update_proposition", proposition=(6, 0x99))
        backend.invoke(ADMINS[1], "vote_for_a_proposition", which_admin=0,
                       support_his_proposition=True)
        backend.close()
        with open(path, "a") as f:
            f.write('{"caller": 16, "fn": "update_pre')  # a torn tail
        fresh = make_contract(p)
        n = p.chainlog.replay_chain_log(path, fresh)
        return (n, fresh.consensus_active, fresh.get_consensus_value(),
                fresh.get_oracle_list(), p.chainlog.duplicate_predictions(path),
                len(p.chainlog.read_chain_log(path)))

    ref, port = both(tmp_path, run)
    assert port == ref
    assert port[0] == 9 and port[1] and port[3][6] == 0x99 and port[4] == []
    same_bytes(tmp_path, "chain.jsonl")


def test_duplicate_detection(tmp_path):
    def run(p, d):
        path = str(d / "chain.jsonl")
        backend = p.chainlog.DurableLocalBackend(make_contract(p), path)
        felts = encode_fleet(p, fleet_predictions())[0]
        backend.invoke(ORACLES[0], "update_prediction", prediction=felts)
        backend.invoke(ORACLES[0], "update_prediction", prediction=felts)
        backend.invoke(ORACLES[1], "update_prediction", prediction=felts)
        return p.chainlog.duplicate_predictions(path)

    ref, port = both(tmp_path, run)
    assert port == ref and len(port) == 1


# ---------------------------------------------------------------------------
# The fault surface and the armed controller
# ---------------------------------------------------------------------------


def test_fault_surface_matches_reference():
    ref = ref_faultspace.load_surface()
    port = faultspace.load_surface()
    assert sorted(port) == sorted(ref)
    for name, spec in port.items():
        r = ref[name]
        assert spec.owner == r.owner.replace("svoc_tpu/", "svoc_torch/")
        assert (spec.invariant, spec.actions, spec.smokes, spec.modes, spec.stage) == (
            r.invariant, r.actions, r.smokes, r.modes, r.stage)


def test_controller_schedule_and_fired_log(tmp_path):
    """The same firing sequence through both controllers: nth matching
    firing, the ``match`` subset test, a shared nth carried to the next
    firing, the ``error`` and ``torn`` actions, and the fired log."""
    firings = [("wal.intent.pre_fsync", {"lineage": "a"}),
               ("chainlog.tx.post_fsync", {"fn": "update_proposition"}),
               ("chainlog.tx.post_fsync", {"fn": "update_prediction"}),
               ("wal.intent.pre_fsync", {"lineage": "b"}),
               ("chainlog.tx.post_fsync", {"fn": "update_prediction"}),
               ("reconcile.pre_resend", {"lineage": "a", "slot": 1}),
               ("wal.intent.pre_fsync", {"lineage": "c"}),
               ("wal.intent.pre_fsync", {"lineage": "d"})]

    def run(p, d):
        fs = p.faultspace
        events = [fs.FaultEvent("chainlog.tx.post_fsync", nth=2, action="kill",
                                match={"fn": "update_prediction"}),
                  fs.FaultEvent("reconcile.pre_resend", action="error"),
                  fs.FaultEvent("wal.intent.pre_fsync", nth=2, action="torn"),
                  fs.FaultEvent("wal.intent.pre_fsync", nth=2, action="kill")]
        deaths, torn, out = [], [], []
        ctl = fs.FaultController(events, log_path=str(d / "fired.jsonl"),
                                 die=lambda: deaths.append(len(out)))
        fs.arm(ctl)
        try:
            with pytest.raises(RuntimeError, match="already armed"):
                fs.arm(ctl)
            for name, payload in firings:
                try:
                    fs.fault_point(name, payload=payload, torn=lambda: torn.append(len(out)))
                    out.append("pass")
                except p.faults.InjectedFault as e:
                    out.append(str(e))
            counts, unfired = ctl.counts(), ctl.unfired_events()
        finally:
            fs.disarm()
        assert not fs.armed()
        return (out, deaths, torn, counts, [e.as_dict() for e in unfired],
                fs.read_fired_log(str(d / "fired.jsonl")),
                [fs.FaultEvent.from_dict(e.as_dict()) == e for e in events])

    ref, port = both(tmp_path, run)
    assert port == ref
    out, deaths, torn, counts, unfired, log, round_trips = port
    assert deaths == [3, 4, 6] and torn == [3] and unfired == [] and all(round_trips)
    assert out[5] == "chaos: injected fault at reconcile.pre_resend"
    assert len(log["actions"]) == 4
    same_bytes(tmp_path, "fired.jsonl")


@pytest.mark.parametrize("event, error", [
    (dict(point="no.such.point"), KeyError),
    (dict(point="serving.step.post", action="torn"), ValueError),
    (dict(point="wal.intent.pre_fsync", nth=0), ValueError),
    (dict(point="wal.intent.pre_fsync", action="melt"), ValueError),
])
def test_controller_refuses_bad_events(event, error):
    for fs in (ref_faultspace, faultspace):
        with pytest.raises(error):
            fs.FaultController([fs.FaultEvent(**event)])


class Died(Exception):
    """Stands in for the SIGKILL a ``kill``/``torn`` action ends with."""


def _die():
    raise Died()


def test_torn_action_leaves_half_a_line_that_the_next_wal_seals(tmp_path):
    """The ``torn`` action at a WAL point writes half the record's line
    (no newline) before the kill; the next WAL over the file seals it —
    the same bytes in both packages."""
    def run(p, d):
        path = str(d / "wal.jsonl")
        w = p.wal.CommitIntentWAL(path)
        w.cycle("blk1-000001", oracles=[1], payloads=[[5]])
        fs = p.faultspace
        fs.arm(fs.FaultController([fs.FaultEvent("wal.done.pre_fsync", action="torn")],
                                  die=_die))
        try:
            with pytest.raises(Died):
                w.close_cycle("blk1-000001", sent=1)
        finally:
            fs.disarm()
        torn = open(path).read()
        w.close()
        sealed = p.wal.CommitIntentWAL(path)
        return torn, open(path).read(), sealed.open_lineages()

    ref, port = both(tmp_path, run)
    assert port == ref
    torn, sealed, still_open = port
    assert not torn.endswith("\n") and sealed == torn[: torn.rfind("\n") + 1]
    assert still_open == {"blk1-000001"}
