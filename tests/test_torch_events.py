"""The port's flight recorder (``svoc_torch.utils.events``) and the
Tracer's trace file against the JAX package's, on the CPU.

- The same event sequences emitted into a reference journal and a port
  journal: byte-identical fingerprints (whole and per lineage family),
  the same records without their timestamps, the same filtered reads,
  summaries and per-block audit summaries.
- Lineage ids, the ring's export and restore (seqs preserved, numbering
  continues), and the JSON coercion of numpy and torch scalars.
- The rotating JSONL writer: the same segment files and contents as the
  reference's at the same byte cap; ``read_trace_events`` reads the
  port's segments as the reference reads them, torn tail included.
- The Tracer's trace file: every completed span is one JSON line in the
  shared writer's file, beside the journal's events; a bad path latches
  export off and counts the error, as the reference's does.
"""

import json
import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from svoc_tpu.utils import events as ref_events
from svoc_tpu.utils.metrics import MetricsRegistry as RefRegistry
from svoc_tpu.utils.metrics import Tracer as RefTracer

from svoc_torch.utils import events
from svoc_torch.utils.metrics import MetricsRegistry, Tracer


def _sequence(seed: int):
    """A seeded event stream over the documented types and a few
    lineages of two claim families, with numpy payloads."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(40):
        etype = events.EVENT_TYPES[int(rng.integers(len(events.EVENT_TYPES)))]
        claim = ("alpha", "beta")[int(rng.integers(2))]
        lineage = None if rng.random() < 0.2 else events.mint_lineage(
            int(rng.integers(1, 6)), prefix=f"blkfab-{claim}"
        )
        data = {
            "n": np.int64(rng.integers(100)),
            "x": np.float32(rng.random()),
            "flag": bool(rng.random() < 0.5),
            "slots": tuple(int(v) for v in rng.integers(0, 7, size=2)),
            "reasons": {str(int(rng.integers(7))): "nan"},
            "tags": {"b", "a"},
        }
        if etype == "breaker.transition":
            data["to"] = ("open", "closed")[i % 2]
        if etype == "commit.sent":
            data["sent"] = int(rng.integers(1, 8))
        if etype == "consensus.result":
            data["interval_valid"] = bool(i % 3)
        out.append((etype, lineage, data))
    return out


def _journals(seed: int, capacity: int = 4096):
    ref = ref_events.EventJournal(registry=RefRegistry(), capacity=capacity)
    port = events.EventJournal(registry=MetricsRegistry(), capacity=capacity)
    for etype, lineage, data in _sequence(seed):
        ref.emit(etype, lineage=lineage, **data)
        port.emit(etype, lineage=lineage, **data)
    return ref, port


def _strip_ts(records):
    return [{k: v for k, v in r.items() if k != "ts"} for r in records]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("capacity", [4096, 16])
def test_fingerprints_and_records_equal_the_reference(seed, capacity):
    ref, port = _journals(seed, capacity)
    assert port.fingerprint() == ref.fingerprint()
    for prefix in ("blkfab-alpha-", "blkfab-beta-", "blkfab-", "nothing"):
        assert port.fingerprint(lineage_prefix=prefix) == ref.fingerprint(lineage_prefix=prefix)
    assert _strip_ts(port.export_ring()) == _strip_ts(ref.export_ring())
    assert port.counts_by_type() == ref.counts_by_type()
    assert port.last_seq() == ref.last_seq()
    ps, rs = port.summary(), ref.summary()
    assert _strip_ts(ps.pop("alerts")) == _strip_ts(rs.pop("alerts"))
    assert ps == rs


@pytest.mark.parametrize("seed", [0, 3])
def test_filtered_reads_equal_the_reference(seed):
    ref, port = _journals(seed)
    payloads = lambda recs: [r.fingerprint_payload() for r in recs]  # noqa: E731
    for kwargs in (
        {}, {"type": "commit.sent"}, {"lineage": events.mint_lineage(2, "blkfab-alpha")},
        {"lineage_prefix": "blkfab-beta-"}, {"type": "slo.alert", "lineage_prefix": "blkfab-"},
    ):
        for n in (None, 3):
            assert payloads(port.recent(n, **kwargs)) == payloads(ref.recent(n, **kwargs))
    for seq in (0, 10, 39):
        assert payloads(port.since(seq, limit=5)) == payloads(ref.since(seq, limit=5))


def test_lineage_ids_and_scopes():
    for n, prefix in ((0, "blk"), (31, "blk"), (2**20 + 5, "blkfab-delta")):
        assert events.mint_lineage(n, prefix) == ref_events.mint_lineage(n, prefix)
    a, b = events.lineage_scope(), events.lineage_scope()
    assert b == a + 1


def test_json_coercion_of_numpy_and_torch_scalars():
    j = events.EventJournal(registry=MetricsRegistry())
    rec = j.emit("x", a=np.float64(0.25), b=torch.tensor(3), c=np.bool_(True), d=(1, 2),
                 e={"k": np.int32(4)}, f=object.__new__(object))
    assert rec.data["a"] == 0.25 and rec.data["b"] == 3 and rec.data["c"] is True
    assert rec.data["d"] == [1, 2] and rec.data["e"] == {"k": 4}
    assert isinstance(rec.data["f"], str)
    json.dumps(rec.as_dict())


def test_export_and_restore_keep_seqs_and_fingerprint():
    ref, port = _journals(4)
    fresh = events.EventJournal(registry=MetricsRegistry())
    assert fresh.restore(ref.export_ring()) == 40
    assert fresh.fingerprint() == ref.fingerprint()
    assert fresh.emit("block.fetched").seq == 41
    # Duplicates by seq collapse; order by seq.
    shuffled = list(reversed(port.export_ring())) + port.export_ring()[:5]
    again = events.EventJournal(registry=MetricsRegistry())
    assert again.restore(shuffled) == 40
    assert again.fingerprint() == port.fingerprint()


def test_audit_summary_equals_the_reference():
    ref, port = _journals(5)
    for n in range(1, 6):
        lineage = events.mint_lineage(n, "blkfab-alpha")
        r = ref_events.audit_record(lineage, journal=ref, tracer=RefTracer())
        p = events.audit_record(lineage, journal=port, tracer=Tracer())
        assert p["summary"] == r["summary"]
        assert _strip_ts(p["events"]) == _strip_ts(r["events"])
        assert p["found"] == r["found"]


def test_subscribers_and_their_errors():
    reg = MetricsRegistry()
    j = events.EventJournal(registry=reg)
    seen = []
    j.subscribe(seen.append)
    j.subscribe(lambda rec: 1 / 0)
    j.emit("commit.sent", sent=1)
    assert [r.type for r in seen] == ["commit.sent"]
    assert reg.counter("event_subscriber_errors").count == 1
    assert reg.counter("events_emitted", labels={"type": "commit.sent"}).count == 1
    assert events.resolve_journal(None) is events.journal
    assert events.resolve_journal(j) is j


@pytest.mark.parametrize("max_bytes,keep", [(200, 2), (120, 0), (10_000, 3)])
def test_rotating_writer_equals_the_reference(tmp_path, max_bytes, keep):
    lines = [json.dumps({"seq": i, "event": "x", "data": {"p": "é" * (i % 5)}}) for i in range(30)]
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    ref = ref_events.RotatingJsonlWriter(
        str(tmp_path / "ref" / "t.jsonl"), max_bytes=max_bytes, keep=keep, registry=RefRegistry()
    )
    port = events.RotatingJsonlWriter(
        str(tmp_path / "port" / "t.jsonl"), max_bytes=max_bytes, keep=keep, registry=MetricsRegistry()
    )
    for line in lines:
        ref.write_line(line)
        port.write_line(line)
    ref.close()
    port.close()
    names = lambda w: [os.path.basename(s) for s in w.segments()]  # noqa: E731
    assert names(port) == names(ref)
    for a, b in zip(port.segments(), ref.segments()):
        assert open(a).read() == open(b).read()
    assert events.read_trace_events(port.path, keep=keep) == ref_events.read_trace_events(
        ref.path, keep=keep
    )


def test_read_trace_events_tolerates_a_torn_tail_only(tmp_path):
    path = tmp_path / "t.jsonl"
    path.write_text(
        json.dumps({"seq": 1, "event": "a"}) + "\n"
        + json.dumps({"name": "span"}) + "\n"
        + json.dumps({"seq": 2, "event": "b"}) + "\n" + '{"seq": 3, "ev'
    )
    got = events.read_trace_events(str(path))
    assert [r["seq"] for r in got] == [1, 2]
    assert got == ref_events.read_trace_events(str(path))
    assert [r["seq"] for r in events.read_trace_events(str(path), since_seq=1)] == [2]
    path.write_text('{"seq": 1, "ev\n' + json.dumps({"seq": 2, "event": "b"}) + "\n")
    with pytest.raises(ValueError):
        events.read_trace_events(str(path))


def test_shared_writer_is_one_per_path(tmp_path):
    a = events.shared_writer(str(tmp_path / "s.jsonl"))
    assert events.shared_writer(str(tmp_path / "." / "s.jsonl")) is a
    a.write_line("{}")
    events.release_writer(str(tmp_path / "s.jsonl"))
    assert a._file is None
    a.write_line("{}")  # reopens lazily
    a.close()
    assert open(tmp_path / "s.jsonl").read() == "{}\n{}\n"


def test_tracer_trace_file_writes_every_span_beside_the_events(tmp_path):
    path = str(tmp_path / "trace.jsonl")
    reg = MetricsRegistry()
    tracer = Tracer(reg)
    journal = events.EventJournal(registry=reg)
    tracer.set_trace_file(path)
    journal.set_trace_file(path)
    with tracer.span("fetch", lineage="blk1-000001"):
        with tracer.span("fleet"):
            journal.emit("block.fetched", lineage="blk1-000001", n_comments=3)
    tracer.flush()
    lines = [json.loads(line) for line in open(path).read().splitlines()]
    assert [line.get("name", line.get("event")) for line in lines] == [
        "block.fetched", "fleet", "fetch"
    ]
    assert lines[1]["lineage"] == lines[2]["lineage"] == "blk1-000001"
    assert lines[1]["parent_id"] == lines[2]["span_id"] and lines[1]["depth"] == 1
    assert events.read_trace_events(path) == [journal.export_ring()[0]]
    # Cleared: no more lines; the file handle is released.
    tracer.set_trace_file(None)
    journal.set_trace_file(None)
    with tracer.span("late"):
        pass
    assert len(open(path).read().splitlines()) == 3


def test_tracer_trace_file_from_the_environment(tmp_path, monkeypatch):
    path = str(tmp_path / "env.jsonl")
    monkeypatch.setenv(Tracer.TRACE_ENV, path)
    tracer = Tracer(MetricsRegistry())
    with tracer.span("stage"):
        pass
    tracer.flush()
    (line,) = open(path).read().splitlines()
    assert json.loads(line)["name"] == "stage"
    monkeypatch.delenv(Tracer.TRACE_ENV)
    events.release_writer(path)


def test_tracer_bad_trace_file_latches_and_counts(tmp_path):
    reg = MetricsRegistry()
    tracer = Tracer(reg)
    bad = str(tmp_path / "missing-dir" / "t.jsonl")
    before = len(events.journal.recent(type="trace.write_error"))
    tracer.set_trace_file(bad)
    for _ in range(3):
        with tracer.span("s"):
            pass
    assert reg.counter("trace_write_errors").count == 1
    assert len(events.journal.recent(type="trace.write_error")) == before + 1
    assert len(tracer.recent()) == 3  # the ring still records every span
    # A repaired path resumes export.
    good = str(tmp_path / "ok.jsonl")
    tracer.set_trace_file(good)
    with tracer.span("t"):
        pass
    tracer.flush()
    assert json.loads(open(good).read())["name"] == "t"
    tracer.set_trace_file(None)
