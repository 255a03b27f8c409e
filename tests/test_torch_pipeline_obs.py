"""The prefetch pipeline's and the sentiment stage's observability
against the JAX package's, on the CPU.

- A producer that raises journals one ``pipeline.producer_error`` in
  each package's journal, with equal type, lineage, error and produced
  (``svoc_tpu/io/pipeline.py:104-117``).
- A wedged producer counts one ``pipeline_producer_leaks`` a wedge in
  both packages: a second close of the same wedge counts nothing, a
  close that reaps it clears the flag, and a new wedge counts again
  (``pipeline.py:180-188``).
- The producer's ``tokenize``/``h2d`` spans and ``SentimentPipeline``'s
  ``tokenize``/``pack``/``forward`` spans match the reference's by name,
  lineage and count (``pipeline.py:81-94``, ``sentiment.py:276-278, 306,
  331, 338``).

Each test runs on fresh journals, registries and tracers in both
packages (as ``tests/test_torch_console.py``'s ``fresh`` fixture), so
nothing an earlier test file emitted in the same worker counts here.
Tolerance: none; events, counts and span lists are compared as values.
"""

import threading

import pytest

jax = pytest.importorskip("jax")

from svoc_tpu.io import pipeline as ref_pipeline
from svoc_tpu.models import configs as jax_configs
from svoc_tpu.models.encoder import SentimentEncoder as JaxEncoder
from svoc_tpu.models.encoder import init_params as jax_init_params
from svoc_tpu.models.sentiment import SentimentPipeline as JaxPipeline
from svoc_tpu.utils import events as ref_events
from svoc_tpu.utils import metrics as ref_metrics

from svoc_torch.io import pipeline
from svoc_torch.io.scraper import SyntheticSource
from svoc_torch.models.configs import TINY_TEST
from svoc_torch.models.from_jax import params_from_flax
from svoc_torch.models.sentiment import SentimentPipeline
from svoc_torch.utils import events, metrics

PACKAGES = {"port": (pipeline, events, metrics), "ref": (ref_pipeline, ref_events, ref_metrics)}


@pytest.fixture
def fresh(monkeypatch):
    """A fresh journal, metrics registry and span tracer in each package
    (``stage_span`` and the pipeline read ``metrics.tracer``,
    ``metrics.registry`` and ``events.journal`` when called)."""
    for mod_events, mod_metrics in ((events, metrics), (ref_events, ref_metrics)):
        reg = mod_metrics.MetricsRegistry()
        monkeypatch.setattr(mod_metrics, "registry", reg)
        monkeypatch.setattr(mod_metrics, "tracer", mod_metrics.Tracer(reg))
        monkeypatch.setattr(mod_events, "journal", mod_events.EventJournal(registry=reg))


def _spans(mod_metrics):
    return [(s.name, s.lineage) for s in mod_metrics.tracer.recent()]


def _crash(mod_pipeline):
    def source():
        yield ["fine"]
        yield ["also fine"]
        raise KeyError("bad source")

    pipe = mod_pipeline.PrefetchPipeline(source(), None, 0, depth=2, lineage="blk-crash-1")
    assert next(pipe) == ["fine"] and next(pipe) == ["also fine"]
    with pytest.raises(KeyError, match="bad source"):
        next(pipe)
    pipe.close()
    return pipe


def test_a_crashed_producer_journals_the_references_event(fresh):
    got = {}
    for name, (mod_pipeline, mod_events, _) in PACKAGES.items():
        pipe = _crash(mod_pipeline)
        records = [e for e in mod_events.journal.recent() if e.type == "pipeline.producer_error"]
        assert len(records) == 1, (name, records)
        (rec,) = records
        got[name] = (rec.type, rec.lineage, rec.data)
        assert rec.data == {"error": pipe.stats()["producer_error"], "produced": 2}
    assert got["port"] == got["ref"] == (
        "pipeline.producer_error", "blk-crash-1", {"error": "KeyError('bad source')", "produced": 2}
    )


def _leaks(mod_metrics):
    return mod_metrics.registry.counter("pipeline_producer_leaks").count


def _wedge(mod_pipeline, gate):
    def stuck(texts, seq_len):
        gate.wait(10.0)
        return texts

    return mod_pipeline.PrefetchPipeline([["a"], ["b"]], stuck, 4, depth=1, join_timeout_s=0.05)


def test_a_wedged_producer_counts_one_leak_a_wedge(fresh):
    counts = {}
    for name, (mod_pipeline, _, mod_metrics) in PACKAGES.items():
        seen = []
        gate = threading.Event()
        pipe = _wedge(mod_pipeline, gate)
        pipe.close()
        seen.append((pipe.stats()["producer_leaked"], _leaks(mod_metrics)))
        pipe.close()  # the same wedge: flagged still, counted once
        seen.append((pipe.stats()["producer_leaked"], _leaks(mod_metrics)))
        gate.set()
        pipe._thread.join(5.0)
        pipe.close()  # reaped: the flag clears, nothing counts
        seen.append((pipe.stats()["producer_leaked"], _leaks(mod_metrics)))
        again = _wedge(mod_pipeline, threading.Event())
        again.close()  # a new wedge counts again
        seen.append((again.stats()["producer_leaked"], _leaks(mod_metrics)))
        counts[name] = seen
    assert counts["port"] == counts["ref"] == [(True, 1), (True, 1), (False, 1), (True, 2)]


def test_the_producers_tokenize_and_h2d_spans_match(fresh):
    got = {}
    for name, (mod_pipeline, _, mod_metrics) in PACKAGES.items():
        texts = [["x"] * (i + 1) for i in range(3)]
        with mod_pipeline.PrefetchPipeline(texts, lambda t, n: (len(t), n), 8, depth=2,
                                           device_put=lambda b: b, lineage="blk-feed-7") as pipe:
            assert list(pipe) == [(1, 8), (2, 8), (3, 8)]
        # raw mode: no tokenize span, the copy stage's alone
        with mod_pipeline.PrefetchPipeline([[1], [2]], None, 0, device_put=lambda b: b) as pipe:
            assert list(pipe) == [[1], [2]]
        got[name] = _spans(mod_metrics)
    assert got["port"] == got["ref"] == [("tokenize", "blk-feed-7"), ("h2d", "blk-feed-7")] * 3 + [
        ("h2d", None)
    ] * 2


@pytest.fixture(scope="module")
def sentiment_pipes():
    flax_params = jax_init_params(JaxEncoder(jax_configs.TINY_TEST), seed=2)
    params = params_from_flax(flax_params)
    pipes = {}
    for packed in (False, True):
        kw = dict(seq_len=32, batch_size=4, packed=packed, max_segments=3)
        pipes[packed] = (
            SentimentPipeline(TINY_TEST, params=params, device="cpu", **kw),
            JaxPipeline(cfg=jax_configs.TINY_TEST, tokenizer_name=None, params=flax_params, **kw),
        )
    return pipes


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
def test_the_sentiment_stages_spans_match(fresh, sentiment_pipes, packed):
    port, ref = sentiment_pipes[packed]
    texts = SyntheticSource(batch=10, seed=4)()  # two full chunks of 4 and one of 2 unpacked
    got = {}
    for name, pipe, mod_metrics in (("port", port, metrics), ("ref", ref, ref_metrics)):
        pipe(texts, lineage="blk-sent-3")
        with mod_metrics.tracer.span("fetch", lineage="blk-sent-4"):
            pipe(texts[:5])  # inside a fetch span the stages inherit its lineage
        got[name] = _spans(mod_metrics)
    assert got["port"] == got["ref"]
    names = [n for n, _ in got["port"]]
    if packed:
        assert names.count("pack") == 2 and "tokenize" in names and "forward" in names
    else:
        assert names.count("tokenize") == names.count("forward") == 3 + 2 and "pack" not in names
    assert {lin for _, lin in got["port"]} == {"blk-sent-3", "blk-sent-4"}

