"""The port's prefetch pipeline and host feed.

On the CPU: order is kept and the queue bounded; a producer's error
reaches the consumer; ``close()`` is idempotent and flags a producer it
cannot join; the feed's worker process yields in order, reports its
error and stops when closed; the flagship's feed (native tokenizer on an
inner thread and native packer, both in the worker, the copy on the
consumer's thread) gives the batches of the serial Python feed bit for
bit; the serving feed keeps the heap it starts on frozen until it
closes.  On the card (``requires_cuda``):
the copy stage's three traps, each with a test: a pinned buffer is not
overwritten while its copy is in flight, the allocator does not hand the
batch's memory out while the consumer's stream still reads it, and the
producer thread makes the batch's device current itself.
"""

import gc
import itertools
import multiprocessing
import threading
import time

import numpy as np
import pytest
import torch

from svoc_torch.flagship import FlagshipStep, TokenBatch, pack_stream, token_lists
from svoc_torch.io.pipeline import DevicePut, PrefetchPipeline, staged_stream, worker_stream
from svoc_torch.io.scraper import SyntheticSource
from svoc_torch.models.configs import TINY_TEST
from svoc_torch.models.packing import PackedBatch, pack_tokens
from svoc_torch.models.tokenizer import HashingTokenizer


def test_order_is_kept_and_the_queue_bounded():
    produced = []

    def source():
        for i in range(20):
            produced.append(i)
            yield [str(i)]

    with PrefetchPipeline(source(), lambda texts, seq: int(texts[0]) * seq, seq_len=3,
                          depth=2) as pipe:
        time.sleep(0.3)  # the producer runs ahead until the queue is full
        assert len(produced) == 2 + 1  # depth queued, one blocked in its put
        assert list(pipe) == [3 * i for i in range(20)]
    stats = pipe.stats()
    assert stats["produced"] == 20 and stats["producer_error"] is None and stats["closed"]


def test_a_producer_error_reaches_the_consumer():
    def source():
        yield ["fine"]
        raise KeyError("bad source")

    pipe = PrefetchPipeline(source(), None, 0, depth=2)
    assert next(pipe) == ["fine"]
    with pytest.raises(KeyError, match="bad source"):
        next(pipe)
    assert "KeyError" in pipe.stats()["producer_error"]
    pipe.close()


def test_a_device_put_error_reaches_the_consumer():
    def put(item):
        raise ValueError("no copy")

    with PrefetchPipeline(iter([[1]]), None, 0, device_put=put) as pipe:
        with pytest.raises(ValueError, match="no copy"):
            next(pipe)


def test_close_is_idempotent_and_closes_a_generator_source():
    closed = []

    def source():
        try:
            for i in itertools.count():
                yield i
        finally:
            closed.append(True)

    pipe = PrefetchPipeline(source(), None, 0, depth=1)
    assert next(pipe) == 0
    for _ in range(3):
        pipe.close()
    assert closed == [True] and not pipe.stats()["producer_leaked"]
    assert pipe.stats()["closed"] and not pipe._thread.is_alive()


def test_a_wedged_producer_sets_producer_leaked():
    release = threading.Event()

    def wedged(texts, seq):
        release.wait(10)
        return texts

    pipe = PrefetchPipeline(iter([["a"], ["b"]]), wedged, 0, join_timeout_s=0.2)
    time.sleep(0.1)
    pipe.close()
    assert pipe.stats()["producer_leaked"]
    release.set()
    pipe._thread.join(5)
    pipe.close()  # joins again: the producer came unstuck
    assert not pipe.stats()["producer_leaked"] and not pipe._thread.is_alive()


def test_worker_stream_yields_in_order_and_ends():
    before = set(multiprocessing.active_children())
    assert list(worker_stream(iter, range(7), depth=2)) == list(range(7))
    assert set(multiprocessing.active_children()) - before == set()  # the worker is reaped


def test_worker_stream_raises_the_workers_error():
    with pytest.raises(RuntimeError, match="feed worker failed(.|\n)*ValueError"):
        next(worker_stream(int, "not a number"))


def test_closing_a_worker_stream_stops_its_process():
    before = set(multiprocessing.active_children())
    feed = worker_stream(itertools.repeat, "text", depth=2)
    assert [next(feed) for _ in range(5)] == ["text"] * 5
    assert len(set(multiprocessing.active_children()) - before) == 1
    feed.close()
    assert set(multiprocessing.active_children()) - before == set()


def test_device_put_on_the_cpu_wraps_the_arrays():
    batch = TokenBatch(np.arange(6, dtype=np.int32).reshape(2, 3), np.ones((2, 3), np.int32))
    staged, n = DevicePut("cpu")((batch, 2))
    assert n == 2 and staged.ready is None
    out = staged.wait()
    assert isinstance(out, TokenBatch) and out.ids.dtype == torch.int32
    assert np.array_equal(out.ids.numpy(), batch.ids)


def test_two_stage_feed_equals_the_serial_python_feed(rows=16, seq=32, max_seg=4):
    step = FlagshipStep(TINY_TEST, rows=rows, seq=seq, max_seg=max_seg, n_oracles=16,
                        subset_size=2, params_dtype=None, device="cpu")
    feed = step.comments(SyntheticSource(batch=rows, seed=11))
    tok = HashingTokenizer(TINY_TEST.vocab_size, pad_id=TINY_TEST.pad_id, max_len=seq)
    serial = pack_stream(token_lists(tok, SyntheticSource(batch=rows, seed=11), seq),
                         rows, seq, max_seg, tok.pad_id, pack=pack_tokens)
    for _ in range(6):
        (got, n_got), (want, n_want) = next(feed), next(serial)
        assert n_got == n_want and isinstance(got, PackedBatch)
        for a, b in zip(got, want):
            assert isinstance(a, torch.Tensor)
            np.testing.assert_array_equal(a.numpy(), b)
    feed.close()


def test_unpacked_feed_runs_on_the_pipeline():
    step = FlagshipStep(TINY_TEST, variant="dense", rows=4, seq=16, n_oracles=16, subset_size=2,
                        params_dtype=None, device="cpu")
    source = SyntheticSource(batch=6, seed=0)
    texts = source() + source()
    feed = step.comments(SyntheticSource(batch=6, seed=0))
    tok = HashingTokenizer(TINY_TEST.vocab_size, pad_id=TINY_TEST.pad_id)
    for i in range(3):
        batch, n = next(feed)
        want = tok(texts[4 * i: 4 * i + 4], 16)
        assert n == 4 and np.array_equal(batch.ids.numpy(), want[0])
        assert np.array_equal(batch.mask.numpy(), want[1])
    feed.close()


def _frozen(obj) -> bool:
    """``obj`` is in the permanent generation: tracked, yet in none of
    the three the collector scans."""
    return gc.is_tracked(obj) and not any(o is obj for o in gc.get_objects())


def _small_batches(n):
    for i in range(n):
        yield TokenBatch(np.full((2, 3), i, np.int32), np.ones((2, 3), np.int32)), i


def test_the_serving_feed_freezes_its_start_up_heap_while_it_runs():
    """A full collection while the feed runs scans only what the loop
    allocated since it started: the heap as it stood is frozen, and
    unfrozen when the feed closes."""
    start_up = [object()]
    feed = staged_stream(_small_batches(4), "cpu")
    batch, n = next(feed)
    assert n == 0 and int(batch.ids.max()) == 0
    assert gc.get_freeze_count() > 0 and _frozen(start_up)
    during = [object()]  # allocated by the loop: the collector's to scan
    assert not _frozen(during)
    assert [n for _, n in feed] == [1, 2, 3]  # run to its end: closed
    assert gc.get_freeze_count() == 0 and not _frozen(start_up)


def test_nested_feeds_unfreeze_when_the_last_closes():
    """4c's variants share one feed while another is open: the heap stays
    frozen until every feed has closed, and a dropped feed counts as
    closed."""
    start_up = [object()]
    first = FlagshipStep(TINY_TEST, rows=4, seq=16, max_seg=4, n_oracles=16, subset_size=2,
                         params_dtype=None, device="cpu").comments(SyntheticSource(batch=4, seed=0))
    next(first)
    second = staged_stream(_small_batches(3), "cpu")
    next(second)
    later = [object()]  # alive only after the first feed froze the heap
    assert _frozen(start_up) and not _frozen(later)
    first.close()
    assert _frozen(start_up)
    del second  # dropped, never closed by hand
    assert gc.get_freeze_count() == 0 and not _frozen(start_up)


def test_a_feed_that_fails_unfreezes_the_heap():
    def broken():
        yield from _small_batches(1)
        raise KeyError("bad source")

    feed = staged_stream(broken(), "cpu")
    next(feed)
    assert gc.get_freeze_count() > 0
    with pytest.raises(KeyError, match="bad source"):
        next(feed)
    assert gc.get_freeze_count() == 0


# ---------------------------------------------------------------------------
# On the card: the copy stage's traps
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the copy stage's streams and pinned buffers)")
    return torch.device("cuda", 0)


def _batches(n, shape=(256, 128)):
    for i in range(n):
        yield TokenBatch(np.full(shape, i, np.int32), np.full(shape, -i, np.int32)), i


@pytest.mark.requires_cuda
def test_card_pinned_ring_is_not_overwritten_in_flight(cuda):
    """More batches than slots, produced as fast as the host can: every
    batch arrives with its own values, none with a later batch's."""
    with PrefetchPipeline(_batches(40), None, 0, depth=4,
                          device_put=DevicePut(cuda, slots=6)) as pipe:
        for staged, i in pipe:
            batch = staged.wait()
            assert batch.ids.device.type == "cuda"
            assert int(batch.ids.min()) == int(batch.ids.max()) == i
            assert int(batch.mask.min()) == int(batch.mask.max()) == -i


@pytest.mark.requires_cuda
def test_card_batch_memory_outlives_the_consumers_stream_work(cuda):
    """The consumer queues long work that reads a batch, drops its
    reference and the feed allocates on: the work still reads the
    batch's own values (``record_stream`` keeps its memory)."""
    sums = []
    feed = staged_stream(_batches(12), cuda)
    for batch, i in feed:
        big = torch.randn(2048, 2048, device=cuda)
        for _ in range(20):
            big = big @ big * 1e-3  # keeps the stream busy after the batch is dropped
        sums.append((batch.ids.sum(), i))  # queued behind the products
        del batch
    torch.cuda.synchronize()
    assert [int(s) for s, _ in sums] == [256 * 128 * i for _, i in sums]


@pytest.mark.requires_cuda
def test_card_producer_thread_makes_the_device_current(cuda):
    """The copy stage runs on the producer thread, which starts with no
    device of its own: the batch lands on the stage's device."""
    seen = []

    def put(item):
        out = stage(item)
        seen.append(torch.cuda.current_device())
        return out

    stage = DevicePut(torch.device("cuda"), slots=3)  # no index: the constructing thread's
    with PrefetchPipeline(_batches(3), None, 0, depth=1, device_put=put) as pipe:
        devices = {staged.wait().ids.device for staged, _ in pipe}
    assert devices == {torch.device("cuda", torch.cuda.current_device())}
    assert set(seen) == {stage.device.index}
