"""Prefetching host → device input pipeline.

Mirrors :class:`svoc_tpu.io.pipeline.PrefetchPipeline`
(``pipeline.py:25-195``): a producer thread runs the host stages
(tokenize, pack, the copy to the device) into a bounded queue while the
device runs the batch before; the producer's exception is re-raised at
the consumer; ``close()`` is idempotent, joins with a timeout and flags
a producer it could not join (``producer_leaked``); ``stats()`` splits
the wall clock into produce time and consumer wait.  The native
tokenizer and packer release the GIL, so the overlap is parallel work.
The producer's ``tokenize`` and ``h2d`` spans carry the pipeline's
``lineage`` (a producer thread inherits none), a crashed producer
journals ``pipeline.producer_error`` and a wedged one counts once in
``pipeline_producer_leaks`` (``pipeline.py:81-117, 180-188``).

:class:`DevicePut` is the copy stage (the reference's ``packed_put_fn``,
``bench.py:1797-1811``): on CUDA it lays a batch's host arrays into one
pinned buffer and copies it to the card on a copy stream of its own;
the consumer's stream waits on the copy's event before it reads them
(:meth:`Staged.wait`).  On the CPU it is ``torch.from_numpy``.

:func:`worker_stream` runs a feed's host stages (the source, tokenize,
pack) in a worker process, not a thread: no counterpart in the
reference, whose step is one jitted call.  PyTorch's eager forward makes
some three hundred launches a step, each taking the GIL again after its
op; a comment source written in Python (``SyntheticSource`` holds the
GIL for milliseconds a batch) on a thread of the same process delayed
them so much that the forward's device time grew fivefold on an H100
(``chip_smoke.py`` phase 4b, PERF.md §6).  In its own process the feed
takes no GIL from the launching thread.

:func:`staged_stream`, the serving loop's feed, runs the copy stage on
the consumer's thread as it takes each batch, between steps: on a
thread of its own here, the stage's GIL handoffs (the batch's unpickling
and its copy) landed inside the launch-bound forward that had just
started, about 2 ms of a 20 ms forward on an H100 host (``chip_smoke.py``
phase 4b, PERF.md §6).  It also freezes the heap it starts on while it
runs (:func:`frozen_heap`): with the feed in its own process the step is
what allocates here, so a full collection of a large start-up heap ran
inside a forward (175 ms for some 270 000 objects on that host).

:func:`window_source` is the fetch loop's read stage over a
:class:`~svoc_torch.io.comment_store.CommentStore`
(``pipeline.py:197-210``).
"""

from __future__ import annotations

import contextlib
import gc
import multiprocessing
import os
import queue
import threading
import time
import traceback
from typing import Callable, Iterable, Iterator, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


class PrefetchPipeline:
    """Iterate ready batches ahead of consumption.

    Args:
      source: yields batches of texts (or, with ``tokenizer=None``,
        finished items); exhaustion ends the pipeline.
      tokenizer: ``(texts, seq_len) → batch``, or None (raw mode: the
        source's items pass straight to ``device_put``).
      seq_len: fixed sequence length (static device shapes).
      depth: producer queue depth (2 = classic double buffering).
      device_put: the copy stage, run on the producer thread, or None.
      join_timeout_s: how long ``close()`` waits for the producer.
      lineage: the block lineage of the producer's spans and of its
        ``pipeline.producer_error`` event.
    """

    def __init__(
        self,
        source: Iterable,
        tokenizer: Optional[Callable],
        seq_len: int,
        depth: int = 2,
        device_put: Optional[Callable] = None,
        join_timeout_s: float = 5.0,
        lineage: Optional[str] = None,
    ):
        self._source = iter(source)
        self._tokenizer = tokenizer
        self._seq_len = seq_len
        self._lineage = lineage
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._device_put = device_put
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._join_timeout_s = join_timeout_s
        self._close_lock = threading.Lock()
        self._closed = False
        self._producer_leaked = False
        self._produced = 0
        self._produce_s = 0.0
        self._consumer_wait_s = 0.0
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _produce(self) -> None:
        from svoc_torch.utils.metrics import stage_span

        try:
            for item in self._source:
                if self._stop.is_set():
                    break
                t0 = time.perf_counter()
                if self._tokenizer is not None:
                    with stage_span("tokenize", lineage=self._lineage):
                        item = self._tokenizer(list(item), self._seq_len)
                if self._device_put is not None:
                    with stage_span("h2d", lineage=self._lineage):
                        item = self._device_put(item)
                self._produced += 1
                self._produce_s += time.perf_counter() - t0
                while not self._stop.is_set():
                    try:
                        self._queue.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # surfaced on the consumer side
            self._error = e
            # A crashed producer is an incident of the flight recorder
            # (the postmortem monitor bundles on it), not only a field of
            # stats() that nobody reads until the consumer re-raises.
            from svoc_torch.utils.events import journal

            journal.emit(
                "pipeline.producer_error",
                lineage=self._lineage,
                error=repr(e),
                produced=self._produced,
            )
        finally:
            # A generator source is closed on the thread that iterated it,
            # so its own cleanup (an inner pipeline's close) runs now.
            close = getattr(self._source, "close", None)
            if close is not None:
                try:
                    close()
                except BaseException as e:  # noqa: BLE001 -- reported like a producer error
                    self._error = self._error or e
            while not self._stop.is_set():
                try:
                    self._queue.put(None, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        item = self._queue.get()
        self._consumer_wait_s += time.perf_counter() - t0
        if item is None:
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item

    def stats(self) -> dict:
        """``{produced, produce_s, consumer_wait_s, closed,
        producer_leaked, producer_error}``: produce time is the producer's
        busy time (tokenize, pack, copy); consumer wait is the time the
        consumer spent blocked on an empty queue (about 0 when the device
        is the bottleneck, the gap when the host is)."""
        return {
            "produced": self._produced,
            "produce_s": round(self._produce_s, 4),
            "consumer_wait_s": round(self._consumer_wait_s, 4),
            "closed": self._closed,
            "producer_leaked": self._producer_leaked,
            "producer_error": repr(self._error) if self._error is not None else None,
        }

    def close(self) -> None:
        """Stop the producer and reap it.  Idempotent; a re-close after a
        timed-out join joins again, so a producer that comes unstuck
        clears the leak flag."""
        with self._close_lock:
            self._closed = True
            self._stop.set()
            try:  # drain, so that the producer's blocked put sees the stop
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
            if not self._thread.is_alive():
                self._producer_leaked = False  # reaped since the last close
                return
            self._thread.join(timeout=self._join_timeout_s)
            leaked = self._thread.is_alive()
            if leaked and not self._producer_leaked:
                # Once a wedge: a later close that reaps the producer
                # clears the flag, so a new wedge counts again.
                from svoc_torch.utils.metrics import registry

                registry.counter("pipeline_producer_leaks").add(1)
            self._producer_leaked = leaked

    def __enter__(self) -> "PrefetchPipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class Staged(NamedTuple):
    """A batch copied by :class:`DevicePut`: ``batch`` holds tensors on
    the device once ``ready`` (None on the CPU) has fired."""

    batch: tuple
    ready: Optional["torch.cuda.Event"]

    def wait(self) -> tuple:
        """The batch, safe to read on the caller's current stream: that
        stream waits for the copy, and the allocator keeps the batch's
        memory (one allocation) until the work queued on it has run."""
        if self.ready is not None:
            stream = torch.cuda.current_stream(self.batch[0].device)
            stream.wait_event(self.ready)
            self.batch[0].record_stream(stream)
        return self.batch


class _Slot:
    """One ring entry: a pinned host buffer and the event of its last
    copy to the device."""

    def __init__(self):
        self.buffer: Optional[torch.Tensor] = None
        self.event: Optional["torch.cuda.Event"] = None


class DevicePut:
    """The copy stage: ``(batch, n) → (Staged, n)`` where ``batch`` is a
    NamedTuple of numpy arrays of one dtype and the staged batch is the
    same NamedTuple of tensors on ``device``.

    On CUDA a batch moves as one buffer: its arrays are laid end to end
    into a pinned buffer, copied to the card in one transfer on a stream
    of its own, and handed out as views of the one device tensor, so the
    stage makes two PyTorch calls a batch (the thread that runs it takes
    the GIL from the thread launching the step's kernels as little as it
    can).  The pinned buffers form a ring of ``slots`` (at least the
    pipeline's depth + 2: one batch in the copy, ``depth`` in the queue,
    one with the consumer): a slot is refilled only after its previous
    copy's event has fired, so no copy in flight reads a buffer being
    overwritten; the ring is pinned in one go on the first batch.  The
    thread that calls this makes ``device`` current itself (a producer
    thread starts on device 0)."""

    def __init__(self, device, slots: int = 6):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        if self.cuda and self.device.index is None:  # the constructing thread's device
            self.device = torch.device("cuda", torch.cuda.current_device())
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        self._ring = [_Slot() for _ in range(slots)]
        self._next = 0
        self._stream = None

    def __call__(self, item: Tuple[tuple, int]) -> Tuple[Staged, int]:
        batch, n = item
        if not self.cuda:
            return Staged(type(batch)(*(torch.from_numpy(np.asarray(a)) for a in batch)), None), n
        arrays = [np.asarray(a) for a in batch]
        dtype = arrays[0].dtype
        if any(a.dtype != dtype for a in arrays):
            raise ValueError(f"a batch moves as one buffer of one dtype, got {[a.dtype for a in arrays]}")
        total = sum(a.size for a in arrays)
        torch.cuda.set_device(self.device)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        slot = self._ring[self._next]
        self._next = (self._next + 1) % len(self._ring)
        if slot.event is not None:
            slot.event.synchronize()  # its previous copy has left the buffer
        if slot.buffer is None or slot.buffer.numel() != total or slot.buffer.numpy().dtype != dtype:
            # The whole ring at once, on the first batch: pinning memory is
            # slow and stalls the other thread's CUDA calls, so it must not
            # happen while the consumer launches a step (a copy in flight
            # keeps its old block).
            for each in self._ring:
                each.buffer = torch.from_numpy(np.empty(total, dtype)).pin_memory()
        np.concatenate([a.reshape(-1) for a in arrays], out=slot.buffer.numpy())
        with torch.cuda.stream(self._stream):
            flat = slot.buffer.to(self.device, non_blocking=True)
            slot.event = torch.cuda.Event()
            slot.event.record(self._stream)
        views = flat.split([a.size for a in arrays])
        return Staged(type(batch)(*(v.view(a.shape) for v, a in zip(views, arrays))), slot.event), n


_frozen = 0
_frozen_lock = threading.Lock()


@contextlib.contextmanager
def frozen_heap():
    """The heap as it stands on entry kept out of the cyclic collector
    until the last of the nested blocks exits: the first entry collects
    once and freezes (``gc.freeze``), the last exit unfreezes the whole
    permanent generation (``gc.unfreeze``: whatever froze it).  A
    long-running loop's start-up heap (the model, the package, the
    caller's own objects) is then not scanned while it runs, so a full
    collection costs what the loop itself keeps alive."""
    global _frozen
    with _frozen_lock:
        if _frozen == 0:
            gc.collect()
            gc.freeze()
        _frozen += 1
    try:
        yield
    finally:
        with _frozen_lock:
            _frozen -= 1
            if _frozen == 0:
                gc.unfreeze()


def staged_stream(items: Iterable[Tuple[tuple, int]], device):
    """``items`` (``(batch of numpy arrays, n)``, produced ahead by a
    :func:`worker_stream`) copied to ``device`` as each is taken, on the
    caller's thread (:class:`DevicePut`: two pinned buffers, one for the
    batch in the copy and one for the batch before it); yields ``(batch
    of tensors, n)`` ready on the consumer's stream.  The heap is frozen
    while the stream runs (:func:`frozen_heap`).  Closing the generator
    closes ``items``."""
    put = DevicePut(device, slots=2)
    source = iter(items)
    try:
        with frozen_heap():
            for item in source:
                staged, n = put(item)
                yield staged.wait(), n
    finally:
        close = getattr(source, "close", None)
        if close is not None:
            close()


#: How long closing a worker stream waits for the worker to stop.
WORKER_JOIN_TIMEOUT_S = 5.0


def _work(factory: Callable, args: tuple, items, stop) -> None:
    """The worker process: ``factory(*args)``'s items into ``items``
    until the stop event, then an end (or error) marker.  It runs at a
    lower priority, so that on a host short of cores the process that
    launches the step's kernels keeps its core."""
    os.nice(10)
    try:
        for item in factory(*args):
            while not stop.is_set():
                try:
                    items.put(("item", item), timeout=0.1)
                    break
                except queue.Full:
                    continue
            if stop.is_set():
                return
        items.put(("end", None))
    except BaseException:  # noqa: BLE001 -- sent to the consumer, which raises it
        items.put(("error", traceback.format_exc()))


def worker_stream(factory: Callable[..., Iterable], *args, depth: int = 4):
    """``factory(*args)``'s items, produced ``depth`` ahead in a spawned
    worker process.  ``factory`` and ``args`` are pickled (a module-level
    function; a picklable source); the worker holds its own copy of
    them.  An error in the worker is raised here as ``RuntimeError`` with
    its traceback.  Closing the generator stops the worker (terminated
    if it does not stop within ``WORKER_JOIN_TIMEOUT_S``)."""
    ctx = multiprocessing.get_context("spawn")
    items = ctx.Queue(maxsize=depth)
    stop = ctx.Event()
    proc = ctx.Process(target=_work, args=(factory, args, items, stop), daemon=True)
    proc.start()
    try:
        while True:
            try:
                kind, value = items.get(timeout=1.0)
            except queue.Empty:
                if not proc.is_alive():
                    raise RuntimeError(f"the feed worker exited with code {proc.exitcode}")
                continue
            if kind == "end":
                return
            if kind == "error":
                raise RuntimeError(f"the feed worker failed:\n{value}")
            yield value
    finally:
        stop.set()
        deadline = time.monotonic() + WORKER_JOIN_TIMEOUT_S
        while proc.is_alive() and time.monotonic() < deadline:
            try:  # drain, so that the worker's put sees the stop
                items.get(timeout=0.05)
            except queue.Empty:
                pass
        if proc.is_alive():
            proc.terminate()
        proc.join()
        items.close()
        items.cancel_join_thread()


def window_source(
    store, *, window: int, limit: int, max_windows: Optional[int] = None
) -> Iterator[Sequence[str]]:
    """Circular comment windows from a
    :class:`~svoc_torch.io.comment_store.CommentStore` (the fetch loop's
    read stage, as a pipeline source): ``store.read_window`` from
    position 0 on, until the store is empty or ``max_windows`` were
    yielded."""
    position = 0
    count = 0
    while max_windows is None or count < max_windows:
        comments, _dates, position = store.read_window(position, window, limit)
        if not comments:
            return
        yield comments
        count += 1
