"""The flagship serving step, end to end, in its three variants.

Mirrors ``bench.py::bench_flagship`` (``bench.py:646-723``) and the body
of ``bench.py::_bench_packed_flagship`` (``bench.py:1870-2060``) with
the fused consensus, in the non-pipelined order: forward → tracked
vectors → window → bootstrap fleet → two-pass consensus.  The variants
are the reference's: ``"packed_flash"`` (sequence-packed rows, flash
attention; the default, as the reference's recorded decision routes
it), ``"packed"`` (packed rows, dense attention) and ``"dense"``
(unpacked rows of one comment each, dense attention).  All three give
the same per-comment vectors to float tolerance.

The host feed is the reference's two-stage feed (``bench.py:1725-1811,
2027``): an inner :class:`~svoc_torch.io.pipeline.PrefetchPipeline`
tokenizes with the native tokenizer and strips the padding while the
native packer (:func:`~svoc_torch.models.packing.pack_tokens_auto`)
packs; an outer one copies each batch to the device
(:class:`~svoc_torch.io.pipeline.DevicePut`).  Unlike the reference's,
the source, the tokenizer and the packer run in a worker process
(:func:`~svoc_torch.io.pipeline.worker_stream`), so that their Python
holds no GIL the launching thread waits for; the unpacked feed
tokenizes there too.  The fleet's key chain is the reference's:
``PRNGKey(0)``, then ``key = fold_in(key, step)`` (``bench.py:2051``).

The pipelined twin (:meth:`FlagshipStep.pipelined` and
:meth:`FlagshipStep.drain`) mirrors the reference's default loop
(``pipelined_step``, ``bench.py:1939-1957``, the loop at ``:2030-2078``
and the body of ``fleet_consensus_body``, ``:1916-1935``): the fleet and
consensus of batch k−1 run beside the forward of batch k, and after the
loop a drain runs the last batch's.  The key that rides with a window is
the key chained at that window's own step, so the per-batch outputs are
``__call__``'s, one step later, key for key.  On CUDA the fleet and
consensus go to a second stream, made once per step object, while the
forward runs on the caller's; nothing on that path reads a value back to
the host, so the two streams overlap on the device.  On the CPU it is
the same code with no second stream.  The mesh forms of the reference's
library (``parallel/serving.py:237, 275``) are
:func:`svoc_torch.parallel.serving.packed_serving_step_fn` and
:func:`~svoc_torch.parallel.serving.packed_serving_pipelined_step_fn`:
the same step with its rows split over a ``data`` mesh, the forward (and
its flash launches) once a slot, and the fleet and consensus
oracle-parallel over the same slots.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
from typing import Callable, Iterable, Iterator, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from svoc_torch.consensus.kernel import ConsensusConfig
from svoc_torch.io.pipeline import PrefetchPipeline, staged_stream, worker_stream
from svoc_torch.models.configs import ROBERTA_GO_EMOTIONS, EncoderConfig
from svoc_torch.models.packing import PackedBatch, pack_tokens_auto, strip_padding
from svoc_torch.models.sentiment import SentimentPipeline
from svoc_torch.ops.fused_consensus import FusedConsensusOutput, fused_consensus
from svoc_torch.ops.select import first_valid_window
from svoc_torch.sim.oracle import FleetDraws, assemble_fleet, draw_fleet

Tokenizer = Callable[[Sequence[str], int], Tuple[np.ndarray, np.ndarray]]
#: Batches each stage of the feed keeps ready ahead of its consumer (the
#: reference's prefetch depth, ``bench.py:1773, 2028``).
FEED_DEPTH = 4


def token_lists(tokenizer: Tokenizer, source: Callable[[], List[str]],
                seq: int) -> Iterator[List[np.ndarray]]:
    """The source's batches tokenized and stripped of padding, serially."""
    while True:
        yield strip_padding(*tokenizer(source(), seq))


def pack_stream(
    lists: Iterable[List[np.ndarray]],
    rows: int,
    seq: int,
    max_seg: int,
    pad_id: int,
    pack=pack_tokens_auto,
) -> Iterator[Tuple[PackedBatch, int]]:
    """``(PackedBatch, n_comments)`` with fixed ``[rows, seq]`` shapes
    from batches of token lists.  The buffer always holds ``rows *
    max_seg`` token lists, enough to fill every row, so no batch is
    partly empty."""
    lists = iter(lists)
    buf: collections.deque = collections.deque()
    need = rows * max_seg
    while True:
        while len(buf) < need:
            buf.extend(next(lists))
        batch, n = pack(list(buf), seq, max_seg, pad_id, rows=rows)
        for _ in range(n):
            buf.popleft()
        yield batch, n


def packed_comment_stream(
    tokenizer: Tokenizer,
    source: Callable[[], List[str]],
    rows: int,
    seq: int,
    max_seg: int,
) -> Iterator[Tuple[PackedBatch, int]]:
    """The packed host feed: tokenize and strip on an inner prefetch
    thread, pack natively on the caller's thread.  Closing the generator
    closes the inner pipeline."""

    def tokenize_strip(texts, seq_len):
        return strip_padding(*tokenizer(texts, seq_len))

    texts = (source() for _ in itertools.count())
    with PrefetchPipeline(texts, tokenize_strip, seq_len=seq, depth=FEED_DEPTH) as lists:
        yield from pack_stream(lists, rows, seq, max_seg, tokenizer.pad_id)


class TokenBatch(NamedTuple):
    """Fixed-shape unpacked token batch: one comment a row."""

    ids: np.ndarray  #: [B, T] int32
    mask: np.ndarray  #: [B, T] int32, 1 on real tokens


def comment_stream(
    tokenizer: Tokenizer,
    source: Callable[[], List[str]],
    rows: int,
    seq: int,
) -> Iterator[Tuple[TokenBatch, int]]:
    """``(TokenBatch, n_comments)`` with fixed ``[rows, seq]`` shapes:
    the unpacked feed, fresh comments in every batch."""
    buf: List[str] = []
    while True:
        while len(buf) < rows:
            buf.extend(source())
        chunk, buf = buf[:rows], buf[rows:]
        yield TokenBatch(*tokenizer(chunk, seq)), rows


#: variant → (cfg.attention, packed rows)
VARIANTS = {
    "packed_flash": ("flash", True),
    "packed": ("dense", True),
    "dense": ("dense", False),
}


class FlagshipStep:
    """One serving step at the flagship's shape: ``rows`` rows of ``seq``
    tokens (packed, with up to ``max_seg`` comments each, or one comment
    a row in the ``"dense"`` variant), a window of the first
    ``window_size`` comments, ``n_oracles`` oracles of which
    ``max(2, n_oracles // 8)`` fail, bootstrap subsets of
    ``subset_size``.  ``variant`` sets ``cfg.attention`` and the row
    layout; any value outside :data:`VARIANTS` raises.  ``quant="int8"``
    runs the W8A8 forward (``bench.py --config 10``, ``bench.py:1845-1854``:
    the ``"packed"`` variant with its block matmuls in int8), folded from
    the float32 parameters whatever ``params_dtype`` says
    (``bench.py:1905-1906``); it needs dense attention, so the flash
    variant raises."""

    def __init__(
        self,
        cfg: EncoderConfig = ROBERTA_GO_EMOTIONS,
        variant: str = "packed_flash",
        rows: int = 256,
        seq: int = 128,
        max_seg: int = 8,
        n_oracles: int = 1024,
        window_size: int = 50,
        subset_size: int = 10,
        seed: int = 0,
        params=None,
        params_dtype: "torch.dtype | None" = torch.bfloat16,
        quant: "str | None" = None,
        device=None,
    ):
        if variant not in VARIANTS:
            raise ValueError(f"flagship_variant {variant!r} not in dense|packed|packed_flash")
        attention, self.packed = VARIANTS[variant]
        self.variant = variant
        self.quant = quant
        self.pipe = SentimentPipeline(
            dataclasses.replace(cfg, attention=attention),
            seq_len=seq,
            batch_size=rows,
            seed=seed,
            params=params,
            params_dtype=None if quant else params_dtype,
            quant=quant,
            device=device,
        )
        self.device = self.pipe.device
        self.rows, self.seq, self.max_seg = rows, seq, max_seg
        self.n_oracles = n_oracles
        self.window_size = min(window_size, rows)
        self.subset_size = subset_size
        self.ccfg = ConsensusConfig(n_failing=max(2, n_oracles // 8), constrained=True)
        #: The stream :meth:`pipelined` runs the fleet and consensus on.
        self._side = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    def comments(self, source: Callable[[], List[str]]):
        """The host feed of this step's shape and layout from ``source``
        (picklable: it runs in the feed's worker process, on its own
        copy), produced ``FEED_DEPTH`` batches ahead and copied to the step's
        device as each is taken: ``(batch, n_comments)``, the batch's
        fields tensors ready on the caller's stream.  Close the generator
        (or drop it) to stop the worker."""
        tok = self.pipe.tokenizer
        if self.packed:
            items = worker_stream(packed_comment_stream, tok, source, self.rows, self.seq,
                                  self.max_seg, depth=FEED_DEPTH)
        else:
            items = worker_stream(comment_stream, tok, source, self.rows, self.seq,
                                  depth=FEED_DEPTH)
        return staged_stream(items, self.device)

    def window(self, batch: "PackedBatch | TokenBatch") -> torch.Tensor:
        """Forward → vectors → the window ``[W, M]``: the first
        ``window_size`` valid segment vectors of a packed batch, the
        first ``window_size`` rows of an unpacked one.  The batch's
        fields are numpy arrays or tensors (from :meth:`comments`)."""
        dev = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
        if not self.packed:
            return self.pipe.forward(dev(batch.ids), dev(batch.mask))[: self.window_size]
        vecs = self.pipe.packed_forward(*map(dev, (batch.ids, batch.pos, batch.seg, batch.cls_pos)))
        valid = dev(batch.seg_valid) > 0
        return first_valid_window(
            vecs.reshape(-1, self.pipe.dimension), valid.reshape(-1), self.window_size
        )

    def draws(self, key: torch.Tensor) -> FleetDraws:
        """The fleet's draws from ``key [2]`` on the step's device (the
        reference's ``gen_oracle_predictions(key, ...)``)."""
        return draw_fleet(
            key, self.window_size, self.pipe.dimension, self.n_oracles,
            self.ccfg.n_failing, self.subset_size,
        )

    def consensus(
        self, window: torch.Tensor, draws: FleetDraws
    ) -> Tuple[FusedConsensusOutput, torch.Tensor]:
        """Fleet from ``draws`` → fused consensus; ``(output, honest)``."""
        values, honest = assemble_fleet(window, *draws)
        return fused_consensus(values.contiguous(), self.ccfg), honest

    def __call__(self, batch: "PackedBatch | TokenBatch", key: torch.Tensor):
        """One step on ``batch`` with the fleet drawn from ``key``; the
        reference's step ``s`` uses ``key = fold_in(key, s)`` on the key
        of the step before, from ``PRNGKey(0)``."""
        return self.consensus(self.window(batch), self.draws(key))

    def drain(self, key: torch.Tensor, window: torch.Tensor):
        """The consensus of the pipeline's last window, drawn from the
        key chained at its step (``bench.py:2074-2078``): ``(output,
        honest)``."""
        return self.consensus(window, self.draws(key))

    def pipelined(self, batch: "PackedBatch | TokenBatch", key: torch.Tensor,
                  window: torch.Tensor):
        """One pipelined step: the forward of ``batch`` (step k) beside
        the fleet and consensus of the window of step k−1, drawn from
        ``key``, the key chained at step k−1.  Returns ``(window_k,
        output_{k-1}, honest_{k-1})``; every tensor is ready for use on
        the caller's stream."""
        if self.device.type != "cuda":
            out, honest = self.drain(key, window)
            return self.window(batch), out, honest
        main, side = torch.cuda.current_stream(self.device), self._side
        side.wait_stream(main)  # the window and key were made on the caller's stream
        with torch.cuda.stream(side):
            out, honest = self.drain(key, window)
        for t in (key, window):
            t.record_stream(side)  # not reused before the side stream is done with them
        new_window = self.window(batch)
        main.wait_stream(side)
        for t in (*out, honest):
            t.record_stream(main)  # made on the side stream, read on the caller's
        return new_window, out, honest
