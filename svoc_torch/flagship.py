"""The flagship serving step, end to end, in its three variants.

Mirrors ``bench.py::bench_flagship`` (``bench.py:646-723``) and the body
of ``bench.py::_bench_packed_flagship`` (``bench.py:1870-1950``) with
the fused consensus, in the non-pipelined order: forward → tracked
vectors → window → bootstrap fleet → two-pass consensus.  The variants
are the reference's: ``"packed_flash"`` (sequence-packed rows, flash
attention; the default, as the reference's recorded decision routes
it), ``"packed"`` (packed rows, dense attention) and ``"dense"``
(unpacked rows of one comment each, dense attention).  All three give
the same per-comment vectors to float tolerance.  The host feeds mirror
``bench.py::packed_comment_stream`` (``bench.py:1725``) and the
unpacked ``unique_batches`` (``bench.py:737``) without their prefetch
threads.  The pipelined twin (``bench.py:719, 1946``) is not ported yet.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Iterator, List, NamedTuple, Tuple

import numpy as np
import torch

from svoc_torch.consensus.kernel import ConsensusConfig
from svoc_torch.models.configs import ROBERTA_GO_EMOTIONS, EncoderConfig
from svoc_torch.models.packing import PackedBatch, pack_tokens, strip_padding
from svoc_torch.models.sentiment import SentimentPipeline
from svoc_torch.models.tokenizer import HashingTokenizer
from svoc_torch.ops.fused_consensus import FusedConsensusOutput, fused_consensus
from svoc_torch.ops.select import first_valid_window
from svoc_torch.sim.oracle import FleetDraws, assemble_fleet, draw_fleet


def packed_comment_stream(
    tokenizer: HashingTokenizer,
    source: Callable[[], List[str]],
    rows: int,
    seq: int,
    max_seg: int,
) -> Iterator[Tuple[PackedBatch, int]]:
    """``(PackedBatch, n_comments)`` with fixed ``[rows, seq]`` shapes.
    The buffer always holds ``rows * max_seg`` token lists, enough to
    fill every row, so no batch is partly empty."""
    buf: collections.deque = collections.deque()
    need = rows * max_seg
    while True:
        while len(buf) < need:
            buf.extend(strip_padding(*tokenizer(source(), seq)))
        batch, n = pack_tokens(list(buf), seq, max_seg, tokenizer.pad_id, rows=rows)
        for _ in range(n):
            buf.popleft()
        yield batch, n


class TokenBatch(NamedTuple):
    """Fixed-shape unpacked token batch: one comment a row."""

    ids: np.ndarray  #: [B, T] int32
    mask: np.ndarray  #: [B, T] int32, 1 on real tokens


def comment_stream(
    tokenizer: HashingTokenizer,
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
    layout; any value outside :data:`VARIANTS` raises."""

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
        device=None,
    ):
        if variant not in VARIANTS:
            raise ValueError(f"flagship_variant {variant!r} not in dense|packed|packed_flash")
        attention, self.packed = VARIANTS[variant]
        self.variant = variant
        self.pipe = SentimentPipeline(
            dataclasses.replace(cfg, attention=attention),
            seq_len=seq,
            batch_size=rows,
            seed=seed,
            params=params,
            params_dtype=params_dtype,
            device=device,
        )
        self.device = self.pipe.device
        self.rows, self.seq, self.max_seg = rows, seq, max_seg
        self.n_oracles = n_oracles
        self.window_size = min(window_size, rows)
        self.subset_size = subset_size
        self.ccfg = ConsensusConfig(n_failing=max(2, n_oracles // 8), constrained=True)

    def comments(self, source: Callable[[], List[str]]):
        """The host feed of this step's shape and layout from ``source``."""
        if not self.packed:
            return comment_stream(self.pipe.tokenizer, source, self.rows, self.seq)
        return packed_comment_stream(
            self.pipe.tokenizer, source, self.rows, self.seq, self.max_seg
        )

    def window(self, batch: "PackedBatch | TokenBatch") -> torch.Tensor:
        """Forward → vectors → the window ``[W, M]``: the first
        ``window_size`` valid segment vectors of a packed batch, the
        first ``window_size`` rows of an unpacked one."""
        if not self.packed:
            ids, mask = (torch.from_numpy(a).to(self.device) for a in batch)
            return self.pipe.forward(ids, mask)[: self.window_size]
        dev = [
            torch.from_numpy(a).to(self.device)
            for a in (batch.ids, batch.pos, batch.seg, batch.cls_pos)
        ]
        valid = torch.from_numpy(batch.seg_valid > 0).to(self.device)
        vecs = self.pipe.packed_forward(*dev)
        return first_valid_window(
            vecs.reshape(-1, self.pipe.dimension), valid.reshape(-1), self.window_size
        )

    def draws(self, gen: torch.Generator) -> FleetDraws:
        return draw_fleet(
            gen, self.window_size, self.pipe.dimension, self.n_oracles,
            self.ccfg.n_failing, self.subset_size,
        )

    def consensus(
        self, window: torch.Tensor, draws: FleetDraws
    ) -> Tuple[FusedConsensusOutput, torch.Tensor]:
        """Fleet from ``draws`` → fused consensus; ``(output, honest)``."""
        values, honest = assemble_fleet(window, *draws)
        return fused_consensus(values.contiguous(), self.ccfg), honest

    def __call__(self, batch: "PackedBatch | TokenBatch", gen: torch.Generator):
        return self.consensus(self.window(batch), self.draws(gen))
