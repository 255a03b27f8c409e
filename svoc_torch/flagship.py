"""The flagship's packed-flash serving step, end to end.

Mirrors the body of ``bench.py::_bench_packed_flagship``
(``bench.py:1870-1950``) with flash attention and the fused
consensus, in the non-pipelined order: packed forward → tracked vectors
→ first valid window → bootstrap fleet → two-pass consensus.  The host
feed mirrors ``bench.py::packed_comment_stream`` (``bench.py:1725``)
without its prefetch threads.  The pipelined twin (``bench.py:1946``)
is not ported yet.
"""

from __future__ import annotations

import collections
from typing import Callable, Iterator, List, Tuple

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


class FlagshipStep:
    """One serving step at the flagship's shape: ``rows`` packed rows of
    ``seq`` tokens with up to ``max_seg`` comments each, a window of the
    first ``window_size`` comments, ``n_oracles`` oracles of which
    ``max(2, n_oracles // 8)`` fail, bootstrap subsets of
    ``subset_size``."""

    def __init__(
        self,
        cfg: EncoderConfig = ROBERTA_GO_EMOTIONS,
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
        self.pipe = SentimentPipeline(
            cfg,
            seq_len=seq,
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
        """The packed host feed of this step's shape from ``source``."""
        return packed_comment_stream(
            self.pipe.tokenizer, source, self.rows, self.seq, self.max_seg
        )

    def window(self, batch: PackedBatch) -> torch.Tensor:
        """Packed forward → vectors → the first ``window_size`` valid
        segment vectors ``[W, M]``."""
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

    def __call__(self, batch: PackedBatch, gen: torch.Generator):
        return self.consensus(self.window(batch), self.draws(gen))
