"""The multi-claim serving step: the device half of one serving cycle.

Mirrors the device path of
:meth:`svoc_tpu.serving.tier.ServingTier._step_inner`
(``tier.py:197-300``) in the router's ``sanitized_dispatch`` mode:
assembled requests → one cross-claim packed forward → per-claim vector
groups → each claim's rolling request window and bootstrap fleet → one
gate-and-consensus dispatch per shape/config group over the padded claim
cube.  The forward is the packed-flash one (the step sets
``cfg.attention = "flash"`` itself), so on CUDA that is 12
flash-attention launches (ROBERTA_GO_EMOTIONS) and one launch of the
gated claim-cube kernel per group.

Admission and shedding, the result cache, latency accounting, SLOs, the
chain commit and the journal are not ported yet (ROADMAP A10).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from svoc_torch.apps.session import fleet_block, request_window
from svoc_torch.consensus.kernel import ConsensusConfig, ConsensusOutput
from svoc_torch.fabric.registry import ClaimSpec
from svoc_torch.fabric.router import dispatch_group
from svoc_torch.models.configs import ROBERTA_GO_EMOTIONS, EncoderConfig
from svoc_torch.models.packing import PackedBatch, pack_tokens, strip_padding
from svoc_torch.models.sentiment import SentimentPipeline
from svoc_torch.serving.batcher import Request, group_by_claim
from svoc_torch.sim.generators import claim_seed


class ClaimGroup(NamedTuple):
    """The fleets of the claims of one shape/config group, in dispatch
    order."""

    cfg: ConsensusConfig
    claims: Tuple[str, ...]
    blocks: Tuple[torch.Tensor, ...]  # each [N, M] float32, after the tamper hook


class ClaimGroupResult(NamedTuple):
    """One group's consensus: every field of ``out`` and ``ok`` has one
    row per claim of ``claims``."""

    claims: Tuple[str, ...]
    out: ConsensusOutput
    ok: torch.Tensor  # [C, N] admission masks, True = admitted
    blocks: Tuple[torch.Tensor, ...]


class ClaimServingStep:
    """One serving step over many claims at the flagship's shape:
    ``rows`` packed rows of ``seq`` tokens with up to ``max_seg``
    comments each.

    Each claim keeps its rolling window (at most
    ``PREDICTION_WINDOW`` rows) and its own ``torch.Generator``, seeded
    from ``spec.seed`` or, when that is None, from ``claim_seed(seed,
    claim_id)``; so one claim's fleets depend on its own requests only.
    ``pipe`` shares an existing :class:`SentimentPipeline` (its weights
    and device)."""

    def __init__(
        self,
        specs: Sequence[ClaimSpec],
        cfg: EncoderConfig = ROBERTA_GO_EMOTIONS,
        rows: int = 256,
        seq: int = 128,
        max_seg: int = 8,
        seed: int = 0,
        params=None,
        params_dtype: Optional[torch.dtype] = torch.bfloat16,
        pipe: Optional[SentimentPipeline] = None,
        device=None,
    ):
        if pipe is None:
            pipe = SentimentPipeline(
                dataclasses.replace(cfg, attention="flash"), seq_len=seq, seed=seed, params=params,
                params_dtype=params_dtype, device=device,
            )
        self.pipe = pipe
        self.device = pipe.device
        self.rows, self.seq, self.max_seg = rows, seq, max_seg
        self.specs: Dict[str, ClaimSpec] = {}
        for spec in specs:
            if spec.claim_id in self.specs:
                raise ValueError(f"claim {spec.claim_id!r} registered twice")
            if spec.dimension != pipe.dimension:
                raise ValueError(
                    f"claim {spec.claim_id!r} has dimension {spec.dimension}, "
                    f"the pipeline's vectors {pipe.dimension}"
                )
            self.specs[spec.claim_id] = spec
        self.windows: Dict[str, Optional[torch.Tensor]] = dict.fromkeys(self.specs)
        self.cycles = dict.fromkeys(self.specs, 0)
        self.gens = {
            cid: torch.Generator(device=self.device).manual_seed(
                claim_seed(seed, cid) if spec.seed is None else spec.seed
            )
            for cid, spec in self.specs.items()
        }

    def pack(self, requests: Sequence[Request]) -> PackedBatch:
        """Tokenize and pack every request's text into the step's
        ``[rows, seq]`` shape; raises when they do not all fit."""
        tok = self.pipe.tokenizer
        ids, mask = tok([r.text for r in requests], self.seq)
        batch, n = pack_tokens(
            strip_padding(ids, mask), self.seq, self.max_seg, tok.pad_id, rows=self.rows
        )
        if n != len(requests):
            raise ValueError(
                f"{len(requests)} requests do not fit one packed batch of {self.rows} x "
                f"{self.seq} tokens with at most {self.max_seg} segments a row ({n} fit)"
            )
        return batch

    def forward(self, batch: PackedBatch) -> torch.Tensor:
        """The packed forward → vectors ``[K, M]`` float32, row ``k`` for
        the ``k``-th packed request."""
        valid = np.flatnonzero(batch.seg_valid.reshape(-1))
        gather = np.empty(valid.size, dtype=np.int64)
        gather[batch.owner.reshape(-1)[valid]] = valid
        arrays = (batch.ids, batch.pos, batch.seg, batch.cls_pos)
        vecs = self.pipe.packed_forward(*(torch.from_numpy(a).to(self.device) for a in arrays))
        index = torch.from_numpy(gather).to(self.device)
        return vecs.reshape(-1, self.pipe.dimension)[index].float()

    def fleets(self, requests: Sequence[Request], vectors: torch.Tensor) -> List[ClaimGroup]:
        """Each fed claim's window and fleet, grouped by fleet shape and
        consensus configuration in the order the claims first appear."""
        groups: Dict[tuple, Tuple[List[str], List[torch.Tensor]]] = {}
        for cid, feed in group_by_claim(requests, vectors).items():
            spec = self.specs[cid]
            kept, tiled, subset = request_window(self.windows[cid], feed)
            self.windows[cid] = kept
            values, _ = fleet_block(
                self.gens[cid], tiled, spec, subset, spec.tamper, self.cycles[cid]
            )
            self.cycles[cid] += 1
            key = (spec.n_oracles, spec.dimension, spec.consensus_config())
            claims, blocks = groups.setdefault(key, ([], []))
            claims.append(cid)
            blocks.append(values)
        return [
            ClaimGroup(key[2], tuple(claims), tuple(blocks))
            for key, (claims, blocks) in groups.items()
        ]

    @staticmethod
    def consensus(groups: Sequence[ClaimGroup]) -> List[ClaimGroupResult]:
        """The in-graph gate and one consensus dispatch per group."""
        results = []
        for group in groups:
            out, ok = dispatch_group(group.blocks, None, group.cfg, sanitized=True)
            results.append(ClaimGroupResult(group.claims, out, ok, group.blocks))
        return results

    def __call__(self, requests: Sequence[Request]) -> List[ClaimGroupResult]:
        if not requests:
            return []
        vectors = self.forward(self.pack(requests))
        return self.consensus(self.fleets(requests, vectors))
