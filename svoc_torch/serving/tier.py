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

Admission and shedding, the result cache, latency accounting, and the
tier's SLOs, chain commits and journal events (over the claim fabric's
``MultiSession``) are not ported yet (ROADMAP A10).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from svoc_torch.apps.session import PREDICTION_WINDOW, fleet_block, tamper_block, window_positions
from svoc_torch.consensus.kernel import ConsensusConfig, ConsensusOutput
from svoc_torch.fabric.registry import ClaimSpec
from svoc_torch.fabric.router import dispatch_group
from svoc_torch.models.configs import ROBERTA_GO_EMOTIONS, EncoderConfig
from svoc_torch.models.packing import PackedBatch, pack_tokens_auto, strip_padding
from svoc_torch.models.sentiment import SentimentPipeline
from svoc_torch.serving.batcher import Request
from svoc_torch.sim import prng
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

    Each claim keeps its rolling window (at most ``PREDICTION_WINDOW``
    rows; all claims' in one device buffer) and its own key chain, the
    reference ``Session``'s (``svoc_tpu/fabric/session.py:159``,
    ``apps/session.py:604-615``): ``PRNGKey(spec.seed)``, or
    ``PRNGKey(claim_seed(seed, claim_id))`` when that is None, then
    ``key, sub = split(key)`` on every fetch of that claim and only then,
    ``sub`` drawing the fetch's fleet.  So one claim's fleets depend on
    its own requests only, and are ``gen_oracle_predictions``' bits.
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
        self.cycles = dict.fromkeys(self.specs, 0)
        self.row = {cid: i for i, cid in enumerate(self.specs)}
        #: [n_claims, PREDICTION_WINDOW, M]: claim c's kept window is
        #: window_buf[c, :window_len[c]], oldest row first.
        self.window_buf = torch.zeros(
            len(self.specs), PREDICTION_WINDOW, pipe.dimension, device=self.device
        )
        self.window_len = np.zeros(len(self.specs), dtype=np.int64)
        #: [n_claims, 2]: each claim's key, in registration order.
        self.keys = prng.PRNGKeys(
            [claim_seed(seed, cid) if spec.seed is None else spec.seed
             for cid, spec in self.specs.items()],
            self.device,
        )

    def pack(self, requests: Sequence[Request]) -> PackedBatch:
        """Tokenize (native) and pack (native) every request's text into
        the step's ``[rows, seq]`` shape; raises when they do not all
        fit."""
        tok = self.pipe.tokenizer
        ids, mask = tok([r.text for r in requests], self.seq)
        batch, n = pack_tokens_auto(
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
        consensus configuration in the order the claims first appear.

        Every fed claim's window follows :func:`window_positions` on the
        rows of its kept window and its new requests, in request order;
        the fed claims' keys advance in one batched ``split``; the
        claims that share a window bucket, a subset size, N, n_failing
        and M gather their tiled windows and build their fleets in one
        :func:`fleet_block` pass; then each tampered claim's block makes
        its round trip through its hook."""
        if vectors.shape[0] != len(requests):
            raise ValueError(f"{len(requests)} requests but {vectors.shape[0]} vectors")
        feeds: Dict[str, List[int]] = {}
        for i, request in enumerate(requests):
            feeds.setdefault(request.claim, []).append(i)
        fed = list(feeds)
        if not fed:
            return []
        rows = torch.tensor([self.row[cid] for cid in fed], device=self.device)
        pair = prng.split(self.keys[rows])  # [F, 2, 2]: key, sub = split(key)
        self.keys[rows] = pair[:, 0]
        subs = pair[:, 1]

        # Positions into src: claim c's kept row t at c * cap + t, request i at base + i.
        n_claims, cap, dim = self.window_buf.shape
        base = n_claims * cap
        src = torch.cat([self.window_buf.reshape(base, dim), vectors.to(self.window_buf.dtype)])
        batches: Dict[tuple, Tuple[List[int], List[np.ndarray]]] = {}
        kept_rows = []
        for j, cid in enumerate(fed):
            spec, c = self.specs[cid], self.row[cid]
            previous = int(self.window_len[c])
            kept, tiled, subset = window_positions(previous, len(feeds[cid]), cap)
            at = np.concatenate([c * cap + np.arange(previous), base + np.asarray(feeds[cid])])
            kept_rows.append(np.resize(at[kept], cap))  # rows past the kept length are unused
            self.window_len[c] = kept.size
            shape = (tiled.size, subset, spec.n_oracles, spec.n_failing, spec.dimension)
            members, tiles = batches.setdefault(shape, ([], []))
            members.append(j)
            tiles.append(at[tiled])
        blocks: List[Optional[torch.Tensor]] = [None] * len(fed)
        for (_, subset, *_), (members, tiles) in batches.items():
            spec = self.specs[fed[members[0]]]
            windows = src[torch.from_numpy(np.stack(tiles)).to(self.device)]  # [Cb, bucket, M]
            values, _ = fleet_block(subs[members], windows, spec, subset)
            for j, block in zip(members, values.unbind(0)):
                blocks[j] = block
        self.window_buf[rows] = src[torch.from_numpy(np.stack(kept_rows)).to(self.device)]

        groups: Dict[tuple, Tuple[List[str], List[torch.Tensor]]] = {}
        for cid, values in zip(fed, blocks):
            spec = self.specs[cid]
            if spec.tamper is not None:
                values = tamper_block(values, spec.tamper, self.cycles[cid])
            self.cycles[cid] += 1
            key = (spec.n_oracles, spec.dimension, spec.consensus_config())
            claims, group_blocks = groups.setdefault(key, ([], []))
            claims.append(cid)
            group_blocks.append(values)
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
