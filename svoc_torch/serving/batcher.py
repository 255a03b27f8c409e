"""Micro-batch assembly: many claims, one packed forward.

Mirrors :mod:`svoc_tpu.serving.batcher` (``batcher.py:1-160``):
:class:`MicroBatcher` assembles each serving step's micro-batch from a
:class:`~svoc_torch.serving.frontend.ServingFrontend` (``assemble``),
vectorizes it through one packed forward, deduplicated on each request's
admission-time digest (``vectorize_requests``, the hash-once rule;
``vectorize`` is its raw-text twin) and groups the vectors per claim
(``group_by_claim``).  The forward's segment axis is filled across
claims: short comments of many claims pack the rows one claim would
leave mostly empty (the pack stage exports the ``packing_fill_ratio``
gauges), and the per-claim groups feed one claim-cube dispatch.

The order is a round-robin over the claims in registration order, one
request per claim per round: fair (a deep queue cannot take a whole
batch) and replayable (the order is part of the seeded serving
fingerprint).  :class:`ClaimQueues`, :class:`Request` and the
module-level :func:`group_by_claim` are the same order over a plain
per-claim queue, for the device half of the step
(:class:`~svoc_torch.serving.tier.ClaimServingStep`).
"""

from __future__ import annotations

import collections
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from svoc_torch.serving.frontend import ServingFrontend, ServingRequest
from svoc_torch.utils.metrics import MetricsRegistry
from svoc_torch.utils.metrics import registry as _default_registry


class MicroBatcher:
    """Assembles one micro-batch a serving step and runs the shared
    cross-claim vectorize."""

    def __init__(self, frontend: ServingFrontend, vectorizer, *, max_requests: int = 64,
                 max_segments: int = 8, metrics: Optional[MetricsRegistry] = None):
        if max_requests < 1:
            raise ValueError("max_requests must be >= 1")
        self.frontend = frontend
        self.vectorizer = vectorizer
        self.max_requests = max_requests
        self.max_segments = max_segments
        self._metrics = metrics or _default_registry

    def assemble(self) -> List[ServingRequest]:
        """Drain up to ``max_requests`` pending requests, one per claim per
        round over the registration order.  A claim whose shape is still
        cold is skipped and keeps its queue."""
        picked: List[ServingRequest] = []
        order = [
            cid for cid in self.frontend.multi.claim_ids()
            if self.frontend.depth(cid) > 0 and not self.frontend.is_cold(cid)
        ]
        while order and len(picked) < self.max_requests:
            still_pending: List[str] = []
            for cid in order:
                if len(picked) >= self.max_requests:
                    break
                got = self.frontend.drain(cid, 1)
                if got:
                    picked.append(got[0])
                    if self.frontend.depth(cid) > 0:
                        still_pending.append(cid)
            order = still_pending
        if picked:
            self._metrics.counter("serving_batches").add(1)
            self._metrics.gauge("serving_batch_requests").set(len(picked))
            self._metrics.gauge("serving_batch_claims").set(len({r.claim for r in picked}))
        return picked

    def vectorize_requests(self, requests: Sequence[ServingRequest]) -> np.ndarray:
        """``[K, M]`` sentiment vectors of one micro-batch, deduplicated on
        each request's admission-time digest: a hot comment submitted to
        several claims in one step is forwarded once and fanned out, and
        no text is hashed again."""
        seen: Dict[str, int] = {}
        texts: List[str] = []
        for request in requests:
            if request.digest not in seen:
                seen[request.digest] = len(texts)
                texts.append(request.text)
        vectors = self._vectorize_unique(texts)
        if len(texts) == len(requests):
            return vectors
        return vectors[[seen[r.digest] for r in requests]]

    def vectorize(self, texts: Sequence[str]) -> np.ndarray:
        """Texts → ``[K, M]`` sentiment vectors, duplicate texts forwarded
        once (the raw-text twin of :meth:`vectorize_requests`)."""
        texts = list(texts)
        unique = list(dict.fromkeys(texts))
        vectors = self._vectorize_unique(unique)
        if len(unique) == len(texts):
            return vectors
        index = {text: i for i, text in enumerate(unique)}
        return vectors[[index[text] for text in texts]]

    def _vectorize_unique(self, texts: List[str]) -> np.ndarray:
        """The packed forward (``call_packed``) of a vectorizer that has
        one, else a plain call (the injected test and scenario
        vectorizers)."""
        call_packed = getattr(self.vectorizer, "call_packed", None)
        if call_packed is not None:
            return np.asarray(call_packed(list(texts), self.max_segments), dtype=np.float64)
        return np.asarray(self.vectorizer(list(texts)), dtype=np.float64)

    @staticmethod
    def group_by_claim(requests: Sequence[ServingRequest]) -> Dict[str, np.ndarray]:
        """The request-fed fabric's feeds: per-claim ``[K, M]`` float32
        stacks in request order; every request must carry its vector."""
        grouped: Dict[str, List[np.ndarray]] = {}
        for request in requests:
            if request.vector is None:
                raise ValueError(
                    f"request {request.request_id} has no vector — vectorize before grouping"
                )
            grouped.setdefault(request.claim, []).append(request.vector)
        return {cid: np.stack(vectors).astype(np.float32) for cid, vectors in grouped.items()}


class Request(NamedTuple):
    """One comment submitted to one claim."""

    claim: str
    text: str


class ClaimQueues:
    """Pending requests per claim, in the claims' registration order."""

    def __init__(self, claim_ids: Iterable[str]):
        self._queues: Dict[str, collections.deque] = {
            cid: collections.deque() for cid in claim_ids
        }

    def submit(self, claim: str, text: str) -> None:
        if claim not in self._queues:
            raise KeyError(f"unknown claim {claim!r}")
        self._queues[claim].append(Request(claim, text))

    def assemble(self, max_requests: int) -> List[Request]:
        """Drain up to ``max_requests`` pending requests, one per claim
        per round over the registration order."""
        if max_requests < 1:
            raise ValueError("max_requests must be >= 1")
        picked: List[Request] = []
        order = [cid for cid, q in self._queues.items() if q]
        while order and len(picked) < max_requests:
            still_pending = []
            for cid in order:
                if len(picked) >= max_requests:
                    break
                picked.append(self._queues[cid].popleft())
                if self._queues[cid]:
                    still_pending.append(cid)
            order = still_pending
        return picked


def group_by_claim(
    requests: Sequence[Request], vectors: torch.Tensor
) -> Dict[str, torch.Tensor]:
    """Per-claim ``[K, M]`` stacks of ``vectors [len(requests), M]`` (row
    ``i`` is request ``i``'s vector), in request order, claims in the
    order they first appear."""
    if vectors.shape[0] != len(requests):
        raise ValueError(f"{len(requests)} requests but {vectors.shape[0]} vectors")
    if not requests:
        return {}
    rows: Dict[str, List[int]] = {}
    for i, request in enumerate(requests):
        rows.setdefault(request.claim, []).append(i)
    # One gather into claim order, then a view per claim.
    order = torch.tensor([i for idx in rows.values() for i in idx], device=vectors.device)
    stacks = vectors[order].split([len(idx) for idx in rows.values()])
    return dict(zip(rows, stacks))
