"""Micro-batch assembly: many claims, one packed forward.

Mirrors the assembly order of
:meth:`svoc_tpu.serving.batcher.MicroBatcher.assemble`
(``batcher.py:59-92``) over a plain per-claim queue, and
``MicroBatcher.group_by_claim`` (``:142-160``).  The order is a
round-robin over the claims in registration order, one request per claim
per round: fair (a deep queue cannot take a whole batch) and replayable.
The ``ServingFrontend`` (admission, shedding, cold-shape deferral), the
result cache and the hash-once dedup are not ported yet (ROADMAP A10).
"""

from __future__ import annotations

import collections
from typing import Dict, Iterable, List, NamedTuple, Sequence

import torch


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
