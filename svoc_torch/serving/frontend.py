"""The ingestion front: bounded per-claim queues and admission control.

Mirrors :mod:`svoc_tpu.serving.frontend` (``frontend.py:1-515``), the
whole module.  Every submitted request lands in its claim's bounded
queue or is shed before it costs anything.  Admission is layered,
cheapest check first:

1. **Cache**: a ``(claim, text)`` hit is answered at once from the
   :class:`~svoc_torch.serving.cache.ResultCache` with the claim's latest
   consensus, and takes no queue slot (also while the tier sheds).
2. **Queue bound**: a full claim queue sheds with ``reason="queue_full"``;
   bounds are per claim, so one flooded claim never starves a sibling.
3. **SLO burn**: above the threshold of the live
   ``slo_burn_rate{slo="request_latency", window="fast"}`` gauge, a
   configured fraction of cache-miss traffic sheds with
   ``reason="slo_burn"``.

Every decision is deterministic: the burn-mode shed draw is a crc32 of
``(seed, claim, request seq)``, so a seeded replay sheds the same
requests.  Admitted and shed requests both emit journal events
(``serving.admitted`` / ``serving.shed``) on a lineage inside the
claim's family (``blk<scope>-<claim>-rq<seq>``).
"""

from __future__ import annotations

import dataclasses
import threading
import time
import zlib
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np

from svoc_torch.serving.cache import ResultCache, content_key_from_digest, text_digest
from svoc_torch.utils.events import resolve_journal
from svoc_torch.utils.metrics import MetricsRegistry
from svoc_torch.utils.metrics import registry as _default_registry
from svoc_torch.utils.rounding import round6_list


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """The admission policy's knobs.  ``shed_fraction`` is the fraction
    of cache-miss traffic dropped while the burn gauge is at or above
    ``burn_threshold`` (1.0: every miss), chosen by the draw ``seed``
    keys."""

    queue_capacity: int = 64
    burn_slo: str = "request_latency"
    burn_window: str = "fast"
    #: Well under the 14.4× page threshold: shedding should prevent the
    #: page, not follow it.
    burn_threshold: float = 4.0
    shed_fraction: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.queue_capacity < 1:
            raise ValueError("queue_capacity must be >= 1")
        if not 0.0 <= self.shed_fraction <= 1.0:
            raise ValueError("shed_fraction must be in [0, 1]")
        if self.burn_threshold <= 0.0:
            raise ValueError("burn_threshold must be > 0")


@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    action: str  # "admit" | "shed"
    reason: str = ""


class AdmissionController:
    """Deterministic admit/shed policy over queue depth and the burn
    gauge."""

    def __init__(self, config: Optional[AdmissionConfig] = None, *,
                 metrics: Optional[MetricsRegistry] = None):
        self.config = config or AdmissionConfig()
        self._metrics = metrics or _default_registry

    def burn_rate(self) -> float:
        """The live fast-window burn of the configured SLO (0 until the
        evaluator's first pass: a cold tier admits everything)."""
        return self._metrics.gauge(
            "slo_burn_rate",
            labels={"slo": self.config.burn_slo, "window": self.config.burn_window},
        ).get()

    def _shed_draw(self, claim_id: str, seq: int) -> float:
        """Uniform [0, 1) from a crc32 of (seed, claim, seq)."""
        return zlib.crc32(f"{self.config.seed}:{claim_id}:{seq}".encode()) / 2**32

    def decide(self, claim_id: str, queue_depth: int, seq: int) -> AdmissionDecision:
        cfg = self.config
        if queue_depth >= cfg.queue_capacity:
            return AdmissionDecision("shed", "queue_full")
        if self.burn_rate() >= cfg.burn_threshold:
            if self._shed_draw(claim_id, seq) < cfg.shed_fraction:
                return AdmissionDecision("shed", "slo_burn")
        return AdmissionDecision("admit")


class ServingRequest:
    """One in-flight request: claim, text, content digest and key,
    lineage, and the slots the batcher fills."""

    __slots__ = ("claim", "text", "seq", "request_id", "lineage", "digest", "key",
                 "t_submit", "vector", "timeline")

    def __init__(self, claim: str, text: str, seq: int, lineage: str, t_submit: float,
                 key: Optional[str] = None, digest: Optional[str] = None):
        self.claim = claim
        self.text = text
        self.seq = seq
        self.request_id = f"{claim}:{seq}"
        self.lineage = lineage
        # Hashed once at admission; the cache key and the batcher's
        # in-batch dedup reuse the digest.
        self.digest = digest if digest is not None else text_digest(text)
        self.key = key if key is not None else content_key_from_digest(claim, self.digest)
        self.t_submit = t_submit
        self.vector: Optional[np.ndarray] = None
        #: The cost plane's timeline, attached at admission when the plane
        #: is on; None otherwise and for requests restored from a
        #: snapshot (a timeline across a restart would mix two clocks).
        self.timeline = None


class ServingFrontend:
    """Per-claim bounded queues and the admission controller, over a
    :class:`~svoc_torch.fabric.session.MultiSession`'s claims.

    ``cold_gate(claim_id) -> bool`` says whether a claim's consensus
    shape is still being prepared: its cache-miss submissions are then
    queued but deferred (``serving.deferred{reason="cold_shape"}``) and
    the batcher skips the claim.  The serving tier passes its
    ``_claim_cold``, which asks the prewarm worker while a walk is in
    flight; None (the default) defers nothing."""

    def __init__(self, multi, *, admission: Optional[AdmissionConfig] = None,
                 cache: Optional[ResultCache] = None, metrics: Optional[MetricsRegistry] = None,
                 journal=None, clock=None, cold_gate=None, cost_plane=None):
        self.multi = multi
        self._metrics = metrics or _default_registry
        self._journal = resolve_journal(journal)
        self._clock = clock if clock is not None else time.monotonic
        self.cache = cache if cache is not None else ResultCache(metrics=self._metrics)
        self.controller = AdmissionController(admission, metrics=self._metrics)
        self._lock = threading.Lock()
        self._queues: Dict[str, deque] = {}
        self._seqs: Dict[str, int] = {}
        #: The graceful-drain latch: while set, every cache-miss
        #: submission sheds with ``reason="draining"``; cache hits still
        #: answer.
        self._draining = False
        self._cold_gate = cold_gate
        #: The cost-attribution plane; None or disabled leaves the submit
        #: path and its journal events unchanged.
        self._cost_plane = cost_plane

    # -- the submit path ----------------------------------------------------

    def submit(self, claim_id: str, text: str, state=None) -> Dict[str, Any]:
        """One request through admission.  The response's ``status`` is
        ``"cached"`` (answered now, with the vector and the claim's
        latest consensus), ``"admitted"`` (queued), ``"deferred"``
        (queued, the claim's shape still cold) or ``"shed"`` (with its
        reason).  Raises ``KeyError`` for an unknown claim.  ``state`` is
        the claim's state when the caller already looked it up."""
        if state is None:
            state = self.multi.get(claim_id)
        prefix = state.session.lineage_prefix
        with self._lock:
            seq = self._seqs.get(claim_id, 0) + 1
            self._seqs[claim_id] = seq
        lineage = f"{prefix}-rq{seq:06x}"
        digest = text_digest(text)
        key = content_key_from_digest(claim_id, digest)
        cached = self.cache.get(key)
        if cached is not None:
            self._metrics.counter("serving_cached", labels={"claim": claim_id}).add(1)
            self._journal.emit("serving.admitted", lineage=lineage, claim=claim_id, seq=seq,
                               source="cache")
            return {
                "status": "cached",
                "claim": claim_id,
                "request_id": f"{claim_id}:{seq}",
                "lineage": lineage,
                "vector": round6_list(cached),
                "consensus": state.last_consensus,
            }
        request = ServingRequest(claim_id, text, seq, lineage, self._clock(), key=key,
                                 digest=digest)
        plane = self._cost_plane
        if plane is not None and plane.enabled:
            # The admission mark is t_submit: the queue wait starts here.
            request.timeline = plane.timeline_for(lineage, claim_id, request.t_submit)
        deferred = self.is_cold(claim_id)
        with self._lock:
            q = self._queues.setdefault(claim_id, deque())
            if self._draining:
                decision = AdmissionDecision("shed", "draining")
            else:
                decision = self.controller.decide(claim_id, len(q), seq)
            if decision.action == "admit":
                q.append(request)
                depth = len(q)
        if decision.action == "admit":
            self._metrics.counter("serving_admitted", labels={"claim": claim_id}).add(1)
            self._metrics.gauge("serving_queue_depth", labels={"claim": claim_id}).set(depth)
            # Emitted outside the frontend lock: the journal lock is a leaf.
            self._journal.emit("serving.admitted", lineage=lineage, claim=claim_id, seq=seq,
                               source="queue")
            if deferred:
                self._metrics.counter(
                    "serving_deferred", labels={"claim": claim_id, "reason": "cold_shape"}
                ).add(1)
                self._journal.emit("serving.deferred", lineage=lineage, claim=claim_id, seq=seq,
                                   reason="cold_shape")
                return {
                    "status": "deferred",
                    "claim": claim_id,
                    "request_id": request.request_id,
                    "lineage": lineage,
                    "queue_depth": depth,
                    "reason": "cold_shape",
                }
            return {
                "status": "admitted",
                "claim": claim_id,
                "request_id": request.request_id,
                "lineage": lineage,
                "queue_depth": depth,
            }
        self._metrics.counter(
            "serving_shed", labels={"claim": claim_id, "reason": decision.reason}
        ).add(1)
        self._journal.emit("serving.shed", lineage=lineage, claim=claim_id, seq=seq,
                           reason=decision.reason)
        if plane is not None and plane.enabled:
            plane.shed(lineage, claim_id, decision.reason)
        return {
            "status": "shed",
            "claim": claim_id,
            "request_id": request.request_id,
            "lineage": lineage,
            "reason": decision.reason,
        }

    def is_cold(self, claim_id: str) -> bool:
        """Whether the claim's shape is still cold.  False without a
        gate, and False when the gate raises (counted under
        ``serving_cold_gate_errors``): a broken probe serves now rather
        than defer forever."""
        gate = self._cold_gate
        if gate is None:
            return False
        try:
            return bool(gate(claim_id))
        except Exception:  # noqa: BLE001 — degrade open, counted
            self._metrics.counter("serving_cold_gate_errors").add(1)
            return False

    def set_draining(self, draining: bool = True) -> None:
        """Set or clear the drain latch."""
        with self._lock:
            self._draining = bool(draining)  # svoc: volatile(per-process drain latch; a restarted process starts undrained by definition)

    @property
    def draining(self) -> bool:
        with self._lock:
            return self._draining

    # -- snapshot and restore -----------------------------------------------

    def state_dict(self) -> Dict[str, Any]:
        """Queued requests and the per-claim seq cursors, JSON-safe.  The
        seqs must survive a restart: lineages are minted from them."""
        with self._lock:
            return {
                "seqs": dict(self._seqs),
                "queues": {
                    cid: [{"text": r.text, "seq": r.seq, "lineage": r.lineage,
                           "t_submit": r.t_submit} for r in q]
                    for cid, q in self._queues.items()
                    if q
                },
            }

    def restore_state(self, state: Dict[str, Any]) -> int:
        """Re-enqueue snapshotted requests and restore the seq cursors
        (max-merged: a cursor never moves back); returns the number of
        requests re-enqueued."""
        n = 0
        with self._lock:
            for cid, seq in (state.get("seqs") or {}).items():
                self._seqs[cid] = max(self._seqs.get(cid, 0), int(seq))
            for cid, entries in (state.get("queues") or {}).items():
                q = self._queues.setdefault(cid, deque())
                for e in entries:
                    q.append(ServingRequest(cid, e["text"], int(e["seq"]), e["lineage"],
                                            float(e.get("t_submit", 0.0))))
                    n += 1
                self._metrics.gauge("serving_queue_depth", labels={"claim": cid}).set(len(q))
        return n

    # -- the batcher's side -------------------------------------------------

    def depth(self, claim_id: str) -> int:
        with self._lock:
            q = self._queues.get(claim_id)
            return len(q) if q else 0

    def depths(self) -> Dict[str, int]:
        with self._lock:
            return {cid: len(q) for cid, q in self._queues.items()}

    def purge(self, claim_id: str) -> List[ServingRequest]:
        """Drop a claim's queue (the claim left the fabric); returns the
        stranded requests for the caller to account as dropped."""
        with self._lock:
            q = self._queues.pop(claim_id, None)
            out = list(q) if q else []
        if out:
            self._metrics.gauge("serving_queue_depth", labels={"claim": claim_id}).set(0)
        return out

    def drain(self, claim_id: str, limit: int) -> List[ServingRequest]:
        """Pop up to ``limit`` queued requests (FIFO) and refresh the depth
        gauge."""
        out: List[ServingRequest] = []
        with self._lock:
            q = self._queues.get(claim_id)
            if not q:
                return out
            while q and len(out) < limit:
                out.append(q.popleft())
            depth = len(q)
        if out:
            self._metrics.gauge("serving_queue_depth", labels={"claim": claim_id}).set(depth)
        return out
