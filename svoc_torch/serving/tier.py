"""The serving tier: submit → micro-batch → fabric → respond, and the
device half of one multi-claim serving step.

:class:`ServingTier` mirrors :class:`svoc_tpu.serving.tier.ServingTier`
(``tier.py:45-521``), the reference's request path in front of the claim
fabric:

- :meth:`ServingTier.submit` is the ingestion edge: cache, admission and
  bounded queues (:class:`~svoc_torch.serving.frontend.ServingFrontend`).
- :meth:`ServingTier.step` is one continuous-batching cycle: the
  :class:`~svoc_torch.serving.batcher.MicroBatcher` assembles a fair
  cross-claim micro-batch, one packed forward vectorizes every cache
  miss, the results fill the dedup cache, and the per-claim vector groups
  feed the request-fed fabric cycle (``MultiSession.step(feeds=...)``:
  the sanitised claim-cube consensus, then each claim's resilient
  commit).  Completion observes each request's latency into
  ``request_latency_seconds``, whose SLO's burn rate closes the
  admission loop.
- The clock is injectable: seeded scenarios
  (:mod:`svoc_torch.serving.scenario`) drive virtual time, so latencies,
  burn rates and shed decisions replay byte for byte.

The tier owns no thread (``run_loop`` is the daemon-thread convenience,
and under ``warmup_mode="prewarm"`` it starts the compile plane's
background prewarm first, ``tier.py:424-446``).  Its ``prewarmer`` is the
injected worker or the router's; while that worker's walk is in flight,
a claim whose dispatch group is still cold has its cache misses queued
and deferred (``serving.deferred{reason="cold_shape"}``); no worker, or a
finished one, defers nothing.  ``attach(console)`` exposes the tier
through :class:`svoc_torch.apps.commands.CommandConsole`.

:class:`ClaimServingStep` mirrors the device path of
:meth:`svoc_tpu.serving.tier.ServingTier._step_inner`
(``tier.py:197-300``) in the router's ``sanitized_dispatch`` mode, at
the flagship's shape and with the fleets drawn in one batched pass:
assembled requests → one cross-claim packed forward → per-claim vector
groups → each claim's rolling request window and bootstrap fleet → one
gate-and-consensus dispatch per shape/config group over the padded claim
cube.  The forward is the packed-flash one (the step sets
``cfg.attention = "flash"`` itself), so on CUDA that is 12
flash-attention launches (ROBERTA_GO_EMOTIONS) and one launch of the
gated claim-cube kernel per group.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from svoc_torch.apps.session import PREDICTION_WINDOW, fleet_block, tamper_block, window_positions
from svoc_torch.consensus.kernel import ConsensusConfig, ConsensusOutput
from svoc_torch.fabric.registry import ClaimSpec
from svoc_torch.fabric.router import dispatch_group
from svoc_torch.models.configs import ROBERTA_GO_EMOTIONS, EncoderConfig
from svoc_torch.models.packing import PackedBatch, pack_tokens_auto, strip_padding
from svoc_torch.models.sentiment import SentimentPipeline
from svoc_torch.obsplane.plane import resolve_cost_plane
from svoc_torch.serving.batcher import MicroBatcher, Request
from svoc_torch.serving.cache import ResultCache
from svoc_torch.serving.frontend import AdmissionConfig, ServingFrontend
from svoc_torch.sim import prng
from svoc_torch.sim.generators import claim_seed
from svoc_torch.utils.events import resolve_journal
from svoc_torch.utils.metrics import stage_span
from svoc_torch.utils.slo import REQUEST_LATENCY_HISTOGRAM, SLOEvaluator, serving_slos


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


class ServingTier:
    """Continuous-batching serving over a
    :class:`~svoc_torch.fabric.session.MultiSession`.

    ``vectorizer`` is the cross-claim vectorizer (None: the first claim
    session's, built on demand).  ``cost_plane`` resolves once here: the
    argument, then ``SVOC_COST_PLANE``, then the committed decision; the
    router shares the plane for its dispatch costs."""

    def __init__(
        self,
        multi,
        *,
        vectorizer=None,
        admission: Optional[AdmissionConfig] = None,
        cache: Optional[ResultCache] = None,
        cache_capacity: int = 4096,
        max_requests_per_step: int = 64,
        max_segments: int = 8,
        clock=None,
        slos: Optional[Sequence] = None,
        slo_clock=None,
        prewarmer=None,
        cost_plane=None,
    ):
        self.multi = multi
        self._metrics = multi.metrics
        self._journal = resolve_journal(multi.journal)
        self._clock = clock if clock is not None else time.monotonic
        if cache is None:
            cache = ResultCache(cache_capacity, metrics=self._metrics)
        #: The worker gating cold-shape deferrals: the injected one, else
        #: the router's (one ``MultiSession.start_prewarm`` wires both).
        self._prewarmer = prewarmer
        self.cost_plane = (
            cost_plane if cost_plane is not None
            else resolve_cost_plane(clock=self._clock, metrics=self._metrics)
        )
        self.multi.router.cost_plane = self.cost_plane
        self.frontend = ServingFrontend(
            multi, admission=admission, cache=cache, metrics=self._metrics,
            journal=self._journal, clock=self._clock, cold_gate=self._claim_cold,
            cost_plane=self.cost_plane,
        )
        self._vectorizer = vectorizer
        self.batcher = MicroBatcher(self.frontend, vectorizer, max_requests=max_requests_per_step,
                                    max_segments=max_segments, metrics=self._metrics)
        #: The serving SLOs (request_latency drives admission), on the
        #: tier's clock unless ``slo_clock`` says otherwise.
        self._evaluator = SLOEvaluator(
            slos if slos is not None else serving_slos(self._metrics),
            registry=self._metrics,
            journal=self._journal,
            clock=slo_clock if slo_clock is not None else self._clock,
        )
        self.steps = 0
        #: End-of-step hooks, called with the step report once every
        #: request is accounted; an exception is counted
        #: (``serving_hook_errors``) and never stops serving.
        self.post_step_hooks: List[Any] = []
        self._loop_thread: Optional[threading.Thread] = None
        self._loop_stop: Optional[threading.Event] = None

    @property
    def cache(self) -> ResultCache:
        return self.frontend.cache

    @property
    def prewarmer(self):
        """The active prewarm worker: the injected one, else whatever
        ``MultiSession.start_prewarm`` attached to the router."""
        return self._prewarmer if self._prewarmer is not None else self.multi.router.prewarmer

    def _claim_cold(self, claim_id: str) -> bool:
        """The frontend's cold-shape gate: True while an in-flight walk
        has not yet warmed this claim's dispatch group; no worker, or a
        finished one, defers nothing."""
        worker = self.prewarmer
        if worker is None or not worker.active:
            return False
        return worker.claim_cold(self.multi.get(claim_id).spec)

    def _resolve_vectorizer(self):
        if self._vectorizer is None:
            states = self.multi.registry.states()
            if not states:
                raise RuntimeError("serving tier has no claims to serve")
            self._vectorizer = states[0].session.vectorizer
            self.batcher.vectorizer = self._vectorizer
        return self._vectorizer

    # -- the ingestion edge ---------------------------------------------------

    def submit(self, claim_id: str, text: str) -> Dict[str, Any]:
        """One request through cache and admission.  The claim is looked
        up first (``KeyError`` for an unknown one), so no counter is made
        for an arbitrary client string."""
        state = self.multi.get(claim_id)
        self._metrics.counter("serving_submitted", labels={"claim": claim_id}).add(1)
        return self.frontend.submit(claim_id, text, state=state)

    # -- the continuous-batching cycle ----------------------------------------

    def step(self) -> Dict[str, Any]:
        """One serving cycle; returns the step report (requests drained,
        claims fed, the fabric's served and skipped claims, dropped
        requests, completion latencies)."""
        report = self._step_inner()
        for hook in list(self.post_step_hooks):
            try:
                hook(report)
            except Exception:  # noqa: BLE001 — a hook must not stop serving
                self._metrics.counter("serving_hook_errors").add(1)
        return report

    def _step_inner(self) -> Dict[str, Any]:
        self.steps += 1
        plane = self.cost_plane
        report: Dict[str, Any] = {"step": self.steps, "requests": 0, "claims": 0, "served": [],
                                  "skipped": {}, "dropped": 0, "latencies_s": []}
        with stage_span("serving_step"):
            dropped = self._purge_removed_claims()
            report["dropped"] = dropped
            requests = self.batcher.assemble()
            if not requests:
                # An idle tick still refreshes the burn gauges.
                self._evaluator.evaluate()
                return report
            plane.mark_requests(requests, "assembled")
            self._resolve_vectorizer()
            drained = len(requests)
            # Every drained request ends this step completed or dropped,
            # even when the step raises: `pending` holds the ones not yet
            # accounted, and the handler below drops them.
            pending = set(requests)

            def drop(request) -> None:
                nonlocal dropped
                self._metrics.counter("serving_dropped", labels={"claim": request.claim}).add(1)
                plane.complete(request, self._clock(), outcome="dropped")
                pending.discard(request)
                dropped += 1

            try:
                with stage_span("serving_batch"):
                    try:
                        vectors = self.batcher.vectorize_requests(requests)
                    except Exception:  # svoclint: disable=SVOC014 -- deliberate: the degrade engages two lines below where BOTH lanes into vectors=None share one counted serving_vectorize_errors increment
                        vectors = None
                if vectors is None:
                    # One poisoned text must not lose the whole micro-batch:
                    # vectorize request by request and drop only those
                    # that fail.
                    self._metrics.counter("serving_vectorize_errors").add(1)
                    survivors: List[Any] = []
                    vecs: List[np.ndarray] = []
                    for request in requests:
                        try:
                            vecs.append(self.batcher.vectorize([request.text])[0])
                            survivors.append(request)
                        except Exception:  # svoclint: disable=SVOC014 -- deliberate: drop() counts serving_dropped{claim=} and closes the request's timeline with outcome="dropped" — the closure is the accounting
                            drop(request)
                    requests, vectors = survivors, vecs
                plane.mark_requests(requests, "vectorized")
                for request, vector in zip(requests, vectors):
                    request.vector = np.asarray(vector, dtype=np.float64)  # svoclint: disable=SVOC001
                    self.cache.put(request.key, request.vector)
                if requests:
                    feeds = self.batcher.group_by_claim(requests)
                    fabric_report = self.multi.step(feeds=feeds)
                else:
                    feeds = {}
                    fabric_report = {"served": [], "skipped": {}}
                served_claims = set(fabric_report["served"])
                now = self._clock()
                latencies: List[float] = []
                for request in requests:
                    if request.claim not in served_claims:
                        # The fabric skipped the claim (paused, malformed
                        # feed, fetch error): its requests did not
                        # complete, and count against serving_admission.
                        drop(request)
                        continue
                    latency = max(0.0, now - request.t_submit)
                    latencies.append(latency)
                    self._metrics.histogram(REQUEST_LATENCY_HISTOGRAM).observe(latency)
                    self._metrics.counter("serving_completed", labels={"claim": request.claim}).add(1)
                    # Closed at the same `now` the histogram saw: the
                    # stages sum to the observed latency.
                    plane.complete(request, now)
                    pending.discard(request)
            except BaseException:
                for request in list(pending):
                    drop(request)
                raise
            finally:
                plane.end_step()
            report.update(requests=drained, claims=len(feeds), served=fabric_report["served"],
                          skipped=fabric_report["skipped"], dropped=dropped,
                          latencies_s=latencies)
            # Counts only: deterministic under a virtual clock.
            self._journal.emit("serving.step", step=self.steps, requests=drained,
                               claims=len(feeds), served=len(fabric_report["served"]))
            self._evaluator.evaluate()
        return report

    def _purge_removed_claims(self) -> int:
        """Purge the queues of claims that left the fabric and count every
        stranded request as dropped."""
        live = set(self.multi.claim_ids())
        n = 0
        for cid in [c for c in self.frontend.depths() if c not in live]:
            for request in self.frontend.purge(cid):
                self._metrics.counter("serving_dropped", labels={"claim": request.claim}).add(1)
                n += 1
        return n

    # -- the graceful drain ----------------------------------------------------

    def drain(self, max_steps: int = 16) -> Dict[str, Any]:
        """Stop admission (new misses shed with ``reason="draining"``),
        run up to ``max_steps`` cycles over the admitted queues, then
        purge what is left, each request journaled as
        ``serving.deferred{reason="draining"}``: every admitted request
        ends answered or deferred.  Idempotent."""
        self.frontend.set_draining(True)
        deferred = 0

        def defer(request) -> None:
            nonlocal deferred
            self._metrics.counter("serving_dropped", labels={"claim": request.claim}).add(1)
            self._journal.emit("serving.deferred", lineage=request.lineage, claim=request.claim,
                               seq=request.seq, reason="draining")
            deferred += 1

        # Paused claims first: the flush cannot serve them.
        for state in self.multi.registry.states():
            if state.paused:
                for request in self.frontend.purge(state.spec.claim_id):
                    defer(request)
        flushed_steps = 0
        while flushed_steps < max_steps and any(self.frontend.depths().values()):
            self.step()
            flushed_steps += 1
        for cid in list(self.frontend.depths()):
            for request in self.frontend.purge(cid):
                defer(request)
        return {"flush_steps": flushed_steps, "deferred": deferred,
                "queues_empty": not any(self.frontend.depths().values())}

    def serving_state_dict(self) -> Dict[str, Any]:
        """The tier's durable slice: queued requests, seq cursors and the
        step cursor."""
        return {"steps": self.steps, **self.frontend.state_dict()}

    def restore_serving_state(self, state: Dict[str, Any]) -> int:
        self.steps = max(self.steps, int(state.get("steps", 0)))
        return self.frontend.restore_state(state)

    # -- the background loop ---------------------------------------------------

    def run_loop(self, period_s: float = 0.05) -> threading.Event:
        """Drive :meth:`step` on a daemon thread every ``period_s``;
        returns the stop event.  A live loop is reused.  A raising step is
        counted (``serving_step_errors``) and the loop goes on.

        The live deployment's entry point, so it activates the pinned
        warmup routing: under ``warmup_mode="prewarm"`` the prewarm walk
        starts in the background before the first tick (cold shapes defer
        instead of loading inline).  After a recovery's primary-only walk
        this background pass adds the twins; warm keys are skipped.  A
        caller that drives :meth:`step` itself gets no warmup."""
        if self._loop_thread is not None and self._loop_thread.is_alive():
            return self._loop_stop
        if self.multi.router.warmup_mode == "prewarm":
            self.multi.start_prewarm(background=True)
        stop = threading.Event()

        def loop():
            while not stop.is_set():
                try:
                    self.step()
                except Exception:  # noqa: BLE001 — counted, the loop goes on
                    self._metrics.counter("serving_step_errors").add(1)
                stop.wait(period_s)

        self._loop_stop = stop  # svoc: volatile(thread handle; the serving loop is restarted explicitly after recovery)
        self._loop_thread = threading.Thread(target=loop, daemon=True)  # svoc: volatile(thread handle; see _loop_stop)
        self._loop_thread.start()
        return stop

    def stop_loop(self) -> None:
        if self._loop_stop is not None:
            self._loop_stop.set()

    # -- views ------------------------------------------------------------------

    def slo_snapshot(self) -> Dict[str, Any]:
        """Evaluate the serving SLOs."""
        return self._evaluator.evaluate()

    def snapshot(self) -> Dict[str, Any]:
        """Queues, admission counts, cache, latency and costs."""
        reg = self._metrics
        router = self.multi.router
        return {
            "steps": self.steps,
            "consensus_impl": router.consensus_impl,
            "mesh": router.mesh_spec,
            "warmup_mode": router.warmup_mode,
            "prewarm": self.prewarmer.stats() if self.prewarmer is not None else None,
            "deferred": reg.family_total("serving_deferred"),
            "queues": self.frontend.depths(),
            "submitted": reg.family_total("serving_submitted"),
            "admitted": reg.family_total("serving_admitted"),
            "cached": reg.family_total("serving_cached"),
            "shed": reg.family_total("serving_shed"),
            "completed": reg.family_total("serving_completed"),
            "dropped": reg.family_total("serving_dropped"),
            "cache": self.cache.stats(),
            "burn_rate": self.frontend.controller.burn_rate(),
            "latency": reg.histogram(REQUEST_LATENCY_HISTOGRAM).snapshot(),
            "costs": self.cost_plane.snapshot(),
        }

    def attach(self, console) -> None:
        """Expose the tier through a
        :class:`~svoc_torch.apps.commands.CommandConsole`: the ``serving``
        command, ``POST /api/submit``, and ``/api/state``'s serving
        section read it (``tier.py:516``)."""
        console.serving = self
