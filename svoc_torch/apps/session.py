"""Session state + the fetch/commit engine of one claim.

Mirrors :mod:`svoc_tpu.apps.session` (``session.py:1-1158``): the
``Session`` with its store-driven and request-fed fetch, the quarantine
gate, the faithful ``commit`` and the resilient ``commit_resilient``
(retry and resume, the circuit breaker, the fleet supervisor), the
journal, the SLOs and the preview statistics; and the window rule and
fleet block the serving tier shares (:func:`window_positions`,
:func:`request_window`, :func:`fleet_block`, :func:`tamper_block`).

The reference keeps everything in the mutable ``globalState`` singleton
(``client/common.py:36-77``) and spreads the fetch path over
``oracle_scheduler.py`` (``simulation_fetch`` → ``sentiment_analysis`` →
``gen_oracles_predictions`` → ``predictions_to_eel_values``).  Here the
session is an explicit object owning:

- the comment store + circular cursor (``globalState.simulation_step``),
- the sentiment vectorizer (injectable so tests and the synthetic mode
  skip transformer weights),
- the fleet draws from its own threefry key chain,
- the chain adapter (local simulator or Sepolia),
- the last fleet predictions (``globalState.predictions``).

Where the port departs from the reference:

- ``Session(device=None)`` resolves through :mod:`svoc_torch.device`:
  it means CUDA and raises without a card.  The fleet is drawn on that
  device (the fleet-draws kernel on CUDA), fetched to the host as float64
  in one copy (with its honest mask), and the gate, the tamper hook and
  the preview statistics read that host block: a ``[N, M]`` fleet is
  too small to pay device launches, and a tampered block needs no
  round trip back.
- ``quant_inference="int8"`` serves the default vectorizer through the
  W8A8 forward (:mod:`svoc_torch.models.quant`), folded from its float
  weights.  With more than one card (and a batch of 32 that divides
  over them) the default vectorizer splits its rows over a data mesh of
  every card, one slot each (``svoc_tpu/apps/session.py:424-437``); on
  one card or the CPU it has none.
- The WAL (``attach_wal``) is duck-typed, as the chain adapter's hooks
  are: :class:`svoc_torch.durability.wal.CommitIntentWAL` is the one the
  durable scenario attaches.  A commit on a lineage whose WAL cycle is
  still open reconciles it first, under the commit lock, as the
  reference does (``durability/reconcile``).
- ``commit_mode=None`` resolves ``SVOC_COMMIT_MODE``, then the port's
  constant default (:func:`svoc_torch.resilience.retry.resolve_commit_mode`).

Defaults mirror ``client/common.py:7-31``: 7 oracles, 2 failing, window
50/limit 30, bootstrap subset 10, 6 go_emotions labels, 5 s refresh.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from svoc_torch.consensus.state import OracleConsensusContract
from svoc_torch.device import resolve_device
from svoc_torch.io.chain import ChainAdapter, ChainCommitError, LocalChainBackend
from svoc_torch.io.comment_store import (
    PREDICTION_WINDOW,
    SQL_FETCH_LIMIT,
    CommentStore,
)
from svoc_torch.ops.stats import rank_array
from svoc_torch.resilience.breaker import CircuitBreaker, CircuitOpenError
from svoc_torch.resilience.retry import (
    CommitOutcome,
    RetryPolicy,
    commit_fleet_with_resume,
    resolve_commit_mode,
    validate_commit_mode,
)
from svoc_torch.resilience.supervisor import (
    FleetHealthSupervisor,
    SupervisorConfig,
)
from svoc_torch.robustness.sanitize import (
    QuarantinedInputError,
    QuarantineGate,
    QuarantineReport,
    SanitizeConfig,
)
from svoc_torch.sim import prng
from svoc_torch.sim.oracle import assemble_fleet, draw_fleet
from svoc_torch.utils.events import audit_record, lineage_scope, mint_lineage
from svoc_torch.utils.events import journal as event_journal
from svoc_torch.utils.metrics import registry as metrics
from svoc_torch.utils.metrics import stage_span, tracer

#: Bootstrap subset of an honest oracle (``SessionConfig.bootstrap_subset``).
BOOTSTRAP_SUBSET = 10


class EmptyStoreError(RuntimeError):
    """Fetch found no comments.  Interactive ``fetch`` surfaces it as an
    error (the reference's fetch on an empty DB also fails); the
    auto-fetch loop treats it as *waiting for ingest* — in live mode the
    scraper and the fetch loop start together, so the first fetch can
    legitimately race the first scrape."""


class DegenerateBlockError(RuntimeError):
    """Committing this block would panic the on-chain consensus: the
    contract's golden recompute divides by a zero standard deviation
    when every reliable prediction agrees exactly in some dimension
    (``math.cairo:320-338`` skewness over a zero-variance sample — an
    i128 division by zero, which reverts the transaction).

    A request-fed cold start produces exactly this shape (one comment →
    every honest bootstrap averages the same vector), so both commit
    paths dry-run the faithful engine on **request-fed blocks** and
    refuse pre-tx — the serving tier defers the chain write
    (``commit.deferred``) instead of stranding the last signer and
    churning the supervisor's replacement clock over deterministic
    math.  Store-driven blocks keep their exact historical commit
    semantics (partial fleets land, per-oracle failures charge the
    supervisor), which tier-1 pins."""


@dataclasses.dataclass
class SessionConfig:
    """``client/common.py:7-31`` constants, as explicit configuration."""

    n_oracles: int = 7
    n_failing: int = 2
    dimension: int = 6
    bootstrap_subset: int = 10
    window: int = PREDICTION_WINDOW
    fetch_limit: int = SQL_FETCH_LIMIT
    #: auto-fetch period (SIMULATION_REFRESH_RATE, common.py:11).
    refresh_rate_s: float = 5.0
    #: scraper period (scraper.py:21 default 600 s) — a separate cadence.
    scraper_rate_s: float = 600.0
    #: use the live Selenium HN source when available (else synthetic).
    live_scraper: bool = False
    constrained: bool = True
    max_spread: float = 0.0
    required_majority: int = 2
    n_admins: int = 3
    seed: int = 0
    #: Sequence-packed inference for the default vectorizer — several
    #: comments per fixed device row (:mod:`svoc_torch.models.packing`),
    #: ~3× fewer forward rows on HN-shaped comments with identical
    #: results to float tolerance.  The default.
    packed_inference: bool = True
    #: ``"int8"`` serves the default vectorizer through the W8A8
    #: dynamic-PTQ forward (:mod:`svoc_torch.models.quant`), within
    #: quantization tolerance of the float one.  None keeps the float
    #: forward.
    quant_inference: Optional[str] = None
    #: Deployment info (``data/contract_info.json`` fields).
    declared_address: Optional[str] = None
    deployed_address: Optional[str] = None
    #: Resilience layer (docs/RESILIENCE.md).  The retry policy drives
    #: ``commit_resilient`` (the auto loop's commit: decorrelated-jitter
    #: backoff + resume of partial fleets); both dataclasses are frozen,
    #: so they are safe as field defaults.
    commit_retry: RetryPolicy = RetryPolicy()
    supervisor: SupervisorConfig = SupervisorConfig()
    #: Fleet health supervision in the auto loop (False = observe-only
    #: sessions: scores still accrue, no automatic replacement votes).
    supervise_fleet: bool = True
    #: Chain circuit breaker: consecutive-failure trip threshold and
    #: the open→half-open reset window.
    breaker_failure_threshold: int = 5
    breaker_reset_s: float = 30.0
    #: Input-integrity quarantine gate ahead of the commit path
    #: (docs/ROBUSTNESS.md): NaN/Inf, value-domain and wsad/felt-codec
    #: checks on every fetched fleet block.  The faithful ``commit``
    #: refuses a dirty block outright; ``commit_resilient`` skips the
    #: quarantined slots and charges them to the oracle's health.
    quarantine_gate: bool = True
    #: Multi-claim fabric (docs/FABRIC.md): the claim (market/story)
    #: this session serves.  When set, lineage ids are minted as
    #: ``blk<scope>-<claim>-<n>`` so one process journal partitions
    #: per claim, the supervisor/breaker series carry a claim label,
    #: and :class:`svoc_torch.fabric.MultiSession` can own many such
    #: sessions side by side.  None = a single-claim session.
    claim: Optional[str] = None
    #: Lineage scope override (seeded fabric scenarios): replay
    #: identity needs two runs to mint IDENTICAL lineage ids, which the
    #: process-unique default ordinal deliberately prevents — only pin
    #: this together with a FRESH ``journal=`` (else two sessions'
    #: audit records merge, the exact bug the scope exists to stop).
    lineage_scope: Optional[str] = None
    #: Commit-plane mode (docs/RESILIENCE.md §batched-commits):
    #: ``"per_tx"`` keeps the reference's one-signed-tx-per-oracle
    #: loop; ``"batched"`` sends a clean fleet as ONE chain RPC (and,
    #: with a WAL attached, one fsynced intent per cycle instead of one
    #: per tx) with counted per-tx fallbacks — identical chain state
    #: and journal events either way.  None resolves ``SVOC_COMMIT_MODE``
    #: > the port's default ONCE at construction
    #: (:func:`svoc_torch.resilience.retry.resolve_commit_mode`) — the
    #: WAL record family a seeded crash replay produces depends on the
    #: mode, so it must not drift mid-run.
    commit_mode: Optional[str] = None


def preview_stats(values: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``predictions_to_eel_values`` math (``oracle_scheduler.py:106-134``,
    the reference's ``_preview_stats``, ``session.py:188-199``) on a
    ``[N, M]`` float32 block: fleet mean, fleet median, and per-oracle
    normalized rank of deviation from the MEDIAN (rank 0 = most deviant —
    suspected failing).  The median is ``jnp.median``'s: the mean of the
    two middle values for an even N (``torch.median`` would return the
    lower one), NaN in a column whose values hold a NaN."""
    n = values.shape[0]
    mean = values.mean(dim=0)
    ordered = values.sort(dim=0).values  # NaN sorts last, as in jnp.sort
    median = (ordered[(n - 1) // 2] + ordered[n // 2]) / 2
    median = torch.where(values.isnan().any(dim=0), torch.nan, median)
    dev = torch.linalg.vector_norm(values - median[None, :], dim=-1)
    normalized, _ranks = rank_array(dev)
    return mean, median, normalized


def _default_contract(cfg: SessionConfig, device=None) -> OracleConsensusContract:
    """A local contract with synthetic felt-style addresses (admins
    0xA0…, oracles 0x10…, the test fixtures' role layout); its batched
    commit's certification sweep runs on ``device``."""
    return OracleConsensusContract(
        admins=[0xA0 + i for i in range(cfg.n_admins)],
        oracles=[0x10 + i for i in range(cfg.n_oracles)],
        required_majority=cfg.required_majority,
        n_failing_oracles=cfg.n_failing,
        constrained=cfg.constrained,
        unconstrained_max_spread=cfg.max_spread,
        dimension=cfg.dimension,
        device=device,
    )


class Session:
    """One client session (the ``globalState`` replacement)."""

    def __init__(
        self,
        config: Optional[SessionConfig] = None,
        store: Optional[CommentStore] = None,
        vectorizer: Optional[Callable[[Sequence[str]], np.ndarray]] = None,
        adapter: Optional[ChainAdapter] = None,
        journal=None,
        device=None,
    ):
        self.config = config or SessionConfig()
        #: Where the fleet is drawn, the default vectorizer runs and the
        #: default contract sweeps: ``None`` means CUDA (raising here
        #: without a card).
        self.device = resolve_device(device)
        self.store = store or CommentStore()
        self._vectorizer = vectorizer
        self.adapter = adapter or ChainAdapter(
            LocalChainBackend(_default_contract(self.config, self.device))
        )
        #: Event journal this session emits into — the process default
        #: unless injected (the multi-claim fabric's seeded smoke runs
        #: two whole MultiSessions and asserts byte-identical per-claim
        #: fingerprints, which needs fresh journals whose seqs restart
        #: at 1; docs/FABRIC.md).
        self.journal = journal if journal is not None else event_journal
        #: Per-backend circuit breaker: the auto loop's commits consult
        #: it, so a dead chain degrades to cheap short-circuits instead
        #: of a retry storm (state lives in /metrics as
        #: ``circuit_breaker_state{backend="chain"}``; claim sessions
        #: get their own series — ``backend="chain[<claim>]"`` — so one
        #: claim's dead chain never masks its siblings' health).
        breaker_name = (
            f"chain[{self.config.claim}]" if self.config.claim else "chain"
        )
        self.breaker = CircuitBreaker(
            breaker_name,
            failure_threshold=self.config.breaker_failure_threshold,
            reset_timeout_s=self.config.breaker_reset_s,
            registry=metrics,
            journal=self.journal,
        )
        #: Fleet health supervisor: commit-failure history + on-chain
        #: reliability → hysteresis scores → automatic replacement votes
        #: (the paper's admin mechanism, driven instead of manual).
        self.supervisor = FleetHealthSupervisor(
            self.adapter,
            self.config.supervisor,
            registry=metrics,
            journal=self.journal,
            claim=self.config.claim,
        )
        #: Input-integrity gate (docs/ROBUSTNESS.md): bounds derived
        #: from the consensus model — the contract's [0,1] interval for
        #: constrained sessions, codec-window-only for unconstrained.
        self.gate = QuarantineGate(
            SanitizeConfig.for_consensus(self.config.constrained),
            registry=metrics,
            journal=self.journal,
        )
        #: Commit-intent WAL (docs/RESILIENCE.md §durability): when
        #: attached (:meth:`attach_wal`), every ``commit_resilient``
        #: cycle journals fsynced per-tx intent/landed records so a
        #: SIGKILL at any instruction leaves enough evidence to resume
        #: EXACTLY the stranded suffix on restart — zero duplicate txs.
        #: None = an in-memory-only session.
        self.wal = None
        #: The resolved commit-plane mode, pinned at construction (the
        #: replay rule — see ``SessionConfig.commit_mode``).  Resolving
        #: here keeps the env read OFF the commit hot path.
        self.commit_mode = (
            validate_commit_mode(self.config.commit_mode, "SessionConfig")
            if self.config.commit_mode is not None
            else resolve_commit_mode()
        )
        #: Last gate verdict over the fetched fleet (written with the
        #: predictions it describes, under the session lock).
        self.last_quarantine: Optional[QuarantineReport] = None
        #: Lineage id of the last PUBLISHED fleet block (minted per
        #: fetch claim, ``svoc_torch.utils.events.mint_lineage``) — the
        #: key every event/span of that block carries, and what the
        #: console's ``audit`` command defaults to.  Prefixed with a
        #: process-unique session scope: several sessions share one
        #: process journal, and without the scope each would mint
        #: ``blk-000001`` for its first fetch and their audit records
        #: would merge.
        self.last_lineage: Optional[str] = None
        scope = (
            self.config.lineage_scope
            if self.config.lineage_scope is not None
            else lineage_scope()
        )
        #: ``blk<scope>`` for single-claim sessions, ``blk<scope>-<claim>``
        #: under the fabric — every lineage id this session mints starts
        #: with it, so one journal partitions cleanly per claim.
        self.lineage_prefix = (
            f"blk{scope}-{self.config.claim}"
            if self.config.claim
            else f"blk{scope}"
        )
        self.predictions: Optional[np.ndarray] = None
        self.last_preview: Optional[Dict] = None
        #: Rolling request-context window (request-driven serving,
        #: docs/SERVING.md): consensus in pull mode runs over a
        #: ``config.window``-comment store window, so the serving tier
        #: must not degrade it to "this step's requests only" — a
        #: 1-request block would make every honest bootstrap identical
        #: and the faithful commit would panic on-chain (zero-variance
        #: skewness, ``math.cairo:320-338``).  ``fetch(window=...)``
        #: appends each feed here and serves consensus over the last
        #: ``config.window`` vectors: the claim's recent sentiment plus
        #: the new requests, exactly the pull-mode window semantics.
        self._request_window: Optional[np.ndarray] = None
        #: Source of the published block: ``"store"`` (pull-mode scrape
        #: window) or ``"serving"`` (request-fed, ``fetch(window=...)``).
        #: The commit paths read it to scope the degeneracy dry-run to
        #: request-fed blocks only — store-driven commits keep their
        #: exact historical semantics (partial fleets, per-oracle
        #: failures), which tier-1 pins.
        self._block_source: str = "store"
        #: Lazy SLO evaluator (``svoc_torch.utils.slo``) over the shared
        #: registry — built on first use so sessions that never ask for
        #: burn rates pay nothing.
        self._slo = None
        #: Bumped on every state change the UI renders (fetch, commit,
        #: resume) — the web UI's poll loop redraws only when this
        #: changes, so auto_fetch/auto_commit/auto_resume surface live
        #: (the eel UI repaints on every push, simulation_graphics.js:85).
        self.state_version: int = 0
        self.simulation_step: int = 0
        self.auto_fetch: bool = False
        #: fetch ⇒ commit (help text web_interface.py:22; unimplemented
        #: in the reference).  Functional here through
        #: :meth:`commit_resilient` — backoff + resume + breaker, so a
        #: flaky chain degrades the loop instead of killing it.
        self.auto_commit: bool = False
        #: commit ⇒ resume (help text web_interface.py:23; also
        #: unimplemented in the reference).  Toggle via
        #: :meth:`set_auto_flags` so the web UI sees the change live.
        self.auto_resume: bool = False
        self.application_on: bool = True
        #: The fleet's threefry key chain on ``device`` (``PRNGKey(seed)``,
        #: split once per fetch), made at the first fetch.
        self._key_value = None
        #: Concurrency model (the reference is single-threaded — one eel
        #: event loop over ``globalState``; here the auto_fetch loop,
        #: the stdin console, and the web UI's ThreadingHTTPServer
        #: handlers share one session), layered so no lock is ever held
        #: across unbounded chain I/O or model building:
        #:
        #: - ``lock`` (reentrant) — session field mutation: fetch's
        #:   cursor/PRNG-split/preview, state_version bumps, commit's
        #:   predictions snapshot.  Held only around in-memory /
        #:   on-device work, with ONE deliberate exception: fetch's
        #:   ``store.read_window`` (SQLite) runs under it so the cursor
        #:   advance is atomic with the read that consumed it — bounded
        #:   by ``fetch_limit`` rows against a local file, not chain
        #:   I/O (ADVICE r3).
        #: - ``_commit_lock`` — whole-fleet commit atomicity: two
        #:   concurrent commits must not interleave per-oracle txs (a
        #:   mixed fleet no fetch produced would reach consensus).
        #: - the adapter's own lock — per-operation atomicity of chain
        #:   reads/txs against the contract simulator and read cache
        #:   (tx-granular interleaving beyond that matches the real
        #:   chain).
        #: - ``_vectorizer_lock`` — single construction of the lazy
        #:   sentiment pipeline (tens of seconds of transformer init;
        #:   double-checked so only first callers pay it).
        self.lock = threading.RLock()
        self._commit_lock = threading.Lock()
        self._vectorizer_lock = threading.Lock()
        #: Fetch publish ordering: each fetch claims a monotonically
        #: increasing token with its window cursor; a slower fetch of an
        #: EARLIER window must not overwrite predictions/preview from a
        #: later one (the UI and auto_commit would regress to stale
        #: data).
        self._fetch_claim = 0
        self._fetch_published = 0

    # -- sentiment stage ----------------------------------------------------

    @property
    def vectorizer(self) -> Callable[[Sequence[str]], np.ndarray]:
        """texts → ``[B, dimension]`` vectors; the RoBERTa pipeline on
        ``device`` by default (``gen_classifier`` equivalent), built lazily so
        sessions that never fetch don't pay transformer init.  The label
        subset is sized to ``config.dimension`` (the 6 tracked
        go_emotions labels when it is 6, the first ``dimension`` labels
        of the 28-label head otherwise) so fetch output always matches
        the contract's dimension.

        Double-checked locking on its own lock (NOT the session lock):
        racing first fetches must not both pay the build, and callers
        of other session state must not wait behind it."""
        if self._vectorizer is not None:
            return self._vectorizer
        with self._vectorizer_lock:
            if self._vectorizer is not None:  # lost the build race
                return self._vectorizer
            from svoc_torch.models.sentiment import (
                GO_EMOTIONS_LABELS,
                TRACKED_INDICES,
                SentimentPipeline,
            )

            dim = self.config.dimension
            if dim == len(TRACKED_INDICES):
                indices = TRACKED_INDICES
            elif dim <= len(GO_EMOTIONS_LABELS):
                indices = tuple(range(dim))
            else:
                raise ValueError(
                    f"dimension {dim} exceeds the {len(GO_EMOTIONS_LABELS)}"
                    "-label head — pass an explicit vectorizer"
                )
            # More than one card: split the vectorizer's rows over them,
            # the data-parallel path of svoc_torch.parallel.serving.
            data_mesh = None
            default_batch = 32
            n_dev = torch.cuda.device_count() if self.device.type == "cuda" else 1
            if n_dev > 1 and default_batch % n_dev == 0:
                from svoc_torch.parallel.serving import serving_mesh

                data_mesh = serving_mesh(device=self.device)
            self._vectorizer = SentimentPipeline(
                label_indices=indices,
                batch_size=default_batch,
                data_mesh=data_mesh,
                packed=self.config.packed_inference,
                quant=self.config.quant_inference,
                device=self.device,
            )
        return self._vectorizer

    @property
    def label_names(self) -> List[str]:
        """Column names for the UI plots (``predictions_to_eel_values``
        uses ``LABELS_KEYS``, ``oracle_scheduler.py:113-118``): the 6
        tracked go_emotions labels at the reference dimension, the first
        ``dimension`` head labels otherwise."""
        from svoc_torch.models.sentiment import GO_EMOTIONS_LABELS, TRACKED_LABELS

        dim = self.config.dimension
        if dim == len(TRACKED_LABELS):
            return list(TRACKED_LABELS)
        if dim <= len(GO_EMOTIONS_LABELS):
            return list(GO_EMOTIONS_LABELS[:dim])
        return [f"label_{i}" for i in range(dim)]

    # -- the fetch path (simulation_fetch, oracle_scheduler.py:155-161) -----

    def fetch(
        self,
        tamper: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        window: Optional[np.ndarray] = None,
    ) -> Dict:
        """One simulation step: window → sentiment → fleet → preview.

        Returns the preview dict (fleet values, mean/median, normalized
        deviation ranks, honest ground truth) and caches ``predictions``
        for ``commit``.

        ``tamper`` (scenario hook, docs/FABRIC.md): applied to the
        fleet block ``[N, M]`` BEFORE the quarantine gate and the
        preview stats — the data-plane twin of the fault injector's
        chaos wrapper, letting a seeded Byzantine oracle live inside
        one claim of a multi-claim run.  The gate's counted verdict
        therefore describes the tampered block it will actually refuse
        to commit (one verdict per block, as always).

        ``window`` (request-driven feed, docs/SERVING.md): precomputed
        ``[K, dimension]`` sentiment vectors — the serving batcher
        already tokenized and forwarded the requests in one cross-claim
        packed batch, so this path skips the store read and the
        vectorize stage entirely and feeds the vectors straight into
        the fleet bootstrap.  Lineage, the quarantine verdict, the
        journal events, and the publish ordering are identical to the
        store-driven path — a request-fed block audits exactly like a
        scraped one.
        """
        # The session lock is held only around bounded in-memory work
        # (cursor advance + claim, PRNG split, publish) — NOT around
        # the sentiment forward or the fleet/preview compute, whose
        # first calls pay pipeline construction and kernel builds (tens
        # of seconds) and must never freeze other commands / the web UI
        # poll.  Racing fetches classify concurrently, each on the
        # distinct window its atomic cursor advance claimed; the claim
        # token keeps publishes in window order.
        with metrics.timer("fetch_latency").time(), stage_span("fetch"):
            with self.lock:
                if window is None:
                    comments, _dates, self.simulation_step = self.store.read_window(
                        self.simulation_step, self.config.window, self.config.fetch_limit
                    )
                self._fetch_claim += 1
                claim = self._fetch_claim
                step = self.simulation_step
            # The block's lineage id, minted from the claim token (so
            # seeded replays mint identical ids) and annotated onto the
            # OPEN fetch span — every child span (vectorize/tokenize/
            # forward/fleet/consensus) inherits it, and every event
            # below carries it, making the whole block auditable as one
            # record (docs/OBSERVABILITY.md §lineage).
            lineage = mint_lineage(claim, prefix=self.lineage_prefix)
            tracer.annotate_lineage(lineage)
            if window is None:
                if not comments:
                    raise EmptyStoreError(
                        "comment store is empty — run the scraper (or seed the "
                        "store) before fetching"
                    )
                n_comments = len(comments)
                self.journal.emit(
                    "block.fetched",
                    lineage=lineage,
                    n_comments=n_comments,
                    cursor=step,
                )
                # Resolved only now: an empty store must fail in
                # milliseconds, not after a transformer build.
                vectorize = self.vectorizer
                # A SentimentPipeline records its own tokenize/pack/
                # forward child spans; "vectorize" covers injected
                # vectorizers too.
                with stage_span("vectorize"):
                    window = torch.from_numpy(
                        np.asarray(vectorize(comments), dtype=np.float32)
                    ).to(self.device)
                subset = self.config.bootstrap_subset
                source = "store"
            else:
                window = torch.as_tensor(
                    np.asarray(window, dtype=np.float32)
                    if not isinstance(window, torch.Tensor)
                    else window.to(torch.float32),
                    device=self.device,
                )
                if window.dim() != 2 or window.shape[1] != self.config.dimension:
                    raise ValueError(
                        f"request window must be [K, {self.config.dimension}]"
                        f", got {tuple(window.shape)}"
                    )
                if window.shape[0] == 0:
                    raise EmptyStoreError(
                        "request-driven fetch got an empty window — the "
                        "feed should skip claims with no pending requests"
                    )
                n_comments = int(window.shape[0])
                # Rolling request context (docs/SERVING.md §windows):
                # consensus runs over the claim's recent sentiment PLUS
                # the new requests, capped at the pull-mode window size,
                # tiled cyclically to a power-of-two row count with the
                # subset strictly under it (:func:`window_positions`).
                with self.lock:
                    kept, window, _ = request_window(
                        self._request_window, window, self.config.window
                    )
                    self._request_window = kept
                window_rows = int(kept.shape[0])
                subset = min(
                    self.config.bootstrap_subset, max(1, window.shape[0] // 2)
                )
                source = "serving"
                # Same event, extra source tag: store-driven blocks keep
                # their exact historical payload (seeded smoke
                # fingerprints), request-fed blocks are distinguishable
                # in the audit record.
                self.journal.emit(
                    "block.fetched",
                    lineage=lineage,
                    n_comments=n_comments,
                    cursor=step,
                    source="serving",
                    window_rows=window_rows,
                )
            with self.lock:
                if self._key_value is None:
                    self._key_value = prng.PRNGKey(self.config.seed, self.device)
                self._key_value, sub = prng.split(self._key_value)
            with stage_span("fleet"):
                values, honest = fleet_block(sub, window, self.config, subset)
            with stage_span("consensus"):
                # The span's one device sync: the block and its honest
                # mask come to the host in one copy.  The gate, the
                # tamper hook and the preview read the host block.
                n, m = values.shape
                fetched = torch.cat(
                    [values.reshape(-1), honest.to(values.dtype)]
                ).cpu().numpy()  # svoclint: disable=SVOC001
                predictions = fetched[: n * m].reshape(n, m).astype(np.float64)
                honest = fetched[n * m :] > 0
                if tamper is not None:
                    # Scenario tampering replaces the block wholesale;
                    # the preview must describe what the gate sees.
                    predictions = np.asarray(
                        tamper(predictions), dtype=np.float64
                    )  # svoclint: disable=SVOC001
                mean, median, ranks = preview_stats(
                    torch.from_numpy(predictions.astype(np.float32))
                )
                # The gate verdict travels WITH the block it describes
                # (one count-bearing inspection per fetch; commits
                # re-check their own snapshot without counting).  The
                # gate emits the block's quarantine.verdict event.
                quarantine = (
                    self.gate.inspect(predictions, lineage=lineage)
                    if self.config.quarantine_gate
                    else None
                )
                ranks_np = ranks.numpy()  # svoclint: disable=SVOC001
                preview = {
                    "values": predictions,
                    "mean": mean.numpy(),  # svoclint: disable=SVOC001
                    "median": median.numpy(),  # svoclint: disable=SVOC001
                    "normalized_ranks": ranks_np,
                    "honest": honest,
                    "n_comments": n_comments,
                    "lineage": lineage,
                    "quarantine": (
                        quarantine.as_dict() if quarantine is not None else None
                    ),
                }
            metrics.counter("comments_processed").add(n_comments)
            admitted = (
                int(np.sum(quarantine.ok))
                if quarantine is not None
                else int(predictions.shape[0])
            )
            self.journal.emit(
                "consensus.result",
                lineage=lineage,
                n_oracles=int(predictions.shape[0]),
                admitted=admitted,
                # The gated kernel's validity bound (docs/ROBUSTNESS.md):
                # below 2 admitted oracles no interval is meaningful —
                # the postmortem monitor auto-bundles on False.
                interval_valid=admitted >= 2,
                suspects=int(np.sum(ranks_np <= 0.2)),
            )
            with self.lock:
                # Publish only if no LATER claim already did — a slow
                # fetch of an older window must not regress the state.
                if claim > self._fetch_published:
                    self._fetch_published = claim
                    self.predictions = predictions
                    self._block_source = source
                    self.last_quarantine = quarantine
                    self.last_lineage = lineage
                    self.last_preview = preview  # svoc: volatile(render cache derived from predictions; the UI rebuilds it on the next fetch/poll)
                    self.bump_state()
        return preview

    def bump_state(self) -> None:
        """Mark renderable state as changed (web UI poll redraw).
        Self-locking: the increment is a read-modify-write racing the
        auto_fetch thread against command dispatch."""
        with self.lock:
            self.state_version += 1

    # -- the commit path (contract.py:200-208) ------------------------------

    def _refuse_degenerate(self, predictions: np.ndarray, lineage) -> None:
        """Pre-tx dry-run of the faithful engine — the same
        ``two_pass_consensus`` the contract's golden recompute runs when
        the final oracle's tx lands.  A fleet whose reliable predictions
        agree exactly in some dimension panics there (zero-variance
        skewness, ``math.cairo:320-338`` — an i128 division by zero that
        reverts the tx), deterministically stranding the last signer and
        churning the supervisor over pure math.  Refusing here turns
        that churn into a typed :class:`DegenerateBlockError` BEFORE any
        tx, journaled as ``commit.deferred`` so the serving tier's defer
        is auditable on the block's lineage."""
        from svoc_torch.consensus import wsad_engine as eng
        from svoc_torch.ops.fixedpoint import to_wsad, to_wsad_rows

        try:
            eng.two_pass_consensus(
                # Vectorized wsad quantization (one numpy truncation,
                # bit-identical to the per-element ``to_wsad`` loop —
                # docs/PARALLELISM.md §host-overhead).
                to_wsad_rows(np.asarray(predictions)),
                constrained=self.config.constrained,
                n_failing=self.config.n_failing,
                max_spread=to_wsad(self.config.max_spread),
                strict_interval=True,
            )
        except ZeroDivisionError:
            metrics.counter("commit_deferred_degenerate").add(1)
            self.journal.emit(
                "commit.deferred", lineage=lineage, reason="degenerate"
            )
            raise DegenerateBlockError(
                "refusing to commit a zero-variance fleet block: the "
                "on-chain skewness recompute would divide by zero and "
                "revert the final oracle's tx (math.cairo:320-338) — "
                "defer until the block regains oracle diversity"
            ) from None
        except Exception:  # svoclint: disable=SVOC014 -- deliberate: every OTHER engine panic keeps its existing commit-path semantics — the txs go out and fail per-oracle with full breaker/supervisor accounting, so the degrade is counted downstream, not here
            # Every OTHER engine panic (interval error, codec range, …)
            # keeps its existing commit-path semantics: the txs are sent
            # and fail per-oracle with full breaker/supervisor
            # accounting.  Only the deterministic zero-variance revert
            # is worth refusing pre-tx.
            pass

    def commit(self) -> int:
        """Send every oracle's prediction as its own signed tx.

        On a mid-loop failure the partial tx count is still recorded
        (those transactions are on chain) before the
        :class:`ChainCommitError` propagates to the command layer.

        A fleet block the quarantine gate flagged refuses to commit AT
        ALL (:class:`QuarantinedInputError`, before any tx): the
        faithful path has no degraded mode, and sending the dirty tx
        would only trade a clear refusal for a felt-codec crash or an
        on-chain interval panic mid-fleet.
        """
        # Snapshot under the session lock, then submit under the COMMIT
        # lock only: a Sepolia RPC can stall indefinitely and must not
        # freeze the console / web UI behind the session lock, but two
        # concurrent commits must also not interleave their per-oracle
        # txs (a mixed fleet no fetch produced would reach consensus) —
        # whole-fleet atomicity lives on ``_commit_lock``.
        with self.lock:
            if self.predictions is None:
                raise RuntimeError("fetch before commit")
            predictions = self.predictions
            lineage = self.last_lineage
            source = self._block_source
        if self.config.quarantine_gate:
            report = self.gate.inspect(predictions, count=False)
            if not report.clean:
                self.journal.emit(
                    "commit.failed",
                    lineage=lineage,
                    reason="quarantined",
                    slots=report.quarantined_slots,
                )
                raise QuarantinedInputError(report)
        if source == "serving":
            # Request-fed blocks only: a serving cold start (one
            # request, no window history) deterministically produces
            # the zero-variance shape — defer instead of reverting.
            # Store-driven blocks keep their exact historical commit
            # semantics (partial fleets, per-oracle failure charges).
            self._refuse_degenerate(predictions, lineage)
        with self._commit_lock, metrics.timer("commit_latency").time():
            try:
                n = self.adapter.update_all_the_predictions(
                    predictions, lineage=lineage
                )  # svoclint: disable=SVOC010 -- deliberate: commit runs under _commit_lock end-to-end (whole-fleet atomicity); no journal subscriber re-enters the commit path (docs/OBSERVABILITY.md §events)
            except ChainCommitError as e:
                metrics.counter("chain_transactions").add(e.committed)
                metrics.counter("chain_commit_failures").add(1)
                # Interactive failures feed the health scores too — the
                # supervisor folds ALL commit-failure history.
                self.supervisor.record_commit_failure(e.failed_oracle, e.cause)
                self.journal.emit(
                    "commit.failed",
                    lineage=lineage,
                    reason="chain",
                    index=e.committed,
                    oracle=e.failed_oracle,
                    cause=str(e.cause),
                )  # svoclint: disable=SVOC010 -- deliberate: failure accounting must land before the raise unwinds the commit lock; no subscriber re-enters commit
                self.bump_state()  # partial txs changed chain state
                raise
        metrics.counter("chain_transactions").add(n)
        self.journal.emit(
            "commit.sent", lineage=lineage, sent=n, total=n, attempts=1,
            stranded=0,
        )
        self.bump_state()
        return n

    def commit_resilient(self) -> CommitOutcome:
        """The auto loop's commit: retry with decorrelated-jitter
        backoff, RESUME partial fleets (re-send only the stranded
        suffix — ``ChainCommitError.committed`` accounting), consult
        the circuit breaker per attempt, and report every per-oracle
        failure to the health supervisor.

        Same locking shape as :meth:`commit` (snapshot under the
        session lock, submit under ``_commit_lock`` only) — the retry
        loop runs INSIDE the whole-fleet atomicity, so two concurrent
        resilient commits still cannot interleave their txs.

        Returns the :class:`CommitOutcome`; a degraded cycle (some
        oracles stranded after their attempt budget) is a *successful
        return* with ``outcome.stranded`` non-empty — the loop stays
        alive and the supervisor owns the replacement decision.  Raises
        :class:`CircuitOpenError` when the breaker short-circuits and
        :class:`ChainCommitError` only when the overall retry deadline
        expires mid-fleet.
        """
        with self.lock:
            if self.predictions is None:
                raise RuntimeError("fetch before commit")
            predictions = self.predictions
            lineage = self.last_lineage
            source = self._block_source
        if self.wal is not None and lineage is not None:
            # Under the commit lock: the reconciler resends chain txs,
            # and two concurrent commits racing this guard would both
            # classify the same slot stranded and double-send it — the
            # exact duplicate the guard exists to prevent.  Re-checked
            # inside the lock; the block completes (and releases)
            # before the commit section re-acquires below, and a loser
            # of the race then sees the cycle closed.
            with self._commit_lock:
                open_here = lineage in self.wal.open_lineages()
                if open_here:
                    from svoc_torch.durability.reconcile import reconcile_wal

                    # An OPEN cycle for this lineage: a previous life
                    # died mid-commit and the recovery reconcile could
                    # not close it (a faulted resend, missing
                    # evidence).  Its txs may be durably on chain —
                    # blind re-execution would double-send them — so
                    # resolve the cycle through the reconciler's
                    # evidence columns instead; on success the
                    # replayed-lineage path below dedups exactly as for
                    # a cleanly-closed cycle.
                    reconcile_wal(
                        self.wal,
                        lambda _claim: self.adapter,
                        journal=self.journal,
                        lineages={lineage},
                    )  # svoclint: disable=SVOC010 -- deliberate: the reconciler journals its per-cycle verdicts inside the whole-fleet atomicity this guard shares with the commit path; no subscriber re-enters commit
            if open_here and lineage not in self.wal.completed_lineages():
                metrics.counter("chain_commit_failures").add(1)
                self.journal.emit(
                    "commit.failed",
                    lineage=lineage,
                    reason="open_cycle_unresolved",
                    sent=0,
                )
                raise ChainCommitError(
                    committed=0,
                    total=len(predictions),
                    failed_oracle=None,
                    cause=RuntimeError(
                        "open WAL cycle unresolved — refusing to "
                        "blind re-commit a lineage whose txs may "
                        "already be on chain"
                    ),
                    sent_count=0,
                )
        if (
            self.wal is not None
            and lineage is not None
            and lineage in self.wal.completed_lineages()
        ):
            # Snapshot-replay re-execution (docs/RESILIENCE.md
            # §durability): a restart resumes from its snapshot and
            # re-runs the steps after it; this block's commit cycle
            # already CLOSED in a previous life (its txs are on chain,
            # witnessed by the WAL's done record), so the chain writes
            # — and the supervisor/SLO charges the original run
            # already made — must not happen twice.
            done = next(
                (
                    r
                    for r in reversed(self.wal.records())
                    if r.get("kind") == "done"
                    and r.get("lineage") == lineage
                ),
                {},
            )
            sent = int(done.get("sent", 0))
            self.journal.emit(
                "commit.sent",
                lineage=lineage,
                sent=sent,
                total=sent,
                attempts=0,
                stranded=0,
                replayed=True,
            )
            return CommitOutcome(sent=sent, total=sent, attempts=0)
        # Quarantine gate (docs/ROBUSTNESS.md): refused slots never
        # produce a tx; each refusal charges the slot's oracle exactly
        # like a commit failure, so a persistent garbage emitter walks
        # the same health→quarantine→replacement path as a dead signer.
        skip: tuple = ()
        if self.config.quarantine_gate:
            report = self.gate.inspect(predictions, count=False)
            if not report.clean:
                skip = tuple(report.quarantined_slots)
                oracles = self.adapter.call_oracle_list()
                for slot in report.quarantined_slots:
                    if slot < len(oracles):
                        # The charge event carries the block lineage —
                        # the audit link from this verdict to the
                        # replacement clock it advanced.
                        self.supervisor.record_quarantine(
                            oracles[slot], report.reasons[slot],
                            lineage=lineage,
                        )
                metrics.counter("commit_skipped_quarantined").add(len(skip))
        if source == "serving" and not skip:
            # Request-fed blocks only (store-driven commits keep their
            # exact historical semantics, which tier-1 pins).  With
            # skipped slots the on-chain block the LAST tx activates
            # keeps the skipped oracles' previous values, so a
            # full-predictions dry-run would not be exact — and a
            # partially-skipped fleet never reproduces the cold-start
            # all-identical shape this guard exists for.
            self._refuse_degenerate(predictions, lineage)
        with self._commit_lock, metrics.timer("commit_latency").time():
            wal_cycle = None
            if self.wal is not None:
                # The cycle-open needs the oracle list (one chain RPC)
                # BEFORE commit_fleet_with_resume's own breaker
                # machinery runs — so the breaker contract must be
                # honored here too: an OPEN breaker short-circuits
                # before paying the RPC + payload fsyncs, and a
                # transport failure on the read records a breaker
                # failure exactly like the loop's first-RPC failure
                # would (otherwise an outage with a WAL attached would
                # never trip the breaker).
                retry_after = self.breaker.retry_after_s()
                if retry_after > 0:
                    metrics.counter("commit_short_circuits").add(1)
                    self.journal.emit(
                        "commit.failed",
                        lineage=lineage,
                        reason="circuit_open",
                        backend=self.breaker.name,
                        sent=0,
                    )  # svoclint: disable=SVOC010 -- deliberate: short-circuit accounting under the commit lock; no subscriber re-enters commit
                    raise CircuitOpenError(
                        self.breaker.name, retry_after, sent=0
                    )
                try:
                    oracles = self.adapter.call_oracle_list()
                except Exception:
                    self.breaker.record_failure()  # svoclint: disable=SVOC010 -- deliberate: breaker flushes its queued transition events on THIS thread after releasing its own lock; only the commit lock is held and no subscriber re-enters commit
                    metrics.counter("chain_commit_failures").add(1)
                    self.journal.emit(
                        "commit.failed",
                        lineage=lineage,
                        reason="transport",
                        sent=0,
                    )  # svoclint: disable=SVOC010 -- deliberate: transport-failure accounting before the raise; no subscriber re-enters commit
                    raise
                wal_cycle = self._open_wal_cycle(
                    predictions, lineage, skip, oracles
                )
            try:
                outcome = commit_fleet_with_resume(
                    self.adapter,
                    predictions,
                    self.config.commit_retry,
                    breaker=self.breaker,
                    skip=skip,
                    on_oracle_failure=self.supervisor.record_commit_failure,
                    journal=self.journal,
                    lineage=lineage,
                    wal=wal_cycle,
                    commit_mode=self.commit_mode,
                )  # svoclint: disable=SVOC010 -- deliberate: the retry/resume loop journals per-attempt outcomes INSIDE the whole-fleet atomicity the commit lock provides; no journal subscriber re-enters the commit path
            except ChainCommitError as e:
                # resilient_sent is the TRUE landed-tx count (committed
                # is a fleet index that counts skipped/stranded slots).
                metrics.counter("chain_transactions").add(
                    getattr(e, "resilient_sent", e.committed)
                )
                metrics.counter("chain_commit_failures").add(1)
                self.bump_state()
                raise
            except CircuitOpenError as e:
                metrics.counter("chain_transactions").add(e.sent)
                metrics.counter("commit_short_circuits").add(1)
                if e.sent:
                    self.bump_state()
                raise
        metrics.counter("chain_transactions").add(outcome.sent)
        if outcome.stranded:
            # The cycle landed degraded — count it like the single-shot
            # path counts its failures, so soak accounting stays one
            # series.
            metrics.counter("chain_commit_failures").add(1)
        self.bump_state()
        return outcome

    def attach_wal(self, wal) -> None:
        """Wire a commit-intent WAL into the resilient commit path
        (docs/RESILIENCE.md §durability).  Duck-typed: anything with the
        reference ``CommitIntentWAL``'s ``cycle``, ``open_lineages``,
        ``completed_lineages`` and ``records``
        (:class:`svoc_torch.durability.wal.CommitIntentWAL`)."""
        self.wal = wal

    def _open_wal_cycle(self, predictions, lineage, skip, oracles):
        """The cycle-open record: the full felt payload matrix ahead of
        any tx, so a restart can classify AND resend every slot.  A
        slot whose payload cannot encode (garbage the gate somehow
        missed) records ``None`` — the commit loop will fail that tx
        with its usual codec semantics, and the reconciler treats the
        slot like a skip.  The encode here is deliberately repeated by
        the commit plane (digest parity REQUIRES the WAL payload and
        the wire payload to be the same encoding; the cost is
        microseconds against a signed tx) — both sides now route
        through the same vectorized
        :func:`svoc_torch.ops.fixedpoint.encode_matrix`, the per-element
        ``encode_vector`` loop's bit-identical replacement
        (docs/PARALLELISM.md §host-overhead).  WAL append failures
        propagate unwrapped — "no durable intent, no tx", and a disk
        problem must not feed the CHAIN breaker."""
        from svoc_torch.ops.fixedpoint import encode_matrix

        skip_set = frozenset(int(i) for i in skip)
        encoded = encode_matrix(
            np.asarray(predictions, dtype=np.float64), on_error="none"
        )
        payloads = [
            None if i in skip_set else row for i, row in enumerate(encoded)
        ]
        return self.wal.cycle(
            lineage,
            claim=self.config.claim,
            oracles=oracles[: len(payloads)],
            payloads=payloads,
            skip=sorted(skip_set),
        )

    def supervisor_step(self) -> Optional[Dict]:
        """One fleet-health fold (auto loop cadence).  Never raises —
        a supervisor problem (faulted chain read mid-chaos, vote race)
        must not take down the serving loop."""
        if not self.config.supervise_fleet:
            return None
        try:
            # The fold's events carry the lineage of the block whose
            # commit cycle drove it — the replacement-vote leg of that
            # block's audit record.
            with self.lock:
                lineage = self.last_lineage
            report = self.supervisor.step(lineage=lineage)
        except Exception:
            metrics.counter("supervisor_errors").add(1)
            return None
        if report.get("replaced"):
            self.bump_state()  # the fleet roster changed
        return report

    def set_auto_flags(
        self,
        *,
        fetch: Optional[bool] = None,
        commit: Optional[bool] = None,
        resume: Optional[bool] = None,
    ) -> None:
        """Toggle the auto flags and bump ``state_version`` so the web
        UI surfaces them live (the reference documents the flags but
        never implements them, ``web_interface.py:22-23``)."""
        with self.lock:
            if fetch is not None:
                self.auto_fetch = fetch
            if commit is not None:
                self.auto_commit = commit
            if resume is not None:
                self.auto_resume = resume
            self.state_version += 1

    def resilience_snapshot(self) -> Dict:
        """Breaker + fleet-health state for the UI and soak artifacts.
        Cheap: no chain I/O (the supervisor reads its cached scores)."""
        with self.lock:
            quarantine = self.last_quarantine
            lineage = self.last_lineage
        return {
            "breaker": self.breaker.state(),
            "health": self.supervisor.health_snapshot(),
            "quarantined": self.supervisor.quarantined_slots(),
            "replacements": len(self.supervisor.replacements),
            # Input-integrity gate verdict over the LAST fetched fleet
            # (docs/ROBUSTNESS.md) — None until the first gated fetch.
            "input_quarantine": (
                quarantine.as_dict() if quarantine is not None else None
            ),
            # The last published block's lineage id — the key for
            # ``GET /api/audit/<block>`` / the console's ``audit``.
            "lineage": lineage,
        }

    # -- flight recorder views (docs/OBSERVABILITY.md §events) --------------

    def audit(self, lineage: Optional[str] = None) -> Dict:
        """The per-block audit record (events + spans + summary) for
        ``lineage`` — default: the last published block."""
        if lineage is None:
            with self.lock:
                lineage = self.last_lineage
        if lineage is None:
            return {"lineage": None, "found": False, "events": [],
                    "spans": [], "summary": {}}
        return audit_record(lineage, journal=self.journal)

    def _slo_evaluator(self):
        if self._slo is None:
            from svoc_torch.utils.slo import SLOEvaluator, default_slos

            self._slo = SLOEvaluator(
                default_slos(metrics), registry=metrics, journal=self.journal
            )
        return self._slo

    def slo_snapshot(self) -> Dict:
        """Evaluate the declarative SLOs (commit success ratio, p99
        consensus latency, quarantine admission) as fast/slow burn
        rates; exports the ``slo_burn_rate`` gauges and emits
        ``slo.alert`` events on threshold crossings."""
        return self._slo_evaluator().evaluate()

    def slo_step(self) -> Optional[Dict]:
        """The auto loop's SLO fold — never raises (a broken evaluator
        must not take down serving)."""
        try:
            return self.slo_snapshot()
        except Exception:
            metrics.counter("slo_errors").add(1)
            return None


def window_positions(previous: int, new: int, cap: int = PREDICTION_WINDOW):
    """The request-window rule on row positions.  Of a claim's
    ``previous`` kept rows followed by its ``new`` request rows, returns
    ``(kept, tiled, subset)``: the positions kept for its next feed (the
    last ``cap``), the positions of the window tiled cyclically up to the
    next power of two of its rows (the padding rows are real vectors
    repeated), and the bootstrap subset ``min(BOOTSTRAP_SUBSET, max(1,
    bucket // 2))``, strictly under the bucket."""
    if new == 0:
        raise ValueError("request-driven fetch got an empty window")
    total = previous + new
    kept = np.arange(max(0, total - cap), total)
    bucket = 1 << max(0, kept.size - 1).bit_length()
    tiled = kept[np.arange(bucket) % kept.size]
    return kept, tiled, min(BOOTSTRAP_SUBSET, max(1, bucket // 2))


def request_window(
    previous: Optional[torch.Tensor],
    window: torch.Tensor,
    cap: int = PREDICTION_WINDOW,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """A claim's new request vectors ``window [K, M]`` appended to its
    ``previous`` window, by :func:`window_positions`.  Returns ``(kept,
    tiled, subset)``: ``kept`` is the window to hold for the claim's next
    feed.  (:class:`svoc_torch.serving.tier.ClaimServingStep` applies the
    same positions to all its claims at once.)"""
    if window.dim() != 2:
        raise ValueError(f"request window must be [K, M], got {tuple(window.shape)}")
    if previous is not None:
        if previous.shape[1] != window.shape[1]:
            raise ValueError(
                f"request window is [K, {window.shape[1]}], the claim's is "
                f"[K, {previous.shape[1]}]"
            )
        window = torch.cat([previous, window])
    n_prev = 0 if previous is None else previous.shape[0]
    kept, tiled, subset = window_positions(n_prev, window.shape[0] - n_prev, cap)
    index = torch.from_numpy(tiled).to(window.device)
    return window[int(kept[0]):], window.index_select(0, index), subset


def fleet_block(
    key: torch.Tensor,
    window: torch.Tensor,
    spec,
    subset: int,
    tamper: Optional[Callable] = None,
    cycle: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The claim's oracle fleet from its tiled window and the fetch's key
    (``sub`` of ``key, sub = split(key)``, the key of ``_fleet``,
    ``session.py:183-185, 604-615``); ``spec`` is anything with
    ``n_oracles`` and ``n_failing`` (a ``ClaimSpec``, a
    :class:`SessionConfig`): ``spec.n_oracles`` oracles of which
    ``spec.n_failing`` fail, honest ones averaging ``subset`` window rows;
    then ``tamper(cycle, block)`` when given (the scenario hook, applied
    before the gate).  Returns ``(values [N, M] float32, honest [N])`` on
    the key's device.  With keys ``[C, 2]`` and windows ``[C, W, M]`` it
    builds ``C`` claims' fleets in one pass (``tamper`` must then be
    None): each the bits of its own one-claim build.

    The hook gets what the reference's gets (``session.py:622-633``): the
    block fetched to the host as a float64 numpy array; its return is
    read as float64, cast to float32 and put back on the block's device.
    Only a tampered claim pays that fetch, as in the reference."""
    draws = draw_fleet(
        key, window.shape[-2], window.shape[-1], spec.n_oracles, spec.n_failing, subset
    )
    values, honest = assemble_fleet(window, *draws)
    values = values.to(torch.float32)
    if tamper is not None:
        if values.dim() != 2:
            raise ValueError("a tamper hook takes one claim's block, not a batch")
        values = tamper_block(values, tamper, cycle)
    return values, honest


def tamper_block(values: torch.Tensor, tamper: Callable, cycle: int) -> torch.Tensor:
    """``tamper(cycle, block)`` on the block fetched to the host as float64,
    its return cast to float32 on the block's device."""
    block = values.detach().cpu().numpy().astype(np.float64)
    tampered = np.asarray(tamper(cycle, block), dtype=np.float64).astype(np.float32)
    return torch.from_numpy(tampered).to(values.device)
