"""MultiSession: the operator facade over the claim fabric.

Mirrors :mod:`svoc_tpu.fabric.session` (``session.py:1-380``).  The
port's ``MultiSession(device=None)`` resolves its device once (CUDA,
raising without a card) and hands it to every claim's ``Session`` and to
the router.  ``start_prewarm`` builds and runs the compile plane's
prewarm worker (``session.py:272-322``).  ``attach(console)`` exposes
the fabric through :class:`svoc_torch.apps.commands.CommandConsole`.
``device_resident`` passes through to the router (its resident staging)
and :meth:`MultiSession.snapshot` reports it with the route and the
mesh, as ``session.py:344`` does; ``mesh`` pins the router's claim mesh
(:class:`~svoc_torch.fabric.router.ClaimRouter`).

One object that owns N claims end-to-end (docs/FABRIC.md): a
:class:`~svoc_torch.fabric.registry.ClaimRegistry` of per-claim state —
each claim gets its own :class:`~svoc_torch.apps.session.Session` (fleet,
chain adapter, supervisor, breaker, quarantine gate, claim-scoped
lineage) and its own SLO evaluator — multiplexed by a
:class:`~svoc_torch.fabric.router.ClaimRouter` through ONE claim-batched
consensus dispatch per cycle.  ``MultiSession`` composes many of them the way
HybridFlow's single controller composes many workloads (PAPERS.md,
arxiv 2409.19256).

Seeding: a claim whose spec leaves ``seed=None`` derives its oracle
stream from the fabric's ``base_seed`` via
:func:`svoc_torch.sim.generators.claim_seed` (crc32-keyed off the claim
id), so N claims are independent AND replayable from one number.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Sequence

from svoc_torch.apps.session import Session, SessionConfig
from svoc_torch.device import resolve_device
from svoc_torch.fabric.registry import ClaimRegistry, ClaimSpec, ClaimState
from svoc_torch.fabric.router import ClaimRouter
from svoc_torch.io.comment_store import CommentStore
from svoc_torch.sim.generators import claim_seed
from svoc_torch.utils.events import audit_record, resolve_journal
from svoc_torch.utils.metrics import MetricsRegistry
from svoc_torch.utils.metrics import registry as _default_metrics


class MultiSession:
    """N claims, one controller (docs/FABRIC.md).

    ``journal``/``metrics``/``lineage_scope`` default to the process
    singletons — live deployments want one journal and one /metrics
    surface.  Seeded scenarios (the fabric smoke) inject all three
    fresh and pinned, because replay identity needs event seqs starting
    at 1, counters starting at 0, and lineage ids that do not depend on
    how many sessions the process made before.
    """

    def __init__(
        self,
        specs: Iterable[ClaimSpec] = (),
        *,
        base_seed: int = 0,
        vectorizer: Optional[Callable[[Sequence[str]], object]] = None,
        store_factory: Optional[Callable[[str], CommentStore]] = None,
        journal=None,
        metrics: Optional[MetricsRegistry] = None,
        lineage_scope: Optional[str] = None,
        max_claims_per_batch: int = 8,
        sanitized_dispatch: bool = False,
        consensus_impl: Optional[str] = None,
        mesh=None,
        pipelined: bool = False,
        device_resident: bool = False,
        commit_mode: Optional[str] = None,
        warmup_mode: Optional[str] = None,
        clock: Optional[Callable[[], float]] = None,
        adapter_factory=None,
        device=None,
    ):
        #: Where every claim's fleet is drawn and every claim cube is
        #: dispatched (``None``: CUDA, raising without a card).
        self.device = resolve_device(device)
        self.base_seed = base_seed
        self._vectorizer = vectorizer
        self._store_factory = store_factory
        #: ``adapter_factory(spec) -> ChainAdapter`` overrides each new
        #: claim session's default in-memory chain — the durability
        #: layer injects adapters over a crash-surviving tx log here,
        #: and a Sepolia deployment would inject real backends the same
        #: way.
        self._adapter_factory = adapter_factory
        #: Commit-intent WAL shared by every claim session once
        #: :meth:`attach_wal` is called (claim-tagged records; duck-typed,
        #: :class:`svoc_torch.durability.wal.CommitIntentWAL` in practice).
        self._wal = None
        self._journal = journal
        self._metrics = metrics or _default_metrics
        self._lineage_scope = lineage_scope
        #: Clock for the per-claim SLO evaluators.  Seeded serving
        #: replays MUST pass the scenario's virtual clock here: the
        #: evaluators emit latched ``slo.alert`` events into the same
        #: journal the replay fingerprint digests, so wall-clock burn
        #: windows would make two identical runs alert differently
        #: (docs/SERVING.md §replay).
        self._clock = clock
        self.registry = ClaimRegistry()
        #: Commit-plane mode for every claim session this fabric builds
        #: (``"per_tx"`` | ``"batched"``; None = ``SVOC_COMMIT_MODE`` >
        #: the port's default, resolved once per Session).  Pinned here:
        #: the WAL record family a seeded crash replay produces depends
        #: on it.  ``pipelined`` turns on the double-buffered pull-mode
        #: dispatch (consensus k-1 overlaps fetch k; drain with
        #: :meth:`flush`).
        self._commit_mode = commit_mode
        self.router = ClaimRouter(
            self.registry,
            max_claims_per_batch=max_claims_per_batch,
            metrics=self._metrics,
            journal=journal,
            sanitized_dispatch=sanitized_dispatch,
            consensus_impl=consensus_impl,
            mesh=mesh,
            pipelined=pipelined,
            device_resident=device_resident,
            warmup_mode=warmup_mode,
            device=self.device,
        )
        for spec in specs:
            self.add_claim(spec)

    @property
    def metrics(self) -> MetricsRegistry:
        """The fabric's metrics registry (the serving tier and tools
        must account into the SAME registry the router does)."""
        return self._metrics

    @property
    def journal(self):
        """The injected journal, or None (= the process default — the
        serving tier resolves it the same way the router does)."""
        return self._journal

    # -- claim lifecycle ----------------------------------------------------

    def add_claim(
        self,
        spec: ClaimSpec,
        *,
        store: Optional[CommentStore] = None,
        vectorizer: Optional[Callable[[Sequence[str]], object]] = None,
    ) -> ClaimState:
        """Register one claim: build its Session (claim-scoped lineage,
        own adapter/supervisor/gate/breaker) and its SLO evaluator.
        The claim joins the router's rotation on the next ``step``."""
        from svoc_torch.utils.slo import SLOEvaluator, claim_slos

        seed = (
            spec.seed
            if spec.seed is not None
            else claim_seed(self.base_seed, spec.claim_id)
        )
        config = SessionConfig(
            n_oracles=spec.n_oracles,
            n_failing=spec.n_failing,
            dimension=spec.dimension,
            constrained=spec.constrained,
            max_spread=spec.max_spread if not spec.constrained else 0.0,
            seed=seed,
            claim=spec.claim_id,
            lineage_scope=self._lineage_scope,
            commit_mode=self._commit_mode,
        )
        if store is None:
            store = (
                self._store_factory(spec.claim_id)
                if self._store_factory is not None
                else CommentStore()
            )
        session = Session(
            config=config,
            store=store,
            vectorizer=vectorizer or self._vectorizer,
            adapter=(
                self._adapter_factory(spec)
                if self._adapter_factory is not None
                else None
            ),
            journal=self._journal,
            device=self.device,
        )
        if self._wal is not None:
            session.attach_wal(self._wal)
        evaluator = SLOEvaluator(
            claim_slos(
                self._metrics,
                spec.claim_id,
                commit_objective=spec.commit_objective,
                admission_objective=spec.admission_objective,
            ),
            registry=self._metrics,
            journal=self._journal,
            **({"clock": self._clock} if self._clock is not None else {}),
        )
        # Pre-register the claim's SLO counter series (and the anomaly
        # counter's stages) at zero, so ``render_prometheus`` exposes a
        # complete per-claim family from registration onward — a scrape
        # can tell "claim exists, nothing happened yet" from "claim
        # unknown", and dashboards don't get born mid-incident.
        labels = {"claim": spec.claim_id}
        for name in (
            "claim_commit_cycles",
            "claim_commit_failures",
            "claim_commit_deferred",
            "claim_slots_inspected",
            "claim_slots_quarantined",
        ):
            self._metrics.counter(name, labels=labels).add(0)
        for stage in ("fetch", "commit"):
            self._metrics.counter(
                "fabric_claim_errors",
                labels={"claim": spec.claim_id, "stage": stage},
            ).add(0)
        return self.registry.add(spec, session, evaluator)

    def attach_wal(self, wal) -> None:
        """Wire one commit-intent WAL through every claim session (current and future): each claim's
        resilient commits journal claim-tagged, fsynced intent records
        into the shared log (docs/RESILIENCE.md §durability)."""
        self._wal = wal
        for state in self.registry.states():
            state.session.attach_wal(wal)

    def remove_claim(self, claim_id: str) -> ClaimState:
        """Drop a claim from the registry (its Session object survives
        for the caller — lineage history in the journal is untouched)."""
        return self.registry.remove(claim_id)

    def pause(self, claim_id: str, paused: bool = True) -> None:
        """Drain a claim without removing its state: a paused claim
        keeps its rotation slots but is skipped by ``select``."""
        self.registry.get(claim_id).paused = paused

    def get(self, claim_id: str) -> ClaimState:
        return self.registry.get(claim_id)

    def claim_ids(self) -> List[str]:
        return self.registry.ids()

    # -- the multiplexed loop -----------------------------------------------

    def step(self, feeds=None) -> Dict:
        """One fabric cycle: fair-select → fetch each → ONE claim-cube
        consensus dispatch per (shape, config) group → per-claim
        resilient commit + supervisor + SLO.  ``feeds`` switches to the
        request-driven cycle (``ClaimRouter.step``, docs/SERVING.md)."""
        return self.router.step(feeds=feeds)

    def run(self, cycles: int) -> List[Dict]:
        """``cycles`` steps; returns the per-step reports.  A pipelined
        router drains its one-cycle consensus tail afterwards, so the
        last cycle's write-backs are visible to the caller."""
        reports = [self.step() for _ in range(cycles)]
        self.flush()
        return reports

    def flush(self) -> int:
        """Drain pipelined in-flight consensus write-backs
        (:meth:`ClaimRouter.flush`); no-op when unpipelined."""
        return self.router.flush()

    # -- the compile plane -------------------------------------------------

    def start_prewarm(
        self,
        *,
        budget_s: Optional[float] = None,
        background: bool = True,
        force: bool = False,
        include_twins: bool = True,
    ):
        """Build (once) and run the prewarm worker over this fabric's
        live shape universe (:class:`~svoc_torch.compile.prewarm.PrewarmWorker`).

        Honors the router's pinned ``warmup_mode``: under ``"none"`` it
        returns None unless ``force=True``.  ``background=True`` (the
        serving default) walks on a daemon thread while the tier serves
        and defers cold shapes; ``background=False`` blocks until the
        universe is warm (recoveries, smokes).  Returns the worker,
        reused on repeat calls, which re-walk the refreshed universe and
        skip what is warm.  ``include_twins=False`` restricts this walk
        to the variants this process can dispatch (the blocking recovery
        walk); a later default call adds the twins."""
        if self.router.warmup_mode == "none" and not force:
            return None
        worker = self.router.prewarmer
        if worker is None:
            from svoc_torch.compile.prewarm import PrewarmConfig, PrewarmWorker

            worker = PrewarmWorker(self.router, self.registry, metrics=self._metrics,
                                   config=PrewarmConfig(budget_s=budget_s))
            self.router.attach_prewarmer(worker)
        if background:
            worker.start(budget_s=budget_s, include_twins=include_twins)
        else:
            worker.warm_all(budget_s=budget_s, include_twins=include_twins)
        return worker

    # -- views ---------------------------------------------------------------

    def claims_state(self) -> Dict[str, Dict]:
        """Per-claim snapshots (``/api/state``'s ``claims`` section)."""
        return {
            state.spec.claim_id: state.snapshot()
            for state in self.registry.states()
        }

    def snapshot(self) -> Dict:
        return {
            "steps": self.router.steps,
            "n_claims": len(self.registry),
            "device": str(self.device),
            "consensus_impl": self.router.consensus_impl,
            "mesh": self.router.mesh_spec,
            "pipelined": self.router.pipelined,
            "device_resident": self.router.device_resident,
            "warmup_mode": self.router.warmup_mode,
            "prewarm": (
                self.router.prewarmer.stats() if self.router.prewarmer is not None else None
            ),
            "claims": self.claims_state(),
        }

    def _resolve_journal(self):
        return resolve_journal(self._journal)

    def claim_fingerprint(self, claim_id: str) -> str:
        """Replay digest of ONE claim's slice of the journal — every
        event whose lineage this claim's session minted.  Seqs are
        global, so identity across runs also certifies identical
        scheduler interleaving (docs/FABRIC.md §replay)."""
        state = self.registry.get(claim_id)
        return self._resolve_journal().fingerprint(
            lineage_prefix=state.session.lineage_prefix + "-"
        )

    def audit(self, lineage: str) -> Dict:
        """The per-block audit record for any claim's block — lineage
        ids are claim-prefixed, so the id alone names the claim."""
        return audit_record(lineage, journal=self._journal)

    def attach(self, console) -> None:
        """Expose this fabric through an existing
        :class:`~svoc_torch.apps.commands.CommandConsole`: the ``claims``
        command and ``/api/state``'s ``claims`` section read it."""
        console.fabric = self
