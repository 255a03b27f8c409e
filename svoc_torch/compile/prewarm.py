"""The prewarm worker: make the claim-cube shape universe warm ahead of traffic.

Mirrors :mod:`svoc_tpu.compile.prewarm` (``prewarm.py:1-559``:
``PrewarmConfig``, ``PrewarmWorker``, ``warm_keys``).  The reference
AOT-compiles each key of the universe (:mod:`svoc_torch.compile.universe`)
through ``jit(...).lower().compile()`` and then primes the dispatch path
with one all-padding cube.  On the card the port's cold cost is per
kernel library, not per shape: the first call of each kernel in a
process builds its source with ``nvcc`` (or loads it from the build
directory, :mod:`svoc_torch.compile.cache`) and opens it.  So a key's
warm-up is:

1. on CUDA (a key whose impl is ``"cuda"``), **build or load** every
   library the serving path launches (:data:`SERVING_KERNELS`: B3 for
   the claim cubes, the flash forward B1 for the encoder, threefry for
   the fetch's key split, the fleet draws for its fleet) through
   :func:`svoc_torch.ops._build.load_all`, one
   ``nvcc`` a missing source and all at once, timed into the
   ``prewarm_compile_seconds`` histogram (the builds the first time, a
   dictionary hit after it, as the reference's later keys are cache
   retrievals);
2. **prime** one all-padding cube (``claim_mask`` all False) through the
   same public dispatch the router calls
   (:func:`svoc_torch.consensus.batch.claims_consensus_sanitized` or
   ``claims_consensus_gated``) on the router's device, and wait for it.
   On CUDA that launches B3 once per (N, M, cfg) group, since another
   bucket is the same library; on the CPU every key runs the plain
   claim-cube forms.

Every key ends in ``compile_prewarm{outcome=}`` with the reference's
names: ``compiled`` (step 1 ran), ``primed`` (step 2 only, the CPU),
``skipped`` (``prime=False`` on a key with nothing to build),
``error`` and ``budget_exhausted``.  The worker never journals: warmup is
invisible to the seeded fingerprints.  A budgeted walk cuts from the
tail of the priority order.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from svoc_torch.compile.universe import (
    CompileKey,
    bucket_ladder,
    dispatch_key,
    enumerate_universe,
    registry_groups,
    universe_summary,
)
from svoc_torch.utils.metrics import MetricsRegistry
from svoc_torch.utils.metrics import registry as _default_registry

_log = logging.getLogger(__name__)

PREWARM_COUNTER = "compile_prewarm"
PREWARM_HISTOGRAM = "prewarm_compile_seconds"
#: The kernel source every claim-cube key dispatches on CUDA (B3).
CLAIM_KERNEL = "gated_claims_consensus"
#: Every kernel source the serving path launches on CUDA: B3, the flash
#: forward (B1) of the encoder, threefry for the fetch's key split and the
#: fleet draws for its fleet.
SERVING_KERNELS = (CLAIM_KERNEL, "flash_attention", "threefry", "fleet_draws")


@dataclasses.dataclass(frozen=True)
class PrewarmConfig:
    """The worker's knobs.  ``budget_s=None`` walks the whole universe;
    ``prime=False`` stops after the build or load, so that a key with
    nothing to build (the CPU's) counts ``skipped`` and stays cold."""

    budget_s: Optional[float] = None
    prime: bool = True
    include_twins: bool = True

    def __post_init__(self):
        if self.budget_s is not None and self.budget_s <= 0:
            raise ValueError("budget_s must be > 0 (or None)")


def _build_serving_kernels(clock, metrics) -> None:
    """Build (in parallel) or load every serving library, timed into the
    prewarm histogram."""
    from svoc_torch.ops import _build

    t0 = clock()
    _build.load_all(SERVING_KERNELS)
    metrics.histogram(PREWARM_HISTOGRAM).observe(max(0.0, clock() - t0))


class PrewarmWorker:
    """Walks one router's universe; owns no thread until :meth:`start`
    and never outlives :meth:`wait`.  The router's pinned resolution
    (impl, gate fusion, batch cap) is read here, never re-resolved."""

    def __init__(
        self,
        router,
        registry,
        *,
        metrics: Optional[MetricsRegistry] = None,
        config: Optional[PrewarmConfig] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.router = router
        self.registry = registry
        self.config = config or PrewarmConfig()
        self._metrics = metrics or _default_registry
        self._clock = clock
        self._lock = threading.Lock()
        self._warm: set = set()
        #: (N, M, cfg) groups whose B3 launch was primed on CUDA.
        self._primed_groups: set = set()
        self._universe: Optional[List[CompileKey]] = None
        #: (N, M, cfg) group -> its primary keys (the pinned variant's
        #: ladder), cached at enumeration for the defer gate.
        self._primary: Dict[Any, List[CompileKey]] = {}
        self._thread: Optional[threading.Thread] = None
        self._done = threading.Event()
        self._started = False
        self._report: Optional[Dict[str, Any]] = None

    # -- the universe --------------------------------------------------------

    def universe(self, refresh: bool = False, include_twins: Optional[bool] = None) -> List[CompileKey]:
        """Enumerate (and cache) the router's universe from the live
        registry; ``include_twins`` overrides the config for one walk."""
        with self._lock:
            if self._universe is not None and not refresh:
                return list(self._universe)
        router = self.router
        keys = enumerate_universe(
            registry_groups(self.registry),
            max_claims_per_batch=router.max_claims_per_batch,
            sanitized_dispatch=router.sanitized_dispatch,
            impl=router.consensus_impl,
            donate=router.device_resident,
            mesh=router.mesh_spec,
            mesh_claim_size=router._shard.claim_size if router._shard else 1,
            include_twins=include_twins if include_twins is not None else self.config.include_twins,
        )
        primary = {group: self._primary_keys(*group) for group in {k.group() for k in keys}}
        with self._lock:
            self._universe = keys
            self._primary = primary
        return list(keys)

    # -- warmth queries (router and serving frontend) -------------------------

    def is_warm(self, key: CompileKey) -> bool:
        with self._lock:
            return key in self._warm

    @property
    def active(self) -> bool:
        """True while a started walk has not finished: the frontend's
        cold-shape deferral window."""
        return self._started and not self._done.is_set()

    def _primary_keys(self, n_oracles: int, dimension: int, cfg) -> List[CompileKey]:
        """The keys the pinned router can dispatch for one group: its own
        variant across the bucket ladder."""
        router = self.router
        sharded = router._shard is not None
        return [
            dispatch_key(sanitized=router.sanitized_dispatch, sharded=sharded, bucket=bucket,
                         n_oracles=n_oracles, dimension=dimension, cfg=cfg,
                         donate=router.device_resident and not sharded,
                         impl=router.consensus_impl, mesh=router.mesh_spec)
            for bucket in bucket_ladder(router.max_claims_per_batch,
                                        multiple_of=router._shard.claim_size if sharded else 1)
        ]

    def group_cold(self, n_oracles: int, dimension: int, cfg) -> bool:
        """Whether a group can still hit a cold dispatch while the walk is
        in flight (its primary keys only: the twins are for the next
        restart)."""
        if not self.active:
            return False
        group = (n_oracles, dimension, cfg)
        with self._lock:
            primary = self._primary.get(group)
            if primary is not None:
                return any(k not in self._warm for k in primary)
        primary = self._primary_keys(*group)  # registered after the enumeration
        with self._lock:
            self._primary.setdefault(group, primary)
            return any(k not in self._warm for k in primary)

    def claim_cold(self, spec) -> bool:
        return self.group_cold(spec.n_oracles, spec.dimension, spec.consensus_config())

    # -- one key ---------------------------------------------------------------

    def step(self, key: CompileKey) -> str:
        """Warm one key; returns the outcome it counted."""
        try:
            outcome = self._warm_one(key)
        except Exception as e:  # noqa: BLE001 — a broken shape must not kill the walk
            outcome = "error"
            _log.warning("prewarm failed for %s (%s: %s); its first dispatch will load inline",
                         key.label(), type(e).__name__, e)
        self._metrics.counter(PREWARM_COUNTER, labels={"outcome": outcome}).add(1)
        if outcome in ("compiled", "primed"):
            with self._lock:
                self._warm.add(key)
        return outcome

    def _warm_one(self, key: CompileKey) -> str:
        built = False
        if key.impl == "cuda":
            _build_serving_kernels(self._clock, self._metrics)
            built = True
        if not self.config.prime:
            return "compiled" if built else "skipped"
        if built:
            with self._lock:
                if key.group() in self._primed_groups:
                    return "compiled"  # another bucket of a primed group: the same library
            self._prime(key)
            with self._lock:
                self._primed_groups.add(key.group())
            return "compiled"
        self._prime(key)
        return "primed"

    def _prime(self, key: CompileKey) -> None:
        if key.kind.startswith("sharded_"):
            if self.router._shard is None:
                raise ValueError(f"{key.label()} is a sharded key but the router has no mesh: a stale universe")
            prime_key(key, self.router.device, shard=self.router._shard)
            return
        if key.donate and self.router.device_resident:
            self.router.prime_staging(key)
            return
        # A router that stages nothing runs a donate key's dispatch as its
        # non-donate twin's (the same B3 library; unlike XLA, nothing is
        # compiled apart): warm once that twin is.
        twin = dataclasses.replace(key, donate=False)
        if key.donate and self.is_warm(twin):
            return
        prime_key(twin, self.router.device)

    def mark_warm(self, keys) -> None:
        """Count ``keys`` as warmed by an earlier walk (the
        reconfiguration plane's PREPARE warms a stack before it exists):
        their first dispatch on this router counts ``prewarmed``."""
        with self._lock:
            self._warm.update(keys)

    # -- the walk --------------------------------------------------------------

    def warm_all(self, budget_s: Optional[float] = None,
                 include_twins: Optional[bool] = None) -> Dict[str, Any]:
        """Walk the refreshed universe in priority order under the budget;
        returns the report.  Warmed keys are skipped on a later call."""
        self._started = True
        self._done.clear()
        try:
            keys = self.universe(refresh=True, include_twins=include_twins)
        except BaseException:
            self._done.set()  # an enumeration error must not defer forever
            raise
        return self._walk(keys, budget_s)

    def _walk(self, keys: List[CompileKey], budget_s: Optional[float]) -> Dict[str, Any]:
        budget = budget_s if budget_s is not None else self.config.budget_s
        started_at = self._clock()
        outcomes: Dict[str, int] = {}
        try:
            for i, key in enumerate(keys):
                if self.is_warm(key):
                    continue
                if budget is not None and (self._clock() - started_at) > budget:
                    remaining = sum(1 for k in keys[i:] if not self.is_warm(k))
                    self._metrics.counter(PREWARM_COUNTER,
                                          labels={"outcome": "budget_exhausted"}).add(remaining)
                    outcomes["budget_exhausted"] = outcomes.get("budget_exhausted", 0) + remaining
                    break
                outcome = self.step(key)
                outcomes[outcome] = outcomes.get(outcome, 0) + 1
        finally:
            self._done.set()
        report = {
            "universe": universe_summary(keys),
            "outcomes": outcomes,
            "warmed": len(self._warm),
            "elapsed_s": round(self._clock() - started_at, 4),
            "budget_s": budget,
        }
        with self._lock:
            self._report = report
        return report

    def start(self, budget_s: Optional[float] = None,
              include_twins: Optional[bool] = None) -> threading.Thread:
        """Run the walk on a daemon thread (the serving deployment's
        mode: the tier serves, and defers cold shapes, meanwhile).  The
        universe is enumerated first, so the defer gate knows its keys
        before it opens.  Idempotent while a walk is live."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self._thread
        keys = self.universe(refresh=True, include_twins=include_twins)
        self._started = True
        self._done.clear()
        thread = threading.Thread(target=self._walk, args=(keys, budget_s), name="svoc-prewarm",
                                  daemon=True)
        with self._lock:
            self._thread = thread
        thread.start()
        return thread

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the walk finishes; True iff it did."""
        return self._done.wait(timeout)

    def stats(self) -> Dict[str, Any]:
        """Warmed count, universe size, liveness and the last report."""
        with self._lock:
            universe = self._universe
            report = self._report
            warmed = len(self._warm)
        return {
            "active": self.active,
            "warmed": warmed,
            "universe": len(universe) if universe is not None else None,
            "report": report,
        }


def prime_key(key: CompileKey, device, shard=None) -> None:
    """One dispatch of an all-padding cube of ``key``'s shape through the
    public wrappers, on ``device`` (a ``sharded_*`` key through the
    router's :class:`~svoc_torch.parallel.claim_shard.ClaimShardDispatcher`
    ``shard``); its outputs are discarded once they are on the host.  No
    journal, no state."""
    import torch

    from svoc_torch.consensus.batch import (
        _PAD_VALUE,
        claims_consensus_gated,
        claims_consensus_sanitized,
    )
    from svoc_torch.robustness.sanitize import SanitizeConfig

    values = torch.full((key.bucket, key.n_oracles, key.dimension), _PAD_VALUE,
                        dtype=torch.float32, device=device)
    mask = torch.zeros(key.bucket, dtype=torch.bool, device=device)
    sharded = key.kind.startswith("sharded_")
    if key.kind.endswith("sanitized"):
        bounds = SanitizeConfig.for_consensus(key.cfg.constrained)
        if sharded:
            out, _ok = shard.dispatch_sanitized(values, mask, key.cfg, bounds.lo, bounds.hi)
        else:
            out, _ok = claims_consensus_sanitized(values, mask, key.cfg, bounds.lo, bounds.hi)
    else:
        ok = torch.ones(key.bucket, key.n_oracles, dtype=torch.bool, device=device)
        if sharded:
            out = shard.dispatch_gated(values, ok, mask, key.cfg)
        else:
            out = claims_consensus_gated(values, ok, mask, key.cfg)
    out.interval_valid.cpu()  # waits for the launch


def warm_keys(keys, *, budget_s: float = 0.0, clock=None, metrics=None) -> Dict[str, int]:
    """Budgeted walk over an explicit key list with no live router behind
    it: each CUDA key builds or loads the serving libraries (``compiled``); a
    sharded key (warmed inside its mesh, as the reference's) or a CPU key
    has nothing to build here (``skipped``).  Never dispatches, never journals.  ``budget_s <= 0``
    walks them all; otherwise the keys past the deadline count
    ``deferred``."""
    clock = clock if clock is not None else time.monotonic
    metrics = metrics if metrics is not None else _default_registry
    deadline = clock() + budget_s if budget_s > 0 else None
    out = {"compiled": 0, "skipped": 0, "deferred": 0}
    keys = list(keys)
    for i, key in enumerate(keys):
        if deadline is not None and clock() >= deadline:
            out["deferred"] = len(keys) - i
            break
        if key.kind.startswith("sharded_") or key.impl != "cuda":
            out["skipped"] += 1
            continue
        _build_serving_kernels(clock, metrics)
        out["compiled"] += 1
    return out
