"""The claim router: fair micro-batches through one consensus dispatch.

Mirrors :mod:`svoc_tpu.fabric.router` (``router.py:189-977``): each
:meth:`ClaimRouter.step`

1. **selects** up to ``max_claims_per_batch`` claims by weighted
   round-robin (a claim of weight *w* holds *w* slots in the rotation;
   selection is deterministic, so seeded fabric runs replay
   byte-identically),
2. **fetches** each selected claim through its own
   :meth:`~svoc_torch.apps.session.Session.fetch` (window → sentiment →
   fleet → counted quarantine verdict, lineage
   ``blk<scope>-<claim>-<n>``),
3. **batches** the fetched fleet blocks into claim cubes — grouped by
   ``(n_oracles, dimension, consensus config)``, padded to a
   power-of-two claim count (:func:`svoc_torch.consensus.batch.pad_claim_cube`)
   — and runs ONE gated consensus dispatch per group
   (:func:`dispatch_group`: the plain claim-cube forms on the CPU, one
   launch of the gated claim-cube kernel on CUDA), giving every claim
   its essence, ``interval_valid`` and reliability mask,
4. **commits** each claim resiliently (retry + resume + breaker +
   supervisor — the claim's own instances), folds the supervisor, and
5. **accounts** the per-claim SLO counters
   (``claim_commit_cycles{claim=}`` …) that
   :func:`svoc_torch.utils.slo.claim_slos` evaluates.

One claim's Byzantine offender, dead chain, or burning error budget
stays in that claim's fleet, breaker, and SLO — sibling claims share
only the device dispatch.

Every dispatch is counted ``cold``, ``prewarmed`` or ``warm`` under
``consensus_dispatch{warmth=}`` by its
:class:`~svoc_torch.compile.universe.CompileKey` (``router.py:715-768``):
``prewarmed`` is the first dispatch of a key that the attached
:class:`~svoc_torch.compile.prewarm.PrewarmWorker` already warmed
(:meth:`ClaimRouter.attach_prewarmer`).  ``warmup_mode`` resolves once
at construction (:func:`svoc_torch.compile.modes.resolve_warmup_mode`:
``SVOC_WARMUP``, then the committed ``"prewarm"``); the router only
records it, and ``MultiSession.start_prewarm`` and the serving loop act
on it.  When the serving tier sets ``cost_plane``, each dispatch's host
seconds feed the cost ledger and its claims get the ``h2d``,
``dispatched``, ``synced`` and ``committed`` timeline marks
(``router.py:553-558, 628-698, 815-850``).  None of this reaches the
journal, so the fingerprints do not change.

``device_resident=True`` stages each ``(n_oracles, dim, cfg)`` group's
cube in a record kept for the process (:class:`_GroupStaging`, the twin
of ``router.py:149-186`` and ``_group_staging``/``_h2d`` at
``:771-797``): host buffers (pinned on CUDA) filled in place each cycle,
and persistent tensors on the router's device that one copy a buffer
refills.  The padded cube goes straight to the claim-cube dispatch, and
the result is bit-identical to the unstaged path's (its dispatches key
``donate=True``).

``mesh=`` pins a claim mesh once, at construction (``"<claims>x<oracles>"``,
a :class:`~svoc_torch.parallel.mesh.Mesh`, or a
:class:`~svoc_torch.parallel.claim_shard.ClaimShardDispatcher`; None reads
``SVOC_MESH``, ``"off"`` is none; ``router.py:229-242, 334-355``): each
group's cube is padded to a multiple of the mesh's claim axis and
dispatched claim-sharded (B3 once a claim shard on CUDA), bitwise the
unsharded dispatch, so a mesh never changes what the fabric journals.
The journaled ``batch_bucket`` stays the mesh-independent power of two.
There is no ``consensus_impl`` routing: the route follows the device.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from svoc_torch.apps.session import DegenerateBlockError, EmptyStoreError
from svoc_torch.compile.modes import ALLOWED_WARMUP_MODES, CompilePlaneError, resolve_warmup_mode
from svoc_torch.compile.universe import dispatch_key
from svoc_torch.consensus.batch import (
    _PAD_VALUE,
    _no_impl_routing,
    claims_consensus_gated,
    claims_consensus_sanitized,
    pad_claim_cube,
    pow2_bucket,
)
from svoc_torch.consensus.kernel import ConsensusConfig, ConsensusOutput
from svoc_torch.device import resolve_device
from svoc_torch.fabric.registry import ClaimRegistry, ClaimState
from svoc_torch.io.chain import ChainCommitError
from svoc_torch.resilience.breaker import CircuitOpenError
from svoc_torch.robustness.sanitize import SanitizeConfig
from svoc_torch.utils.events import resolve_journal
from svoc_torch.utils.metrics import MetricsRegistry
from svoc_torch.utils.metrics import registry as _default_registry
from svoc_torch.utils.metrics import stage_span
from svoc_torch.utils.rounding import round6_list


def dispatch_group(
    blocks,
    oks,
    cfg: ConsensusConfig,
    sanitized: bool = False,
    shard=None,
) -> Tuple[ConsensusOutput, torch.Tensor]:
    """One consensus dispatch over the ``[N, M]`` fleet blocks of ``C``
    claims that share a shape and ``cfg`` (the non-meshed branch of the
    reference's ``_dispatch_group``, ``router.py:567-713``): pad the
    cube to its power-of-two bucket, one dispatch, keep the first ``C``
    rows.  ``blocks`` is a ``[C, N, M]`` tensor or a sequence of
    ``[N, M]`` tensors.

    ``sanitized=True`` (the router's ``sanitized_dispatch`` mode)
    computes the admission masks from the cube on its device, with the
    bounds of ``SanitizeConfig.for_consensus(cfg.constrained)``, and
    ignores ``oks``; otherwise ``oks`` are the claims' ``[N]`` admission
    masks (a ``[C, N]`` tensor or a sequence; all admitted when None).
    Returns ``(output, ok)``, each with ``C`` rows.  ``shard`` (a
    :class:`~svoc_torch.parallel.claim_shard.ClaimShardDispatcher`) pads
    the cube to a multiple of its claim axis and dispatches it there (the
    meshed branch)."""
    if isinstance(blocks, torch.Tensor):
        values = blocks.to(torch.float32)
    else:
        values = torch.stack([b.to(torch.float32) for b in blocks])
    c = values.shape[0]
    if oks is not None and not sanitized and not isinstance(oks, torch.Tensor):
        oks = torch.stack(list(oks))
    multiple = shard.claim_size if shard is not None else 1
    values, ok, claim_mask = pad_claim_cube(values, None if sanitized else oks, multiple_of=multiple)
    return dispatch_padded(values, ok, claim_mask, cfg, c, sanitized, shard)


def dispatch_padded(
    values: torch.Tensor,
    ok: torch.Tensor,
    claim_mask: torch.Tensor,
    cfg: ConsensusConfig,
    c: int,
    sanitized: bool = False,
    shard=None,
) -> Tuple[ConsensusOutput, torch.Tensor]:
    """One consensus dispatch over an already padded cube (``values [B,
    N, M]``, ``ok [B, N]``, ``claim_mask [B]``; ``ok`` is ignored when
    ``sanitized``), claim-sharded through ``shard`` when one is given.
    Returns ``(output, ok)`` with the first ``c`` rows."""
    if sanitized:
        bounds = SanitizeConfig.for_consensus(cfg.constrained)
        if shard is not None:
            out, ok = shard.dispatch_sanitized(values, claim_mask, cfg, bounds.lo, bounds.hi)
        else:
            out, ok = claims_consensus_sanitized(values, claim_mask, cfg, bounds.lo, bounds.hi)
    elif shard is not None:
        out = shard.dispatch_gated(values, ok, claim_mask, cfg)
    else:
        out = claims_consensus_gated(values, ok, claim_mask, cfg)
    return ConsensusOutput(*(field[:c] for field in out)), ok[:c]


class _GroupStaging:
    """Reusable staging for one ``(n_oracles, dim, cfg)`` dispatch group
    (``ClaimRouter(device_resident=True)``; ``router.py:149-186``): the
    cube, the admission masks and the claim mask live in host buffers
    updated in place each cycle (pinned on CUDA), and in persistent
    tensors on the router's device that :meth:`upload` refills with one
    copy a buffer.

    Pad rows are written once, at allocation (neutral fill, every
    oracle admitted, claim inactive), and again only on the rows a
    shrinking batch leaves behind (``active`` is the last batch's
    size): bit for bit :func:`pad_claim_cube`'s output.  A buffer is
    written only after the copy that last read it has finished (the
    event recorded after each upload).  On the CPU the "device" tensors
    are separate tensors that the upload copies into, never views of
    the host buffers (the aliasing hazard of ``router.py:786-797``)."""

    __slots__ = ("bucket", "host", "dev", "_arrays", "active", "_copied")

    def __init__(self, bucket: int, n: int, m: int, device: torch.device):
        pin = device.type == "cuda"
        self.bucket = bucket
        self.host = (
            torch.full((bucket, n, m), _PAD_VALUE, dtype=torch.float32, pin_memory=pin),
            torch.ones((bucket, n), dtype=torch.bool, pin_memory=pin),
            torch.zeros(bucket, dtype=torch.bool, pin_memory=pin),
        )
        #: numpy views of the host buffers: the per-cycle writes.
        self._arrays = tuple(t.numpy() for t in self.host)
        self.dev = tuple(t.to(device, copy=True) for t in self.host)
        self.active = 0
        self._copied: Optional[torch.cuda.Event] = None

    def load(self, blocks, oks) -> None:
        """Write this cycle's blocks into rows ``[0, C)`` (``np.copyto``'s
        float64 → float32 cast rounds as ``np.asarray(..., float32)``
        does on the unstaged path) and restore the pad state on rows the
        previous, larger batch used."""
        if self._copied is not None:
            self._copied.synchronize()
        values, ok, mask = self._arrays
        c = len(blocks)
        for i, block in enumerate(blocks):
            np.copyto(values[i], block, casting="same_kind")
            np.copyto(ok[i], oks[i])
        if self.active > c:
            values[c : self.active] = _PAD_VALUE
            ok[c : self.active] = True
        mask[:c] = True
        mask[c:] = False
        self.active = c

    def upload(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One copy a buffer into the persistent device tensors, on the
        current stream (the dispatch that reads them follows on it);
        returns ``(values, ok, claim_mask)``."""
        cuda = self.dev[0].device.type == "cuda"
        for dst, src in zip(self.dev, self.host):
            dst.copy_(src, non_blocking=cuda)
        if cuda:
            self._copied = torch.cuda.Event()
            self._copied.record()
        return self.dev


class _PendingGroup:
    """One in-flight claim-cube dispatch: the device outputs plus the
    per-claim context (lineage, admission masks) captured at dispatch
    time, so the pipelined write-back one cycle later journals against
    the RIGHT blocks even after the sessions fetched new ones."""

    __slots__ = ("members", "out", "ok", "bucket", "lineages", "warmth_key", "warmth",
                 "h2d_s", "dispatch_s")

    def __init__(self, members, out, ok, bucket, lineages, warmth_key=None, warmth="warm",
                 h2d_s=0.0, dispatch_s=0.0):
        self.members = members
        self.out = out
        self.ok = ok
        self.bucket = bucket
        self.lineages = lineages
        #: The dispatch's CompileKey and warmth, kept for the cost
        #: ledger (None when the plane is off), and its measured host
        #: seconds so far.
        self.warmth_key = warmth_key
        self.warmth = warmth
        self.h2d_s = h2d_s
        self.dispatch_s = dispatch_s


class ClaimRouter:
    """Multiplexes fetch → vectorize → consensus → commit across the
    registry's claims.  ``step()`` is the single-threaded scheduling
    loop (the fabric's controller thread); registry mutation and
    snapshot reads are safe concurrently.  The claim cubes are
    dispatched on ``device`` (``None``: CUDA, raising without a card)."""

    def __init__(
        self,
        registry: ClaimRegistry,
        *,
        max_claims_per_batch: int = 8,
        metrics: Optional[MetricsRegistry] = None,
        journal=None,
        sanitized_dispatch: bool = False,
        consensus_impl: Optional[str] = None,
        mesh=None,
        pipelined: bool = False,
        device_resident: bool = False,
        warmup_mode: Optional[str] = None,
        device=None,
    ):
        if max_claims_per_batch < 1:
            raise ValueError("max_claims_per_batch must be >= 1")
        _no_impl_routing(consensus_impl)
        if warmup_mode is not None and warmup_mode not in ALLOWED_WARMUP_MODES:
            raise CompilePlaneError(
                f"warmup_mode {warmup_mode!r} is not one of {ALLOWED_WARMUP_MODES}"
            )
        self.registry = registry
        self.max_claims_per_batch = max_claims_per_batch
        self.device = resolve_device(device)
        self._metrics = metrics or _default_registry
        self._journal = journal
        #: The serving tier's cost-attribution plane
        #: (:class:`~svoc_torch.obsplane.plane.CostPlane`); None: no
        #: cost accounting.
        self.cost_plane = None
        #: The compile plane's warmup routing, pinned here: cold, prewarmed
        #: and warm dispatches must mean one thing a process.
        self.warmup_mode = warmup_mode if warmup_mode is not None else resolve_warmup_mode()
        #: The attached prewarm worker (None until :meth:`attach_prewarmer`
        #: or ``MultiSession.start_prewarm``).
        self.prewarmer = None
        #: The claim mesh, resolved and pinned once (part of a seeded
        #: replay's config, as the impl is): a
        #: ClaimShardDispatcher, or None for the unsharded dispatch.
        self._shard = self._build_shard(mesh)
        self.mesh_spec = self._shard.spec_str if self._shard else None
        #: The route of every claim-cube dispatch, read only: one kernel
        #: launch on CUDA, the plain forms on the CPU.
        self.consensus_impl = "cuda" if self.device.type == "cuda" else "plain"
        #: CompileKeys dispatched at least once (the cold/warm boundary
        #: of ``consensus_dispatch{warmth=}``), and each cube shape's key.
        self._warmth_seen: set = set()
        self._warmth_keys: Dict[Any, Any] = {}
        #: Double-buffered dispatch: the claim-cube consensus for cycle
        #: k-1 runs on the device while the host fetches (and commits)
        #: cycle k — its write-back (state.last_consensus,
        #: ``fabric.consensus`` events) lands one cycle later, drained
        #: by :meth:`flush`.  Pull-mode only: request-driven feeds need
        #: same-cycle accounting.  Its own fingerprint family.
        self.pipelined = pipelined
        self._inflight: List[_PendingGroup] = []
        #: Resident staging: each (N, M, cfg) group's cube is staged in a
        #: record kept for the process and refilled in place each cycle
        #: (:class:`_GroupStaging`).  Bit-identical to the unstaged path,
        #: so not a fingerprint family; its dispatches key ``donate=True``.
        self.device_resident = bool(device_resident)
        #: The dispatches that read the staging tensors key donate=True;
        #: a meshed dispatch keys its sharded kind instead.
        self._donate = self.device_resident and self._shard is None
        self._staging: Dict[Any, _GroupStaging] = {}
        #: Fuse gate + consensus into ONE device pass per micro-batch
        #: (:func:`svoc_torch.consensus.batch.claims_consensus_sanitized`)
        #: instead of reusing the host gate's per-claim verdicts.
        self.sanitized_dispatch = sanitized_dispatch
        self._lock = threading.Lock()
        #: weighted rotation: claim ids, each appearing ``weight``
        #: times.  Rebuilt lazily when the registry's membership
        #: changes; rotation POSITION survives rebuilds (fairness
        #: across adds/removes).
        self._rotation: deque = deque()
        self._rotation_members: Tuple[Tuple[str, int], ...] = ()
        self.steps = 0
        #: End-of-cycle hooks, called with the step report AFTER every
        #: claim was committed/accounted.  Hooks run in registration
        #: order on the router thread; an exception is counted
        #: (``fabric_hook_errors``) and never kills the loop.
        self.post_step_hooks: List[Any] = []

    def _resolve_journal(self):
        return resolve_journal(self._journal)

    def _build_shard(self, mesh):
        """The claim-shard dispatcher for ``mesh`` (constructor only), or
        None for the unsharded dispatch."""
        from svoc_torch.parallel.claim_shard import ClaimShardDispatcher
        from svoc_torch.parallel.mesh import Mesh, claim_mesh, resolve_claim_mesh

        if isinstance(mesh, ClaimShardDispatcher):
            return mesh
        if not isinstance(mesh, Mesh):
            mesh = claim_mesh(mesh if mesh is not None else resolve_claim_mesh(), device=self.device)
            if mesh is None:
                return None
        return ClaimShardDispatcher(mesh, metrics=self._metrics)

    # -- scheduling ---------------------------------------------------------

    def _refresh_rotation_locked(self, states: List[ClaimState]) -> None:
        members = tuple(
            (s.spec.claim_id, s.spec.weight)
            for s in sorted(states, key=lambda s: s.index)
        )
        if members == self._rotation_members:
            return
        # Preserve relative order of surviving ids; new claims join at
        # the rotation tail in registration order.
        old_order = [cid for cid in self._rotation]
        alive = {cid for cid, _w in members}
        seen = set()
        new_rotation: List[str] = []
        for cid in old_order:
            if cid in alive and cid not in seen:
                seen.add(cid)
                new_rotation.append(cid)
        for cid, _w in members:
            if cid not in seen:
                seen.add(cid)
                new_rotation.append(cid)
        weights = dict(members)
        expanded: List[str] = []
        for cid in new_rotation:
            expanded.extend([cid] * weights[cid])
        self._rotation = deque(expanded)  # svoc: volatile(derived from registry membership + weights; rebuilt on the next select() after any membership change)
        self._rotation_members = members  # svoc: volatile(cache key for the rotation rebuild; derived like _rotation)

    def select(self) -> List[ClaimState]:
        """The next micro-batch: up to ``max_claims_per_batch`` DISTINCT
        unpaused claims in weighted-rotation order.  Deterministic —
        the replay witness covers scheduling, not just math."""
        states = self.registry.states()
        by_id = {s.spec.claim_id: s for s in states}
        with self._lock:
            self._refresh_rotation_locked(states)
            if not self._rotation:
                return []
            selected: List[ClaimState] = []
            picked = set()
            # One full rotation scan at most: claims beyond the batch
            # cap (or paused) keep their slots for the next step.
            for _ in range(len(self._rotation)):
                cid = self._rotation[0]
                self._rotation.rotate(-1)
                if cid in picked:
                    continue
                state = by_id.get(cid)
                if state is None or state.paused:
                    continue
                picked.add(cid)
                selected.append(state)
                if len(selected) >= self.max_claims_per_batch:
                    break
            return selected

    # -- the multiplexed cycle ----------------------------------------------

    def step(
        self, feeds: Optional[Dict[str, Any]] = None
    ) -> Dict[str, Any]:
        """One fabric cycle over the next micro-batch.  Never raises on
        a per-claim failure (an empty store or open breaker in one
        claim must not starve its siblings); per-claim errors land in
        the report and the claim's own counters.

        ``feeds`` switches the cycle to **request-driven** feeding
        (docs/SERVING.md): a ``{claim_id: [K, M] sentiment vectors}``
        map.  Only fed claims are served this cycle, each through
        ``Session.fetch(window=...)``, preserving lineage, gate
        verdicts, and the per-claim isolation contract: a claim whose
        feed is malformed lands in ITS
        ``fabric_claim_errors{claim=,stage="fetch"}`` and its siblings
        are still served.  ``feeds=None`` is the pull-mode cycle."""
        if self.pipelined and feeds is not None:
            raise ValueError(
                "pipelined dispatch is pull-mode only: request-driven "
                "feeds need same-cycle consensus accounting"
            )
        report = self._step_inner(feeds=feeds)
        for hook in list(self.post_step_hooks):
            try:
                hook(report)
            except Exception:  # noqa: BLE001 — a hook must not kill serving
                self._metrics.counter("fabric_hook_errors").add(1)
        return report

    def flush(self) -> int:
        """Drain the pipelined in-flight consensus write-backs (the
        pipeline's one-cycle tail); returns how many groups were
        finished.  A no-op when unpipelined or already drained."""
        pending, self._inflight = self._inflight, []  # svoc: volatile(pipelined device buffers are process-local; a crashed cycle's groups are re-selected from the registry next step)
        if pending:
            with stage_span("fabric_consensus"):
                for group in pending:
                    self._finish_group(group)
        return len(pending)

    def _step_inner(
        self, feeds: Optional[Dict[str, Any]] = None
    ) -> Dict[str, Any]:
        self.steps += 1
        report: Dict[str, Any] = {
            "step": self.steps,
            "served": [],
            "skipped": {},
            "claims": {},
        }
        if feeds is None:
            selected = self.select()
        else:
            # Registration order (deterministic), fed + unpaused claims
            # only.  Unknown claim ids in the feed are a caller bug —
            # surfaced in the report, never fatal to the batch.
            selected = []
            known = {s.spec.claim_id: s for s in self.registry.states()}
            for cid in feeds:
                state = known.get(cid)
                if state is None:
                    report["skipped"][cid] = "unknown_claim"
                elif state.paused:
                    report["skipped"][cid] = "paused"
                else:
                    selected.append(state)
            selected.sort(key=lambda s: s.index)
        if not selected:
            return report

        # ---- fetch every selected claim (its own lineage + verdict) ----
        fetched: List[ClaimState] = []
        for state in selected:
            spec = state.spec
            tamper = None
            if spec.tamper is not None:
                cycle = state.cycles
                tamper = lambda block, _t=spec.tamper, _c=cycle: _t(_c, block)
            try:
                state.session.fetch(
                    tamper=tamper,
                    window=None if feeds is None else feeds[spec.claim_id],
                )
            except EmptyStoreError:  # svoclint: disable=SVOC014 -- deliberate: an empty store is the routine pre-data wait, surfaced per claim in the step report's `skipped` map; anomalies take the counted fabric_claim_errors lane below
                report["skipped"][spec.claim_id] = "empty_store"
                continue
            except Exception as e:  # noqa: BLE001 — isolation contract
                # ANY per-claim fetch failure skips THIS claim, never
                # the batch — and, unlike the routine empty-store wait,
                # surfaces in its own anomaly counter.
                report["skipped"][spec.claim_id] = (
                    f"fetch_error:{type(e).__name__}"
                )
                self._metrics.counter(
                    "fabric_claim_errors",
                    labels={"claim": spec.claim_id, "stage": "fetch"},
                ).add(1)
                continue
            fetched.append(state)
        if not fetched:
            return report

        # ---- claim-cube consensus: one dispatch per (shape, config) ----
        groups: Dict[Any, List[ClaimState]] = {}
        for state in fetched:
            spec = state.spec
            key = (spec.n_oracles, spec.dimension, spec.consensus_config())
            groups.setdefault(key, []).append(state)
        if self.pipelined:
            # Double-buffered dispatch: enqueue cycle k's cubes (no host
            # sync), THEN resolve cycle k-1's.  The commit below still
            # commits cycle k's blocks (the chain path never consumed
            # the cube outputs); only state.last_consensus and the
            # ``fabric.consensus`` events trail one cycle, against the
            # lineages captured at dispatch.
            dispatched = [
                self._dispatch_group(members, cfg)
                for (_n, _m, cfg), members in groups.items()
            ]
            pending, self._inflight = self._inflight, dispatched
            with stage_span("fabric_consensus"):
                for group in pending:
                    self._finish_group(group)
        else:
            with stage_span("fabric_consensus"):
                for (_n, _m, cfg), members in groups.items():
                    self._finish_group(self._dispatch_group(members, cfg))

        # ---- commit + supervise + SLO, claim by claim ----
        plane = self.cost_plane
        track = plane is not None and plane.enabled
        for state in fetched:
            self._commit_claim(state)
            if track:
                plane.claim_mark([state.spec.claim_id], "committed")
            state.cycles += 1
            report["served"].append(state.spec.claim_id)
            report["claims"][state.spec.claim_id] = {
                "consensus": state.last_consensus,
                "commit": state.last_commit,
            }
        return report

    def _dispatch_group(
        self, members: List[ClaimState], cfg
    ) -> _PendingGroup:
        """Collect one shape/config group's blocks and run ONE gated
        consensus dispatch — device outputs only, no host sync (the
        pipelined mode's overlap window lives between this and
        :meth:`_finish_group`).  The cube and its masks go to the device
        in one copy each."""
        lineages = []
        blocks = []
        oks = []
        with stage_span("fabric_stage"):
            for state in members:
                session = state.session
                with session.lock:
                    predictions = session.predictions
                    quarantine = session.last_quarantine
                    lineages.append(session.last_lineage)
                blocks.append(predictions)
                oks.append(
                    np.asarray(quarantine.ok, dtype=bool)
                    if quarantine is not None
                    else np.ones(predictions.shape[0], dtype=bool)
                )
            n, m = np.shape(blocks[0])
            multiple = self._shard.claim_size if self._shard else 1
            if self.device_resident:
                # In place: no host allocation in the steady state.  The
                # per-claim ``oks`` arrays stay the accounting source.
                staging = self._group_staging(len(blocks), n, m, cfg, multiple)
                staging.load(blocks, oks)
            else:
                cube = np.stack([np.asarray(b, dtype=np.float32) for b in blocks])
                ok = np.stack(oks)
        # The journaled batch_bucket is the mesh-independent power of two:
        # padding to the mesh's claim axis must not reach the journal.
        bucket = pow2_bucket(len(members))
        warmth_key, warmth = self._account_warmth(pow2_bucket(len(members), multiple_of=multiple), n, m, cfg)
        # Cost plane: host perf_counter windows around the copy and the
        # dispatch feed the ledger; the claims' marks ride the plane's
        # (the tier's) clock.  Off, the path is the plane-less one.
        plane = self.cost_plane
        track = plane is not None and plane.enabled
        claim_ids = [s.spec.claim_id for s in members] if track else None
        t_start = time.perf_counter() if track else 0.0
        with stage_span("fabric_h2d"):
            if self.device_resident:
                values_dev, ok_dev, mask_dev = staging.upload()
            else:
                values_dev = torch.from_numpy(cube).to(self.device)
                ok_dev = None if self.sanitized_dispatch else torch.from_numpy(ok).to(self.device)
        h2d_s = dispatch_s = 0.0
        if track:
            h2d_s = time.perf_counter() - t_start
            plane.claim_mark(claim_ids, "h2d")
        with stage_span("fabric_dispatch"):
            if self.device_resident:
                out, ok_out = dispatch_padded(values_dev, ok_dev, mask_dev, cfg, len(members),
                                              sanitized=self.sanitized_dispatch, shard=self._shard)
                if not self.sanitized_dispatch:
                    # A view of the staging tensor the next cycle refills:
                    # the pipelined write-back reads it a cycle later.
                    ok_out = ok_out.clone()
            else:
                out, ok_out = dispatch_group(
                    values_dev, ok_dev, cfg, sanitized=self.sanitized_dispatch, shard=self._shard
                )
        if track:
            dispatch_s = max(0.0, time.perf_counter() - t_start - h2d_s)
            plane.claim_mark(claim_ids, "dispatched")
        # Seen only once the dispatch returned: a raising dispatch
        # counts cold again on its retry.
        self._warmth_seen.add(warmth_key)
        # The journaled batch_bucket is the pow2 bucket of the group.
        return _PendingGroup(members, out, ok_out, bucket, lineages,
                             warmth_key=warmth_key if track else None, warmth=warmth,
                             h2d_s=h2d_s, dispatch_s=dispatch_s)

    def _account_warmth(self, bucket: int, n: int, m: int, cfg):
        """Count this dispatch under ``consensus_dispatch{warmth=}``:
        ``cold`` (the first of its CompileKey in this process, and no
        prewarmer warmed it: on CUDA it pays the kernel library's build or
        load, where the reference's pays a compile), ``prewarmed`` (the
        first, of a key the attached worker warmed) or ``warm`` (every
        repeat); returns ``(key, warmth)``.  The caller marks the key seen
        once the dispatch returned.  Metrics only: the journal never sees
        warmth."""
        shape_key = (bucket, n, m, cfg)
        key = self._warmth_keys.get(shape_key)
        if key is None:
            key = dispatch_key(
                sanitized=self.sanitized_dispatch, sharded=self._shard is not None, bucket=bucket,
                n_oracles=n, dimension=m, cfg=cfg, donate=self._donate,
                impl=self.consensus_impl, mesh=self.mesh_spec,
            )
            self._warmth_keys[shape_key] = key
        if key in self._warmth_seen:
            warmth = "warm"
        elif self.prewarmer is not None and self.prewarmer.is_warm(key):
            warmth = "prewarmed"
        else:
            warmth = "cold"
        self._metrics.counter("consensus_dispatch", labels={"warmth": warmth}).add(1)
        return key, warmth

    def _group_staging(self, c: int, n: int, m: int, cfg, multiple: int = 1) -> _GroupStaging:
        """The group's staging record, sized to ``c`` claims' power-of-two
        bucket (a multiple of the mesh's claim axis): reallocated only when
        the bucket changes, so the steady state reuses one allocation a
        group for the process."""
        bucket = pow2_bucket(c, multiple_of=multiple)
        key = (n, m, cfg)
        with self._lock:
            staging = self._staging.get(key)
            if staging is None or staging.bucket != bucket:
                staging = _GroupStaging(bucket, n, m, self.device)
                self._staging[key] = staging
        return staging

    def prime_staging(self, key) -> None:
        """Prime a ``donate`` key on a resident router (the prewarm
        worker's step): fill a staging record of the key's shape with
        padding alone, upload it and dispatch it through the staged path,
        then wait.  The router keeps the record when it has none for the
        group yet; a record it already owns is never written from here."""
        if not self.device_resident:
            raise ValueError("prime_staging primes a resident router's staging; this router stages nothing")
        staging = _GroupStaging(key.bucket, key.n_oracles, key.dimension, self.device)
        staging.load([], [])
        values, ok, mask = staging.upload()
        out, _ok = dispatch_padded(values, ok, mask, key.cfg, key.bucket,
                                   sanitized=key.kind == "sanitized")
        out.interval_valid.cpu()  # waits for the launch
        with self._lock:
            self._staging.setdefault(key.group(), staging)

    def attach_prewarmer(self, worker) -> None:
        """Wire a :class:`~svoc_torch.compile.prewarm.PrewarmWorker` into
        the warmth accounting (and the serving tier's cold-shape gate,
        which reads ``router.prewarmer``)."""
        self.prewarmer = worker

    def _finish_group(self, pending: _PendingGroup) -> None:
        """Bring one dispatched group to the host and write each member's
        per-claim slice back (consensus state, journal, metrics)."""
        members = pending.members
        out = pending.out
        c = len(members)
        n, m = out.reliable.shape[1], out.essence.shape[1]
        plane = self.cost_plane
        track = plane is not None and plane.enabled and pending.warmth_key is not None
        t_sync = time.perf_counter() if track else 0.0
        with stage_span("fabric_sync"):
            # ONE host copy for the whole micro-batch: every field the
            # write-back reads, as float32 columns (the masks as exact
            # 0/1), so the claim axis amortizes the sync a per-claim
            # loop would pay C times.
            host = torch.cat(
                [
                    out.essence,
                    out.essence_first_pass,
                    out.reliability_first_pass[:, None],
                    out.reliability_second_pass[:, None],
                    out.reliable.to(torch.float32),
                    out.interval_valid.to(torch.float32)[:, None],
                    pending.ok.to(torch.float32),
                ],
                dim=1,
            ).cpu().numpy()  # svoclint: disable=SVOC001
            cols = np.cumsum([0, m, m, 1, 1, n, 1, n])
            essence, essence1, rel1, rel2, reliable, valid, oks = (
                host[:, cols[i] : cols[i + 1]] for i in range(7)
            )
            rel1, rel2, valid = rel1[:, 0], rel2[:, 0], valid[:, 0] > 0
            reliable, oks = reliable > 0, oks > 0
        if track:
            # The dispatch's whole host cost lands in the ledger here, one
            # fold a group, under the warmth it was counted at.
            sync_s = time.perf_counter() - t_sync
            plane.claim_mark([s.spec.claim_id for s in members], "synced")
            plane.observe_dispatch(
                pending.warmth_key, pending.warmth,
                pending.h2d_s + pending.dispatch_s + sync_s,
                breakdown={"h2d": pending.h2d_s, "dispatch": pending.dispatch_s, "sync": sync_s},
            )
        journal = self._resolve_journal()
        bucket = pending.bucket
        with stage_span("fabric_journal"):
            # Every journaled float rounds through ONE numpy pass
            # (utils/rounding.round6's exactness contract; the replay
            # fingerprints pin it).
            essence_rows = round6_list(essence[:c])
            essence1_rows = round6_list(essence1[:c])
            rel1_vals = round6_list(rel1[:c])
            rel2_vals = round6_list(rel2[:c])
            reliable_rows = reliable[:c].tolist()
            valid_flags = valid[:c].tolist()
            n_reliable = reliable[:c].sum(axis=1).tolist()
            admitted = oks.sum(axis=1).tolist()
            for i, state in enumerate(members):
                lineage = pending.lineages[i]
                n_admitted = int(admitted[i])
                slice_ = {
                    "essence": essence_rows[i],
                    "essence_first_pass": essence1_rows[i],
                    "reliability_first_pass": rel1_vals[i],
                    "reliability_second_pass": rel2_vals[i],
                    "reliable": reliable_rows[i],
                    "interval_valid": valid_flags[i],
                    "admitted": n_admitted,
                }
                state.last_consensus = slice_
                journal.emit(
                    "fabric.consensus",
                    lineage=lineage,
                    claim=state.spec.claim_id,
                    interval_valid=slice_["interval_valid"],
                    admitted=n_admitted,
                    n_reliable=int(n_reliable[i]),
                    batch_claims=c,
                    batch_bucket=bucket,
                )
                labels = {"claim": state.spec.claim_id}
                self._metrics.counter(
                    "claim_slots_inspected", labels=labels
                ).add(n)
                self._metrics.counter(
                    "claim_slots_quarantined", labels=labels
                ).add(n - n_admitted)
                self._metrics.gauge(
                    "claim_interval_valid", labels=labels
                ).set(1.0 if slice_["interval_valid"] else 0.0)

    def _commit_claim(self, state: ClaimState) -> None:
        """One resilient commit + supervisor fold + SLO pass for one
        claim; failures count into THAT claim's series only."""
        session = state.session
        labels = {"claim": state.spec.claim_id}
        failed = None
        outcome = None
        try:
            outcome = session.commit_resilient()
        except DegenerateBlockError:
            # Expected serving cold start (a first request-fed block
            # has no oracle diversity yet): the chain write is deferred,
            # not failed — no commit budget burned, no anomaly, and not
            # a good commit either (``claim_commit_cycles`` counts only
            # attempted chain writes).  The session already journaled
            # ``commit.deferred`` on the block's lineage.
            self._metrics.counter(
                "claim_commit_deferred", labels=labels
            ).add(1)
            state.last_commit = {"deferred": True}
            session.supervisor_step()
            try:
                state.evaluator.evaluate()
            except Exception:
                self._metrics.counter("slo_errors").add(1)
            return
        except (ChainCommitError, CircuitOpenError) as e:
            # The commit path's EXPECTED failure classes: routine claim
            # accounting (this claim's breaker/supervisor already saw
            # them).
            failed = type(e).__name__
        except Exception as e:  # noqa: BLE001 — isolation contract
            # Anything else is a defect surfacing per claim: it still
            # must not starve the sibling claims, but it lands in the
            # anomaly counter so it reads as a bug, not as SLO burn.
            failed = f"{type(e).__name__}: {e}"
            self._metrics.counter(
                "fabric_claim_errors",
                labels={"claim": state.spec.claim_id, "stage": "commit"},
            ).add(1)
        self._metrics.counter("claim_commit_cycles", labels=labels).add(1)
        if failed is not None:
            self._metrics.counter(
                "claim_commit_failures", labels=labels
            ).add(1)
            state.last_commit = {"error": failed}
        else:
            if outcome.stranded:
                # Degraded cycles burn the claim's commit budget just
                # like the single-claim soak accounting.
                self._metrics.counter(
                    "claim_commit_failures", labels=labels
                ).add(1)
            state.last_commit = {
                "sent": outcome.sent,
                "total": outcome.total,
                "attempts": outcome.attempts,
                "stranded": len(outcome.stranded),
                "complete": outcome.complete,
            }
        session.supervisor_step()
        try:
            state.evaluator.evaluate()
        except Exception:
            self._metrics.counter("slo_errors").add(1)
