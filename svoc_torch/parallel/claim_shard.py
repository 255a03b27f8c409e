"""The 2-D (claim × oracle) sharded claim cube and its fleet.

Mirrors :mod:`svoc_tpu.parallel.claim_shard` (``claim_shard.py:1-694``:
the two counters, ``claims_out_specs``, ``sharded_claims_consensus_fn``,
``sharded_claims_sanitized_fn``, ``sharded_claims_pallas_fn``,
``one_claim_fleet``, ``fleet_claims_reference``,
``sharded_fleet_claims_fn`` and ``ClaimShardDispatcher``) on the port's
single-controller mesh (:mod:`svoc_torch.parallel.mesh`).

- **The claim axis** is pure data parallelism: a claim shard serves
  ``C / mesh_claims`` claims and never sees its siblings.
- **The host-fed cube dispatch** (the fabric's,
  :func:`sharded_claims_consensus_fn` and
  :func:`sharded_claims_sanitized_fn`) splits the claim axis only and
  runs the port's one route per device on each shard: the gated
  claim-cube kernel (B3) once a claim shard on CUDA, the plain claim-cube
  forms on the CPU.  The body has no collective (the runner enforces it),
  so each claim's math is the unsharded cube's and the dispatch is
  bitwise equal to it, whatever the mesh: the reference's exact-parity
  contract.  No spec names the oracle axis, so the runner runs one body
  a claim shard and the oracle-axis slots share its result: a dispatch
  on a ``CxO`` mesh launches B3 ``C`` times.
- **The fleet path** (:func:`sharded_fleet_claims_fn`) makes each
  slot's ``[Cl, Nl, M]`` rows of the fleet from keys of global claim and
  oracle index (:func:`svoc_torch.sim.generators.claim_fleet_keys`,
  :func:`svoc_torch.parallel.sharded.oracle_rows`), gathers each
  claim's ``[N, M]`` block over the oracle axis and runs the gated
  consensus on it on every slot, each keeping its own oracles' rows of
  the per-oracle outputs: ``C × O`` B3 launches on CUDA.  Its outputs
  are bitwise the same on every factorization, ``1x1`` included.

The reference's ``consensus_impl`` composition (a Pallas route per shard
on a claims-only mesh, counted ``sharded_unsupported`` on an
oracle-sharded one) has no counterpart: the port has one route per
device, and ``consensus_impl`` raises on anything but None.  A cube the
mesh cannot split is dispatched unsharded and counted under
``claim_shard_fallback{reason=}``; nothing else falls back.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, Optional, Tuple

import torch

from svoc_torch.consensus.batch import _no_impl_routing, claims_consensus_gated, claims_consensus_sanitized
from svoc_torch.consensus.kernel import ConsensusConfig, ConsensusOutput
from svoc_torch.parallel.mesh import CLAIM_AXIS, ORACLE_AXIS, Mesh, P
from svoc_torch.parallel.sharded import all_gather, axis_index, axis_size, oracle_rows, shard_map
from svoc_torch.robustness.sanitize import quarantine_mask_claims
from svoc_torch.utils.metrics import MetricsRegistry
from svoc_torch.utils.metrics import registry as _default_registry

_log = logging.getLogger("svoc_torch.parallel.claim_shard")

#: Cube dispatches the mesh could not split (a fleet size not divisible
#: by the oracle axis, a claim count the caller did not pad with
#: ``pad_claim_cube(multiple_of=)``): dispatched unsharded and counted;
#: the shard smoke holds it at zero.
SHARD_FALLBACK_COUNTER = "claim_shard_fallback"
#: Dispatches the mesh served (the smoke's witness that it ran).
SHARD_DISPATCH_COUNTER = "claim_shard_dispatches"


def claims_out_specs(oracle_sharded: bool = False) -> ConsensusOutput:
    """Specs of the shard-mapped claim cube: per-claim fields split over
    the claim axis; per-oracle fields over both axes on the fleet path
    (``oracle_sharded=True``), over the claim axis on the dispatch
    path."""
    per_oracle = P(CLAIM_AXIS, ORACLE_AXIS) if oracle_sharded else P(CLAIM_AXIS, None)
    return ConsensusOutput(
        essence=P(CLAIM_AXIS),
        essence_first_pass=P(CLAIM_AXIS),
        reliability_first_pass=P(CLAIM_AXIS),
        reliability_second_pass=P(CLAIM_AXIS),
        reliable=per_oracle,
        quadratic_risk=per_oracle,
        skewness=P(CLAIM_AXIS),
        kurtosis=P(CLAIM_AXIS),
        interval_valid=P(CLAIM_AXIS),
    )


_CUBE_SPECS = (P(CLAIM_AXIS, None, None), P(CLAIM_AXIS, None), P(CLAIM_AXIS))


def sharded_claims_consensus_fn(mesh: Mesh, cfg: ConsensusConfig):
    """``(values [C, N, M], ok [C, N], claim_mask [C]) → ConsensusOutput``
    with the cube split over the claim axis: the gated claim-cube
    dispatch once a claim shard, no collective.  ``C`` must divide by
    the claim axis.  Bitwise the unsharded
    :func:`svoc_torch.consensus.batch.claims_consensus_gated`."""

    def body(values_local, ok_local, claim_mask_local):
        return claims_consensus_gated(values_local, ok_local, claim_mask_local, cfg)

    return shard_map(body, mesh=mesh, in_specs=_CUBE_SPECS, out_specs=claims_out_specs(), collectives=False)


def sharded_claims_sanitized_fn(mesh: Mesh, cfg: ConsensusConfig, lo: Optional[float], hi: Optional[float]):
    """The claim-sharded twin of
    :func:`svoc_torch.consensus.batch.claims_consensus_sanitized`:
    ``(values, claim_mask) → (ConsensusOutput, ok)``, the quarantine gate
    and the consensus on each claim shard's device."""

    def body(values_local, claim_mask_local):
        return claims_consensus_sanitized(values_local, claim_mask_local, cfg, lo, hi)

    return shard_map(
        body,
        mesh=mesh,
        in_specs=(P(CLAIM_AXIS, None, None), P(CLAIM_AXIS)),
        out_specs=(claims_out_specs(), P(CLAIM_AXIS, None)),
        collectives=False,
    )


def sharded_claims_pallas_fn(mesh: Mesh, cfg: ConsensusConfig):
    """The reference's claims-only-sharded fused-kernel dispatch.  The
    port has one route per device, so this is
    :func:`sharded_claims_consensus_fn`: B3 once a claim shard on CUDA."""
    return sharded_claims_consensus_fn(mesh, cfg)


# ---------------------------------------------------------------------------
# The sharded fleet over the claim cube
# ---------------------------------------------------------------------------


def one_claim_fleet(
    key: torch.Tensor,
    window: torch.Tensor,
    n_oracles: int,
    n_failing: int,
    subset_size: int,
    oracle_idx: range,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One claim's bootstrap fleet rows for the global oracle indices
    ``oracle_idx`` (a contiguous ``range``), ``(values [len, M], honest
    [len])``: :func:`svoc_torch.parallel.sharded.oracle_rows`, the one
    implementation the sharded and unsharded fleets share."""
    if oracle_idx.step != 1:
        raise ValueError(f"oracle_idx must be a contiguous range, got {oracle_idx}")
    return oracle_rows(key, window, n_oracles, n_failing, subset_size, oracle_idx.start, len(oracle_idx))


def fleet_claims_reference(
    keys: torch.Tensor,
    windows: torch.Tensor,
    n_oracles: int,
    n_failing: int,
    subset_size: int = 10,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The unsharded fleet cube ``(values [C, N, M], honest [C, N])`` from
    per-claim keys ``[C, 2]`` and windows ``[C, W, M]``: what the sharded
    generation is held to bit for bit."""
    return oracle_rows(keys, windows, n_oracles, n_failing, subset_size, 0, n_oracles)


def sharded_fleet_claims_fn(
    mesh: Mesh,
    cfg: ConsensusConfig,
    n_oracles: int,
    subset_size: int = 10,
    gate: Optional[Tuple[Optional[float], Optional[float]]] = None,
):
    """``(keys [C, 2], windows [C, W, M]) → (ConsensusOutput, honest [C,
    N])`` (plus ``admitted [C, N]`` with ``gate=(lo, hi)``): each slot
    makes its ``[Cl, Nl, M]`` rows of the fleet, gathers its claims'
    blocks over the oracle axis (the one collective) and runs the gated
    consensus on them; the per-oracle outputs keep the slot's rows."""
    mesh_oracles = mesh.shape[ORACLE_AXIS]
    if n_oracles % mesh_oracles:
        raise ValueError(f"n_oracles={n_oracles} not divisible by the mesh oracle axis {mesh_oracles}")

    def step(keys_local, windows_local):
        n_local = n_oracles // axis_size(ORACLE_AXIS)
        first = axis_index(ORACLE_AXIS) * n_local
        own = slice(first, first + n_local)
        values_local, honest_local = oracle_rows(
            keys_local, windows_local, n_oracles, cfg.n_failing, subset_size, first, n_local
        )
        c_local = values_local.shape[0]
        claim_mask = torch.ones(c_local, dtype=torch.bool, device=values_local.device)
        values = all_gather(values_local, ORACLE_AXIS, dim=1)
        if gate is not None:
            ok = quarantine_mask_claims(values, gate[0], gate[1])
        else:
            ok = torch.ones(values.shape[:2], dtype=torch.bool, device=values.device)
        out = claims_consensus_gated(values, ok, claim_mask, cfg)
        out = out._replace(reliable=out.reliable[:, own], quadratic_risk=out.quadratic_risk[:, own])
        if gate is not None:
            return out, honest_local, ok[:, own]
        return out, honest_local

    per_oracle = P(CLAIM_AXIS, ORACLE_AXIS)
    out_specs = (claims_out_specs(oracle_sharded=True), per_oracle)
    if gate is not None:
        out_specs += (per_oracle,)
    return shard_map(step, mesh=mesh, in_specs=(P(CLAIM_AXIS, None), P(CLAIM_AXIS, None, None)),
                     out_specs=out_specs)


# ---------------------------------------------------------------------------
# The fabric-facing dispatcher
# ---------------------------------------------------------------------------


class ClaimShardDispatcher:
    """The mesh-aware claim-cube dispatch the
    :class:`~svoc_torch.fabric.router.ClaimRouter` owns, built once with
    the pinned mesh (the mesh is part of a seeded replay's config).
    ``dispatch_gated`` and ``dispatch_sanitized`` return device tensors
    and read nothing back, so the pipelined router overlaps them with the
    next cycle's host work."""

    def __init__(
        self,
        mesh: Mesh,
        *,
        consensus_impl: Optional[str] = None,
        metrics: Optional[MetricsRegistry] = None,
    ):
        _no_impl_routing(consensus_impl)
        if CLAIM_AXIS not in mesh.shape or ORACLE_AXIS not in mesh.shape:
            raise ValueError(f"claim-shard mesh needs axes ({CLAIM_AXIS!r}, {ORACLE_AXIS!r}); got {tuple(mesh.shape)}")
        self.mesh = mesh
        self.consensus_impl = consensus_impl
        # Not ``metrics or ...``: an empty registry is falsy.
        self._metrics = metrics if metrics is not None else _default_registry
        self._fns: Dict[tuple, object] = {}
        self._lock = threading.Lock()
        self._warned: set = set()

    @property
    def claim_size(self) -> int:
        return int(self.mesh.shape[CLAIM_AXIS])

    @property
    def oracle_size(self) -> int:
        return int(self.mesh.shape[ORACLE_AXIS])

    @property
    def spec_str(self) -> str:
        """The ``SVOC_MESH`` form of the pinned mesh, for snapshots."""
        return f"{self.claim_size}x{self.oracle_size}"

    def _fallback(self, reason: str, detail: str) -> None:
        self._metrics.counter(SHARD_FALLBACK_COUNTER, labels={"reason": reason}).add(1)
        with self._lock:
            if reason in self._warned:
                return
            self._warned.add(reason)
        _log.warning(
            "claim-cube dispatch ran unsharded (mesh=%s, reason=%s: %s); further ones are counted in "
            "%s{reason=%s} without logging",
            self.spec_str, reason, detail, SHARD_FALLBACK_COUNTER, reason,
        )

    def _fn(self, key, make):
        with self._lock:
            fn = self._fns.get(key)
            if fn is None:
                fn = self._fns[key] = make()
        return fn

    def shardable(self, n_claims: int, n_oracles: int) -> Optional[str]:
        """None when the cube fits the mesh, else the fallback reason."""
        if n_claims % self.claim_size:
            return "claim_indivisible"
        if n_oracles % self.oracle_size:
            return "oracle_indivisible"
        return None

    def dispatch_gated(self, values, ok, claim_mask, cfg: ConsensusConfig) -> ConsensusOutput:
        """One claim-sharded gated dispatch; a cube the mesh cannot split
        runs unsharded, counted."""
        values, ok, claim_mask = (torch.as_tensor(x) for x in (values, ok, claim_mask))
        c, n, _m = values.shape
        reason = self.shardable(c, n)
        if reason is not None:
            self._fallback(reason, f"cube {c}x{n}")
            return claims_consensus_gated(values, ok, claim_mask, cfg)
        out = self._fn(("gated", cfg), lambda: sharded_claims_consensus_fn(self.mesh, cfg))(values, ok, claim_mask)
        self._metrics.counter(SHARD_DISPATCH_COUNTER).add(1)
        return out

    def dispatch_sanitized(self, values, claim_mask, cfg: ConsensusConfig, lo, hi):
        """The claim-sharded gate and consensus; returns ``(output,
        ok)``.  A cube the mesh cannot split runs unsharded, counted."""
        values, claim_mask = torch.as_tensor(values), torch.as_tensor(claim_mask)
        c, n, _m = values.shape
        reason = self.shardable(c, n)
        if reason is not None:
            self._fallback(reason, f"cube {c}x{n}")
            return claims_consensus_sanitized(values, claim_mask, cfg, lo, hi)
        fn = self._fn(("sanitized", cfg, lo, hi), lambda: sharded_claims_sanitized_fn(self.mesh, cfg, lo, hi))
        out = fn(values, claim_mask)
        self._metrics.counter(SHARD_DISPATCH_COUNTER).add(1)
        return out
