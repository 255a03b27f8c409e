"""The certified fleet commit's device sweep, and claim micro-batches.

Mirrors :mod:`svoc_tpu.consensus.batch`.

**The certified fleet commit** (``batch.py:70-211``: ``PrefixMargins``,
``_one_prefix_margins``, ``prefix_margins_sweep``, ``CertifyMargins``,
``certify``).  A fleet commit is one tx per oracle, and after activation
every tx recomputes the consensus on chain.  Intermediate recomputes
write only state the next one overwrites, so they are unobservable
unless they panic.  The golden engine's panic surfaces are known: an
interval check on a reliability below 0, ``wsad_sqrt(1)``, a
reliable-subset variance of 0 or 1 wsad (the moments' ``std`` divides),
and an unconstrained max spread of 0.  :func:`prefix_margins_sweep`
evaluates every intermediate prefix state at once in float32, batched
over the prefixes on the tensors' device, and :func:`certify` checks
that each keeps clear of those surfaces by a guard band; then the
contract (:mod:`svoc_torch.consensus.state`) runs the golden engine
once, on the final block.  A near-tie at the reliability cut, where the
float and Cairo orders could choose different reliable sets, fails the
``boundary_gap`` band.  The reference sweeps with a ``jax.vmap`` in XLA
(no Pallas kernel); here it is plain PyTorch with a leading prefix
axis, from :mod:`svoc_torch.ops.stats`, :mod:`svoc_torch.ops.sort` and
:func:`svoc_torch.consensus.kernel.reliability`.

**Claim micro-batches** (``batch.py:214-556``: ``pow2_bucket``,
``_PAD_VALUE``, ``pad_claim_cube``, ``claims_consensus``,
``claims_consensus_gated`` and ``claims_consensus_sanitized``).
Routing is by device, one route each, as for the other kernels: a CPU
cube runs the plain claim-cube forms of
:mod:`svoc_torch.consensus.kernel` (the reference's ``"xla"`` route),
and a CUDA cube launches the gated claim-cube kernel once
(:func:`svoc_torch.ops.fused_consensus.fused_consensus_gated_claims_cuda`,
which raises on what it does not take).  The reference's
``consensus_impl`` routing (``"xla"``/``"pallas"``, resolved from the
environment and ``PERF_DECISIONS.json``, with counted fallbacks,
``consensus/dispatch.py``) has no counterpart: a plain version on the
card would be a hidden fallback.  The ``consensus_impl`` argument stays
for readability and raises on any value but ``None``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from svoc_torch.consensus.kernel import (
    ConsensusConfig,
    ConsensusOutput,
    consensus_step_claims,
    consensus_step_gated_claims,
    reliability,
)
from svoc_torch.ops import sort as sort_ops
from svoc_torch.ops import stats
from svoc_torch.ops.fixedpoint import WSAD
from svoc_torch.ops.fused_consensus import fused_consensus_gated_claims_cuda
from svoc_torch.robustness.sanitize import quarantine_mask_claims


class PrefixMargins(NamedTuple):
    """Per-prefix distances to the golden engine's panic surfaces, each
    ``[K]`` float32 on the sweep's device."""

    rel1: torch.Tensor  # first-pass reliability
    rel2: torch.Tensor  # second-pass reliability
    sqrt_arg1: torch.Tensor  # first-pass sqrt input (real units)
    sqrt_arg2: torch.Tensor  # second-pass sqrt input (real units)
    min_variance: torch.Tensor  # smallest reliable-subset variance
    boundary_gap: torch.Tensor  # risk gap around the reliability cut


def _masked_sum(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Sum over the oracle axis (1) of the rows ``mask [K, N]`` selects."""
    if x.dim() == 3:
        mask = mask[..., None]
    return torch.where(mask, x, 0.0).sum(dim=1)


def _one_prefix_margins(values: torch.Tensor, cfg: ConsensusConfig) -> PrefixMargins:
    """The reference's per-prefix margins (``batch.py:81-108``) for every
    prefix state of ``values [K, N, M]`` at once: essence₁ the smooth
    median of all N rows, the risk against it, the reliable set in the
    Cairo order, the second-pass mean risk, and the reliable subset's
    biased variances."""
    if cfg.smooth_mode not in ("cairo", "true"):
        raise ValueError(f"unknown smooth median mode: {cfg.smooth_mode!r}")
    k, n, dim = values.shape
    s = torch.sort(values, dim=1).values
    mid = n // 2
    pair_mean = (s[:, min(max(mid - 1, 0), n - 1)] + s[:, min(mid, n - 1)]) / 2.0
    if cfg.smooth_mode == "true" and n % 2 == 1:
        essence1 = s[:, mid]
    else:
        essence1 = pair_mean
    qr = stats.quadratic_risk(values, essence1[:, None, :])  # [K, N]
    mean_qr1 = qr.mean(dim=1)
    rel1 = reliability(cfg, mean_qr1, dim)

    reliable = sort_ops.reliability_mask(qr, cfg.n_failing)  # [K, N]
    thr = n - cfg.n_failing
    # Exact-int ties at the cut can order differently than the float
    # sort; a healthy gap certifies both select the same reliable set.
    if 0 < cfg.n_failing:
        sorted_qr = torch.sort(qr, dim=1).values
        gap = sorted_qr[:, min(thr, n - 1)] - sorted_qr[:, thr - 1]
    else:
        gap = torch.full((k,), torch.inf, dtype=values.dtype, device=values.device)

    count = torch.clamp(reliable.to(values.dtype).sum(dim=1), min=1.0)
    mean_qr2 = _masked_sum(qr, reliable) / count
    rel2 = reliability(cfg, mean_qr2, dim)
    means = _masked_sum(values, reliable) / count[:, None]
    d = torch.where(reliable[..., None], values - means[:, None, :], 0.0)
    variances = (d * d).sum(dim=1) / count[:, None]

    if cfg.constrained:
        a1, a2 = mean_qr1 / dim, mean_qr2 / dim
    else:
        a1, a2 = mean_qr1, mean_qr2
    return PrefixMargins(rel1, rel2, a1, a2, variances.min(dim=1).values, gap)


def prefix_margins_sweep(
    old_values: torch.Tensor,
    new_values: torch.Tensor,
    positions: torch.Tensor,
    cfg: ConsensusConfig,
    ks: torch.Tensor,
) -> PrefixMargins:
    """Margins of every prefix state ``V_k`` for ``k`` in ``ks [K]``:
    ``V_k[i]`` is oracle ``i``'s new value iff its tx index
    ``positions[i]`` is below ``k`` (``batch.py:119-135``).
    ``old_values``/``new_values`` are ``[N, M]`` float32, the blocks
    before and after the batch; every tensor on one device, where the
    sweep runs (``[K, N, M]`` states, 25 MB at K = N = 1024, M = 6)."""
    inside = positions[None, :] < ks[:, None]  # [K, N]
    states = torch.where(inside[..., None], new_values[None], old_values[None])
    return _one_prefix_margins(states, cfg)


@dataclasses.dataclass(frozen=True)
class CertifyMargins:
    """Guard bands (real units) around the exact panic surfaces
    (``batch.py:138-160``); float32 error on these [0, 1]-bounded
    reductions is about 0.1 wsad units."""

    #: interval_check distance: reliabilities must clear 0 by this.
    rel: float = 1e-3
    #: ``wsad_sqrt`` panics exactly on int input 1 (i.e. [1, 2) wsad
    #: units): inputs must avoid [lo, hi] wsad units.
    sqrt_band_lo: float = 0.6
    sqrt_band_hi: float = 2.4
    #: variances feed sqrt AND the std divisor: int value must be ≥ 2,
    #: certified by clearing this many wsad units.
    variance: float = 2.4
    #: reliable-set agreement between float and Cairo tie order.
    boundary_gap: float = 1e-5


def certify(
    m: PrefixMargins, cfg: ConsensusConfig, strict_interval: bool,
    bands: CertifyMargins = CertifyMargins(),
    lineage=None,
) -> np.ndarray:
    """Per-prefix bool: True where the golden engine provably completes
    that recompute without a panic (``batch.py:163-211``).  The six
    margin arrays come to the host in one copy, inside a
    ``consensus_certify`` span (``lineage`` tags it)."""
    from svoc_torch.utils.metrics import stage_span

    with stage_span("consensus_certify", lineage=lineage):
        return _certify(m, cfg, strict_interval, bands)


def _certify(
    m: PrefixMargins, cfg: ConsensusConfig, strict_interval: bool,
    bands: CertifyMargins,
) -> np.ndarray:
    host = torch.stack([torch.as_tensor(x) for x in m]).cpu().numpy().astype(np.float64)
    rel1, rel2, a1, a2, min_var, gap = host
    a1, a2, min_var = a1 * WSAD, a2 * WSAD, min_var * WSAD

    def sqrt_safe(a):
        return (a < bands.sqrt_band_lo) | (a > bands.sqrt_band_hi)

    ok = (
        sqrt_safe(a1)
        & sqrt_safe(a2)
        & (min_var > bands.variance)
        & (gap > bands.boundary_gap)
    )
    if strict_interval and cfg.constrained:
        # Constrained reliabilities are ≤ 1 by construction; only the
        # lower bound can panic.  Unconstrained ones lie in [0, 1].
        ok &= (rel1 > bands.rel) & (rel2 > bands.rel)
    if not cfg.constrained and cfg.max_spread <= 0.0:
        # max_spread 0 divides by zero on every recompute.
        ok &= False
    return ok


def pow2_bucket(n: int, floor: int = 1, multiple_of: int = 1) -> int:
    """Smallest power of two ≥ ``n`` (and ≥ ``floor``), rounded up to a
    multiple of ``multiple_of``: the claim micro-batch bucket."""
    if n < 0:
        raise ValueError("n must be >= 0")
    if multiple_of < 1:
        raise ValueError("multiple_of must be >= 1")
    bucket = max(1, int(floor))
    while bucket < n:
        bucket *= 2
    if bucket % multiple_of:
        bucket = ((bucket + multiple_of - 1) // multiple_of) * multiple_of
    return bucket


#: Neutral fill for padding claims: mid-domain and in range for every
#: gate; a padding claim's outputs are masked out regardless.
_PAD_VALUE = 0.5


def pad_claim_cube(
    values,
    ok=None,
    floor: int = 1,
    multiple_of: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pad a claim cube ``[C, N, M]`` (and its admission masks ``[C,
    N]``) to ``B = pow2_bucket(C, floor, multiple_of)`` claims.

    Returns ``(values [B, N, M] float32, ok [B, N] bool, claim_mask [B]
    bool)`` on the cube's device (numpy input is taken as a CPU tensor):
    padding claims hold ``_PAD_VALUE`` with every oracle admitted and
    ``claim_mask`` False."""
    values = torch.as_tensor(values, dtype=torch.float32)
    if values.dim() != 3:
        raise ValueError(f"claim cube must be [C, N, M], got {tuple(values.shape)}")
    c, n, m = values.shape
    dev = values.device
    if ok is None:
        ok = torch.ones(c, n, dtype=torch.bool, device=dev)
    ok = torch.as_tensor(ok, dtype=torch.bool, device=dev)
    if tuple(ok.shape) != (c, n):
        raise ValueError(f"ok must be [C, N]={(c, n)}, got {tuple(ok.shape)}")
    bucket = pow2_bucket(c, floor, multiple_of)
    claim_mask = torch.zeros(bucket, dtype=torch.bool, device=dev)
    claim_mask[:c] = True
    if bucket == c:
        return values, ok, claim_mask
    pad_values = torch.full((bucket - c, n, m), _PAD_VALUE, dtype=torch.float32, device=dev)
    pad_ok = torch.ones(bucket - c, n, dtype=torch.bool, device=dev)
    return torch.cat([values, pad_values]), torch.cat([ok, pad_ok]), claim_mask


def _no_impl_routing(consensus_impl: Optional[str]) -> None:
    if consensus_impl is not None:
        raise ValueError(
            f"consensus_impl={consensus_impl!r}: the port has one route per device "
            "(the plain version on the CPU, the kernel on CUDA); pass None"
        )


def claims_consensus(
    values: torch.Tensor,
    claim_mask: torch.Tensor,
    cfg: ConsensusConfig,
    consensus_impl: Optional[str] = None,
) -> ConsensusOutput:
    """The ungated two-pass consensus over every claim of a micro-batch.
    On CUDA the gated kernel runs with every oracle admitted: the same
    outputs on a finite cube (a non-finite value gets the gated neutral
    fill instead of propagating), as the reference's kernel route."""
    _no_impl_routing(consensus_impl)
    if values.device.type == "cpu":
        return consensus_step_claims(values, claim_mask, cfg)
    ok = torch.ones(values.shape[:2], dtype=torch.bool, device=values.device)
    return fused_consensus_gated_claims_cuda(values, ok, claim_mask, cfg)


def claims_consensus_gated(
    values: torch.Tensor,
    ok: torch.Tensor,
    claim_mask: torch.Tensor,
    cfg: ConsensusConfig,
    consensus_impl: Optional[str] = None,
) -> ConsensusOutput:
    """The gated two-pass consensus over a claim micro-batch with the
    admission masks ``ok [C, N]`` given."""
    _no_impl_routing(consensus_impl)
    if values.device.type == "cpu":
        return consensus_step_gated_claims(values, ok, claim_mask, cfg)
    return fused_consensus_gated_claims_cuda(values, ok, claim_mask, cfg)


def claims_consensus_sanitized(
    values: torch.Tensor,
    claim_mask: torch.Tensor,
    cfg: ConsensusConfig,
    lo: Optional[float],
    hi: Optional[float],
    consensus_impl: Optional[str] = None,
):
    """Gate and consensus in one pass over the device: the admission
    masks come from :func:`quarantine_mask_claims` on the cube's device
    and go to the consensus with no host round trip.  Returns
    ``(output, ok)``."""
    ok = quarantine_mask_claims(values, lo, hi)
    return claims_consensus_gated(values, ok, claim_mask, cfg, consensus_impl), ok
