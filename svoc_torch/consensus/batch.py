"""Claim micro-batches: one consensus dispatch over a padded claim cube.

Mirrors the claim part of :mod:`svoc_tpu.consensus.batch`
(``batch.py:214-556``): ``pow2_bucket``, ``_PAD_VALUE``,
``pad_claim_cube``, ``claims_consensus``, ``claims_consensus_gated`` and
``claims_consensus_sanitized``.  The certified fleet commit above it
(``prefix_margins_sweep``, ``certify``) belongs to the commit path and is
not ported yet.

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

from typing import Optional, Tuple

import torch

from svoc_torch.consensus.kernel import (
    ConsensusConfig,
    ConsensusOutput,
    consensus_step_claims,
    consensus_step_gated_claims,
)
from svoc_torch.ops.fused_consensus import fused_consensus_gated_claims_cuda
from svoc_torch.robustness.sanitize import quarantine_mask_claims


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
