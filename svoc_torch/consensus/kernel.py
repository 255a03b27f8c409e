"""The two-pass consensus in plain PyTorch.

Mirrors :mod:`svoc_tpu.consensus.kernel` (``ConsensusConfig``,
``ConsensusOutput``, ``consensus_step``, the gated form
``consensus_step_gated``, the batched and claim-cube forms,
``_mask_padded_claims`` and ``jit_consensus_gated``).  The reference's
``jax.vmap`` over blocks is a loop here: these are the plain versions
the CPU runs; on the card the claim cube goes through one kernel launch
(:func:`svoc_torch.ops.fused_consensus.fused_consensus_gated_claims`).
Reference semantics:
``update_constrained_consensus`` / ``update_unconstrained_consensus``
(``contract/src/contract.cairo:370-503``):

1. First pass over all N oracles: essence₁ is the component-wise smooth
   median, the quadratic risk is taken against it, and the worst
   ``n_failing`` oracles by risk are marked unreliable.
2. Second pass over the reliable subset: essence is the smooth median
   (constrained) or the mean (unconstrained); the second-pass risk stays
   centred on essence₁ (``contract.cairo:414`` and ``:484``); skewness
   and kurtosis of the reliable subset.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from svoc_torch.ops import sort as sort_ops
from svoc_torch.ops import stats


@dataclasses.dataclass(frozen=True)
class ConsensusConfig:
    """Static consensus parameters (``contract.cairo:236-265``)."""

    n_failing: int = 2
    constrained: bool = True
    #: Unconstrained max spread ``ms`` in real units (wsad/1e6).
    max_spread: float = 10.0
    #: "cairo" replicates the reference's degenerate smooth median;
    #: "true" is the proper median.
    smooth_mode: str = "cairo"


class ConsensusOutput(NamedTuple):
    essence: torch.Tensor  # [M] second-pass consensus value
    essence_first_pass: torch.Tensor  # [M]
    reliability_first_pass: torch.Tensor  # scalar
    reliability_second_pass: torch.Tensor  # scalar
    reliable: torch.Tensor  # [N] bool
    quadratic_risk: torch.Tensor  # [N] first-pass risk vs essence₁
    skewness: torch.Tensor  # [M]
    kurtosis: torch.Tensor  # [M]
    interval_valid: torch.Tensor  # scalar bool, reliabilities in [0, 1]


def reliability(cfg: ConsensusConfig, mean_qr: torch.Tensor, dim: int) -> torch.Tensor:
    """Constrained ``1 − 2·sqrt(mean/M)`` or unconstrained
    ``1 − min(ms, sqrt(mean))/ms`` (``contract.cairo:365-368, 436-439``)."""
    if cfg.constrained:
        return 1.0 - 2.0 * torch.sqrt(mean_qr / dim)
    ms = cfg.max_spread
    return 1.0 - torch.clamp(torch.sqrt(mean_qr), max=ms) / ms


def consensus_step(values: torch.Tensor, cfg: ConsensusConfig) -> ConsensusOutput:
    """The full two-pass consensus on an oracle block ``values [N, M]``."""
    n, dim = values.shape
    all_mask = torch.ones(n, dtype=torch.bool, device=values.device)

    essence1 = stats.masked_smooth_median(values, all_mask, cfg.smooth_mode)
    qr = stats.quadratic_risk(values, essence1)
    rel1 = reliability(cfg, torch.mean(qr), dim)
    reliable = sort_ops.reliability_mask(qr, cfg.n_failing)

    if cfg.constrained:
        essence2 = stats.masked_smooth_median(values, reliable, cfg.smooth_mode)
    else:
        essence2 = stats.masked_mean(values, reliable)
    rel2 = reliability(cfg, stats.masked_scalar_mean(qr, reliable), dim)

    means = stats.masked_mean(values, reliable)
    variances = stats.masked_component_variance(values, reliable, means)
    skew = stats.masked_skewness(values, reliable, means, variances)
    kurt = stats.masked_kurtosis(values, reliable, means, variances)

    valid = torch.logical_and(stats.interval_ok(rel1), stats.interval_ok(rel2))
    # Fewer than two reliable oracles is no consensus: the smooth median
    # would read clipped rows (svoc_tpu/consensus/kernel.py:107-115).
    if n - cfg.n_failing < 2:
        valid = torch.zeros_like(valid)

    return ConsensusOutput(
        essence=essence2,
        essence_first_pass=essence1,
        reliability_first_pass=rel1,
        reliability_second_pass=rel2,
        reliable=reliable,
        quadratic_risk=qr,
        skewness=skew,
        kurtosis=kurt,
        interval_valid=valid,
    )


def _stack(outs) -> ConsensusOutput:
    """Per-block outputs → one output with a leading batch axis (the
    reference's ``jax.vmap``, written out)."""
    return ConsensusOutput(*(torch.stack(field) for field in zip(*outs)))


def consensus_step_batched(values: torch.Tensor, cfg: ConsensusConfig) -> ConsensusOutput:
    """:func:`consensus_step` over each block of ``[B, N, M]``."""
    return _stack([consensus_step(v, cfg) for v in values])


def consensus_step_gated(
    values: torch.Tensor, ok: torch.Tensor, cfg: ConsensusConfig
) -> ConsensusOutput:
    """Two-pass consensus over the admitted (``ok [N]``, True = admitted)
    oracles of a block (``svoc_tpu/consensus/kernel.py:138-210``).

    Quarantined oracles are left out of the first-pass median, rank
    after every admitted one, and never enter the reliable set; the cut
    counts from the run-time ``n_ok``.  Fewer than two admitted, or two
    reliable, oracles is no consensus (``interval_valid`` False), with
    both essences zeroed where not finite."""
    dim = values.shape[1]
    # Neutral fill before any arithmetic: masked reductions multiply by
    # 0 rather than select, and 0 * NaN is NaN.
    safe = torch.where(ok[:, None], values, 0.0)
    safe = torch.where(torch.isfinite(safe), safe, 0.0)
    n_ok = ok.to(torch.int64).sum()

    # ---- FIRST PASS over the admitted subset ----
    essence1 = stats.masked_smooth_median(safe, ok, cfg.smooth_mode)
    qr_raw = stats.quadratic_risk(safe, essence1)
    qr_ok = torch.where(ok, qr_raw, 0.0)
    rel1 = reliability(cfg, stats.masked_scalar_mean(qr_ok, ok), dim)
    reliable = sort_ops.gated_reliability_mask(qr_raw, ok, n_ok, cfg.n_failing)

    # ---- SECOND PASS (the same essence₁-centred risk) ----
    if cfg.constrained:
        essence2 = stats.masked_smooth_median(safe, reliable, cfg.smooth_mode)
    else:
        essence2 = stats.masked_mean(safe, reliable)
    rel2 = reliability(cfg, stats.masked_scalar_mean(qr_ok, reliable), dim)

    means = stats.masked_mean(safe, reliable)
    variances = stats.masked_component_variance(safe, reliable, means)
    skew = stats.masked_skewness(safe, reliable, means, variances)
    kurt = stats.masked_kurtosis(safe, reliable, means, variances)

    n_rel = reliable.to(torch.int64).sum()
    valid = torch.logical_and(stats.interval_ok(rel1), stats.interval_ok(rel2))
    valid = valid & (n_ok >= 2) & (n_rel >= 2)
    # An all-quarantined (or single-survivor) block reports a finite
    # essence beside its invalid flag: +inf sort sentinels do not leak.
    return ConsensusOutput(
        essence=torch.where(torch.isfinite(essence2), essence2, 0.0),
        essence_first_pass=torch.where(torch.isfinite(essence1), essence1, 0.0),
        reliability_first_pass=rel1,
        reliability_second_pass=rel2,
        reliable=reliable,
        quadratic_risk=qr_raw,
        skewness=skew,
        kurtosis=kurt,
        interval_valid=valid,
    )


def consensus_step_gated_batched(
    values: torch.Tensor, ok: torch.Tensor, cfg: ConsensusConfig
) -> ConsensusOutput:
    """:func:`consensus_step_gated` over ``[B, N, M]`` blocks with masks
    ``[B, N]``."""
    return _stack([consensus_step_gated(v, m, cfg) for v, m in zip(values, ok)])


def _mask_padded_claims(out: ConsensusOutput, claim_mask: torch.Tensor) -> ConsensusOutput:
    """Padding claims of a claim-batched output read as no consensus
    (``svoc_tpu/consensus/kernel.py:233-257``): ``interval_valid``
    False, every float field 0, no reliable oracle."""
    active = claim_mask.bool()
    row = active[:, None]
    return ConsensusOutput(
        essence=torch.where(row, out.essence, 0.0),
        essence_first_pass=torch.where(row, out.essence_first_pass, 0.0),
        reliability_first_pass=torch.where(active, out.reliability_first_pass, 0.0),
        reliability_second_pass=torch.where(active, out.reliability_second_pass, 0.0),
        reliable=torch.logical_and(out.reliable, row),
        quadratic_risk=torch.where(row, out.quadratic_risk, 0.0),
        skewness=torch.where(row, out.skewness, 0.0),
        kurtosis=torch.where(row, out.kurtosis, 0.0),
        interval_valid=torch.logical_and(out.interval_valid, active),
    )


def consensus_step_claims(
    values: torch.Tensor, claim_mask: torch.Tensor, cfg: ConsensusConfig
) -> ConsensusOutput:
    """Two-pass consensus over a claim cube ``[C, N, M]``; padding claims
    (``claim_mask`` False) come back inactive."""
    return _mask_padded_claims(consensus_step_batched(values, cfg), claim_mask)


def consensus_step_gated_claims(
    values: torch.Tensor,
    ok: torch.Tensor,
    claim_mask: torch.Tensor,
    cfg: ConsensusConfig,
) -> ConsensusOutput:
    """Gated two-pass consensus over a claim cube ``[C, N, M]`` with
    admission masks ``ok [C, N]`` and active claims ``claim_mask [C]``
    (``svoc_tpu/consensus/kernel.py:277-296``); each claim's degenerate
    cases stay its own."""
    return _mask_padded_claims(consensus_step_gated_batched(values, ok, cfg), claim_mask)


def jit_consensus_gated(cfg: ConsensusConfig):
    """The single-block gated consensus for ``cfg`` as a closure (the
    reference jits it; PyTorch runs it eagerly)."""
    return lambda values, ok: consensus_step_gated(values, ok, cfg)
