"""The two-pass consensus in plain PyTorch.

Mirrors :mod:`svoc_tpu.consensus.kernel` (``ConsensusConfig``,
``ConsensusOutput``, ``consensus_step``).  Reference semantics:
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
