"""Masked statistics of the two-pass consensus.

Mirrors the parts of :mod:`svoc_tpu.ops.stats` that
:func:`svoc_torch.consensus.kernel.consensus_step` and its gated forms
call.  The second pass works on the full ``[N, M]`` block with a boolean
mask, and masked rows sort as ``+inf`` so they can never enter a median.
Every count is the mask's sum, a value known only at run time (the
gated forms pass their ``ok`` and ``reliable`` masks); a smooth-median
rank clipped into ``[0, N)`` that lands on a masked row reads the
``+inf`` sentinel, as the reference does.

- Cairo's ``smooth_median`` (``math.cairo:113-126``) always averages
  ``sorted[m/2-1]`` and ``sorted[m/2]``, also for odd ``m``:
  ``mode="cairo"`` keeps that; ``mode="true"`` is the proper median.
- Skewness and kurtosis are the bias-corrected sample versions
  (``math.cairo:320-363``); variance is the biased mean of squares.
- A mask selects: a masked row adds an exact 0 even where its value is
  not finite, as the reference's product with a boolean mask (a select
  in XLA) does.
"""

from __future__ import annotations

import torch


def _take_row(sorted_vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row ``idx`` (a 0-d tensor) of ``[N, M]``, clipped into range."""
    n = sorted_vals.shape[0]
    return sorted_vals[idx.clamp(0, n - 1)]


def _masked_sorted(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Each column of ``[N, M]`` sorted, masked rows pushed to +inf."""
    return torch.sort(torch.where(mask[:, None], values, torch.inf), dim=0).values


def masked_smooth_median(
    values: torch.Tensor, mask: torch.Tensor, mode: str = "cairo"
) -> torch.Tensor:
    """Component-wise smooth median over the unmasked rows of ``[N, M]``."""
    if mode not in ("cairo", "true"):
        raise ValueError(f"unknown smooth median mode: {mode!r}")
    s = _masked_sorted(values, mask)
    m = mask.sum()
    mid = torch.div(m, 2, rounding_mode="floor")
    pair_mean = (_take_row(s, mid - 1) + _take_row(s, mid)) / 2.0
    if mode == "cairo":
        return pair_mean
    return torch.where(m % 2 == 1, _take_row(s, mid), pair_mean)


def quadratic_risk(values: torch.Tensor, center: torch.Tensor) -> torch.Tensor:
    """Per-oracle squared distance to ``center`` over the last axis
    (``math.cairo:225-238``), ``center`` broadcasting against
    ``values``.  Summed in column order with each product and sum
    rounded on its own: the order the reference takes op by op, and the
    one the consensus kernels take, so a near-tie in the risk ranking
    falls the same way in all of them."""
    d = values - center
    qr = d[..., 0] * d[..., 0]
    for c in range(1, values.shape[-1]):
        qr = qr + d[..., c] * d[..., c]
    return qr


def _count(mask: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return mask.to(dtype).sum()


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Component-wise mean over unmasked rows (``math.cairo:240-269``)."""
    m = _count(mask, values.dtype)
    return torch.where(mask[:, None], values, 0.0).sum(dim=0) / torch.clamp(m, min=1.0)


def masked_scalar_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of a masked 1-D array (``average``, ``math.cairo:240-254``)."""
    m = _count(mask, values.dtype)
    return torch.where(mask, values, 0.0).sum() / torch.clamp(m, min=1.0)


def masked_component_variance(
    values: torch.Tensor, mask: torch.Tensor, center: torch.Tensor
) -> torch.Tensor:
    """Biased per-component variance about ``center`` (``math.cairo:208-222``)."""
    d = torch.where(mask[:, None], values - center[None, :], 0.0)
    m = _count(mask, values.dtype)
    return torch.sum(d * d, dim=0) / torch.clamp(m, min=1.0)


def _standardized(values, mask, mean, variance):
    std = torch.sqrt(variance)
    z = (values - mean[None, :]) / torch.clamp(std[None, :], min=1e-30)
    return torch.where(mask[:, None], z, 0.0)


def masked_skewness(values, mask, mean, variance) -> torch.Tensor:
    """``Σ ((x-μ)/σ)³ · n / ((n-1)(n-2))`` over unmasked rows."""
    n = _count(mask, values.dtype)
    s3 = torch.sum(_standardized(values, mask, mean, variance) ** 3, dim=0)
    return s3 * n / torch.clamp((n - 1.0) * (n - 2.0), min=1.0)


def masked_kurtosis(values, mask, mean, variance) -> torch.Tensor:
    """``(Σ z⁴ · n(n+1)/(n-1) − 3(n-1)²) / ((n-2)(n-3))`` over unmasked rows."""
    n = _count(mask, values.dtype)
    s4 = torch.sum(_standardized(values, mask, mean, variance) ** 4, dim=0)
    term1 = s4 * n * (n + 1.0) / torch.clamp(n - 1.0, min=1.0)
    term2 = 3.0 * (n - 1.0) ** 2
    return (term1 - term2) / torch.clamp((n - 2.0) * (n - 3.0), min=1.0)


def interval_ok(x: torch.Tensor) -> torch.Tensor:
    """Whether ``x`` lies in [0, 1] (the contract panics otherwise,
    ``math.cairo:294-296``); a 0-d bool tensor."""
    return torch.logical_and(torch.all(x >= 0.0), torch.all(x <= 1.0))
