"""The golden wsad (i128 × 1e-6) consensus engine.

Mirrors :mod:`svoc_tpu.consensus.wsad_engine` (``wsad_engine.py:20-232``):
the statistical core of the Cairo contract (``contract/src/math.cairo``
and ``contract/src/contract.cairo:370-503``) on Python ints, with
integer truncation, rounded wsad multiply and divide, Newton's square
root capped at 50 iterations and the merge sort's tie order.  It drives
the contract simulator (:mod:`svoc_torch.consensus.state`) and is what
the float consensus is held against.  Python ints are exact; every
division goes through :func:`svoc_torch.ops.fixedpoint.div_trunc` for
Cairo's truncation toward zero.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from svoc_torch.ops.fixedpoint import (
    WSAD,
    div_trunc,
    wsad_div,
    wsad_mul,
    wsad_sqrt,
)
from svoc_torch.ops.sort import indexed_sort_host


class IntervalError(AssertionError):
    """Raised where the contract panics with 'interval error'
    (``math.cairo:294-310``)."""


def interval_check(value: int) -> None:
    if not (0 <= value <= WSAD):
        raise IntervalError(f"interval error: {value}")


def nd_interval_check(vector: Sequence[int]) -> None:
    for v in vector:
        interval_check(v)


def smooth_median(values: Sequence[int]) -> int:
    """``math.cairo:113-126`` — including the dead odd-length branch:
    ``(len & 2) == 1`` can never hold, so the result is always the mean
    of the two sorted values around ``len/2``."""
    sorted_vals = sorted(values)
    mid = len(values) // 2
    a, b = sorted_vals[mid - 1], sorted_vals[mid]
    return div_trunc(a + b, 2)


def median(values: Sequence[int]) -> int:
    """Upper median (``math.cairo:102-110``)."""
    return sorted(values)[len(values) // 2]


def nd_smooth_median(values: Sequence[Sequence[int]]) -> List[int]:
    """Component-wise smooth median (``math.cairo:152-165``)."""
    dim = len(values[0])
    return [smooth_median([v[i] for v in values]) for i in range(dim)]


def nd_median(values: Sequence[Sequence[int]]) -> List[int]:
    dim = len(values[0])
    return [median([v[i] for v in values]) for i in range(dim)]


def quadratic_deviation(a: int, b: int) -> int:
    x = a - b
    return wsad_mul(x, x)


def nd_quadratic_deviation(a: Sequence[int], b: Sequence[int]) -> int:
    return sum(quadratic_deviation(x, y) for x, y in zip(a, b))


def nd_quadratic_risk(
    values: Sequence[Sequence[int]], center: Sequence[int]
) -> List[int]:
    """``math.cairo:225-238``."""
    return [nd_quadratic_deviation(v, center) for v in values]


def average(values: Sequence[int]) -> int:
    """Truncating mean (``math.cairo:240-254``)."""
    return div_trunc(sum(values), len(values))


def nd_average(values: Sequence[Sequence[int]]) -> List[int]:
    dim = len(values[0])
    return [average([v[i] for v in values]) for i in range(dim)]


def nd_component_wise_variance(
    values: Sequence[Sequence[int]], center: Sequence[int]
) -> List[int]:
    """``math.cairo:208-222`` — biased variance, truncating mean."""
    dim = len(values[0])
    return [
        average([quadratic_deviation(v[i], center[i]) for v in values])
        for i in range(dim)
    ]


def skewness(values: Sequence[int], mean: int, variance: int) -> int:
    """``math.cairo:320-338``."""
    n = len(values)
    std = wsad_sqrt(variance)
    skew = 0
    for v in values:
        diff = wsad_div(v - mean, std)
        skew += wsad_mul(wsad_mul(diff, diff), diff)
    return div_trunc(skew * n, (n - 1) * (n - 2))


def kurtosis(values: Sequence[int], mean: int, variance: int) -> int:
    """``math.cairo:340-363``."""
    n = len(values)
    std = wsad_sqrt(variance)
    kurt = 0
    for v in values:
        diff = wsad_div(v - mean, std)
        d2 = wsad_mul(diff, diff)
        kurt += wsad_mul(d2, d2)
    term1 = div_trunc(kurt * n * (n + 1), n - 1)
    term2 = 3 * WSAD * (n - 1) * (n - 1)
    return div_trunc(term1 - term2, (n - 2) * (n - 3))


def nd_skewness(values, means, variances) -> List[int]:
    dim = len(values[0])
    return [
        skewness([v[i] for v in values], means[i], variances[i]) for i in range(dim)
    ]


def nd_kurtosis(values, means, variances) -> List[int]:
    dim = len(values[0])
    return [
        kurtosis([v[i] for v in values], means[i], variances[i]) for i in range(dim)
    ]


# ---------------------------------------------------------------------------
# Two-pass consensus (contract.cairo:370-503), pure function over a block.
# ---------------------------------------------------------------------------


def two_pass_consensus(
    values: Sequence[Sequence[int]],
    *,
    constrained: bool,
    n_failing: int,
    max_spread: int = 0,
    strict_interval: bool = True,
) -> Dict:
    """Run both passes on a complete oracle block of wsad vectors.

    Returns a dict with wsad-int fields mirroring the contract storage
    after an ``update_*_consensus`` call: ``essence``,
    ``reliability_first_pass``, ``reliability_second_pass``,
    ``reliable`` (per original oracle index), ``skewness``,
    ``kurtosis``, plus ``essence_first_pass`` and ``quadratic_risk``.
    """
    n = len(values)
    dim = len(values[0])

    def reliability(mean_qr_or_std: int) -> int:
        if constrained:
            # contract.cairo:436-439 — argument is mean(qr)
            return WSAD - wsad_sqrt(div_trunc(mean_qr_or_std, dim)) * 2
        # contract.cairo:365-368 — argument is sqrt(mean(qr))
        return WSAD - wsad_div(min(max_spread, mean_qr_or_std), max_spread)

    # FIRST PASS
    essence1 = nd_smooth_median(values)
    qr = nd_quadratic_risk(values, essence1)
    if constrained:
        rel1 = reliability(average(qr))
    else:
        rel1 = reliability(wsad_sqrt(average(qr)))
    if strict_interval:
        interval_check(rel1)
    else:
        rel1 = min(max(rel1, 0), WSAD)

    ordered = indexed_sort_host(qr)  # (index, risk) ascending, Cairo tie order
    threshold = n - n_failing
    reliable = [False] * n
    for rank, (idx, _risk) in enumerate(ordered):
        reliable[idx] = rank < threshold

    reliable_values = [v for v, ok in zip(values, reliable) if ok]

    # SECOND PASS
    if constrained:
        essence = nd_smooth_median(reliable_values)
    else:
        essence = nd_average(reliable_values)
    qr2 = nd_quadratic_risk(reliable_values, essence1)  # centered on essence₁
    if constrained:
        rel2 = reliability(average(qr2))
    else:
        rel2 = reliability(wsad_sqrt(average(qr2)))
    if strict_interval:
        interval_check(rel2)
    else:
        rel2 = min(max(rel2, 0), WSAD)

    # MOMENTS
    means = nd_average(reliable_values)
    variances = nd_component_wise_variance(reliable_values, means)
    skew = nd_skewness(reliable_values, means, variances)
    kurt = nd_kurtosis(reliable_values, means, variances)

    return {
        "essence": essence,
        "essence_first_pass": essence1,
        "reliability_first_pass": rel1,
        "reliability_second_pass": rel2,
        "reliable": reliable,
        "quadratic_risk": qr,
        "skewness": skew,
        "kurtosis": kurt,
    }
