"""Indexed sort with the reference contract's exact tie semantics.

Mirrors :mod:`svoc_tpu.ops.sort` (``indexed_sort_host``,
``argsort_cairo``, ``reliability_mask``, ``gated_reliability_mask``).
The Cairo contract's indexed merge sort
(``contract/src/sort.cairo:13-103``) takes the right element on ties,
so equal values come out in **descending original index**.  The top
``n - n_failing`` entries of that order are marked reliable, so the tie
order decides which oracle gets masked.

:func:`indexed_sort_host` is the merge sort itself on Python ints (the
golden engine's order); the tensor functions reach the same order by a
stable sort of the reversed vector.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def indexed_sort_host(values: Sequence[int]) -> List[Tuple[int, int]]:
    """``IndexedMergeSort::sort`` (``sort.cairo:13-17``) on Python ints
    (``svoc_tpu/ops/sort.py:29``): ``(original_index, value)`` pairs
    ascending by value, a tie taking the right half's element first."""
    arr = list(enumerate(values))

    def sort_aux(a: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
        if len(a) <= 1:
            return list(a)
        middle = len(a) // 2
        left = sort_aux(a[:middle])
        right = sort_aux(a[middle:])
        out: List[Tuple[int, int]] = []
        li = ri = 0
        while len(out) < len(left) + len(right):
            if li == len(left):
                out.append(right[ri])
                ri += 1
            elif ri == len(right):
                out.append(left[li])
                li += 1
            elif left[li][1] < right[ri][1]:
                out.append(left[li])
                li += 1
            else:
                out.append(right[ri])
                ri += 1
        return out

    return sort_aux(arr)


def argsort_cairo(values: torch.Tensor) -> torch.Tensor:
    """Permutation along dim 0 that sorts ``values`` ascending with ties
    in descending-index order (each column on its own for 2-D input).

    A stable ascending sort of the reversed vector keeps equal values in
    reversed (= descending original) index order; ``n - 1 - i`` maps the
    reversed positions back."""
    n = values.shape[0]
    order = torch.sort(values.flip(0), dim=0, stable=True).indices
    return (n - 1) - order


def cairo_rank(values: torch.Tensor) -> torch.Tensor:
    """Rank of each element along dim 0 in the Cairo order (the inverse
    permutation of :func:`argsort_cairo`), int64."""
    n = values.shape[0]
    order = argsort_cairo(values)
    positions = torch.arange(n, device=values.device)
    positions = positions.view(-1, *([1] * (values.dim() - 1))).expand_as(order)
    return torch.empty_like(order).scatter_(0, order, positions)


def reliability_mask(risk: torch.Tensor, n_failing: int) -> torch.Tensor:
    """Oracles that pass: the first ``n - n_failing`` by ascending risk in
    Cairo order (``contract.cairo:345-363``), along the last axis of
    ``risk [..., N]``."""
    n = risk.shape[-1]
    return cairo_rank(risk.reshape(-1, n).T).T.reshape(risk.shape) < (n - n_failing)


def gated_reliability_mask(
    risk: torch.Tensor, ok: torch.Tensor, n_ok, n_failing: int
) -> torch.Tensor:
    """:func:`reliability_mask` over the admitted (``ok``) oracles of a
    block (``svoc_tpu/ops/sort.py:90-120``): quarantined oracles key
    ``+inf`` so they rank after every admitted one (ties among them by
    descending index), the cut is ``rank < n_ok - n_failing`` with
    ``n_ok`` counted at run time, and a passing oracle must also be
    admitted.  The cut may be negative, and then none passes."""
    rank = cairo_rank(torch.where(ok, risk, torch.inf))
    return torch.logical_and(rank < n_ok - n_failing, ok)
