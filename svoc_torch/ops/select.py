"""Fixed-shape "first K valid rows" selection for consensus windows.

Mirrors :func:`svoc_tpu.ops.select.first_valid_window`
(``select.py:33-58``).  The TPU version is a cumsum and a one-hot
matmul, because a TPU sort is slow; here it is a cumsum and an index
gather, which is exact and needs no host sync.  When fewer than
``window_size`` rows are valid the missing slots are zero vectors, as in
the reference.
"""

from __future__ import annotations

import torch


def first_valid_window(
    vecs: torch.Tensor, valid: torch.Tensor, window_size: int
) -> torch.Tensor:
    """First ``window_size`` rows of ``vecs[valid]`` in input order:
    ``vecs [N, M]``, ``valid [N]`` bool → ``[window_size, M]``."""
    n = valid.shape[0]
    if vecs.shape[0] != n:
        raise ValueError(f"vecs rows {vecs.shape[0]} != valid length {n}")
    count = torch.cumsum(valid.to(torch.int64), dim=0)  # [N], count[i] = #valid <= i
    want = torch.arange(1, window_size + 1, device=vecs.device)
    src = torch.searchsorted(count, want)  # first row with count == k + 1
    found = src < n
    rows = vecs[src.clamp(max=n - 1)]
    return torch.where(found[:, None], rows, torch.zeros((), dtype=vecs.dtype, device=vecs.device))
