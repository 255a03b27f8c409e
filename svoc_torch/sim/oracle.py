"""The stochastic bootstrap oracle model over the whole fleet.

Mirrors :func:`svoc_tpu.sim.oracle.gen_oracle_predictions`
(``oracle.py:23-59``; the reference ``gen_oracles_predictions``,
``client/oracle_scheduler.py:73-92``): the first ``n_failing`` oracles
draw ``uniform(0, 1)^M``, the others average a ``subset_size``-element
sample of the window drawn without replacement, and the fleet is then
shuffled.

:func:`gen_oracle_predictions` is the reference's one call; it is split
in two: :func:`draw_fleet` makes the random numbers from a key with JAX's
threefry draws, the same bits ``gen_oracle_predictions`` draws from that
key, and :func:`assemble_fleet` builds the fleet from them
deterministically.  On CUDA the draws of every claim are one launch of
the fleet-draws kernel (:mod:`svoc_torch.ops.fleet_draws`); on the CPU
they are the plain composition of :mod:`svoc_torch.sim.prng`.  Both take
a leading batch axis (one key and one window per claim), so the fleets of
many claims are one pass.  The honest means add the ``subset_size`` rows
in index order and multiply by the float32 ``1 / subset_size``,
elementwise, as XLA compiles ``jnp.mean`` on the CPU (its reduce adds in
index order, its ``div`` by a constant becomes that product); so a fleet
has the same bits whatever it is batched with, and the bits
``gen_oracle_predictions`` gives there.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from svoc_torch.ops.fleet_draws import FleetDraws, fleet_draws_cuda, fleet_draws_plain


def draw_fleet(
    key: torch.Tensor,
    window_rows: int,
    dim: int,
    n_oracles: int,
    n_failing: int,
    subset_size: int = 10,
) -> FleetDraws:
    """The fleet's random numbers from ``key [..., 2]``, on its device:
    ``k_fail, k_boot, k_perm = split(key, 3)``; ``uniform(k_fail,
    (n_failing, M))``; ``choice(k, W, (subset,), replace=False)`` for
    each of ``split(k_boot, n_honest)``; ``permutation(k_perm, N)``.  On
    CUDA one launch of the fleet-draws kernel for every key, which raises
    on a shape it does not take (a window above 1625 rows, more than 16384
    oracles); on the CPU the plain draws."""
    if key.device.type == "cpu":
        return fleet_draws_plain(key, window_rows, dim, n_oracles, n_failing, subset_size)
    return fleet_draws_cuda(key, window_rows, dim, n_oracles, n_failing, subset_size)


def assemble_fleet(
    window: torch.Tensor,
    failing_vals: torch.Tensor,
    boot_idx: torch.Tensor,
    perm: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values [..., n_oracles, M], honest [..., n_oracles])`` after the
    shuffle, from ``window [..., W, M]`` and the draws of the same
    leading axes."""
    lead = window.shape[:-2]
    w, m = window.shape[-2:]
    n_failing, subset = failing_vals.shape[-2], boot_idx.shape[-1]
    window = window.reshape(-1, w, m)
    c = window.shape[0]
    idx = boot_idx.reshape(c, -1, subset).transpose(1, 2)  # [C, subset, H]
    rows = window[torch.arange(c, device=window.device)[:, None, None], idx]  # [C, subset, H, M]
    total = rows[:, 0]
    for j in range(1, subset):
        total = total + rows[:, j]
    honest_vals = total * float(np.float32(1.0 / subset))  # XLA's mean: a product by 1/S
    values = torch.cat([failing_vals.reshape(c, n_failing, m).to(window.dtype), honest_vals], dim=1)
    perm = perm.reshape(c, -1)
    n = values.shape[1]
    honest = torch.arange(n, device=window.device) >= n_failing
    values = values.gather(1, perm[:, :, None].expand(c, n, m))
    return values.reshape(*lead, n, m), honest[perm].reshape(*lead, n)


def gen_oracle_predictions(
    key: torch.Tensor,
    window: torch.Tensor,
    n_oracles: int,
    n_failing: int,
    subset_size: int = 10,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``gen_oracle_predictions(key, window [W, M], n_oracles, n_failing)``:
    ``(values [n_oracles, M], honest [n_oracles])`` after the shuffle, the
    draws of :func:`draw_fleet` assembled by :func:`assemble_fleet`."""
    w, m = window.shape[-2:]
    return assemble_fleet(window, *draw_fleet(key, w, m, n_oracles, n_failing, subset_size))
