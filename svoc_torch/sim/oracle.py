"""The stochastic bootstrap oracle model over the whole fleet.

Mirrors :func:`svoc_tpu.sim.oracle.gen_oracle_predictions`
(``oracle.py:23-59``; the reference ``gen_oracles_predictions``,
``client/oracle_scheduler.py:73-92``): the first ``n_failing`` oracles
draw ``uniform(0, 1)^M``, the others average a ``subset_size``-element
sample of the window drawn without replacement, and the fleet is then
shuffled.

:func:`gen_oracle_predictions` is the reference's one call; it is split
in two: :func:`draw_fleet` makes the random numbers from a
key with JAX's threefry draws (:mod:`svoc_torch.sim.prng`), the same
bits ``gen_oracle_predictions`` draws from that key, and
:func:`assemble_fleet` builds the fleet from them deterministically.
Both take a leading batch axis (one key and one window per claim), so
the fleets of many claims are one pass.  The honest means add the
``subset_size`` rows in index order and multiply by the float32
``1 / subset_size``, elementwise, as XLA compiles ``jnp.mean`` on the
CPU (its reduce adds in index order, its ``div`` by a constant becomes
that product); so a fleet has the same bits whatever it is batched
with, and the bits ``gen_oracle_predictions`` gives there.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from svoc_torch.sim import prng


class FleetDraws(NamedTuple):
    failing_vals: torch.Tensor  #: [..., n_failing, M] uniform(0, 1)
    boot_idx: torch.Tensor  #: [..., n_oracles - n_failing, subset] window rows, no repeats per row
    perm: torch.Tensor  #: [..., n_oracles] the shuffle


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
    each of ``split(k_boot, n_honest)``; ``permutation(k_perm, N)``."""
    if not 0 < subset_size <= window_rows:
        raise ValueError(f"subset_size {subset_size} must be in [1, {window_rows}]")
    k_fail, k_boot, k_perm = prng.split(key, 3).unbind(-2)
    failing_vals = prng.uniform(k_fail, (n_failing, dim))
    boot_idx = prng.choice(prng.split(k_boot, n_oracles - n_failing), window_rows, subset_size)
    perm = prng.permutation(k_perm, n_oracles)
    return FleetDraws(failing_vals, boot_idx, perm)


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
