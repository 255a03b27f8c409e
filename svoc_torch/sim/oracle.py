"""The stochastic bootstrap oracle model over the whole fleet.

Mirrors :func:`svoc_tpu.sim.oracle.gen_oracle_predictions`
(``oracle.py:23-59``; the reference ``gen_oracles_predictions``,
``client/oracle_scheduler.py:73-92``): the first ``n_failing`` oracles
draw ``uniform(0, 1)^M``, the others average a ``subset_size``-element
sample of the window drawn without replacement, and the fleet is then
shuffled.

It is split in two so that the tests can feed JAX's own draws:
:func:`draw_fleet` makes the random numbers from a ``torch.Generator``
(they are not JAX's threefry numbers: that port comes later) and
:func:`assemble_fleet` builds the fleet from them deterministically.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class FleetDraws(NamedTuple):
    failing_vals: torch.Tensor  #: [n_failing, M] uniform(0, 1)
    boot_idx: torch.Tensor  #: [n_oracles - n_failing, subset] window rows, no repeats per row
    perm: torch.Tensor  #: [n_oracles] the shuffle


def draw_fleet(
    gen: torch.Generator,
    window_rows: int,
    dim: int,
    n_oracles: int,
    n_failing: int,
    subset_size: int = 10,
) -> FleetDraws:
    """The fleet's random numbers, drawn on ``gen``'s device."""
    if not 0 < subset_size <= window_rows:
        raise ValueError(f"subset_size {subset_size} must be in [1, {window_rows}]")
    device = gen.device
    failing_vals = torch.rand((n_failing, dim), generator=gen, device=device)
    keys = torch.rand((n_oracles - n_failing, window_rows), generator=gen, device=device)
    boot_idx = keys.argsort(dim=1)[:, :subset_size]  # a sample without replacement
    perm = torch.randperm(n_oracles, generator=gen, device=device)
    return FleetDraws(failing_vals, boot_idx, perm)


def assemble_fleet(
    window: torch.Tensor,
    failing_vals: torch.Tensor,
    boot_idx: torch.Tensor,
    perm: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values [n_oracles, M], honest [n_oracles])`` after the shuffle."""
    n_failing = failing_vals.shape[0]
    honest_vals = window[boot_idx].mean(dim=1)  # [n_honest, M]
    values = torch.cat([failing_vals.to(window.dtype), honest_vals], dim=0)
    honest = torch.arange(values.shape[0], device=window.device) >= n_failing
    return values[perm], honest[perm]
