"""Multimodal consensus demo — the reference's open problem, solved.

Mirrors ``examples/multimodal_demo.py`` (``main`` ``:43``): the
mixture-model oracle scenario (K poles, each honest oracle following
pole k with probability ``p_k``) through the mixture estimator
(:mod:`svoc_torch.sim.multimodal`) against the unimodal two-pass
estimator, printing the reference's lines:

1. one bimodal fleet: the EM fit, the fixed-count mask and both
   policies' essences (:func:`one_fleet`);
2. a Monte-Carlo table over pole weights: nearest-pole error and
   dominant-pole hit rate for the mixture estimator vs the unimodal
   rule, whose trials are one cube through
   :func:`svoc_torch.ops.fused_consensus.consensus_blocks` (the gated
   claim-cube kernel on the card) (:func:`monte_carlo`);
3. the reading: "dominant" keeps the essence on a believed value,
   "average" lands between the poles.

Usage::

    python -m svoc_torch.examples.multimodal_demo [--trials 300] [--seed 0] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from svoc_torch.device import resolve_device
from svoc_torch.examples import add_device_argument
from svoc_torch.sim import prng
from svoc_torch.sim.multimodal import benchmark_multimodal, generate_multimodal_oracles, multimodal_consensus

POLES = np.array([[0.2, 0.2], [0.8, 0.7]], np.float32)
SIGMA = 0.03
#: The table's dominant-pole weights.
WEIGHTS = (0.5, 0.6, 0.7, 0.85)


def round3(t: torch.Tensor) -> list:
    """``jnp.round(t, 3).tolist()`` as the reference prints it: the
    rounded thousandths times the float32 0.001 (XLA's CPU program
    multiplies by the reciprocal where ``jnp.round`` divides by 1000)."""
    return (torch.round(t.float() * 1000.0) * torch.tensor(0.001, dtype=torch.float32)).tolist()


def one_fleet(key: torch.Tensor) -> None:
    """Stage 1: one bimodal fleet (N=64, 4 failing, weights 0.6/0.4)."""
    print("== one bimodal fleet (N=64, 4 failing, weights 0.6/0.4) ==")
    values, honest, _pole_of = generate_multimodal_oracles(key, 64, 4, POLES, SIGMA, weights=[0.6, 0.4])
    res = multimodal_consensus(values, 2, 4, policy="dominant")
    avg = multimodal_consensus(values, 2, 4, policy="average")
    print(f"true poles:        {POLES.tolist()}")
    print(f"EM pole means:     {round3(res.pole_means)}")
    print(f"EM pole weights:   {round3(res.pole_weights)}")
    print(f"essence (dominant): {round3(res.essence)}")
    print(f"essence (average):  {round3(avg.essence)}  "
          "<- between poles: held by no oracle")
    flagged = int((~res.reliable & ~honest).sum())
    print(f"adversaries caught in mask: {flagged}/4")


def monte_carlo(key: torch.Tensor, trials: int) -> None:
    """Stage 2: one :func:`benchmark_multimodal` cell a weight, keyed
    ``fold_in(key, int(w0 * 100))``."""
    print(f"\n== Monte-Carlo ({trials} trials/cell): mixture vs unimodal two-pass ==")
    print(
        f"{'weights':>12} {'mix near-pole':>14} {'uni near-pole':>14} "
        f"{'mix dom%':>9} {'uni dom%':>9} {'pole recov':>11}"
    )
    for w0 in WEIGHTS:
        cell = benchmark_multimodal(prng.fold_in(key, int(w0 * 100)), POLES, SIGMA, weights=[w0, 1.0 - w0],
                                    n_oracles=64, n_failing=4, k_trials=trials)
        print(
            f"{w0:>6.2f}/{1 - w0:<5.2f}"
            f" {cell['mixture_nearest_pole_error']:>14.4f}"
            f" {cell['unimodal_nearest_pole_error']:>14.4f}"
            f" {cell['mixture_dominant_pole_pct']:>9.1f}"
            f" {cell['unimodal_dominant_pole_pct']:>9.1f}"
            f" {cell['pole_recovery_error']:>11.4f}"
        )


def printed_bars(trials: int) -> tuple:
    """For :func:`svoc_torch.examples.compare_printed`: the table's two
    dominant-pole shares count trials, so one trial's share (100/K
    percentage points) on top of their printed unit (its errors are means,
    held to their printed unit); stage 1's fitted numbers are thousandths
    (:func:`round3`) printed as float32 reprs, so their unit is a
    thousandth, not the repr's last digit."""
    return ((r"^ *[\d.]+/[\d.]+ +\S+ +\S+ +(\S+) +(\S+)", 100.0 / trials),
            (r"^(?:EM pole \w+|essence \(\w+\)): +(\[.*\])", 0.001))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--trials", type=int, default=300)
    p.add_argument("--seed", type=int, default=0)
    add_device_argument(p)
    args = p.parse_args(argv)
    key = prng.PRNGKey(args.seed, resolve_device(args.device))
    one_fleet(key)
    monte_carlo(key, args.trials)
    print(
        "\nReading: the mixture essence stays ~sigma from a true pole in "
        "every regime and\nrecovers BOTH pole centers; the unimodal "
        "median's nearest-pole error includes the\nbalanced-tie trials "
        "where it lands in the empty gap between the poles."
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
