"""Gaussian (unconstrained) consensus demo — the reference notebook as a script.

Mirrors ``examples/gaussian_demo.py`` (``single_fleet_walkthrough``
``:47``, ``main`` ``:77``), the runnable counterpart of the notebooks that
generated the unconstrained Cairo fixture (mu=[20,12], sigma=[3,2]).
Three stages, printing the reference's lines:

1. draw one unconstrained fleet (Gaussian honest + wide-uniform failing)
   and run the on-chain unconstrained two-pass rule;
2. Monte-Carlo estimator quality over sigma settings
   (:func:`svoc_torch.sim.montecarlo.benchmark_unconstrained` with the
   on-chain rule: a cell's trials are one cube through
   :func:`svoc_torch.ops.fused_consensus.consensus_blocks`, the gated
   claim-cube kernel on the card);
3. regenerate Cairo fixture source for the stage-1 fleet.

Usage::

    python -m svoc_torch.examples.gaussian_demo [--trials 3000] [--seed 0] [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from svoc_torch.consensus.kernel import ConsensusConfig, consensus_step
from svoc_torch.device import resolve_device
from svoc_torch.examples import add_device_argument
from svoc_torch.ops.fixedpoint import to_cairo_fixture
from svoc_torch.sim import prng
from svoc_torch.sim.generators import generate_gaussian_oracles
from svoc_torch.sim.montecarlo import benchmark_unconstrained

#: The reference fixture's parameters (``examples/gaussian_demo.py:41-45``).
MU = (20.0, 12.0)
SIGMA = (3.0, 2.0)
MAX_SPREAD = 10.0
#: Stage 2's noise scales.
SIGMA_SCALES = (0.5, 1.0, 2.0)


def single_fleet_walkthrough(key: torch.Tensor, n_oracles: int = 7, n_failing: int = 2) -> torch.Tensor:
    values, honest = generate_gaussian_oracles(key, n_oracles, n_failing, MU, SIGMA, failing_spread=MAX_SPREAD)
    out = consensus_step(values, ConsensusConfig(n_failing=n_failing, constrained=False, max_spread=MAX_SPREAD))
    print(f"fleet ({n_oracles} oracles, {n_failing} failing, honest ~ N({MU}, {SIGMA}^2)):")
    for i in range(n_oracles):
        tag = "honest " if bool(honest[i]) else "FAILING"
        flag = "" if bool(out.reliable[i]) == bool(honest[i]) else "   <- misjudged"
        print(f"  oracle {i}: {values[i].cpu().numpy().round(3)}  {tag}{flag}")
    print(f"  consensus (mean of detected-honest): {out.essence.cpu().numpy().round(4)}")
    print(
        f"  reliability first/second pass: "
        f"{float(out.reliability_first_pass):.4f} / "
        f"{float(out.reliability_second_pass):.4f}"
        "   (the Cairo fixture run records 0.533 / 0.647 for its vectors)"
    )
    return values


def estimator_quality(key: torch.Tensor, trials: int, n_oracles: int = 7, n_failing: int = 2) -> dict:
    """Stage 2: one on-chain-rule cell a noise scale, keyed
    ``fold_in(key, int(10 * scale))``; ``{scale: cell}``."""
    cells = {}
    for sigma_scale in SIGMA_SCALES:
        sigma = tuple(s * sigma_scale for s in SIGMA)
        r = benchmark_unconstrained(prng.fold_in(key, int(10 * sigma_scale)), MU, sigma, n_oracles, n_failing,
                                    k_trials=trials, max_spread=MAX_SPREAD, use_kernel=True)
        cells[sigma_scale] = r
        print(
            f"  sigma={tuple(round(s, 2) for s in sigma)}: identification "
            f"{r['identification_success_pct']:.2f} % | reliability "
            f"{r['reliability_pct']:.2f} % | on-chain rel2 "
            f"{r['mean_onchain_reliability2_pct']:.2f} % | estimator error "
            f"{r['mean_estimator_error']:.4f}"
        )
    return cells


def printed_bars(trials: int) -> tuple:
    """For :func:`svoc_torch.examples.compare_printed`: stage 2's
    identification counts trials, so one trial's share (100/K percentage
    points) on top of its printed unit; its reliabilities and estimator
    error are means of continuous values, held to their printed unit."""
    return ((r"identification (\S+) %", 100.0 / trials),)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--trials", type=int, default=3000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n-oracles", type=int, default=7)
    p.add_argument("--n-failing", type=int, default=2)
    add_device_argument(p)
    args = p.parse_args(argv)
    k1, k2 = prng.split(prng.PRNGKey(args.seed, resolve_device(args.device)), 2)

    print("== 1. single-fleet walkthrough (on-chain unconstrained rule) ==")
    values = single_fleet_walkthrough(k1, args.n_oracles, args.n_failing)

    print(f"\n== 2. Monte-Carlo estimator quality (K={args.trials}) ==")
    estimator_quality(k2, args.trials, args.n_oracles, args.n_failing)

    print("\n== 3. Cairo fixture source for the stage-1 fleet ==")
    print(to_cairo_fixture(values.cpu().numpy()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
