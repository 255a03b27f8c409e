"""Beta/Kumaraswamy consensus demo — the reference notebook as a script.

Mirrors ``examples/beta_kumaraswamy_demo.py`` (``single_fleet_walkthrough``
``:55``, ``compare_models`` ``:84``, ``main`` ``:101``), the runnable
counterpart of the notebook that produced the published estimator-quality
tables and the Cairo test fixtures.  Four stages, printing the reference's
lines:

1. draw one constrained fleet (Beta honest + uniform failing, shuffled)
   and show detection + the restricted median;
2. compare Beta vs Kumaraswamy modelling of the honest belief;
3. run the published benchmark grid (K trials per cell) with both the
   notebook rule and the on-chain two-pass rule; every trial's two-pass
   consensus of a cell is one ``[K, N, 1]`` cube through
   :func:`svoc_torch.ops.fused_consensus.consensus_blocks` (the gated
   claim-cube kernel on the card, its plain version on the CPU);
4. emit Cairo test-fixture source from the drawn fleet.

Usage::

    python -m svoc_torch.examples.beta_kumaraswamy_demo [--trials 3000] [--seed 0] [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from svoc_torch.consensus.kernel import ConsensusConfig, consensus_step
from svoc_torch.device import resolve_device
from svoc_torch.examples import add_device_argument
from svoc_torch.ops.fixedpoint import to_cairo_fixture
from svoc_torch.sim import prng
from svoc_torch.sim.generators import (
    beta_mode,
    generate_beta_oracles,
    generate_kumaraswamy_oracles,
    kumaraswamy_mode,
)
from svoc_torch.sim.montecarlo import identify_failing_oracles, launch_benchmark, restricted_median


def single_fleet_walkthrough(key: torch.Tensor, n_oracles: int = 7, n_failing: int = 2, a: float = 10.0,
                             b: float = 10.0) -> torch.Tensor:
    """Stage 1: one fleet, end to end (the notebook's opening cells)."""
    values, honest = generate_beta_oracles(key, n_oracles, n_failing, a, b, dim=2)
    guess = identify_failing_oracles(values, n_failing)
    m = n_oracles - n_failing
    essence = restricted_median(values, guess, m)
    truth = restricted_median(values, honest, m)
    out = consensus_step(values, ConsensusConfig(n_failing=n_failing, constrained=True))

    print(f"fleet ({n_oracles} oracles, {n_failing} failing, Beta a=b={a:g}):")
    for i in range(n_oracles):
        tag = "honest " if bool(honest[i]) else "FAILING"
        flag = "" if bool(guess[i]) == bool(honest[i]) else "   <- misjudged"
        print(f"  oracle {i}: {values[i].cpu().numpy().round(4)}  {tag}{flag}")
    print(f"  mode of Beta({a:g},{a:g}) (true essence): {beta_mode(a, b):.4f}")
    print(f"  restricted median (detected set):  {essence.cpu().numpy().round(4)}")
    print(f"  restricted median (honest truth):  {truth.cpu().numpy().round(4)}")
    print(
        "  on-chain two-pass kernel: essence="
        f"{out.essence.cpu().numpy().round(4)} rel1={float(out.reliability_first_pass):.4f} "
        f"rel2={float(out.reliability_second_pass):.4f}"
    )
    return values


def compare_models(key: torch.Tensor, a: float = 10.0, b: float = 10.0, n: int = 100_000) -> None:
    """Stage 2: Beta vs Kumaraswamy honest-belief modelling — same mode,
    slightly different tails."""
    kb, kk = prng.split(key, 2)
    vb, _ = generate_beta_oracles(kb, n, 0, a, b)
    vk, _ = generate_kumaraswamy_oracles(kk, n, 0, a, b)
    print(
        f"Beta({a:g},{b:g}):        mode={beta_mode(a, b):.4f}  "
        f"sample mean={float(vb.mean()):.4f}  std={float(vb.std(correction=0)):.4f}"
    )
    print(
        f"Kumaraswamy({a:g},{b:g}): mode={kumaraswamy_mode(a, b):.4f}  "
        f"sample mean={float(vk.mean()):.4f}  std={float(vk.std(correction=0)):.4f}"
    )


def printed_bars(trials: int) -> tuple:
    """For :func:`svoc_torch.examples.compare_printed`: a grid cell's
    identification success counts trials, so one trial's share (100/K
    percentage points) on top of its printed unit; its reliability is a
    mean of distances, held to its printed unit."""
    return ((r"identification success: +(\S+) %", 100.0 / trials),)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--trials", type=int, default=3000, help="K trials per cell")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n-oracles", type=int, default=7, help="fleet size (tables use 7 and 20)")
    p.add_argument("--n-failing", type=int, default=2)
    add_device_argument(p)
    args = p.parse_args(argv)
    key = prng.PRNGKey(args.seed, resolve_device(args.device))
    k1, k2, k3 = prng.split(key, 3)

    print("== 1. single-fleet walkthrough ==")
    values = single_fleet_walkthrough(k1, args.n_oracles, args.n_failing)

    print("\n== 2. Beta vs Kumaraswamy honest model ==")
    compare_models(k2)

    print(f"\n== 3. benchmark grid (notebook rule, K={args.trials}, N={args.n_oracles}/{args.n_failing} failing) ==")
    launch_benchmark(k3, args.n_oracles, args.n_failing, k_trials=args.trials)
    print("\n== 3b. same grid through the on-chain two-pass kernel ==")
    launch_benchmark(k3, args.n_oracles, args.n_failing, k_trials=args.trials, use_kernel=True)

    print("\n== 4. Cairo test-fixture source for the stage-1 fleet ==")
    print(to_cairo_fixture(values.cpu().numpy()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
