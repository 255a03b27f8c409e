"""Monte-Carlo statistical benchmark of the consensus estimator.

Mirrors :mod:`svoc_tpu.sim.montecarlo` (``montecarlo.py:43-457``):
:func:`true_median`, :func:`restricted_median`,
:func:`identify_failing_oracles`, :func:`benchmark` (with
``use_kernel``), :func:`benchmark_unconstrained`,
:func:`fleet_benchmark`, :func:`fleet_acceptance_grid`,
:func:`fleet_breakdown_curve` and :func:`launch_benchmark`.

K independent trials each draw an oracle fleet with ``n_failing``
adversarial members; *identification success* is the failing oracles
identified exactly, *reliability* ``1 − 2·E‖median_identified −
median_truth‖`` over restricted medians (``documentation/README.md:
204-236``).  The reference vmaps a trial over a key batch; here every
function takes leading trial axes, so the ``K`` trials of a cell are one
pass: the fleets are one batched draw on the key's device, and the
two-pass consensus of all ``K`` fleets is
:func:`svoc_torch.ops.fused_consensus.consensus_blocks` (the reference's
``consensus_step`` per fleet on the CPU, one launch of the gated
claim-cube kernel B3 for the ``[K, N, M]`` cube on CUDA).  The keys are
the reference's, so the fleets are its fleets within a few ulp
(:mod:`svoc_torch.sim.generators`).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from svoc_torch.consensus.kernel import ConsensusConfig
from svoc_torch.ops.fused_consensus import consensus_blocks
from svoc_torch.sim import prng
from svoc_torch.sim.generators import (
    generate_beta_oracles,
    generate_biased_beta_oracles,
    generate_gaussian_oracles,
)


def true_median(values: torch.Tensor) -> torch.Tensor:
    """``np.median`` semantics, component-wise over the oracle axis of
    ``values [..., n, M]``."""
    n = values.shape[-2]
    s = torch.sort(values, dim=-2).values
    if n % 2 == 1:
        return s[..., n // 2, :]
    return (s[..., n // 2 - 1, :] + s[..., n // 2, :]) / 2.0


def restricted_median(values: torch.Tensor, mask: torch.Tensor, m: int) -> torch.Tensor:
    """``np.median`` over the ``m`` unmasked rows (masked rows sort as
    +inf, so rows ``[0, m)`` of the sorted block are the active set)."""
    s = torch.sort(torch.where(mask[..., None], values, torch.inf), dim=-2).values
    if m % 2 == 1:
        return s[..., m // 2, :]
    return (s[..., m // 2 - 1, :] + s[..., m // 2, :]) / 2.0


def _ranks_descending(scores: torch.Tensor) -> torch.Tensor:
    """``rank_array``'s ranks over the last axis: the smallest score gets
    ``n - 1``, the largest 0 (a stable sort, as ``jnp.argsort``)."""
    n = scores.shape[-1]
    order = torch.argsort(scores, dim=-1, stable=True)
    values = torch.arange(n - 1, -1, -1, device=scores.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, values)


def identify_failing_oracles(values: torch.Tensor, n_failing: int) -> torch.Tensor:
    """Healthy-oracle mask by the rank of each oracle's deviation from the
    median (``documentation/README.md:204-209``)."""
    med = true_median(values)
    dev = torch.linalg.vector_norm(values - med[..., None, :], dim=-1)
    return _ranks_descending(dev) >= n_failing


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over unmasked rows — the unconstrained second-pass estimator."""
    w = mask[..., None].to(values.dtype)
    return (values * w).sum(-2) / torch.clamp(w.sum(-2), min=1.0)


def _benchmark_trials(keys, a, b, *, n_oracles, n_failing, dim, use_kernel):
    m = n_oracles - n_failing
    values, honest = generate_beta_oracles(keys, n_oracles, n_failing, a, b, dim=dim)
    if use_kernel:
        guess = consensus_blocks(values, ConsensusConfig(n_failing=n_failing, constrained=True)).reliable
    else:
        guess = identify_failing_oracles(values, n_failing)
    success = torch.all(guess == honest, dim=-1)
    dist = torch.linalg.vector_norm(restricted_median(values, guess, m) - restricted_median(values, honest, m),
                                    dim=-1)
    return success.float().mean(), dist.mean()


def benchmark(
    key: torch.Tensor,
    a,
    b,
    n_oracles: int,
    n_failing: int,
    k_trials: int = 300,
    dim: int = 1,
    use_kernel: bool = False,
) -> Dict[str, float]:
    """One benchmark cell (``documentation/README.md:222-239``), in
    percentages like the published tables."""
    success_rate, mean_dist = _benchmark_trials(
        prng.split(key, k_trials), a, b, n_oracles=n_oracles, n_failing=n_failing, dim=dim, use_kernel=use_kernel)
    return {
        "identification_success_pct": float(success_rate) * 100.0,
        "reliability_pct": (1.0 - 2.0 * float(mean_dist)) * 100.0,
    }


def _unconstrained_trials(keys, mu, sigma, *, n_oracles, n_failing, use_kernel, max_spread, failing_spread):
    values, honest = generate_gaussian_oracles(keys, n_oracles, n_failing, mu, sigma, failing_spread=failing_spread)
    if use_kernel:
        out = consensus_blocks(values, ConsensusConfig(n_failing=n_failing, constrained=False,
                                                       max_spread=max_spread))
        guess, rel2 = out.reliable, out.reliability_second_pass
    else:
        guess = identify_failing_oracles(values, n_failing)
        rel2 = torch.full(values.shape[:-2], float("nan"), device=values.device)
    success = torch.all(guess == honest, dim=-1)
    dist = torch.linalg.vector_norm(masked_mean(values, guess) - masked_mean(values, honest), dim=-1)
    return success.float().mean(), dist.mean(), rel2.mean()


def benchmark_unconstrained(
    key: torch.Tensor,
    mu,
    sigma,
    n_oracles: int,
    n_failing: int,
    k_trials: int = 300,
    max_spread: float = 10.0,
    failing_spread: float = 10.0,
    use_kernel: bool = False,
) -> Dict[str, float]:
    """Estimator quality for the UNCONSTRAINED (Gaussian, R^M) case: the
    mean second pass, reliability ``1 − E‖pred − truth‖ / max_spread``;
    with ``use_kernel`` detection runs through the two-pass consensus and
    the mean on-chain second-pass reliability is reported."""
    success_rate, mean_dist, mean_rel2 = _unconstrained_trials(
        prng.split(key, k_trials), mu, sigma, n_oracles=n_oracles, n_failing=n_failing, use_kernel=use_kernel,
        max_spread=float(max_spread), failing_spread=float(failing_spread))
    out = {
        "identification_success_pct": float(success_rate) * 100.0,
        "reliability_pct": (1.0 - float(mean_dist) / max_spread) * 100.0,
        "mean_estimator_error": float(mean_dist),
    }
    if use_kernel:
        out["mean_onchain_reliability2_pct"] = float(mean_rel2) * 100.0
    return out


def _fleet_trials(key, a, b, *, n_oracles, n_failing, dim, k_trials, biased=False):
    m = n_oracles - n_failing
    gen = generate_biased_beta_oracles if biased else generate_beta_oracles
    values, honest = gen(prng.split(key, k_trials), n_oracles, n_failing, a, b, dim=dim)
    out = consensus_blocks(values, ConsensusConfig(n_failing=n_failing, constrained=True))
    guess = out.reliable
    exact = torch.all(guess == honest, dim=-1)
    miscls = (guess != honest).sum(-1)
    dist = torch.linalg.vector_norm(restricted_median(values, guess, m) - restricted_median(values, honest, m),
                                    dim=-1)
    return exact.float().mean(), miscls.float().mean(), dist.mean(), out.reliability_second_pass.mean()


def fleet_benchmark(
    key: torch.Tensor,
    n_oracles: int,
    n_failing: int,
    a: float = 20.0,
    b: float = 20.0,
    k_trials: int = 200,
    dim: int = 6,
    biased: bool = False,
) -> Dict[str, float]:
    """Estimator quality at product scale (a 1024-oracle fleet at the
    product dimension), detection through the two-pass consensus; beside
    exact identification, the mean number of misclassified oracles and
    the mean on-chain second-pass reliability."""
    exact, miscls, dist, rel2 = _fleet_trials(
        key, a, b, n_oracles=n_oracles, n_failing=n_failing, dim=dim, k_trials=k_trials, biased=biased)
    return {
        "identification_success_pct": float(exact) * 100.0,
        "mean_misclassified": float(miscls),
        "misclassified_rate_pct": float(miscls) / n_oracles * 100.0,
        "reliability_pct": (1.0 - 2.0 * float(dist)) * 100.0,
        "mean_onchain_reliability2_pct": float(rel2) * 100.0,
    }


def _fleet_sweep(key, n_oracles, rows, *, biased, k_trials, a, b, dim, print_fn, label_fn):
    """One independent key (``fold_in(key, i)``) and one
    :func:`fleet_benchmark` a row."""
    results = {}
    for i, (result_key, n_failing) in enumerate(rows):
        r = fleet_benchmark(prng.fold_in(key, i), n_oracles, n_failing, a=a, b=b, k_trials=k_trials, dim=dim,
                            biased=biased)
        results[result_key] = r
        print_fn(
            f"N={n_oracles} {label_fn(result_key, n_failing)} | "
            f"misflag rate {r['misclassified_rate_pct']:6.2f} % | "
            f"reliability {r['reliability_pct']:7.2f} % | rel2(chain) "
            f"{r['mean_onchain_reliability2_pct']:6.2f} %"
        )
    return results


def fleet_acceptance_grid(
    key: torch.Tensor,
    n_oracles: int = 1024,
    failing_list=(2, 64, 256, 768),
    k_trials: int = 200,
    a: float = 20.0,
    b: float = 20.0,
    dim: int = 6,
    print_fn: Callable[[str], None] = print,
) -> Dict[int, Dict[str, float]]:
    """The fleet-scale acceptance table (rows = adversary count)."""
    return _fleet_sweep(key, n_oracles, [(n, n) for n in failing_list], biased=False, k_trials=k_trials, a=a, b=b,
                        dim=dim, print_fn=print_fn, label_fn=lambda _k, n: f"failing={n:<4}")


def fleet_breakdown_curve(
    key: torch.Tensor,
    n_oracles: int = 1024,
    fractions=(0.1, 0.25, 0.4, 0.45, 0.49, 0.51, 0.55),
    k_trials: int = 100,
    a: float = 20.0,
    b: float = 20.0,
    dim: int = 6,
    print_fn: Callable[[str], None] = print,
) -> Dict[float, Dict[str, float]]:
    """The estimator's breakdown point, measured with COORDINATED biased
    adversaries (a narrow corner band): below N/2 the first-pass median
    stays with the honest mass and detection holds; above it the median
    jumps into the adversary band and the estimator inverts."""
    return _fleet_sweep(key, n_oracles, [(frac, int(round(frac * n_oracles))) for frac in fractions], biased=True,
                        k_trials=k_trials, a=a, b=b, dim=dim, print_fn=print_fn,
                        label_fn=lambda frac, n: f"biased={frac:5.0%} ({n:4d})")


def launch_benchmark(
    key: torch.Tensor,
    n_oracles: int,
    n_failing: int,
    k_trials: int = 300,
    print_fn: Callable[[str], None] = print,
    use_kernel: bool = False,
):
    """The published benchmark grid (``documentation/README.md:241-246``):
    a ∈ {10, 20, 30, 100} × b ∈ {15, a}, one independent key a cell."""
    results = {}
    cell = 0
    for a in [10, 20, 30, 100]:
        print_fn("---")
        for b in [15.0, float(a)]:
            cell += 1
            r = benchmark(prng.fold_in(key, cell), float(a), b, n_oracles, n_failing, k_trials=k_trials,
                          use_kernel=use_kernel)
            results[(a, b)] = r
            print_fn(
                f"a={a} | b={b:<8} | identification success: "
                f"{r['identification_success_pct']:0.2f} % | reliability : "
                f"{r['reliability_pct']:0.2f} %"
            )
    return results
