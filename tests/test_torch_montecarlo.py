"""The port's Monte-Carlo benchmark (``svoc_torch.sim.montecarlo``) against
the JAX package's, on the CPU, at small fleets (N <= 64) and a few trials:

- the medians and the reference rule's identification on the same
  numpy fleets: exactly;
- every benchmark cell on the same seeds (the port's fleets within a few
  ulp of the reference's, ``tests/test_torch_generators.py``):
  identification rates, misclassification counts and reliability
  percentages within 1e-4 (the float32 mean's rounding: one trial of 40
  is 2.5 points), distances within 1e-5;
- the CUDA route's function on the CPU: ``fused_consensus_gated_claims_plain``
  with every row admitted and every block active equals
  ``consensus_step_batched`` on a sweep's cube at the consensus bars
  (the reliable mask and ``interval_valid`` exactly; essence, risk and
  reliabilities within 1e-5; skewness within 1e-4; kurtosis within
  1e-3), which is what :func:`svoc_torch.ops.fused_consensus.consensus_blocks`
  launches as B3 on the card.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import torch  # noqa: E402

from svoc_tpu.sim import montecarlo as ref  # noqa: E402
from svoc_torch.consensus.kernel import ConsensusConfig, consensus_step_batched  # noqa: E402
from svoc_torch.ops.fused_consensus import consensus_blocks, fused_consensus_gated_claims_plain  # noqa: E402
from svoc_torch.sim import montecarlo, prng  # noqa: E402
from svoc_torch.sim.generators import generate_biased_beta_oracles  # noqa: E402


def keys(seed):
    return jax.random.PRNGKey(seed), prng.PRNGKey(seed, "cpu")


def assert_cell(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if k.endswith("_pct") or k == "mean_misclassified":
            assert got[k] == pytest.approx(v, abs=1e-4), k
        else:
            assert got[k] == pytest.approx(v, abs=1e-5), k


def test_medians_and_identification_equal_the_reference():
    rng = np.random.default_rng(0)
    for n in (7, 8):
        v = rng.uniform(size=(5, n, 3)).astype(np.float32)
        mask = rng.random((5, n)) < 0.7
        mask[:, :4] = True
        m = 4
        mask[:, 4:] = False
        tv = torch.from_numpy(v)
        for i in range(5):
            assert np.array_equal(montecarlo.true_median(tv)[i].numpy(), np.asarray(ref.true_median(v[i])))
            assert np.array_equal(montecarlo.restricted_median(tv, torch.from_numpy(mask), m)[i].numpy(),
                                  np.asarray(ref.restricted_median(v[i], mask[i], m)))
            assert np.array_equal(montecarlo.identify_failing_oracles(tv, 2)[i].numpy(),
                                  np.asarray(ref.identify_failing_oracles(v[i], 2)))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_benchmark_equals_reference(use_kernel):
    jk, tk = keys(3)
    assert_cell(montecarlo.benchmark(tk, 20.0, 20.0, 7, 2, k_trials=40, use_kernel=use_kernel),
                ref.benchmark(jk, 20.0, 20.0, 7, 2, k_trials=40, use_kernel=use_kernel))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_benchmark_unconstrained_equals_reference(use_kernel):
    jk, tk = keys(4)
    assert_cell(montecarlo.benchmark_unconstrained(tk, [20.0, 12.0], [3.0, 2.0], 7, 2, k_trials=40,
                                                   use_kernel=use_kernel),
                ref.benchmark_unconstrained(jk, [20.0, 12.0], [3.0, 2.0], 7, 2, k_trials=40, use_kernel=use_kernel))


def test_fleet_breakdown_curve_equals_reference_and_breaks_at_half():
    jk, tk = keys(5)
    fractions = (0.4, 0.55)  # each fraction compiles the reference's trials anew
    got = montecarlo.fleet_breakdown_curve(tk, n_oracles=64, fractions=fractions, k_trials=8, print_fn=lambda _: None)
    want = ref.fleet_breakdown_curve(jk, n_oracles=64, fractions=fractions, k_trials=8, print_fn=lambda _: None)
    assert list(got) == list(want)
    for f in want:
        assert_cell(got[f], want[f])
    assert got[0.4]["misclassified_rate_pct"] == 0.0 and got[0.55]["misclassified_rate_pct"] >= 60.0


def test_acceptance_grid_and_launch_benchmark_equal_reference():
    jk, tk = keys(6)
    got = montecarlo.fleet_acceptance_grid(tk, n_oracles=32, failing_list=(2, 24), k_trials=6,
                                           print_fn=lambda _: None)
    want = ref.fleet_acceptance_grid(jk, n_oracles=32, failing_list=(2, 24), k_trials=6, print_fn=lambda _: None)
    for n in want:
        assert_cell(got[n], want[n])
    lines = []
    got = montecarlo.launch_benchmark(tk, 7, 2, k_trials=12, print_fn=lines.append)
    want = ref.launch_benchmark(jk, 7, 2, k_trials=12, print_fn=lambda _: None)
    assert list(got) == list(want) and len(lines) == 12
    for cell in want:
        assert_cell(got[cell], want[cell])


def test_plain_gated_cube_equals_consensus_step_batched_on_a_sweep_cube():
    """The route of the card (B3's plain version, all rows admitted) and
    the route of the CPU compute the same consensus on a breakdown cube."""
    values = generate_biased_beta_oracles(prng.split(prng.PRNGKey(9, "cpu"), 12), 64, 28, 20.0, 20.0, dim=6)[0]
    for n_failing in (8, 28, 40):
        cfg = ConsensusConfig(n_failing=n_failing)
        ok = torch.ones(values.shape[:2], dtype=torch.bool)
        got = fused_consensus_gated_claims_plain(values, ok, ok[:, 0], cfg)
        want = consensus_step_batched(values, cfg)
        assert torch.equal(got.reliable, want.reliable) and torch.equal(got.interval_valid, want.interval_valid)
        for f in ("essence", "essence_first_pass", "reliability_first_pass", "reliability_second_pass",
                  "quadratic_risk"):
            torch.testing.assert_close(getattr(got, f), getattr(want, f), rtol=0, atol=1e-5)
        torch.testing.assert_close(got.skewness, want.skewness, rtol=0, atol=1e-4)
        torch.testing.assert_close(got.kurtosis, want.kurtosis, rtol=0, atol=1e-3)
        assert consensus_blocks(values, cfg).essence.equal(want.essence)  # the CPU route is the reference's


def test_fleet_benchmark_on_cpu_never_counts_a_launch():
    from svoc_torch.ops.fused_consensus import fused_consensus_gated_claims_cuda
    from svoc_torch.ops.threefry import threefry_cuda

    before = fused_consensus_gated_claims_cuda.launches, threefry_cuda.launches
    r = montecarlo.fleet_benchmark(prng.PRNGKey(1, "cpu"), 32, 4, k_trials=4)
    assert r["identification_success_pct"] == 100.0
    assert (fused_consensus_gated_claims_cuda.launches, threefry_cuda.launches) == before
