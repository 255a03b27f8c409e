"""The port's mixture estimator (``svoc_torch.sim.multimodal``) against the
JAX package's, on the CPU, at small fleets and a few trials:

- the multimodal generator: the honest mask and the pole labels exactly,
  the values within 1e-6 (the normal noise within 3 ulp);
- ``em_mixture`` on the same numpy fleets: the farthest-point
  initialisation's picks exactly (the first EM iteration starts from
  the reference's means bit for bit), the fixed iteration count, then
  the log-sum-exp responsibilities, means, spreads and weights within
  1e-5 and the mean log-likelihood within 1e-4;
- ``multimodal_consensus`` under both policies: the reliable mask and the
  pole assignment exactly, the essence and the pole estimates within 1e-5;
- ``select_k``: the same K, the BICs within 1e-2 (2·N times the
  log-likelihood), the same disqualified (``inf``) candidates;
- ``benchmark_multimodal`` and ``multimodal_breakdown_curve`` on the same
  seeds: the rates within 1e-4 (points), the errors within 1e-5.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from svoc_tpu.sim import multimodal as ref  # noqa: E402
from svoc_torch.sim import multimodal, prng  # noqa: E402

POLES = [[0.2, 0.2], [0.8, 0.7]]
POLES6 = [[0.2] * 6, [0.8] * 6]


def keys(seed):
    return jax.random.PRNGKey(seed), prng.PRNGKey(seed, "cpu")


def _fleet(seed, n=32):
    rng = np.random.default_rng(seed)
    honest = np.concatenate([rng.normal(0.25, 0.04, (n // 2, 2)), rng.normal(0.75, 0.05, (n - n // 2 - 3, 2)),
                             rng.uniform(0, 1, (3, 2))])
    return rng.permutation(honest).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 3])
def test_generator_equals_reference(seed):
    jk, tk = keys(seed)
    v, h, p = ref.generate_multimodal_oracles(jk, 40, 5, POLES6, 0.05, weights=[0.7, 0.3])
    vt, ht, pt = multimodal.generate_multimodal_oracles(tk, 40, 5, POLES6, 0.05, weights=[0.7, 0.3])
    assert np.array_equal(np.asarray(h), ht.numpy()) and np.array_equal(np.asarray(p), pt.numpy())
    np.testing.assert_allclose(vt.numpy(), np.asarray(v), rtol=0, atol=1e-6)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_em_mixture_equals_reference(k):
    v = _fleet(k)
    want = ref.em_mixture(jnp.asarray(v), k)
    got = multimodal.em_mixture(torch.from_numpy(v), k)
    zero = multimodal.em_mixture(torch.from_numpy(v), k, n_iters=0)
    assert np.array_equal(zero.means.numpy(), np.asarray(ref.em_mixture(jnp.asarray(v), k, n_iters=0).means))
    for f in ("means", "sigmas", "weights", "resp"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)), rtol=0, atol=1e-5)
    assert float(got.log_likelihood) == pytest.approx(float(want.log_likelihood), abs=1e-4)


def test_em_mixture_takes_a_batch_of_fleets():
    vs = np.stack([_fleet(s) for s in range(4)])
    got = multimodal.em_mixture(torch.from_numpy(vs), 2)
    want = jax.vmap(lambda x: ref.em_mixture(x, 2))(jnp.asarray(vs))
    np.testing.assert_allclose(got.means.numpy(), np.asarray(want.means), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.resp.numpy(), np.asarray(want.resp), rtol=0, atol=1e-5)


@pytest.mark.parametrize("policy", ["dominant", "average"])
def test_consensus_equals_reference(policy):
    v = _fleet(7)
    want = ref.multimodal_consensus(jnp.asarray(v), 2, 3, policy=policy)
    got = multimodal.multimodal_consensus(torch.from_numpy(v), 2, 3, policy=policy)
    assert np.array_equal(got.reliable.numpy(), np.asarray(want.reliable))
    assert np.array_equal(got.pole_of.numpy(), np.asarray(want.pole_of))
    for f in ("essence", "pole_means", "pole_weights", "pole_sigmas"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="policy"):
        multimodal.multimodal_consensus(torch.from_numpy(v), 2, 3, policy="median")


def test_select_k_equals_reference():
    v = _fleet(11, n=36)
    best, bics = multimodal.select_k(torch.from_numpy(v), k_max=4)
    want_best, want_bics = ref.select_k(jnp.asarray(v), k_max=4)
    assert best == want_best and len(bics) == len(want_bics)
    for a, b in zip(bics, want_bics):
        assert (a == b == float("inf")) or a == pytest.approx(b, abs=1e-2)


def test_benchmark_and_breakdown_curve_equal_reference():
    jk, tk = keys(8)
    got = multimodal.benchmark_multimodal(tk, POLES, 0.03, weights=[0.5, 0.5], n_oracles=32, k_trials=12)
    want = ref.benchmark_multimodal(jk, POLES, 0.03, weights=[0.5, 0.5], n_oracles=32, k_trials=12)
    for key, value in want.items():
        assert got[key] == pytest.approx(value, abs=1e-4 if key.endswith("_pct") else 1e-5), key
    got = multimodal.multimodal_breakdown_curve(tk, POLES, 0.03, weights=[0.6, 0.4], n_oracles=32, k_trials=8,
                                                fractions=(0.1, 0.55))
    want = ref.multimodal_breakdown_curve(jk, POLES, 0.03, weights=[0.6, 0.4], n_oracles=32, k_trials=8,
                                          fractions=(0.1, 0.55))
    for f in want:
        assert got[f]["on_honest_pole_pct"] == pytest.approx(want[f]["on_honest_pole_pct"], abs=1e-4)
        assert got[f]["essence_err"] == pytest.approx(want[f]["essence_err"], abs=1e-5)
