"""The port's fleet generators (``svoc_torch.sim.generators``) and the new
draws of ``svoc_torch.sim.prng`` against JAX's, on the CPU, on seeded keys:

- ``randint``, ``choice(p=)``, ``permutation`` and the failing slots of
  every generator: exactly;
- ``uniform`` on ``[minval, maxval)``: bit for bit (XLA's fused
  multiply-add);
- ``normal``: within 3 ulp (XLA's ``erf_inv`` polynomial, ported; its
  ``log1p`` is not PyTorch's in the last bit), 99 % of draws exactly;
- ``gamma``, ``loggamma`` and ``beta``: within 1e-6 absolute (a few ulp)
  wherever no rejection flips, and the flips counted: a flip would show
  as an element off by more than 1e-4, and none does on these seeds
  (``FLIPS_ALLOWED`` is 0);
- the Beta, biased-Beta, Kumaraswamy and Gaussian fleets: the honest
  masks exactly, the values within 1e-6 relative (2e-6 absolute for the
  Gaussian's spread of 3), also with a leading batch of keys.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from svoc_tpu.sim import generators as ref  # noqa: E402
from svoc_torch.sim import generators, prng  # noqa: E402

SEEDS = (0, 1, 7)
FLIPS_ALLOWED = 0  # elements off by more than 1e-4 (a rejection flipped by an ulp)


def keys(seed):
    return jax.random.PRNGKey(seed), prng.PRNGKey(seed, "cpu")


def ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_integer_draws_match_exactly(seed):
    jk, tk = keys(seed)
    assert np.array_equal(np.asarray(jax.random.randint(jk, (500,), 0, 37)),
                          prng.randint(tk, (500,), 0, 37).numpy())
    assert int(jax.random.randint(jk, (), 0, 64)) == int(prng.randint(tk, (), 0, 64))
    p = np.array([0.55, 0.3, 0.15], np.float32)
    assert np.array_equal(np.asarray(jax.random.choice(jk, 3, (400,), p=p)), prng.choice_p(tk, (400,), p).numpy())
    assert np.array_equal(np.asarray(jax.random.permutation(jk, 300)), prng.permutation(tk, 300).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_on_a_range_is_bit_for_bit(seed):
    jk, tk = keys(seed)
    for lo, hi in ((-2.5, 3.0), (0.85, 1.0), (1e-7, 1.0 - 1e-7), (-10.0, 10.0)):
        assert np.array_equal(np.asarray(jax.random.uniform(jk, (2000,), minval=lo, maxval=hi)),
                              prng.uniform(tk, (2000,), lo, hi).numpy())
    hi = np.array([1.0, 2.0, 3.0], np.float32)
    assert np.array_equal(np.asarray(jax.random.uniform(jk, (300, 3), minval=-1.0, maxval=hi)),
                          prng.uniform(tk, (300, 3), -1.0, hi).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_three_ulp(seed):
    jk, tk = keys(seed)
    u = ulps(jax.random.normal(jk, (20000,)), prng.normal(tk, (20000,)))
    assert u.max() <= 3 and (u == 0).mean() >= 0.98


def test_erf_inv_is_xlas_polynomial():
    x = np.random.default_rng(0).uniform(-1, 1, 200000).astype(np.float32)
    x[:2] = (-1.0, 1.0)
    j, t = np.asarray(jax.lax.erf_inv(jnp.asarray(x))), prng.erf_inv(torch.from_numpy(x)).numpy()
    assert np.array_equal(np.isinf(j), np.isinf(t)) and np.array_equal(j[:2], t[:2])
    assert ulps(j[2:], t[2:]).max() <= 2


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("a", [0.5, 2.0, 20.0])
def test_gamma_and_loggamma_within_a_few_ulp_no_flips(seed, a):
    jk, tk = keys(seed)
    g = np.abs(np.asarray(jax.random.gamma(jk, a, (2000,))) - prng.gamma(tk, a, (2000,)).numpy())
    lg = np.abs(np.asarray(jax.random.loggamma(jk, a, (2000,))) - prng.loggamma(tk, a, (2000,)).numpy())
    assert (g > 1e-4).sum() <= FLIPS_ALLOWED and (lg > 1e-4).sum() <= FLIPS_ALLOWED
    assert g[g <= 1e-4].max() <= 1e-5 * max(a, 1.0) and lg[lg <= 1e-4].max() <= 2e-6


@pytest.mark.parametrize("seed", SEEDS)
def test_beta_within_1e6_no_flips(seed):
    jk, tk = keys(seed)
    a = np.array([20.0, 5.0, 0.7], np.float32)
    d = np.abs(np.asarray(jax.random.beta(jk, a[None, :], 20.0, shape=(1500, 3)))
               - prng.beta(tk, a[None, :], 20.0, (1500, 3)).numpy())
    assert (d > 1e-4).sum() <= FLIPS_ALLOWED and d.max() <= 1e-6


GENERATORS = {
    "beta": (lambda k: ref.generate_beta_oracles(k, 64, 8, 20.0, [5.0, 20.0], dim=2),
             lambda k: generators.generate_beta_oracles(k, 64, 8, 20.0, [5.0, 20.0], dim=2), 1e-6),
    "biased_beta": (lambda k: ref.generate_biased_beta_oracles(k, 48, 20, 20.0, 20.0, dim=6),
                    lambda k: generators.generate_biased_beta_oracles(k, 48, 20, 20.0, 20.0, dim=6), 1e-6),
    "kumaraswamy": (lambda k: ref.generate_kumaraswamy_oracles(k, 40, 5, 3.0, 4.0, dim=3),
                    lambda k: generators.generate_kumaraswamy_oracles(k, 40, 5, 3.0, 4.0, dim=3), 1e-6),
    "gaussian": (lambda k: ref.generate_gaussian_oracles(k, 40, 5, [20.0, 12.0], [3.0, 2.0]),
                 lambda k: generators.generate_gaussian_oracles(k, 40, 5, [20.0, 12.0], [3.0, 2.0]), 2e-6),
}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generator_equals_reference(seed, name):
    jfn, tfn, atol = GENERATORS[name]
    jk, tk = keys(seed)
    vj, hj = jfn(jk)
    vt, ht = tfn(tk)
    assert np.array_equal(np.asarray(hj), ht.numpy())
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-6, atol=atol)


def test_generators_take_a_batch_of_keys():
    jks = jax.random.split(jax.random.PRNGKey(4), 5)
    tks = prng.split(prng.PRNGKey(4, "cpu"), 5)
    vj, hj = jax.vmap(lambda k: ref.generate_beta_oracles(k, 16, 4, 20.0, 20.0, dim=6))(jks)
    vt, ht = generators.generate_beta_oracles(tks, 16, 4, 20.0, 20.0, dim=6)
    assert vt.shape == (5, 16, 6) and np.array_equal(np.asarray(hj), ht.numpy())
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-6, atol=1e-6)


def test_modes_and_claim_seed_equal_the_reference():
    assert generators.beta_mode(20.0, 5.0) == ref.beta_mode(20.0, 5.0)
    assert generators.kumaraswamy_mode(3.0, 4.0) == ref.kumaraswamy_mode(3.0, 4.0)
    for base, claim in ((0, "alpha"), (7, 3), (2**40, "zeta")):
        assert generators.claim_seed(base, claim) == ref.claim_seed(base, claim)


def test_package_exports_and_gen_oracle_predictions_equal_the_reference():
    """``svoc_torch.sim`` and ``svoc_torch.robustness`` export the
    reference's names (and ``claim_fleet_keys``; the ``*_jax`` gate twins
    keep the port's names), and the one-call fleet
    ``gen_oracle_predictions`` is the reference's bit for bit."""
    import svoc_torch.robustness as port_robustness
    import svoc_torch.sim as port_sim
    import svoc_tpu.robustness as ref_robustness
    import svoc_tpu.sim as ref_sim
    from svoc_tpu.sim.oracle import gen_oracle_predictions

    public = {n for n in dir(ref_sim) if not n.startswith("_") and callable(getattr(ref_sim, n))}
    assert public - {n for n in dir(port_sim)} == set()
    renamed = {"quarantine_reasons_jax": "quarantine_reasons", "quarantine_mask_jax": "quarantine_mask"}
    for name in dir(ref_robustness):
        if not name.startswith("_") and not hasattr(getattr(ref_robustness, name), "__path__"):
            assert hasattr(port_robustness, renamed.get(name, name)), name
    window = np.random.default_rng(0).uniform(size=(50, 6)).astype(np.float32)
    v, h = gen_oracle_predictions(jax.random.PRNGKey(3), jnp.asarray(window), 64, 8)
    tv, th = port_sim.gen_oracle_predictions(prng.PRNGKey(3, "cpu"), torch.from_numpy(window), 64, 8)
    assert np.array_equal(np.asarray(v), tv.numpy()) and np.array_equal(np.asarray(h), th.numpy())
