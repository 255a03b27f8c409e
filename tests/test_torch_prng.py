"""The port's threefry draws against ``jax.random`` on the installed jax,
bit for bit, on the CPU (the plain threefry; the kernel is held against
it on the card, in ``tests/test_torch_kernels.py`` and ``chip_smoke.py``
phase 3c).

The draws are those of the installed jax with its default
``jax_threefry_partitionable`` (True from jax 0.5); the tests assert that
default and change no global setting.  ``gen_oracle_predictions`` is
reproduced exactly: indices, permutation, honest mask, failing values
and the honest means (XLA's ``jnp.mean`` on the CPU adds in index order
and multiplies by the float32 ``1 / S``, as the port does).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from svoc_tpu.sim.oracle import gen_oracle_predictions as jax_gen_oracle_predictions

from svoc_torch.ops.threefry import threefry, threefry2x32_plain, threefry_cuda
from svoc_torch.sim import prng
from svoc_torch.sim.oracle import assemble_fleet, draw_fleet


def _j(a) -> np.ndarray:
    """A JAX uint32 array as the port holds it (int64 words)."""
    return np.asarray(a).astype(np.int64)


def _key(seed) -> torch.Tensor:
    return prng.PRNGKey(seed, "cpu")


def test_jax_runs_the_partitionable_threefry():
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_default_prng_impl == "threefry2x32"


def test_raw_threefry_2x32_matches_jax():
    from jax._src import prng as jax_prng

    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2**32, size=(64, 2), dtype=np.uint64).astype(np.uint32)
    counts = rng.integers(0, 2**32, size=(64, 2), dtype=np.uint64).astype(np.uint32)
    y1, y2 = threefry2x32_plain(*(torch.from_numpy(a.astype(np.int64)) for a in
                                  (keys[:, 0], keys[:, 1], counts[:, 0], counts[:, 1])))
    for i in range(len(keys)):
        want = jax_prng.threefry_2x32(jnp.asarray(keys[i]), jnp.asarray(counts[i]))
        assert [int(y1[i]), int(y2[i])] == _j(want).tolist()


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1, 2**31, 3_000_000_000, 2**32 - 1, 2**32,
                                  2**40 + 7, -1, -5, -(2**31), -(2**31) - 1])
def test_prng_key_matches_jax_on_large_and_negative_seeds(seed):
    assert _key(seed).tolist() == _j(jax.random.PRNGKey(seed)).tolist()


def test_prng_key_refuses_what_jax_refuses():
    with pytest.raises(OverflowError):
        jax.random.PRNGKey(2**63)
    with pytest.raises(OverflowError):
        _key(2**63)


def test_known_answer_of_split():
    assert prng.split(_key(0), 3).tolist() == [
        [1797259609, 2579123966], [928981903, 3453687069], [4146024105, 2718843009]]


@pytest.mark.parametrize("seed,num", [(0, 2), (7, 5), (3_000_000_000, 1), (11, 1024)])
def test_split_matches_jax(seed, num):
    want = _j(jax.random.split(jax.random.PRNGKey(seed), num))
    np.testing.assert_array_equal(prng.split(_key(seed), num).numpy(), want)


def test_split_of_a_batch_of_keys_is_each_key_split():
    keys = jax.random.split(jax.random.PRNGKey(3), 6)
    want = _j(jax.vmap(lambda k: jax.random.split(k, 4))(keys))
    got = prng.split(torch.from_numpy(_j(keys)).reshape(2, 3, 2), 4)
    np.testing.assert_array_equal(got.numpy().reshape(6, 4, 2), want)


@pytest.mark.parametrize("data", [0, 1, 5, 123456, 2**31, 2**32 - 1, 2**32 + 3, -1])
def test_fold_in_matches_jax(data):
    key = jax.random.PRNGKey(9)
    want = _j(jax.random.fold_in(key, np.uint32(data & 0xFFFFFFFF)))
    if 0 <= data < 2**31:
        np.testing.assert_array_equal(want, _j(jax.random.fold_in(key, data)))
    np.testing.assert_array_equal(prng.fold_in(_key(9), data).numpy(), want)


def test_flagship_fold_in_chain_matches_jax():
    key, tkey = jax.random.PRNGKey(0), _key(0)
    for step in range(6):
        key, tkey = jax.random.fold_in(key, step), prng.fold_in(tkey, step)
        np.testing.assert_array_equal(tkey.numpy(), _j(key))


@pytest.mark.parametrize("shape", [(1,), (13, 6), (128, 6), (3, 5, 7)])
def test_uniform_matches_jax_bit_for_bit(shape):
    key = jax.random.PRNGKey(sum(shape))
    want = np.asarray(jax.random.uniform(key, shape))
    got = prng.uniform(_key(sum(shape)), shape).numpy()
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_random_bits_match_jax():
    from jax._src import prng as jax_prng

    key = jax.random.PRNGKey(17)
    want = _j(jax_prng.threefry_random_bits(key, 32, (50, 3)))
    np.testing.assert_array_equal(prng.random_bits(_key(17), (50, 3)).numpy(), want)


@pytest.mark.parametrize("n", [1, 2, 50, 1024, 1625, 1626, 2048])
def test_permutation_matches_jax(n):
    assert prng.shuffle_rounds(n) == (0 if n == 1 else 1 if n <= 1625 else 2)
    for seed in (0, n):
        want = _j(jax.random.permutation(jax.random.PRNGKey(seed), n))
        np.testing.assert_array_equal(prng.permutation(_key(seed), n).numpy(), want)


def test_permutation_sorts_its_keys_as_unsigned():
    """A key above 2**31 sorts after every smaller one: the words are
    int64, not int32 (which would sort it first)."""
    keys = torch.from_numpy(_j(jax.random.split(jax.random.PRNGKey(1), 64)))
    perms = prng.permutation(keys, 50)
    for k, perm in zip(keys, perms):
        sub = prng.split(k)[1]  # one round: key, sub = split(key)
        bits = prng.random_bits(sub, (50,))
        assert bool((bits >= 2**31).any())
        assert bool((bits[perm][1:] >= bits[perm][:-1]).all())


def test_vmapped_choice_without_replacement_matches_jax():
    keys = jax.random.split(jax.random.PRNGKey(5), 200)
    for w, k in ((50, 10), (64, 10), (8, 4), (3, 3)):
        want = _j(jax.vmap(lambda key: jax.random.choice(key, w, (k,), replace=False))(keys))
        got = prng.choice(torch.from_numpy(_j(keys)), w, k)
        np.testing.assert_array_equal(got.numpy(), want)
        assert all(len(set(row)) == k for row in got.tolist())


@pytest.mark.parametrize("w,n,f,s", [(50, 1024, 128, 10), (64, 1024, 128, 10), (20, 7, 2, 3)])
def test_gen_oracle_predictions_reproduced_exactly(w, n, f, s):
    window = np.random.default_rng(w + n).uniform(size=(w, 6)).astype(np.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 3)
    want_values, want_honest = jax.jit(jax_gen_oracle_predictions, static_argnums=(2, 3, 4))(
        key, jnp.asarray(window), n, f, s)
    draws = draw_fleet(torch.from_numpy(_j(key)), w, 6, n, f, s)

    # The draws themselves, against jax.random's.
    k_fail, k_boot, k_perm = jax.random.split(key, 3)
    np.testing.assert_array_equal(
        draws.failing_vals.numpy(), np.asarray(jax.random.uniform(k_fail, (f, 6))))
    boot = jax.vmap(lambda k: jax.random.choice(k, w, (s,), replace=False))(
        jax.random.split(k_boot, n - f))
    np.testing.assert_array_equal(draws.boot_idx.numpy(), _j(boot))
    np.testing.assert_array_equal(draws.perm.numpy(), _j(jax.random.permutation(k_perm, n)))

    values, honest = assemble_fleet(torch.from_numpy(window), *draws)
    np.testing.assert_array_equal(honest.numpy(), np.asarray(want_honest))
    np.testing.assert_array_equal(values.numpy(), np.asarray(want_values))  # honest means too


def test_draws_take_a_leading_claim_axis():
    """A batch of keys draws each key's fleet: the batched draws are the
    one-key draws, stacked."""
    keys = torch.from_numpy(_j(jax.random.split(jax.random.PRNGKey(2), 3)))
    batched = draw_fleet(keys, 16, 6, 40, 5, 4)
    for c in range(3):
        one = draw_fleet(keys[c], 16, 6, 40, 5, 4)
        for a, b in zip(batched, one):
            assert torch.equal(a[c], b)


def test_threefry_refuses_and_never_launches_on_the_cpu():
    before = threefry_cuda.launches
    keys = _key(0)[None]
    assert threefry(keys, 4).shape == (1, 4, 2) and threefry(keys, 4, xor=True).shape == (1, 4)
    with pytest.raises(ValueError, match="CUDA"):
        threefry_cuda(keys, 4)
    with pytest.raises(ValueError, match=r"\[B, 2\] int64"):
        threefry(keys.int(), 4)
    with pytest.raises(ValueError, match="uint32"):
        threefry(keys, 4, base=2**32)
    assert threefry_cuda.launches == before
