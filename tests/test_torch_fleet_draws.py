"""The fleet-draws kernel's algorithm (``svoc_torch/csrc/fleet_draws.cu``)
against ``jax.random`` and the JAX package's ``gen_oracle_predictions``,
bit for bit, on the CPU.

The kernel runs only on the card (``tests/test_torch_kernels.py`` and
``chip_smoke.py`` phase 3c hold it to its plain version there).  Here an
element-wise model of what it computes stands in for it: each draw's key
chain hashed per element with the plain threefry, and each shuffle's
order as the stable rank of its (word, index) pairs, counted.  The model
is held to ``jax.random``'s ``split``, ``uniform``, ``choice(replace=
False)`` and ``permutation``, the port's plain draws (``draw_fleet`` on
the CPU) to the model, and the assembled fleet to the JAX package's.
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from svoc_tpu.sim.oracle import gen_oracle_predictions as jax_gen_oracle_predictions

from svoc_torch.ops.fleet_draws import MAX_ORACLES, MAX_WINDOW, fleet_draws_cuda
from svoc_torch.ops.threefry import threefry2x32_plain, threefry_cuda
from svoc_torch.sim import prng
from svoc_torch.sim.oracle import assemble_fleet, draw_fleet

#: (claims C, window W, oracles N, failing, subset S, values M): every C in
#: {1, 3}, W in {1, 10, 50, 64}, N in {7, 64, 1024, 1626, 2048}, n_failing
#: in {0, 128} and S in {1, 10, W} at least once; N = 1626 and 2048 take two
#: shuffle rounds, W = 1 none.
CASES = [
    (1, 50, 1024, 128, 10, 6),  # the flagship's fleet
    (3, 64, 1024, 128, 10, 6),  # the multi-claim step's bucket
    (3, 10, 7, 0, 10, 6),  # the fabric's 7-oracle fleet, S = W
    (1, 1, 7, 0, 1, 6),
    (3, 64, 2048, 128, 64, 6),
    (1, 50, 1626, 0, 1, 6),
    (3, 10, 64, 0, 1, 2),
    (1, 64, 64, 0, 10, 6),
    (3, 50, 1626, 128, 50, 6),
    (1, 1, 2048, 128, 1, 3),
    (3, 1, 64, 0, 1, 6),
    (1, 10, 1024, 0, 1, 6),
]


def _keys(c: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 2**32, size=(c, 2), dtype=np.uint64).astype(np.int64))


def _hash(keys: torch.Tensor, i) -> torch.Tensor:
    """``threefry(key, (0, i))`` as a key pair ``[..., 2]``, keys and
    counters broadcast."""
    i = torch.as_tensor(i, dtype=torch.int64)
    y1, y2 = threefry2x32_plain(keys[..., 0], keys[..., 1], torch.zeros_like(i), i)
    return torch.stack([y1, y2], dim=-1)


def _bits(keys: torch.Tensor, i) -> torch.Tensor:
    pair = _hash(keys, i)
    return pair[..., 0] ^ pair[..., 1]


def stable_rank(words: torch.Tensor) -> torch.Tensor:
    """Each word's place in the order of the (word, index) pairs along the
    last axis, counted: the pairs before it."""
    idx = torch.arange(words.shape[-1])
    before = (words[..., None, :] < words[..., :, None]) | (
        (words[..., None, :] == words[..., :, None]) & (idx[None, :] < idx[:, None]))
    return before.sum(-1)


def order_of(words: torch.Tensor) -> torch.Tensor:
    """The indices in stable order: ``order[rank[i]] = i``."""
    rank = stable_rank(words)
    order = torch.empty_like(rank)
    return order.scatter_(-1, rank, torch.arange(words.shape[-1]).expand_as(rank))


def model_draws(keys: torch.Tensor, w: int, m: int, n: int, n_failing: int, s: int):
    """The kernel's draws for keys ``[C, 2]``, element by element."""
    c, h = keys.shape[0], n - n_failing
    k_fail, k_boot, k_perm = (_hash(keys, i) for i in range(3))
    failing = (_bits(k_fail[:, None], torch.arange(n_failing * m)) >> 9).float() * 2.0**-23
    key_h = _hash(k_boot[:, None], torch.arange(h))  # [C, H, 2]
    if prng.shuffle_rounds(w) == 0:
        boot = torch.arange(s).expand(c, h, s)
    else:
        sub = _hash(key_h, 1)
        boot = order_of(_bits(sub[:, :, None], torch.arange(w)))[..., :s]
    x, k = torch.arange(n).expand(c, n), k_perm
    for _ in range(prng.shuffle_rounds(n)):
        sub, k = _hash(k, 1), _hash(k, 0)
        x = x.gather(-1, order_of(_bits(sub[:, None], torch.arange(n))))
    return failing.reshape(c, n_failing, m), boot, x


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 5))
def _jax_draws(keys, w, m, n, n_failing, s):
    def one(key):
        k_fail, k_boot, k_perm = jax.random.split(key, 3)
        boot = jax.vmap(lambda k: jax.random.choice(k, w, (s,), replace=False))(
            jax.random.split(k_boot, n - n_failing))
        return (jax.random.uniform(k_fail, (n_failing, m)), boot, jax.random.permutation(k_perm, n))

    return jax.vmap(one)(keys)


@pytest.mark.parametrize("c,w,n,f,s,m", CASES)
def test_the_kernels_model_matches_jax_random(c, w, n, f, s, m):
    keys = _keys(c, seed=c * 7 + w + n)
    failing, boot, perm = model_draws(keys, w, m, n, f, s)
    want = _jax_draws(jnp.asarray(keys.numpy().astype(np.uint32)), w, m, n, f, s)
    assert np.array_equal(failing.numpy().view(np.int32), np.asarray(want[0]).view(np.int32))
    assert np.array_equal(boot.numpy(), np.asarray(want[1]).astype(np.int64))
    assert np.array_equal(perm.numpy(), np.asarray(want[2]).astype(np.int64))


@pytest.mark.parametrize("c,w,n,f,s,m", CASES)
def test_the_plain_draws_equal_the_kernels_model(c, w, n, f, s, m):
    keys = _keys(c, seed=c + w * 3 + n)
    got = draw_fleet(keys, w, m, n, f, s)
    want = model_draws(keys, w, m, n, f, s)
    for g, x in zip(got, want):
        assert g.dtype == x.dtype and torch.equal(g, x)
    one = draw_fleet(keys[0], w, m, n, f, s)  # no leading axis: the claim's own draws
    assert all(torch.equal(g, x[0]) for g, x in zip(one, want))


@pytest.mark.parametrize("w,n,f,s", [(50, 1024, 128, 10), (10, 7, 2, 10), (1, 64, 0, 1), (64, 2048, 128, 10)])
def test_the_assembled_fleet_is_gen_oracle_predictions(w, n, f, s):
    keys = _keys(1, seed=w + n)
    window = np.random.default_rng(n).random((w, 6), dtype=np.float32)
    want_values, want_honest = jax.jit(jax_gen_oracle_predictions, static_argnums=(2, 3, 4))(
        jnp.asarray(keys[0].numpy().astype(np.uint32)), jnp.asarray(window), n, f, s)
    values, honest = assemble_fleet(torch.from_numpy(window), *(a[0] for a in model_draws(keys, w, 6, n, f, s)))
    assert np.array_equal(values.numpy().view(np.int32), np.asarray(want_values).view(np.int32))
    assert np.array_equal(honest.numpy(), np.asarray(want_honest))


def test_equal_words_keep_their_index_order():
    """The tie order: equal words rank by index, as a stable sort and
    JAX's ``_shuffle`` order them, and as the kernel's numbers ``word << 32
    | index`` sort as plain integers."""
    words = torch.tensor([[7, 3, 7, 3, 0, 7, 2**32 - 1, 3, 0, 2**32 - 1],
                          [5, 5, 5, 5, 5, 5, 5, 5, 5, 5]], dtype=torch.int64)
    order = order_of(words)
    assert order.tolist() == [[4, 8, 1, 3, 7, 0, 2, 5, 6, 9], list(range(10))]
    assert torch.equal(order, torch.sort(words, dim=-1, stable=True).indices)
    assert np.array_equal(order.numpy(), np.argsort(words.numpy(), axis=-1, kind="stable"))
    numbers = (words.numpy().astype(np.uint64) << np.uint64(32)) | np.arange(10, dtype=np.uint64)
    assert np.array_equal(np.argsort(numbers, axis=-1), order.numpy())  # distinct: any sort gives it


def test_draw_fleet_on_the_cpu_counts_no_launch():
    before = (fleet_draws_cuda.launches, threefry_cuda.launches)
    draw_fleet(_keys(2, seed=1), 50, 6, 1024, 128, 10)
    assert (fleet_draws_cuda.launches, threefry_cuda.launches) == before


@pytest.mark.parametrize("args,match", [
    ((50, 6, 1024, 128, 10), "CUDA"),  # keys on the CPU
    ((MAX_WINDOW + 1, 6, 1024, 128, 10), "two shuffle rounds"),
    ((50, 6, MAX_ORACLES + 1, 128, 10), "shared memory"),
    ((50, 70000, 4096, 4096, 10), "jobs"),
    ((50, 6, 1024, 1025, 10), "n_failing"),
    ((50, 6, 1024, 128, 51), "subset_size"),
    ((50, 6, 1024, 128, 0), "subset_size"),
])
def test_the_kernel_wrapper_refuses_before_any_launch(args, match):
    before = fleet_draws_cuda.launches
    with pytest.raises(ValueError, match=match):
        fleet_draws_cuda(_keys(2, seed=0), *args)
    assert fleet_draws_cuda.launches == before


def test_the_draws_take_only_int64_key_words():
    for keys in (torch.zeros(2, 2, dtype=torch.int32), torch.zeros(2, 3, dtype=torch.int64)):
        with pytest.raises(ValueError, match=r"\[\.\.\., 2\] int64"):
            draw_fleet(keys, 50, 6, 1024, 128, 10)


def test_the_hash_kernel_refuses_a_grid_beyond_its_index_arithmetic():
    before = threefry_cuda.launches
    for b, n in ((1, 2**31), (2**29, 2**4 + 1)):
        with pytest.raises(ValueError, match="grid"):
            threefry_cuda(torch.zeros(b, 2, dtype=torch.int64, device="meta"), n)
    assert threefry_cuda.launches == before
