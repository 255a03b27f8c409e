"""JAX's default PRNG, bit for bit: keys, ``split``, ``fold_in`` and the
draws the fleet takes.

Mirrors ``jax.random`` under jax 0.9.0 with ``jax_threefry_partitionable``
True, its default there (``jax/_src/prng.py:1138-1202``,
``jax/_src/random.py:222, 435-477, 660-800``):

- a key is two uint32 words; ``PRNGKey(seed)`` is ``[0, seed mod 2**32]``
  for any seed of int64's range (JAX without x64 keeps the low word);
- ``split(key, n)[i]`` and ``fold_in(key, i)`` are both
  ``threefry2x32(key, (0, i))``;
- ``random_bits`` of a shape is ``y1 ^ y2`` of ``threefry2x32(key,
  (hi, lo))`` over the words of each element's flat index;
- ``uniform`` keeps the top 23 bits as the mantissa of a float32 in
  ``[1, 2)`` and subtracts 1 (exactly ``(bits >> 9) * 2**-23``);
- ``permutation`` is ``_shuffle``: ``ceil(3 ln n / ln(2**32 - 1))``
  rounds, each a ``split`` and a **stable** sort of ``arange(n)`` by
  fresh 32-bit keys; ``choice(replace=False)`` is its first ``k``.

Keys are int64 tensors ``[..., 2]`` of uint32 words (so the sort keys
compare as unsigned numbers), and every function takes any number of
leading key axes, so a fleet of many oracles or claims is one call of
each.  The hash is :func:`svoc_torch.ops.threefry.threefry` (the kernel
on CUDA).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from svoc_torch.device import resolve_device
from svoc_torch.ops.threefry import MASK, threefry


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: ``[0, seed mod 2**32]`` int64 on
    ``device`` (None: CUDA)."""
    return PRNGKeys([seed], device)[0]


def PRNGKeys(seeds: Sequence[int], device=None) -> torch.Tensor:
    """``PRNGKey`` of each seed, ``[len(seeds), 2]``, in one copy."""
    words = []
    for seed in seeds:
        seed = int(seed)
        if not -(2**63) <= seed < 2**63:  # JAX raises OverflowError there too
            raise OverflowError(f"seed {seed} does not fit in int64")
        words.append((0, seed & MASK))
    return torch.tensor(words, dtype=torch.int64).reshape(-1, 2).to(resolve_device(device))


def _flat(keys: torch.Tensor) -> torch.Tensor:
    if keys.shape[-1:] != (2,) or keys.dtype != torch.int64:
        raise ValueError(f"keys must be [..., 2] int64, got {tuple(keys.shape)} {keys.dtype}")
    return keys.reshape(-1, 2).contiguous()


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``[..., 2]`` → ``[..., num, 2]``."""
    return threefry(_flat(keys), num).reshape(*keys.shape[:-1], num, 2)


def fold_in(keys: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: ``[..., 2]`` → ``[..., 2]``; ``data`` is
    taken modulo 2**32, as JAX casts it to uint32."""
    return threefry(_flat(keys), 1, base=int(data) & MASK).reshape(keys.shape)


def random_bits(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32-bit random bits ``[..., *shape]`` int64 in ``[0, 2**32)``."""
    shape = tuple(shape)
    bits = threefry(_flat(keys), math.prod(shape), xor=True)
    return bits.reshape(*keys.shape[:-1], *shape)


def uniform(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.uniform`` on ``[0, 1)``: float32 ``[..., *shape]``.
    JAX sets the top 23 bits as the mantissa of a float in ``[1, 2)``
    and subtracts 1, which is exactly ``(bits >> 9) * 2**-23``."""
    return (random_bits(keys, shape) >> 9).to(torch.float32) * 2.0**-23


def shuffle_rounds(n: int) -> int:
    """``_shuffle``'s rounds (``random.py:717``): 1 up to n = 1625, 2 from
    n = 1626, computed as JAX computes it."""
    return int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))


def permutation(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: int64 ``[..., n]``."""
    lead = keys.shape[:-1]
    keys = _flat(keys)
    x = None
    rounds = shuffle_rounds(n)
    for r in range(rounds):
        # key, subkey = split(key): the subkey draws this round's sort keys,
        # the key (needed only by a next round) splits again.
        sub = threefry(keys, 1, base=1).reshape(-1, 2)
        if r + 1 < rounds:
            keys = threefry(keys, 1).reshape(-1, 2)
        order = torch.sort(threefry(sub, n, xor=True), dim=-1, stable=True).indices
        x = order if x is None else x.gather(-1, order)
    if x is None:
        x = torch.arange(n, device=keys.device).expand(keys.shape[0], n)
    return x.reshape(*lead, n)


def choice(keys: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """``jax.random.choice(key, n, (k,), replace=False)``: the first ``k``
    of :func:`permutation`, int64 ``[..., k]``."""
    if not 0 <= k <= n:
        raise ValueError(f"cannot take {k} of {n} without replacement")
    return permutation(keys, n)[..., :k]

