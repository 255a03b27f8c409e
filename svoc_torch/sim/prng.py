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
  fresh 32-bit keys; ``choice(replace=False)`` is its first ``k``;
- ``randint`` (``random.py:581-640``) draws two words a value from
  ``split(key)`` and folds them modulo the span, in uint32 arithmetic:
  bit for bit;
- ``choice(p=, replace=True)`` (``random.py:800-806``) is a
  ``searchsorted`` of ``cumsum(p)`` at ``p_cuml[-1] * (1 - uniform)``:
  bit for bit for the few categories it is given;
- ``uniform`` on ``[minval, maxval)`` is ``f * (maxval - minval) + minval``
  with one rounding, as XLA contracts it to a fused multiply-add;
- ``normal`` (``random.py:867-872``) is ``sqrt(2) * erf_inv(u)`` with
  ``u`` uniform on ``(nextafter(-1, 0), 1)``.  XLA's float32 ``erf_inv``
  is Giles' polynomial (:func:`erf_inv`), ported here; it calls
  ``log1p`` and ``sqrt``, and PyTorch's ``log1p`` differs from XLA's in
  the last bit of about 8 % of float32 inputs, so a normal draw agrees
  to 3 ulp (99 % of them exactly);
- ``gamma`` and ``loggamma`` (``random.py:1298-1413``) are
  Marsaglia–Tsang with JAX's key schedule (one key an element from
  ``split(key, size)``, then per rejection round ``split(key, 3)`` and
  an inner loop of ``split`` until ``v > 0``), run as a masked loop over
  every element until all accept; ``beta`` (``random.py:1133-1148``)
  combines two log-gammas.  PyTorch's ``log`` and ``exp`` differ from
  XLA's in the last bit of 10-15 % of inputs, so a sample agrees to a
  few ulp, except where an ulp moves a rejection test across its bound
  (a flip): that element then takes another round and a different
  value.  ``tests/test_torch_generators.py`` counts the flips.

Keys are int64 tensors ``[..., 2]`` of uint32 words (so the sort keys
compare as unsigned numbers), and every function takes any number of
leading key axes, so a fleet of many oracles or claims is one call of
each.  The hash is :func:`svoc_torch.ops.threefry.threefry` (the kernel
on CUDA).
"""

from __future__ import annotations

import functools
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


def fold_in_range(keys: torch.Tensor, start: int, n: int) -> torch.Tensor:
    """``fold_in(key, start + j)`` for ``j < n``: ``[..., 2]`` →
    ``[..., n, 2]``, one hash call (a key's oracle streams by global
    index, ``svoc_tpu/parallel/sharded.py:212``)."""
    return threefry(_flat(keys), n, base=int(start) & MASK).reshape(*keys.shape[:-1], n, 2)


def random_bits(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32-bit random bits ``[..., *shape]`` int64 in ``[0, 2**32)``."""
    shape = tuple(shape)
    bits = threefry(_flat(keys), math.prod(shape), xor=True)
    return bits.reshape(tuple(keys.shape[:-1]) + shape)


def uniform(keys: torch.Tensor, shape: Sequence[int], minval=0.0, maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform`` on ``[minval, maxval)``: float32 ``[...,
    *shape]``.  JAX sets the top 23 bits as the mantissa of a float in
    ``[1, 2)`` and subtracts 1, which is exactly ``(bits >> 9) * 2**-23``;
    then ``max(minval, f * (maxval - minval) + minval)`` in float32 (the
    bounds broadcast against ``shape``)."""
    f = (random_bits(keys, shape) >> 9).to(torch.float32) * 2.0**-23
    if isinstance(minval, (int, float)) and isinstance(maxval, (int, float)) and (minval, maxval) == (0.0, 1.0):
        return f
    lo = torch.as_tensor(np.asarray(minval, np.float32), device=f.device)
    hi = torch.as_tensor(np.asarray(maxval, np.float32), device=f.device)
    return torch.maximum(lo, _fma(f, hi - lo, lo))


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` in float32 with one rounding, as XLA's CPU backend
    contracts a multiply feeding an add: the float32 product is exact in
    float64, so only the sum rounds before the cast (twice only where the
    float64 sum lands on a float32 midpoint)."""
    return (a.double() * torch.as_tensor(b).double() + torch.as_tensor(c).double()).float()


@functools.cache
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
        raise ValueError(f"Cannot take a larger sample (size {k}) than population (size {n}) when 'replace=False'")
    return permutation(keys, n)[..., :k]


def randint(keys: torch.Tensor, shape: Sequence[int], minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` with int32
    values: int64 ``[..., *shape]``.  Two words a value (``split(key)``),
    reduced modulo the span with JAX's uint32 wrap-around."""
    minval, maxval = int(minval), int(maxval)
    k1, k2 = split(keys, 2).unbind(-2)
    hi, lo = random_bits(k1, shape), random_bits(k2, shape)
    span = (maxval - minval) & MASK if maxval > minval else 1
    multiplier = (2**16 % span) ** 2 % span
    offset = (((hi % span) * multiplier) & MASK) + lo % span
    return minval + (offset & MASK) % span


def choice_p(keys: torch.Tensor, shape: Sequence[int], p) -> torch.Tensor:
    """``jax.random.choice(key, len(p), shape, replace=True, p=p)``: int64
    ``[..., *shape]``, the first index whose cumulative weight reaches
    ``p_cuml[-1] * (1 - u)``."""
    p_cuml = torch.cumsum(torch.as_tensor(np.asarray(p, np.float32), device=keys.device), 0)
    r = p_cuml[-1] * (1.0 - uniform(keys, shape))
    return torch.searchsorted(p_cuml, r.reshape(-1).contiguous()).reshape(r.shape)


#: XLA's float32 ``ErfInv`` (Giles, "Approximating the erfinv function"):
#: the polynomial's coefficients, highest degree first, for ``w < 5`` and
#: for ``w >= 5``.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
               -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
               -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv``, op for op: ``w = -log1p(-x*x)``, a
    degree-8 polynomial in ``w - 2.5`` or ``sqrt(w) - 3`` (each Horner
    step a fused multiply-add, as XLA's CPU backend contracts it), times
    ``x``; ``±inf`` at ``|x| == 1``."""
    w = -torch.log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coefficient(i):
        return torch.where(lt, float(np.float32(_ERFINV_LT5[i])), float(np.float32(_ERFINV_GE5[i])))

    p = coefficient(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = _fma(p, w, coefficient(i))
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2)))


def normal(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.normal``: float32 ``[..., *shape]``."""
    return _SQRT2 * erf_inv(uniform(keys, shape, _NORMAL_LO, 1.0))


_THIRD = float(np.float32(1.0 / 3.0))
_SQUEEZE = float(np.float32(0.0331))


def _gamma_one(keys: torch.Tensor, alpha: torch.Tensor, log_space: bool) -> torch.Tensor:
    """``_gamma_one(key, alpha, log_space)`` for each element: keys
    ``[E, 2]``, ``alpha [E]`` float32 → ``[E]``.  Each rejection loop runs
    on the elements still rejecting, until none is."""
    boost = alpha >= 1.0
    alpha_orig = alpha
    alpha = torch.where(boost, alpha, alpha + 1.0)
    d = alpha - _THIRD
    c = _THIRD / torch.sqrt(d)
    key, subkey = split(keys, 2).unbind(-2)
    key = key.clone()
    e = alpha.shape[0]
    X = torch.zeros(e, dtype=torch.float32, device=alpha.device)
    V = torch.ones_like(X)
    U = torch.full_like(X, 2.0)

    def rejects(X, V, U, d):
        return (U >= 1.0 - _SQUEEZE * (X * X)) & (torch.log(U) >= X * 0.5 + d * ((1.0 - V) + torch.log(V)))

    active = torch.arange(e, device=alpha.device)  # every element starts in the loop
    while active.numel():
        key_a, x_key, u_key = split(key[active], 3).unbind(-2)
        ca = c[active]
        x = torch.zeros_like(ca)
        v = torch.full_like(ca, -1.0)
        inner = torch.arange(active.numel(), device=alpha.device)
        while inner.numel():
            x_key_i, sub = split(x_key[inner], 2).unbind(-2)
            x_key[inner] = x_key_i
            xi = normal(sub, ())
            x[inner] = xi
            v[inner] = 1.0 + xi * ca[inner]
            inner = inner[v[inner] <= 0.0]
        key[active] = key_a
        X[active] = x * x
        V[active] = (v * v) * v
        U[active] = uniform(u_key, ())
        active = active[rejects(X[active], V[active], U[active], d[active])]
    if not log_space:
        samples = 1.0 - uniform(subkey, ())
        return (d * V) * torch.where(boost, 1.0, torch.pow(samples, 1.0 / alpha_orig))
    log_samples = torch.log1p(-uniform(subkey, ()))
    log_boost = torch.where(boost | (log_samples == 0), 0.0, log_samples * (1.0 / alpha_orig))
    return (torch.log(d) + torch.log(V)) + log_boost


def _gamma(keys: torch.Tensor, a, shape: Sequence[int], log_space: bool) -> torch.Tensor:
    shape = tuple(shape)
    lead = keys.shape[:-1]
    size = math.prod(shape)
    flat = split(_flat(keys), size).reshape(-1, 2)  # split(key, size) for each key, in order
    alpha = torch.as_tensor(np.broadcast_to(np.asarray(a, np.float32), shape).copy(), device=keys.device)
    alpha = alpha.reshape(1, size).expand(flat.shape[0] // max(size, 1), size).reshape(-1)
    return _gamma_one(flat, alpha.contiguous(), log_space).reshape(*lead, *shape)


def gamma(keys: torch.Tensor, a, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gamma(key, a, shape)``: float32 ``[..., *shape]``;
    ``a`` broadcasts against ``shape``."""
    return _gamma(keys, a, shape, log_space=False)


def loggamma(keys: torch.Tensor, a, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.loggamma(key, a, shape)``: float32 ``[..., *shape]``."""
    return _gamma(keys, a, shape, log_space=True)


def beta(keys: torch.Tensor, a, b, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.beta(key, a, b, shape)``: two log-gammas from
    ``split(key)``, combined as ``ga / (ga + gb)`` after subtracting
    their maximum."""
    key_a, key_b = split(keys, 2).unbind(-2)
    log_a = loggamma(key_a, a, shape)
    log_b = loggamma(key_b, b, shape)
    log_max = torch.maximum(log_a, log_b)
    ga = torch.exp(log_a - log_max)
    gb = torch.exp(log_b - log_max)
    return ga / (ga + gb)
