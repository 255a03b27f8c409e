"""Synthetic oracle-fleet generators with adversarial failure injection.

Mirrors :mod:`svoc_tpu.sim.generators` (``generators.py:26-197``):
``claim_seed`` (bit for bit), ``beta_mode``, ``kumaraswamy_mode``,
``FLEET_CLAIM_SALT`` and ``claim_fleet_keys`` (bit for bit),
``_shuffle``, ``generate_beta_oracles``, ``generate_biased_beta_oracles``,
``generate_kumaraswamy_oracles`` and ``generate_gaussian_oracles``, on
the threefry draws of :mod:`svoc_torch.sim.prng`.

A failing oracle is a uniform draw (``documentation/README.md:105-114``)
and the fleet is shuffled so the failing identities are hidden.  Every
generator returns ``(values [..., n, dim], honest_mask [..., n])``,
``honest_mask`` after the shuffle.  The reference vmaps a generator over
a batch of keys; here ``key [..., 2]`` may carry any leading axes, and
the outputs carry the same ones, so a batch of trials is one call.

What matches the reference, and how closely (``tests/test_torch_generators.py``):

- the shuffle, the failing slots and every uniform draw: bit for bit;
- the Beta fleets: JAX's Marsaglia–Tsang key schedule bit for bit, the
  values within a few ulp (``prng.beta``: PyTorch's ``log`` and ``exp``
  are not XLA's in the last bit); a rejection that an ulp flips would
  give that one element another value, and none flips on the tested
  seeds;
- the Kumaraswamy fleet: within a few ulp (``pow`` is not XLA's);
- the Gaussian fleet: within 3 ulp of the normal draw (``prng.normal``).
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from svoc_torch.sim import prng


def claim_seed(base_seed: int, claim_id) -> int:
    """Per-claim seed: ``zlib.crc32(repr(claim_id))`` (not ``hash()``,
    which Python randomizes per process) mixed with the base seed by a
    polynomial and folded to 32 bits.  A pure function of ``(base_seed,
    claim_id)``, so N claims sharing one base seed get independent,
    replayable oracle streams."""
    crc = zlib.crc32(repr(claim_id).encode())
    mixed = (int(base_seed) * 1_000_003 + crc) & 0xFFFFFFFFFFFFFFFF
    return ((mixed >> 32) ^ mixed) & 0xFFFFFFFF


#: ``fold_in`` salt separating the per-claim key stream from the
#: per-oracle streams the claim keys later fold (``fold_in(claim_key,
#: 0)`` is the failing-slot permutation, ``i + 1`` oracle ``i``'s
#: stream): crc32 of a stable string, masked to an int32-safe word.
FLEET_CLAIM_SALT = zlib.crc32(b"svoc.fleet.claim") & 0x7FFFFFFF


def claim_fleet_keys(key: torch.Tensor, n_claims: int) -> torch.Tensor:
    """Per-claim keys ``[n_claims, 2]`` of the sharded claim-cube fleet
    (:mod:`svoc_torch.parallel.claim_shard`): ``fold_in(fold_in(key,
    FLEET_CLAIM_SALT), c)`` for each global claim index ``c``, so the
    fleet cube is the same bits however (and whether) the claim ×
    oracle mesh splits it."""
    return prng.fold_in_range(prng.fold_in(key, FLEET_CLAIM_SALT), 0, n_claims)


def beta_mode(a: float, b: float) -> float:
    """Mode of Beta(a, b) — the essence under the constrained model."""
    return (a - 1.0) / (a + b - 2.0)


def kumaraswamy_mode(a: float, b: float) -> float:
    """Mode of Kumaraswamy(a, b)."""
    return ((a - 1.0) / (a * b - 1.0)) ** (1.0 / a)


def _per_dim(x, dim: int) -> np.ndarray:
    return np.broadcast_to(np.asarray(x, np.float32), (dim,))


def _shuffle(key: torch.Tensor, values: torch.Tensor, honest: torch.Tensor):
    """``values [..., n, dim]`` and ``honest [n]`` in the order of
    ``permutation(key, n)``."""
    n = values.shape[-2]
    perm = prng.permutation(key, n)
    values = values.gather(-2, perm[..., None].expand(*perm.shape, values.shape[-1]))
    return values, honest[perm]


def _assemble(key_perm, failing_vals, honest_vals, n_oracles: int, n_failing: int):
    values = torch.cat([failing_vals, honest_vals], dim=-2)
    honest = torch.arange(n_oracles, device=values.device) >= n_failing
    return _shuffle(key_perm, values, honest)


def generate_beta_oracles(
    key: torch.Tensor,
    n_oracles: int,
    n_failing: int,
    a,
    b,
    dim: int = 1,
    fail_lo: float = 0.0,
    fail_hi: float = 1.0,
):
    """Beta(a, b) honest oracles (``a``, ``b`` scalars or per dimension)
    and uniform failing oracles on ``[fail_lo, fail_hi)``; the values
    within a few ulp of the reference's."""
    k_beta, k_unif, k_perm = prng.split(key, 3).unbind(-2)
    shape = (n_oracles - n_failing, dim)
    honest_vals = prng.beta(k_beta, _per_dim(a, dim)[None, :], _per_dim(b, dim)[None, :], shape)
    failing_vals = prng.uniform(k_unif, (n_failing, dim), fail_lo, fail_hi)
    return _assemble(k_perm, failing_vals, honest_vals, n_oracles, n_failing)


def generate_biased_beta_oracles(
    key: torch.Tensor,
    n_oracles: int,
    n_failing: int,
    a,
    b,
    dim: int = 1,
    bias_lo: float = 0.85,
    bias_hi: float = 1.0,
):
    """Beta honest oracles and COORDINATED adversaries in the corner band
    ``[bias_lo, bias_hi)^dim``: the attack that can displace a median, and
    the one :func:`svoc_torch.sim.montecarlo.fleet_breakdown_curve`
    measures the estimator's breakdown point with."""
    return generate_beta_oracles(key, n_oracles, n_failing, a, b, dim=dim, fail_lo=bias_lo, fail_hi=bias_hi)


def generate_kumaraswamy_oracles(
    key: torch.Tensor,
    n_oracles: int,
    n_failing: int,
    a,
    b,
    dim: int = 1,
):
    """Kumaraswamy(a, b) honest oracles by the inverse CDF,
    ``X = (1 − (1 − U)^{1/b})^{1/a}``, within a few ulp of the
    reference's."""
    k_u, k_unif, k_perm = prng.split(key, 3).unbind(-2)
    u = prng.uniform(k_u, (n_oracles - n_failing, dim), 1e-7, 1.0 - 1e-7)
    dev = u.device
    a = torch.as_tensor(_per_dim(a, dim).copy(), device=dev)
    b = torch.as_tensor(_per_dim(b, dim).copy(), device=dev)
    honest_vals = (1.0 - (1.0 - u) ** (1.0 / b)) ** (1.0 / a)
    failing_vals = prng.uniform(k_unif, (n_failing, dim))
    return _assemble(k_perm, failing_vals, honest_vals, n_oracles, n_failing)


def generate_gaussian_oracles(
    key: torch.Tensor,
    n_oracles: int,
    n_failing: int,
    mu,
    sigma,
    failing_spread: float = 10.0,
):
    """Unconstrained fleet: honest ~ N(mu, diag(sigma²)), failing uniform
    on ``mu ± failing_spread``.  ``mu + sigma·z`` is one fused
    multiply-add, as XLA compiles it."""
    mu = np.asarray(mu, np.float32)
    dim = mu.shape[0]
    k_norm, k_unif, k_perm = prng.split(key, 3).unbind(-2)
    z = prng.normal(k_norm, (n_oracles - n_failing, dim))
    mu_t = torch.as_tensor(mu.copy(), device=z.device)
    sigma_t = torch.as_tensor(np.broadcast_to(np.asarray(sigma, np.float32), (dim,)).copy(), device=z.device)
    honest_vals = prng._fma(sigma_t, z, mu_t)
    failing_vals = mu_t + prng.uniform(k_unif, (n_failing, dim), -failing_spread, failing_spread)
    return _assemble(k_perm, failing_vals, honest_vals, n_oracles, n_failing)
