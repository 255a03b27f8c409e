"""Multimodal (mixture-model) oracle consensus.

Mirrors :mod:`svoc_tpu.sim.multimodal` (``multimodal.py:61-589``):
:func:`generate_multimodal_oracles`, :func:`em_mixture`,
:func:`multimodal_consensus`, :func:`select_k`,
:func:`multimodal_breakdown_curve` and :func:`benchmark_multimodal`.
The reference documents K poles ``e_k``, each honest oracle following
pole k with probability ``p_k`` (``documentation/README.md:90-103``),
and this is its estimator: a spherical-Gaussian EM fit, the on-chain
fixed-count mask on each oracle's scaled distance to its nearest pole,
a restricted re-estimate over the survivors, and the essence by policy
(``"dominant"``: the heaviest pole's center; ``"average"``: the
weight-averaged center).

The EM has no Pallas kernel in the reference (an XLA scan), so it stays
plain PyTorch on both devices, batched over leading (trial) axes: a
Monte-Carlo cell's ``T`` fleets are one fit.  Where a trial calls the
unimodal consensus it takes
:func:`svoc_torch.ops.fused_consensus.consensus_blocks` (B3 on CUDA).

What matches the reference (``tests/test_torch_multimodal.py``): the
draws (pole choice, failing slots and shuffle bit for bit, the normal
noise within 3 ulp), the farthest-point initialisation's picks and the
fixed iteration count exactly; the log-sum-exp responsibilities, means,
spreads and weights within 1e-5.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from svoc_torch.consensus.kernel import ConsensusConfig
from svoc_torch.ops.fused_consensus import consensus_blocks
from svoc_torch.ops.sort import reliability_mask
from svoc_torch.sim import prng

__all__ = [
    "MixtureFit",
    "MultimodalResult",
    "generate_multimodal_oracles",
    "em_mixture",
    "multimodal_consensus",
    "select_k",
    "benchmark_multimodal",
    "multimodal_breakdown_curve",
]


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32).copy(), device=device)


def _normalized_weights(weights, k: int) -> np.ndarray:
    if weights is None:
        return np.full((k,), np.float32(1.0 / k), np.float32)
    w = np.asarray(weights, np.float32)
    return (w / w.sum(dtype=np.float32)).astype(np.float32)


def generate_multimodal_oracles(
    key: torch.Tensor,
    n_oracles: int,
    n_failing: int,
    poles,
    sigma,
    weights=None,
    constrained: bool = True,
):
    """The reference's documented multimodal generative model: honest
    oracles draw a pole from ``Mult(1, p)`` and sample ``N(e_k, sigma_k)``
    (clipped into ``]0, 1[^M`` when ``constrained``), failing oracles are
    uniform.  Returns ``(values [..., n, dim], honest [..., n], pole_of
    [..., n])``, ``pole_of`` −1 for failing oracles, all shuffled alike."""
    poles_np = np.asarray(poles, np.float32)
    k_components, dim = poles_np.shape
    sigma_np = np.broadcast_to(np.asarray(sigma, np.float32), (k_components, dim))
    w = _normalized_weights(weights, k_components)
    n_honest = n_oracles - n_failing
    k_pole, k_norm, k_unif, k_perm = prng.split(key, 4).unbind(-2)
    dev = key.device
    pole_of_honest = prng.choice_p(k_pole, (n_honest,), w)
    noise = prng.normal(k_norm, (n_honest, dim))
    honest_vals = prng._fma(noise, _f32(sigma_np, dev)[pole_of_honest], _f32(poles_np, dev)[pole_of_honest])
    failing_vals = prng.uniform(k_unif, (n_failing, dim))
    if constrained:
        eps = 1e-4
        honest_vals = torch.clamp(honest_vals, eps, 1.0 - eps)
        failing_vals = torch.clamp(failing_vals, eps, 1.0 - eps)
    values = torch.cat([failing_vals, honest_vals], dim=-2)
    honest = torch.arange(n_oracles, device=dev) >= n_failing
    pole_of = torch.cat([torch.full((*pole_of_honest.shape[:-1], n_failing), -1, dtype=torch.int64, device=dev),
                         pole_of_honest], dim=-1)
    perm = prng.permutation(k_perm, n_oracles)
    values = values.gather(-2, perm[..., None].expand(*perm.shape, dim))
    return values, honest[perm], pole_of.gather(-1, perm)


class MixtureFit(NamedTuple):
    """EM fit state: spherical Gaussians, one scalar spread each."""

    means: torch.Tensor  # [..., K, dim]
    sigmas: torch.Tensor  # [..., K]
    weights: torch.Tensor  # [..., K]
    resp: torch.Tensor  # [..., N, K] posterior responsibilities
    log_likelihood: torch.Tensor  # [...], mean per-point


def _sq_dist(values: torch.Tensor, means: torch.Tensor) -> torch.Tensor:
    """``[..., N, K]`` squared distances of ``values [..., N, dim]`` to
    ``means [..., K, dim]``."""
    return ((values[..., :, None, :] - means[..., None, :, :]) ** 2).sum(-1)


def _log_resp(values, means, sigmas, weights):
    """``[..., N, K]`` log p(k | x_i) and the per-point log-evidence."""
    dim = values.shape[-1]
    d2 = _sq_dist(values, means)
    s = sigmas[..., None, :]
    log_pdf = -0.5 * d2 / (s**2) - dim * torch.log(s) - 0.5 * dim * math.log(2.0 * math.pi)
    joint = log_pdf + torch.log(weights[..., None, :])
    evidence = torch.logsumexp(joint, dim=-1, keepdim=True)
    return joint - evidence, evidence[..., 0]


def em_mixture(
    values: torch.Tensor,
    k_components: int,
    n_iters: int = 30,
    seed: int = 0,
    min_sigma: float = 1e-3,
) -> MixtureFit:
    """Spherical-Gaussian mixture EM over ``values [..., N, dim]``:
    farthest-point initialisation from a uniform first pick
    (``randint(PRNGKey(seed), (), 0, N)``, the same pick for every fleet
    of a batch, as the reference's), then ``n_iters`` EM steps; spreads
    floored at ``min_sigma``."""
    n, dim = values.shape[-2:]
    lead = values.shape[:-2]
    dev, dt = values.device, values.dtype
    first = int(prng.randint(prng.PRNGKey(seed, dev), (), 0, n))

    def row(idx):  # values[..., idx, :] for a per-fleet index idx [...]
        return values.gather(-2, idx[..., None, None].expand(*lead, 1, dim))[..., 0, :]

    means = [values[..., first, :]]
    min_d2 = torch.full((*lead, n), torch.inf, dtype=dt, device=dev)
    for _ in range(1, k_components):
        d2 = ((values - means[-1][..., None, :]) ** 2).sum(-1)
        min_d2 = torch.minimum(min_d2, d2)
        means.append(row(torch.argmax(min_d2, dim=-1)))
    means = torch.stack(means, dim=-2)

    flat = values.reshape(*lead, n * dim)
    global_sigma = torch.clamp(flat.std(dim=-1, correction=0), min=min_sigma)
    sigmas = global_sigma[..., None].expand(*lead, k_components).clone()
    weights = torch.full((*lead, k_components), 1.0 / k_components, dtype=dt, device=dev)
    for _ in range(n_iters):
        log_r, _ = _log_resp(values, means, sigmas, weights)
        r = torch.exp(log_r)
        nk = r.sum(-2) + 1e-9
        means = (r.transpose(-1, -2) @ values) / nk[..., None]
        d2 = _sq_dist(values, means)
        sigmas = torch.sqrt((r * d2).sum(-2) / (nk * dim) + 1e-12)
        sigmas = torch.clamp(sigmas, min=min_sigma)
        weights = nk / nk.sum(-1, keepdim=True)
    log_r, evidence = _log_resp(values, means, sigmas, weights)
    return MixtureFit(means=means, sigmas=sigmas, weights=weights, resp=torch.exp(log_r),
                      log_likelihood=evidence.mean(-1))


class MultimodalResult(NamedTuple):
    essence: torch.Tensor  # [..., dim], per the chosen policy
    pole_means: torch.Tensor  # [..., K, dim] restricted re-estimate
    pole_weights: torch.Tensor  # [..., K] share of RELIABLE oracles per pole
    pole_sigmas: torch.Tensor  # [..., K]
    reliable: torch.Tensor  # [..., N] bool, fixed-count mask
    pole_of: torch.Tensor  # [..., N] argmax-responsibility assignment
    fit: MixtureFit


def multimodal_consensus(
    values: torch.Tensor,
    k_components: int,
    n_failing: int,
    n_iters: int = 30,
    policy: str = "dominant",
    seed: int = 0,
) -> MultimodalResult:
    """Mixture-aware two-pass consensus over ``values [..., N, dim]``:
    the EM fit; each oracle scored by its scaled distance to the nearest
    pole and the worst ``n_failing`` flagged (the on-chain fixed-count
    mask, Cairo tie order); the poles re-estimated over the reliable
    set; the essence by ``policy``."""
    if policy not in ("dominant", "average"):
        raise ValueError(f"policy {policy!r} not in dominant|average")
    fit = em_mixture(values, k_components, n_iters=n_iters, seed=seed)
    d = torch.sqrt(_sq_dist(values, fit.means))
    score = (d / fit.sigmas[..., None, :]).min(-1).values
    reliable = reliability_mask(score, n_failing)

    r = fit.resp * reliable[..., None]
    nk = r.sum(-2) + 1e-9
    pole_means = (r.transpose(-1, -2) @ values) / nk[..., None]
    dim = values.shape[-1]
    d2 = _sq_dist(values, pole_means)
    pole_sigmas = torch.sqrt((r * d2).sum(-2) / (nk * dim) + 1e-12)
    pole_weights = nk / nk.sum(-1, keepdim=True)
    if policy == "dominant":
        idx = torch.argmax(pole_weights, dim=-1)
        essence = pole_means.gather(-2, idx[..., None, None].expand(*idx.shape, 1, dim))[..., 0, :]
    else:
        essence = (pole_weights[..., None] * pole_means).sum(-2)
    return MultimodalResult(
        essence=essence,
        pole_means=pole_means,
        pole_weights=pole_weights,
        pole_sigmas=pole_sigmas,
        reliable=reliable,
        pole_of=torch.argmax(fit.resp, dim=-1),
        fit=fit,
    )


def select_k(
    values: torch.Tensor,
    k_max: int = 8,
    n_iters: int = 30,
    seed: int = 0,
    min_support: int = 3,
) -> tuple:
    """The pole count by BIC over ``K = 1..k_max`` for one fleet ``[N,
    dim]``, with the reference's guards (support cap ``N // min_support``,
    a collapsed component (soft count below 2) or two overlapping poles
    disqualify a fit, and a larger K wins only by ΔBIC > 10).  Returns
    ``(best_k, bics)``."""
    n, dim = values.shape
    k_max = max(1, min(k_max, n // max(min_support, 1) or 1))
    bics = []
    for k in range(1, k_max + 1):
        fit = em_mixture(values, k, n_iters=n_iters, seed=seed)
        if k > 1:
            if float(fit.resp.sum(0).min()) < 2.0:
                bics.append(float("inf"))
                continue
            pair_d = torch.linalg.vector_norm(fit.means[:, None, :] - fit.means[None, :, :], dim=-1)
            sep = 2.0 * (fit.sigmas[:, None] + fit.sigmas[None, :])
            off_diag = ~torch.eye(k, dtype=torch.bool, device=values.device)
            if bool(((pair_d < sep) & off_diag).any()):
                bics.append(float("inf"))
                continue
        p = k * dim + k + (k - 1)
        bics.append(-2.0 * float(fit.log_likelihood) * n + p * math.log(n))
    best_k = 1
    for k in range(2, len(bics) + 1):
        if bics[k - 1] < bics[best_k - 1] - 10.0:
            best_k = k
    return best_k, bics


def _pole_recovery_error(est_means: torch.Tensor, true_poles: torch.Tensor) -> torch.Tensor:
    """Mean over TRUE poles of the distance to the nearest estimated pole."""
    d = torch.linalg.vector_norm(true_poles[:, None, :] - est_means[..., None, :, :], dim=-1)
    return d.min(-1).values.mean(-1)


def _nearest(poles: torch.Tensor, essence: torch.Tensor):
    d = torch.linalg.vector_norm(poles - essence[..., None, :], dim=-1)
    return d.min(-1).values, d.argmin(-1)


def _multimodal_trials(keys, poles, sigma, weights, *, n_oracles, n_failing, k_components, policy):
    cfg = ConsensusConfig(n_failing=n_failing, constrained=True)
    dev = keys.device
    poles_t = _f32(poles, dev)
    dominant = int(np.argmax(weights))
    values, honest, _ = generate_multimodal_oracles(keys, n_oracles, n_failing, poles, sigma, weights)
    mm = multimodal_consensus(values, k_components, n_failing, policy=policy)
    uni = consensus_blocks(values, cfg)
    mm_near, mm_which = _nearest(poles_t, mm.essence)
    uni_near, uni_which = _nearest(poles_t, uni.essence)
    ident = torch.all(mm.reliable == honest, dim=-1)
    pole_err = _pole_recovery_error(mm.pole_means, poles_t)
    return (mm_near.mean(), uni_near.mean(), (mm_which == dominant).float().mean(),
            (uni_which == dominant).float().mean(), ident.float().mean(), pole_err.mean())


def _coordinated_trials(keys, poles, sigma, weights, adv_point, adv_spread, *, n_oracles, n_failing, k_components):
    dev = keys.device
    dominant_pole = _f32(poles, dev)[int(np.argmax(weights))]
    adv_point_t = _f32(adv_point, dev)
    k_gen, k_adv = prng.split(keys, 2).unbind(-2)
    values, honest, _ = generate_multimodal_oracles(k_gen, n_oracles, n_failing, poles, sigma, weights)
    z = prng.normal(k_adv, (n_oracles, values.shape[-1]))
    adv = prng._fma(torch.tensor(float(np.float32(adv_spread)), device=dev), z, adv_point_t)
    adv = torch.clamp(adv, 1e-4, 1.0 - 1e-4)
    values = torch.where(honest[..., None], values, adv)
    mm = multimodal_consensus(values, k_components, n_failing)
    err = torch.linalg.vector_norm(mm.essence - dominant_pole, dim=-1)
    on_honest = err < torch.linalg.vector_norm(mm.essence - adv_point_t, dim=-1)
    return err.mean(), on_honest.float().mean()


def multimodal_breakdown_curve(
    key: torch.Tensor,
    poles,
    sigma,
    weights=None,
    n_oracles: int = 64,
    fractions=(0.1, 0.2, 0.3, 0.35, 0.45, 0.55),
    adv_point=None,
    adv_spread: float = 0.01,
    k_trials: int = 200,
) -> dict:
    """Breakdown of the MIXTURE estimator under coordinated adversaries
    forming a tight fake pole: the fit has K+1 components, and the
    essence leaves the dominant honest pole once the fake pole outweighs
    it (a cliff at the dominant pole's weight, not at N/2).  Returns
    ``{fraction: {"essence_err": ..., "on_honest_pole_pct": ...}}``."""
    poles = np.asarray(poles, np.float32)
    weights = _normalized_weights(weights, poles.shape[0])
    adv_point = np.full((poles.shape[1],), 0.95, np.float32) if adv_point is None else np.asarray(adv_point,
                                                                                                   np.float32)
    out = {}
    for frac in fractions:
        n_failing = int(round(frac * n_oracles))
        keys = prng.split(prng.fold_in(key, n_failing), k_trials)
        err, on_honest = _coordinated_trials(keys, poles, sigma, weights, adv_point, adv_spread,
                                             n_oracles=n_oracles, n_failing=n_failing,
                                             k_components=int(poles.shape[0]) + 1)
        out[frac] = {"essence_err": float(err), "on_honest_pole_pct": float(on_honest) * 100.0}
    return out


def benchmark_multimodal(
    key: torch.Tensor,
    poles,
    sigma,
    weights=None,
    n_oracles: int = 64,
    n_failing: int = 4,
    k_components: "int | None" = None,
    k_trials: int = 300,
    policy: str = "dominant",
) -> dict:
    """Monte-Carlo cell comparing the mixture estimator against the
    unimodal two-pass consensus on the documented multimodal model: the
    distance from each essence to the nearest true pole, how often it
    lies nearest the dominant pole, the mixture's exact identification
    and its permutation-free pole-recovery error."""
    poles = np.asarray(poles, np.float32)
    weights = _normalized_weights(weights, poles.shape[0])
    if k_components is None:
        k_components = int(poles.shape[0])
    mm_near, uni_near, mm_dom, uni_dom, ident, pole_err = _multimodal_trials(
        prng.split(key, k_trials), poles, sigma, weights, n_oracles=n_oracles, n_failing=n_failing,
        k_components=k_components, policy=policy)
    return {
        "mixture_nearest_pole_error": float(mm_near),
        "unimodal_nearest_pole_error": float(uni_near),
        "mixture_dominant_pole_pct": float(mm_dom) * 100.0,
        "unimodal_dominant_pole_pct": float(uni_dom) * 100.0,
        "identification_success_pct": float(ident) * 100.0,
        "pole_recovery_error": float(pole_err),
    }
